"""K2 (ops/banded.py): host tables, the plain version against the JAX Pallas
banded kernel in interpret mode, scale_, components, the wrapper's checks,
and the CUDA kernel against its plain version on a card (skipped without
one)."""

import functools

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import banded as bd
from deal_and_ceed_on_gpu_torch.ops.stencil import face_mask
from deal_and_ceed_on_gpu_torch.utils.convert import banded_tables_from_jax

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.ops.pallas_banded import build_banded_operator
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

# tests/test_pallas_banded.py's cases: elements (mx, my, mz), p, q, graded,
# kind, value_const
CASES = [
    ((4, 5, 6), 3, 5, False, "stiffness", None),
    ((4, 5, 6), 3, 4, True, "stiffness", 2.5),
    ((3, 4, 5), 5, 7, True, "stiffness", None),
    ((4, 5, 6), 2, 4, True, "mass", None),
    ((3, 4, 5), 4, 6, False, "mass", 3.0),
]


def _breaks(n_el):
    rng = np.random.default_rng(7)
    return [np.cumsum(np.concatenate([[0.0], 0.6 + rng.random(m)])) for m in n_el]


def _mesh(lib, n_el, graded):
    return lib.BrickMesh.graded(*_breaks(n_el)) if graded else lib.BrickMesh(n_el)


def _random(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@functools.cache
def _jax_case(i):
    """The JAX interpret-mode kernel on case i: its converted tables, the
    input and the raw (``M A M``) and constrained outputs, as numpy."""
    n_el, p, q, graded, kind, c = CASES[i]
    mesh = _mesh(jx, n_el, graded)
    space = jx.FESpace.create(mesh, p, n_q=q, rule="gauss", dtype=jnp.float64)
    op = build_banded_operator(mesh, space.basis, jnp.float64, kind=kind, value_const=c, interpret=True)
    L = op.layout
    u = _random(space.n_dofs, seed=i)
    up = L.pad_flat(jnp.asarray(u))
    raw = np.asarray(L.unpad_flat(op(up)))
    con = np.asarray(L.unpad_flat(op.constrained_call(up)))
    return banded_tables_from_jax(L), u, raw, con, np.asarray(space.dirichlet_mask)


def _port(i, dtype=torch.float64):
    n_el, p, q, graded, kind, c = CASES[i]
    space = pt.FESpace.create(_mesh(pt, n_el, graded), p, n_q=q, rule="gauss", dtype=dtype, device="cpu")
    return space, bd.banded_tables_np(space.mesh, space.basis, kind, c)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_tables_equal_converted_jax_layout(i):
    conv = _jax_case(i)[0]
    _, own = _port(i)
    assert set(own) == set(conv) == set(bd.KINDS[CASES[i][4]])
    for k in own:
        assert own[k].shape == conv[k].shape
        np.testing.assert_allclose(own[k], conv[k], rtol=0, atol=1e-15)


@pytest.mark.parametrize("source", ["own", "converted"])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_matches_jax_pallas_interpret(i, source):
    """The plain K2 on the port's own tables and on the tables carried across
    from the JAX layout, against the JAX kernel: 1e-12 of max|want| on the
    free rows, the identity faces exact."""
    conv, u, raw, con, mask = _jax_case(i)
    space, own = _port(i)
    tabs = bd.BandedTables.from_numpy(own if source == "own" else conv, space.degree, torch.float64, device="cpu")
    got = bd.banded_apply_reference(torch.as_tensor(u).reshape(space.grid_shape), tabs).reshape(-1).numpy()
    free = ~mask
    scale = np.abs(raw[free]).max()
    assert np.abs(got[free] - raw[free]).max() <= 1e-12 * scale
    np.testing.assert_array_equal(got[mask], u[mask])
    np.testing.assert_array_equal(con[mask], u[mask])  # JAX's in-kernel identity faces agree
    assert np.abs(got - con).max() <= 1e-12 * scale


@pytest.mark.parametrize("i", [0, 3])
def test_scale_scales_the_x_tables_only(i):
    space, own = _port(i)
    tabs = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    u = torch.as_tensor(_random(space.grid_shape, seed=2))
    before = bd.banded_apply(u, tabs)
    untouched = {k: getattr(tabs, k).clone() for k in ("my", "ay", "mz", "gz") if getattr(tabs, k) is not None}
    mx = tabs.mx
    tabs.scale_(2.5)
    assert tabs.mx is mx  # in place: the tensor the kernel reads
    np.testing.assert_array_equal(tabs.mx.numpy(), 2.5 * own["mx"])
    if "ax" in own:
        np.testing.assert_array_equal(tabs.ax.numpy(), 2.5 * own["ax"])
    for k, t in untouched.items():
        assert torch.equal(getattr(tabs, k), t)
    after = bd.banded_apply(u, tabs)
    face = face_mask(space.grid_shape, "cpu")
    assert torch.equal(after[face], u[face])
    np.testing.assert_allclose(after[~face].numpy(), 2.5 * before[~face].numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_components_match_single_calls(i):
    """nc = 3 in one call equals three nc = 1 calls, and the components do
    not couple: one non-zero component leaves exact zeros in the others."""
    space, own = _port(i)
    tabs = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    u = torch.as_tensor(_random((3, *space.grid_shape), seed=i))
    got = bd.banded_apply(u, tabs)
    assert got.shape == u.shape
    for c in range(3):
        assert torch.equal(got[c], bd.banded_apply(u[c].contiguous(), tabs))
    one = torch.zeros_like(u)
    one[1] = u[1]
    out = bd.banded_apply(one, tabs)
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[2]) == 0
    assert torch.equal(out[1], got[1])


def test_out_buffer_is_written_everywhere():
    space, own = _port(1)
    tabs = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    u = torch.as_tensor(_random((3, *space.grid_shape), seed=4))
    out = torch.full_like(u, float("nan"))
    assert bd.banded_apply(u, tabs, out=out) is out
    assert torch.equal(out, bd.banded_apply_reference(u, tabs))


def test_bf16_storage_rounds_once_each_way():
    """bf16 storage, f32 compute: the result is the f32 apply of the rounded
    input, rounded once (to bf16's 3e-2 of max|out|)."""
    space, own = _port(2, torch.float32)
    t32 = bd.BandedTables.from_numpy(own, space.degree, torch.float32, device="cpu")
    u = torch.as_tensor(_random(space.grid_shape, seed=5), dtype=torch.float32).to(torch.bfloat16)
    got = bd.banded_apply(u, t32)
    assert got.dtype == torch.bfloat16
    want = bd.banded_apply(u.float(), t32)
    assert torch.equal(got, want.to(torch.bfloat16))
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err < 3e-2


def test_cpu_apply_uses_the_plain_version_and_counts_no_launch():
    space, own = _port(0)
    tabs = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    u = torch.as_tensor(_random(space.grid_shape))
    before = bd.LAUNCHES
    assert torch.equal(bd.banded_apply(u, tabs), bd.banded_apply_reference(u, tabs))
    assert bd.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    space, own = _port(0)
    t64 = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    t32 = bd.BandedTables.from_numpy(own, space.degree, torch.float32, device="cpu")
    u = torch.zeros(space.grid_shape, dtype=torch.float64)
    with pytest.raises(TypeError):
        bd.banded_apply(u.float(), t64)  # f32 storage with f64 tables
    with pytest.raises(TypeError):
        bd.banded_apply(u.to(torch.bfloat16), t64)
    with pytest.raises(TypeError):
        bd.banded_apply(u.half(), t32)
    with pytest.raises(ValueError):
        bd.banded_apply(u.reshape(-1), t64)  # flat
    with pytest.raises(ValueError):
        bd.banded_apply(u.transpose(0, 2).contiguous(), t64)  # wrong shape
    with pytest.raises(ValueError):
        bd.banded_apply(u[None, None], t64)  # too many dimensions
    with pytest.raises(ValueError):
        nz, ny, nx = space.grid_shape
        bd.banded_apply(torch.zeros((nz, ny, 2 * nx), dtype=torch.float64)[:, :, ::2], t64)  # strided
    with pytest.raises(ValueError):
        bd.banded_apply(torch.zeros(space.grid_shape, dtype=torch.float64, device="meta"), t64)  # device
    with pytest.raises(ValueError):
        bd.banded_apply(u, t64, out=torch.zeros_like(u).float())  # out dtype
    with pytest.raises(ValueError):
        bd.banded_apply(u, t64, out=u)  # out overlaps u
    bad = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    bad.my = bad.my[:, :-1]
    with pytest.raises(ValueError):
        bd.banded_apply(u, bad)  # a table of the wrong width
    assert bd.banded_apply(u.to(torch.bfloat16), t32).dtype == torch.bfloat16


def test_tables_reject_unsupported_configurations():
    with pytest.raises(ValueError):
        bd.banded_tables_np(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(3, 5, "gauss"), kind="helmholtz")
    with pytest.raises(ValueError):
        bd.banded_tables_np(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(9, 11, "gauss"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(CASES)))
@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("storage,compute,tol", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_kernel_matches_plain_on_card(cuda_device, i, nc, storage, compute, tol):
    n_el, p, q, graded, kind, c = CASES[i]
    tables = bd.BandedTables.create(_mesh(pt, n_el, graded), pt.Basis1D.make(p, q, "gauss"), compute, cuda_device,
                                    kind, c)
    shape = tables.shape if nc == 1 else (nc, *tables.shape)
    u = torch.as_tensor(_random(shape, seed=i), device=cuda_device).to(storage)
    before = bd.LAUNCHES
    got = bd.banded_apply(u, tables, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    assert bd.LAUNCHES == before + 1
    want = bd.banded_apply_reference(u, tables)
    assert torch.isfinite(got).all()
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert float(err) <= tol
    face = face_mask(tables.shape, cuda_device).expand(shape)
    assert torch.equal(got[face], u[face])
