"""K2 (ops/banded.py): host tables (the band form and the element form the
CUDA kernel reads), the plain version against the JAX Pallas banded kernel in
interpret mode, scale_, components, the wrapper's checks, and the CUDA kernel
against its plain version on a card (skipped without one)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import banded as bd
from deal_and_ceed_on_gpu_torch.ops.separable import _bands_from_dense, band_matrix_1d
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


def _assemble(m, p, pairs):
    """The band table ``[n, 2p+1]`` of ``sum Z^T diag(f) M Z`` over the
    (element matrix, per-element factors) ``pairs``, Dirichlet rows and
    columns zeroed (the kernel's masks)."""
    A = sum(band_matrix_1d(m, p, M, scale=np.asarray(f)) for M, f in pairs)
    A[0, :] = A[:, 0] = A[-1, :] = A[:, -1] = 0.0
    return _bands_from_dense(A, p).T


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("c", [None, 1.75])
@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("kind", ["stiffness", "mass"])
@pytest.mark.parametrize("p", range(1, 9))
def test_element_form_reassembles_the_band_tables(p, kind, graded, c, scaled):
    """The element form the kernel reads (B, K and the per-element factors)
    assembles to banded_tables_np's band tables, to 1e-14 of their largest
    entry, also after scale_ (which scales both forms); ex's ratio rows are
    those of its factor rows to the element below."""
    n_el = (3, 2, 4)
    tabs = bd.BandedTables.create(_mesh(pt, n_el, graded), pt.Basis1D.make(p, p + 2, "gauss"), torch.float64,
                                  "cpu", kind, c)
    s = 0.625 if scaled else 1.0
    if scaled:
        tabs.scale_(s)
    B, K = tabs.B_host, tabs.K_host
    ex, ey, ez = (t.numpy() for t in (tabs.ex, tabs.ey, tabs.ez))
    mx, my, mz = n_el
    got = {"mx": _assemble(mx, p, [(B, ex[0])]), "my": _assemble(my, p, [(B, ey[0])]),
           "gz": _assemble(mz, p, [(K, ez[1]), (B, ez[2])])}
    if kind == "stiffness":
        got.update(ax=_assemble(mx, p, [(K, ex[1])]), ay=_assemble(my, p, [(K, ey[1])]),
                   mz=_assemble(mz, p, [(B, ez[0])]))
    assert set(got) == set(bd.KINDS[kind])
    for k, g in got.items():
        want = getattr(tabs, k).numpy()
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-14 * np.abs(want).max())
    np.testing.assert_allclose(ex[2, 1:] * ex[0, 1:], ex[0, :-1], rtol=1e-14)
    np.testing.assert_allclose(ex[3, 1:] * ex[1, 1:], ex[1, :-1], rtol=1e-14)
    assert ex[2, 0] == ex[3, 0] == 0.0
    fresh = bd.element_tables_np(_mesh(pt, n_el, graded), pt.Basis1D.make(p, p + 2, "gauss"), kind, c)
    np.testing.assert_array_equal(ex[:2], s * fresh["ex"][:2])
    np.testing.assert_array_equal(ex[2:], fresh["ex"][2:])


def test_band_only_tables_run_the_plain_version_on_cpu():
    """Tables from band tables alone (no element form) still apply on a CPU
    tensor, through the plain version."""
    space, own = _port(1)
    tabs = bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu")
    assert tabs.B_host is None and tabs.ex is None and not tabs.symmetric
    u = torch.as_tensor(_random(space.grid_shape, seed=9))
    full = bd.BandedTables.create(space.mesh, space.basis, torch.float64, "cpu", "stiffness", 2.5)
    assert torch.equal(bd.banded_apply(u, tabs), bd.banded_apply_reference(u, tabs))
    assert torch.equal(bd.banded_apply(u, tabs), bd.banded_apply(u, full))


def test_cuda_launch_refuses_band_only_or_asymmetric_tables():
    """The host checks of the CUDA launch (kernel_args, made before any
    launch): band tables alone and element matrices of an asymmetric rule
    raise; symmetric tables give the five addresses the launcher takes.
    Element factors of the wrong shape are refused when the tables are
    made."""
    space, own = _port(0)
    with pytest.raises(ValueError, match="element form"):
        bd.kernel_args(bd.BandedTables.from_numpy(own, space.degree, torch.float64, device="cpu"))
    tabs = bd.BandedTables.create(space.mesh, space.basis, torch.float64, "cpu")
    args = bd.kernel_args(tabs)
    assert len(args) == 5 and all(isinstance(a, int) and a for a in args)
    w = space.basis.q_weights.copy()
    w[0] *= 1.01
    skew = dataclasses.replace(space.basis, q_weights=w)  # a rule that is not symmetric
    asym = bd.BandedTables.create(space.mesh, skew, torch.float64, "cpu")
    assert not asym.symmetric
    with pytest.raises(ValueError, match="symmetric"):
        bd.kernel_args(asym)
    u = torch.as_tensor(_random(space.grid_shape, seed=3))
    assert torch.equal(bd.banded_apply(u, asym), bd.banded_apply_reference(u, asym))  # the CPU still runs it
    good = bd.BandedTables.create(space.mesh, space.basis, torch.float64, "cpu")
    with pytest.raises(ValueError, match="ez"):
        dataclasses.replace(good, ez=good.ez[:2])


@pytest.mark.parametrize("field", ["ex", "ey", "ez", "B_host", "K_host"])
def test_tables_check_both_forms_when_made(field):
    """Each part of the element form is checked once, when the tables are
    made: a part of the wrong shape, type or layout, or one part missing,
    is refused there (the launch then checks only u and out)."""
    space, own = _port(0)
    good = bd.BandedTables.create(space.mesh, space.basis, torch.float64, "cpu")
    t = getattr(good, field)
    host = field.endswith("host")
    with pytest.raises(ValueError, match="element matrices" if host else field):
        dataclasses.replace(good, **{field: t[:-1]})
    if not host:
        for wrong in (t.float(), t.t().contiguous().t()):  # type, layout
            with pytest.raises(ValueError, match=field):
                dataclasses.replace(good, **{field: wrong})
    with pytest.raises(ValueError, match="all of"):
        dataclasses.replace(good, **{field: None})
    with pytest.raises(ValueError, match="table my"):
        dataclasses.replace(good, my=good.my[:, :-1])


@pytest.mark.parametrize("p", range(1, 9))
def test_every_rule_the_kernel_is_built_for_is_symmetric(p):
    """The kernel's even-odd sweeps need centrosymmetric B and K: Gauss at q
    = p+1..p+3 and GLL give them."""
    for name, q in (("gauss", p + 1), ("gauss", p + 2), ("gauss", p + 3), ("gauss_lobatto", p + 1)):
        tabs = bd.BandedTables.create(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(p, q, name), torch.float64, "cpu")
        assert tabs.symmetric, (name, q)


@pytest.mark.parametrize("name", ["bp1", "bp3"])
def test_library_call_is_the_same_operator(name):
    """bench_k2's yardstick, torch.matmul(U, M_loc or A_loc) on the gathered
    element vectors, overlap-added, is the plain K2 on the free rows."""
    from deal_and_ceed_on_gpu_torch.ops.local_global import gather_elements, scatter_elements
    from deal_and_ceed_on_gpu_torch.scripts import bench_k2

    mesh, basis = pt.BrickMesh((3, 2, 4)), pt.Basis1D.make(5, 7, "gauss")
    library = bench_k2._library(name, mesh, basis, torch.float64, "cpu")
    tabs = bd.BandedTables.create(mesh, basis, torch.float64, "cpu", "mass" if name == "bp1" else "stiffness")
    u = torch.as_tensor(_random(tabs.shape, seed=5))
    face = face_mask(tabs.shape, "cpu")
    U = gather_elements(torch.where(face, torch.zeros_like(u), u), mesh.n_elements, 5)
    got = scatter_elements(library(U), mesh.n_elements, 5).reshape(tabs.shape)
    want = bd.banded_apply_reference(u, tabs)
    assert float((got[~face] - want[~face]).abs().max()) <= 1e-13 * float(want.abs().max())


def test_bench_k2_needs_a_card_and_known_shapes(monkeypatch):
    from deal_and_ceed_on_gpu_torch.scripts import bench_k2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench_k2.main()
    with pytest.raises(ValueError, match="unknown shape"):
        next(bench_k2.k2_shapes(["bp7"], device="cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


# the card's cases: CASES, then every p on a brick that is not a multiple of
# K2's tile (graded, with value_const) and one element, stiffness and mass
CARD_CASES = CASES + [((bd.kernel_tile(p) + 1, 2 * bd.kernel_tile(p) + 1, 3), p, p + 2, True, kind, 1.5)
                      for p in range(1, 9) for kind in ("stiffness", "mass")] + [
    ((1, 1, 1), p, p + 2, False, kind, None) for p in (2, 5, 8) for kind in ("stiffness", "mass")]


def _card_tables(case, compute, device):
    n_el, p, q, graded, kind, c = case
    return bd.BandedTables.create(_mesh(pt, n_el, graded), pt.Basis1D.make(p, q, "gauss"), compute, device, kind, c)


def _card_check(tables, u, tol, device):
    """One launch into a NaN-filled output against the plain version: every
    entry written and finite, tol of max|out|, the faces bitwise."""
    before = bd.LAUNCHES
    got = bd.banded_apply(u, tables, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    assert bd.LAUNCHES == before + 1
    want = bd.banded_apply_reference(u, tables)
    assert torch.isfinite(got).all()
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert float(err) <= tol
    face = face_mask(tables.shape, device).expand(u.shape)
    assert torch.equal(got[face], u[face])
    return got


PRECISIONS = [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(CARD_CASES)))
@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("storage,compute,tol", PRECISIONS)
def test_kernel_matches_plain_on_card(cuda_device, i, nc, storage, compute, tol):
    tables = _card_tables(CARD_CASES[i], compute, cuda_device)
    shape = tables.shape if nc == 1 else (nc, *tables.shape)
    _card_check(tables, torch.as_tensor(_random(shape, seed=i), device=cuda_device).to(storage), tol, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("storage,compute,tol", PRECISIONS)
def test_scale_on_card(cuda_device, storage, compute, tol):
    """scale_ reaches the element form the kernel reads: the scaled tables
    against their (scaled) plain version, and against twice the unscaled
    apply on the free rows."""
    tables = _card_tables(CASES[1], compute, cuda_device)
    u = torch.as_tensor(_random(tables.shape, seed=11), device=cuda_device).to(storage)
    before = bd.banded_apply(u, tables).double()
    tables.scale_(2.0)
    after = _card_check(tables, u, tol, cuda_device).double()
    free = ~face_mask(tables.shape, cuda_device)
    assert float((after[free] - 2 * before[free]).abs().max()) <= 2 * tol * float(after.abs().max())


@pytest.mark.cuda
def test_kernel_tile_is_the_librarys(cuda_device):
    """kernel_tile (the CPU's restatement, which sizes the tile-edge bricks
    above) equals the width the library was built with, at every p."""
    assert [bd.library_tile(p) for p in range(1, 9)] == [bd.kernel_tile(p) for p in range(1, 9)]
    assert bd.library_tile(0) == bd.library_tile(9) == 0


@pytest.mark.cuda
def test_kernel_refuses_asymmetric_tables_on_card(cuda_device):
    space, _ = _port(0)
    w = space.basis.q_weights.copy()
    w[0] *= 1.01
    tables = bd.BandedTables.create(space.mesh, dataclasses.replace(space.basis, q_weights=w), torch.float64,
                                    cuda_device)
    before = bd.LAUNCHES
    with pytest.raises(ValueError, match="symmetric"):
        bd.banded_apply(torch.zeros(tables.shape, dtype=torch.float64, device=cuda_device), tables)
    assert bd.LAUNCHES == before
