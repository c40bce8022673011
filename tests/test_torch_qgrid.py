"""K3 (ops/qgrid.py): the plain version against the JAX Pallas q-grid kernel
in interpret mode on every case of tests/test_pallas_qgrid.py (tables
carried across with qgrid_tables_from_jax, so the graded diag3 and mapped
full6 streams are covered without the port's mapped geometry), the port's
own host tables, fold_scale, the wrapper's checks, and the CUDA kernel
against its plain version on a card (skipped without one)."""

import functools

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import qgrid as qg
from deal_and_ceed_on_gpu_torch.utils.convert import qgrid_tables_from_jax

try:
    import jax.numpy as jnp
    from test_pallas_qgrid import CASES, _make

    from deal_and_ceed_on_gpu_tpu import FESpace
    from deal_and_ceed_on_gpu_tpu.ops.pallas_qgrid import build_qgrid_operator
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    CASES = []

TOL = 1e-12  # f64, relative to max|want|


def _a_fn(x):
    return 3.0 + x[..., 0] + 0.5 * x[..., 1] * x[..., 2]


def _specs(geo, grad, val):
    """The term specs tests/test_pallas_qgrid.py builds for a case (``geo``:
    either package's geometry; the port's has bricks only)."""
    w3 = np.asarray(geo.w3d).reshape(-1)
    gspec = vspec = None
    if grad:
        if geo.uniform:
            gspec = ("const", geo.const_merged_diag)
        elif not getattr(geo, "mapped", False):
            gspec = ("diag3", geo.merged_coef_full()[:, :, (0, 3, 5)] / w3[None, :, None])
        else:
            gspec = ("full6", geo.merged_coef_full() / w3[None, :, None])
    if val == "table":
        vspec = ("table", np.asarray(_a_fn(geo.q_points_phys())) * geo.det_q_full())
    elif val == "dettab":
        vspec = ("table", 2.0 * geo.det_q_full())
    elif val == "const":
        vspec = ("const", 2.0 * geo.det_j)
    return gspec, vspec


@functools.cache
def _jax_case(i):
    kind, shape, p, qoff, grad, val = CASES[i]
    mesh = _make(kind, shape)
    space = FESpace.create(mesh, p, n_q=p + 1 + qoff, rule="gauss", dtype=jnp.float64)
    gspec, vspec = _specs(space.geometry, grad, val)
    qop = build_qgrid_operator(mesh, space.basis, jnp.float64, grad=gspec, val=vspec, interpret=True)
    return space, qop


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{c[0]}-{c[1]}-p{c[2]}-q{c[2] + 1 + c[3]}" for c in CASES])
def test_reference_matches_jax_interpret(case, constrained):
    space, qop = _jax_case(case)
    L = qop.layout
    tables = qg.QGridTables.from_numpy(qgrid_tables_from_jax(L), torch.float64, device="cpu")
    assert tables.shape == L.real_shape
    u = np.random.default_rng(case).standard_normal(space.n_dofs)
    up = L.pad_flat(jnp.asarray(u))
    want = np.asarray(L.unpad_flat(qop.constrained_call(up) if constrained else qop(up)))
    ut = torch.as_tensor(u).reshape(tables.shape)
    got = qg.qgrid_apply_reference(ut, tables, constrained).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(qg.qgrid_apply(ut, tables, constrained).reshape(-1).numpy(), got)


@pytest.mark.parametrize("case", [i for i, c in enumerate(CASES) if c[0] == "uniform"])
def test_port_tables_equal_converted_jax_tables(case):
    """On uniform bricks the port builds K3's tables from its own geometry,
    equal to the JAX layout's tables cut to the real q grid."""
    kind, shape, p, qoff, grad, val = CASES[case]
    _, qop = _jax_case(case)
    want = qgrid_tables_from_jax(qop.layout)
    mesh = pt.BrickMesh(shape, upper=(1.0, 0.9, 1.2))
    space = pt.FESpace.create(mesh, p, n_q=p + 1 + qoff, rule="gauss", dtype=torch.float64, device="cpu")
    got = qg.qgrid_tables_np(mesh, space.basis, *_specs(space.geometry, grad, val))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, rtol=1e-15, atol=0)
        else:
            assert got[k] == v, k


def _tables(shape=(2, 3, 4), p=2, qoff=1, grad="const", val="table", dtype=torch.float64, device="cpu"):
    mesh = pt.BrickMesh(shape, upper=(1.0, 0.9, 1.2))
    basis = pt.Basis1D.make(p, p + 1 + qoff, "gauss")
    gspec, vspec = _specs(pt.Geometry.from_mesh(mesh, basis), grad, val)
    return qg.QGridTables.create(mesh, basis, dtype, grad=gspec, val=vspec, device=device)


def test_fold_scale_scales_the_streamed_tables():
    t = _tables()
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(t.shape))
    before = qg.qgrid_apply(u, t)
    a_q = t.a_q
    t.fold_scale(2.5)
    assert t.a_q is a_q  # scaled in place: the tensor the kernel reads
    np.testing.assert_allclose(qg.qgrid_apply(u, t).numpy(), 2.5 * before.numpy(), rtol=1e-13, atol=1e-13)
    after = qg.qgrid_apply(u, t, constrained=True)
    face = qg._face_mask(t.shape, u.device)
    assert torch.equal(after[face], u[face])


def test_cpu_apply_counts_no_launch():
    t = _tables()
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(t.shape))
    before = qg.LAUNCHES
    qg.qgrid_apply(u, t, constrained=True)
    assert qg.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    t = _tables()
    u = torch.zeros(t.shape, dtype=torch.float64)
    with pytest.raises(TypeError):
        qg.qgrid_apply(u.float(), t)  # f32 vector, f64 tables
    with pytest.raises(TypeError):
        qg.qgrid_apply(u.to(torch.bfloat16), t)
    with pytest.raises(ValueError):
        qg.qgrid_apply(u.reshape(-1), t)
    with pytest.raises(ValueError):
        qg.qgrid_apply(u.transpose(0, 2).contiguous(), t)
    with pytest.raises(ValueError):
        qg.qgrid_apply(torch.zeros(t.shape[:2] + (2 * t.shape[2],), dtype=torch.float64)[:, :, ::2], t)
    t.a_q = t.a_q[:, :, :-1]
    with pytest.raises(ValueError):
        qg.qgrid_apply(u, t)


def test_tables_reject_unsupported_configurations():
    basis = pt.Basis1D.make(3, 4, "gauss")
    graded = pt.BrickMesh.graded([0, 0.3, 1], [0, 1], [0, 1])
    with pytest.raises(ValueError):
        qg.qgrid_tables_np(graded, basis, grad=("const", (1.0, 1.0, 1.0)))
    with pytest.raises(ValueError):
        qg.qgrid_tables_np(graded, basis, val=("const", 1.0))
    with pytest.raises(ValueError):
        qg.qgrid_tables_np(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(3, 7, "gauss"), grad=("const", (1.0, 1.0, 1.0)))
    with pytest.raises(ValueError):
        qg.qgrid_tables_np(pt.BrickMesh((2, 2, 2)), basis)  # neither term
    with pytest.raises(ValueError):
        qg.qgrid_tables_np(pt.BrickMesh((2, 2, 2)), basis, grad=("full9", None))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


MODES = [(g, v) for g in (None, "const", "diag3", "full6") for v in (None, "const", "table") if g or v]
# bricks (mx, my, mz): tiles of unequal widths (9 and 11 exceed every tile
# width), mx and my below the tile width, and a 1-element brick
CARD_SHAPES = ((9, 4, 3), (2, 11, 5), (1, 1, 1))


def _random_tables(shape, p, q, grad, val, dtype, device, seed):
    """Tables with random positive diag3/full6/value streams (full6
    diagonally dominant) and const terms from the geometry."""
    rng = np.random.default_rng(seed)
    mesh = pt.BrickMesh(shape, upper=(1.0, 0.9, 1.2))
    basis = pt.Basis1D.make(p, q, "gauss")
    geo = pt.Geometry.from_mesh(mesh, basis)
    cells = (mesh.n_cells, q**3)
    gspec = vspec = None
    if grad == "const":
        gspec = ("const", geo.const_merged_diag)
    elif grad == "diag3":
        gspec = ("diag3", 0.5 + rng.random(cells + (3,)))
    elif grad == "full6":
        c = 0.2 * rng.random(cells + (6,))
        c[..., (0, 3, 5)] += 1.0
        gspec = ("full6", c)
    if val == "const":
        vspec = ("const", 2.0 * geo.det_j)
    elif val == "table":
        vspec = ("table", (0.5 + rng.random(cells)) * geo.det_q_full())
    return qg.QGridTables.create(mesh, basis, dtype, grad=gspec, val=vspec, device=device)


def test_out_buffer_receives_the_result():
    t = _tables()
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(t.shape))
    out = torch.full_like(u, float("nan"))
    got = qg.qgrid_apply(u, t, constrained=True, out=out)
    assert got is out
    assert torch.equal(out, qg.qgrid_apply_reference(u, t, constrained=True))
    with pytest.raises(ValueError):
        qg.qgrid_apply(u, t, out=torch.empty(t.shape, dtype=torch.float32))
    with pytest.raises(ValueError):
        qg.qgrid_apply(u, t, out=torch.empty(t.shape[::-1], dtype=torch.float64))


@pytest.mark.parametrize("p", range(1, qg.MAX_DEGREE + 1))
def test_every_rule_the_kernel_is_built_for_is_symmetric(p):
    """The CUDA kernel's even-odd sweeps need S[q-1-a, p-i] = S[a, i] and
    D[q-1-a, p-i] = -D[a, i]: every Gauss rule it is built for."""
    for qoff in qg.Q_OFFSETS:
        t = qg.QGridTables.create(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(p, p + qoff, "gauss"), torch.float64,
                                  val=("const", 1.0), device="cpu")
        assert t.symmetric, qoff


def test_asymmetric_tables_are_flagged_and_run_plain_on_cpu():
    t = _tables()
    t.D_host = t.D_host.copy()
    t.D_host[0, 1] += 1e-3
    assert not t.symmetric
    u = torch.as_tensor(np.random.default_rng(6).standard_normal(t.shape))
    assert torch.equal(qg.qgrid_apply(u, t), qg.qgrid_apply_reference(u, t))


def test_plain_version_reads_the_host_tables_rounded_to_its_dtype():
    """The 1D tables live in host memory only; the plain version's dense
    matrices are built from them, rounded to the compute type as the kernel
    rounds them."""
    t = _tables(dtype=torch.float32)
    assert isinstance(t.S_host, np.ndarray) and t.S_host.dtype == np.float64
    m = t.axis_matrix(2, "SW")
    assert m.dtype == torch.float32
    q, p1 = t.S_host.shape
    S = torch.as_tensor(t.S_host).float().double().numpy()
    w = torch.as_tensor(t.w_host).float().double().numpy()
    np.testing.assert_array_equal(m[:q, :p1].double().numpy(), torch.as_tensor(S * w[:, None]).float().double().numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("p,qoff", [(p, qoff) for p in range(1, qg.MAX_DEGREE + 1) for qoff in qg.Q_OFFSETS])
def test_kernel_matches_reference_on_card(cuda_device, p, qoff, dtype, tol):
    """Every grad x val mode, raw and constrained, on CARD_SHAPES, from a
    NaN-filled output: relative error to the plain version, identity faces
    bitwise, one launch a call."""
    for shape in CARD_SHAPES:
        for i, (grad, val) in enumerate(MODES):
            t = _random_tables(shape, p, p + qoff, grad, val, dtype, cuda_device, seed=i)
            u = torch.as_tensor(np.random.default_rng(p + i).standard_normal(t.shape), dtype=dtype, device=cuda_device)
            for constrained in (False, True):
                before = qg.LAUNCHES
                got = qg.qgrid_apply(u, t, constrained, out=torch.full_like(u, float("nan")))
                torch.cuda.synchronize()
                assert qg.LAUNCHES == before + 1
                want = qg.qgrid_apply_reference(u, t, constrained)
                assert bool(torch.isfinite(got).all()), (shape, grad, val, constrained)
                assert float((got - want).abs().max() / want.abs().max()) <= tol, (shape, grad, val, constrained)
                if constrained:
                    face = qg._face_mask(t.shape, u.device)
                    assert torch.equal(got[face], u[face])


@pytest.mark.cuda
def test_kernel_refuses_asymmetric_tables_on_card(cuda_device):
    t = _tables(device=cuda_device)
    t.S_host = t.S_host.copy()
    t.S_host[1, 0] += 1e-3
    with pytest.raises(ValueError, match="symmetric"):
        qg.qgrid_apply(torch.zeros(t.shape, dtype=torch.float64, device=cuda_device), t)
