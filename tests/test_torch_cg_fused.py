"""K5 (ops/cg.py) and solve_cg_fused: the plain version on the CPU against
the JAX CGFusedStep and solve_cg_fused in interpret mode (the cases of
tests/test_cg_fused.py, f32 and bf16 streaming as the TPU kernel has them),
port-only f64 checks against the port's merged solver, and the CUDA kernels
against their plain versions on a card (skipped without one)."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import assemble_rhs
from deal_and_ceed_on_gpu_torch.ops import cg, copy
from deal_and_ceed_on_gpu_torch.ops.stencil import StencilTables
from deal_and_ceed_on_gpu_torch.utils.convert import cg_state_from_jax

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

OPTS = dict(interpret=True, block_z=8, block_y=16)  # as tests/test_cg_fused.py
OPS = {"poisson": (PoissonJ, pt.PoissonOperator), "helmholtz": (HelmholtzJ, pt.HelmholtzOperator)} if jnp else {}


def _setup(kind="poisson", shape=(6, 5, 7), p=3, stream=None, seed=0):
    """The same operator in both packages (f32 compute, JAX interpret
    mode) and the same random right-hand side: JAX padded, port flat."""
    jcls, tcls = OPS[kind]
    js = jx.FESpace.create(jx.BrickMesh(shape), p, rule="gauss_lobatto", dtype=jnp.float32)
    opts = dict(OPTS, stream_dtype=stream) if stream else OPTS
    jop = jcls(js, backend="pallas", pallas_opts=opts)
    ts = pt.FESpace.create(pt.BrickMesh(shape), p, rule="gauss_lobatto", dtype=torch.float32, device="cpu")
    sd = getattr(torch, stream) if stream else None
    top = tcls(ts, backend="stencil", stream_dtype=sd)
    b = np.random.default_rng(seed).standard_normal(ts.n_dofs).astype(np.float32)
    jb = jop.layout.pad_flat(jnp.asarray(b))
    tb = torch.as_tensor(b).to(top.stream_dtype)
    return jop, jb, top, tb


def _x_err(x_t, jop, x_j):
    """|x_port - x_jax| / |x_jax| in f64, the JAX solution unpadded."""
    want = np.asarray(jop.layout.unpad_flat(x_j), dtype=np.float64)
    return np.linalg.norm(x_t.double().numpy() - want) / np.linalg.norm(want)


# degree -> brick of test_step_matches_jax: p = 3 is tests/test_cg_fused.py's
# case, the others reach the lowest, the main and the highest degree
STEP_BRICKS = {1: (5, 4, 6), 3: (6, 5, 7), 5: (3, 2, 3), 8: (2, 2, 2)}
MID = (0.7, 0.4, 1.75)  # a mid-solve step from a random state


@pytest.mark.parametrize("kind", ["poisson", "helmholtz"])
@pytest.mark.parametrize("stream,scal,p", [
    pytest.param(None, (0.0, 0.0, 0.0), 3, id="None-scal0"),  # the alpha = beta = 0 step of test_step_matches_constrained_vmult
    pytest.param(None, MID, 3, id="None-scal1"),
    pytest.param("bfloat16", MID, 3, id="bfloat16-scal2"),  # bf16 storage: the rounding order of pallas_cg.py
] + [pytest.param(stream, MID, p, id=f"{stream}-p{p}") for p in (1, 5, 8) for stream in (None, "bfloat16")])
def test_step_matches_jax(kind, stream, scal, p):
    jop, jb, top, tb = _setup(kind, STEP_BRICKS[p], p, stream=stream)
    jstep, tstep = jop.fused_cg_step, top.fused_cg_step
    L = jop.layout
    rng = np.random.default_rng(1)
    if scal == (0.0, 0.0, 0.0):
        vecs = [np.zeros(tb.numel()), -tb.float().numpy(), np.zeros(tb.numel()), np.zeros(tb.numel())]
    else:
        vecs = [rng.standard_normal(tb.numel()) for _ in range(4)]
    js = jstep.stack_state(*(L.pad_flat(jnp.asarray(v, jnp.float32)) for v in vecs))
    js2, jdots = jstep(js, jnp.zeros_like(js), jnp.asarray(scal, jnp.float32))
    ts = tstep.stack_state(*(torch.as_tensor(v, dtype=torch.float32).to(tb.dtype) for v in vecs))
    ts2, tdots = tstep(ts, torch.full_like(ts, float("nan")), torch.tensor(scal, dtype=torch.float32))
    want = cg_state_from_jax(np.asarray(js2, dtype=np.float32), L.p, L.real_shape)
    got = ts2.float().numpy()
    assert np.isfinite(got).all()  # every point written: the NaN-filled buffer is gone
    # bf16: XLA contracts g + alpha h into an FMA, so d' rounds one bf16 ulp
    # apart at ~0.4 % of the points (measured), and the dots move by ~1e-5
    tol, dot_tol = (3e-2, 1e-4) if stream else (1e-6, 1e-5)
    for k in range(4):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * np.abs(want[k]).max())
    np.testing.assert_allclose(tdots.numpy(), np.asarray(jnp.sum(jdots[:4], axis=1)), rtol=dot_tol)


@pytest.mark.parametrize("kind,shape,p,n_it,x0", [
    ("poisson", (6, 5, 7), 3, 30, None),     # test_solver_matches_xla_merged
    ("poisson", (4, 4, 4), 2, 25, 0.3),      # test_solver_x0
    ("helmholtz", (5, 4, 6), 3, 25, None),   # test_solver_helmholtz_value_term
])
def test_solver_matches_jax(kind, shape, p, n_it, x0):
    jop, jb, top, tb = _setup(kind, shape, p)
    ctrl_j, ctrl_t = jx.IterationNumberControl(n_it, 0.0), pt.IterationNumberControl(n_it, 0.0)
    xj, ij = jx.solve_cg_fused(jop, jb, ctrl_j, x0=None if x0 is None else x0 * jb)
    xt, it = pt.solve_cg_fused(top, tb, ctrl_t, x0=None if x0 is None else x0 * tb)
    assert it["n_iterations"] == int(ij["n_iterations"]) == n_it
    np.testing.assert_allclose(float(it["res_norm"]), float(ij["res_norm"]), rtol=1e-5)
    assert _x_err(xt, jop, xj) < 1e-5


def test_solver_reduction_control_matches_jax():
    """Tolerance stopping: the JAX fused solver's iteration count (+-1) and
    a true residual below 2e-6."""
    jop, jb, top, tb = _setup(shape=(4, 4, 4), p=2)
    xj, ij = jx.solve_cg_fused(jop, jb, jx.ReductionControl(200, 0.0, 1e-6))
    xt, it = pt.solve_cg_fused(top, tb, pt.ReductionControl(200, 0.0, 1e-6))
    assert abs(it["n_iterations"] - int(ij["n_iterations"])) <= 1
    rel = float(torch.linalg.vector_norm(top.vmult(xt) - tb) / torch.linalg.vector_norm(tb))
    assert rel < 2e-6


def test_solver_bf16_stream_matches_jax():
    """bf16 state: the trajectories drift with the rounding; the solution
    agrees with the JAX fused solve and the port's merged solve loosely."""
    jop, jb, top, tb = _setup(stream="bfloat16")
    assert tb.dtype == torch.bfloat16
    xj, _ = jx.solve_cg_fused(jop, jb, jx.IterationNumberControl(20, 0.0))
    xt, _ = pt.solve_cg_fused(top, tb, pt.IterationNumberControl(20, 0.0))
    assert xt.dtype == torch.bfloat16
    assert _x_err(xt, jop, xj.astype(jnp.float32)) < 0.05
    xm, _ = pt.solve_cg_merged(top.vmult, tb, pt.IterationNumberControl(20, 0.0), dot_dtype=torch.float32)
    assert float(torch.linalg.vector_norm((xt - xm).float()) / torch.linalg.vector_norm(xm.float())) < 0.05


def test_fold_scale_rebuilds_step():
    jop, _, top, _ = _setup(shape=(4, 4, 4), p=2)
    # zero Dirichlet rows: the iterates are then exactly scale-equivariant
    b0 = np.random.default_rng(1).standard_normal(top.space.n_dofs).astype(np.float32)
    b0[top.space.mesh.boundary_dof_mask(2)] = 0.0
    tb = torch.as_tensor(b0)
    ctrl = pt.IterationNumberControl(10, 0.0)
    step0 = top.fused_cg_step
    x1, _ = pt.solve_cg_fused(top, tb, ctrl)
    xj, _ = jx.solve_cg_fused(jop, jop.layout.pad_flat(jnp.asarray(b0)), jx.IterationNumberControl(10, 0.0))
    assert _x_err(x1, jop, xj) < 1e-5
    top.fold_scale(2.0)
    assert top.fused_cg_step is not step0
    x2, _ = pt.solve_cg_fused(top, tb, ctrl)
    np.testing.assert_allclose(x2.numpy(), x1.numpy() / 2.0, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["poisson", "helmholtz"])
def test_f64_matches_merged(kind):
    """f64, which the TPU kernel lacks: the same iterations as the port's
    merged CG and the same solution to 1e-12, from x = 0 and from an x0."""
    ts = pt.FESpace.create(pt.BrickMesh((6, 5, 7)), 3, dtype=torch.float64, device="cpu")
    op = {"poisson": pt.PoissonOperator, "helmholtz": pt.HelmholtzOperator}[kind](ts, backend="stencil")
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(ts.n_dofs))
    ctrl = pt.SolverControl(1000, 1e-10 * float(torch.linalg.vector_norm(b)))
    for x0 in (None, 0.3 * b):
        xm, im = pt.solve_cg_merged(op.vmult, b, ctrl, x0=x0)
        xf, i_f = pt.solve_cg_fused(op, b, ctrl, x0=x0)
        assert i_f["n_iterations"] == im["n_iterations"] > 50
        assert float(torch.linalg.vector_norm(xf - xm) / torch.linalg.vector_norm(xm)) < 1e-12
        ctrl.check(i_f)


def test_write_buffer_contents_are_ignored():
    """Every real point is written on every call: a NaN-filled write buffer
    gives the result of a zero-filled one; the buffers may not overlap."""
    ts = pt.FESpace.create(pt.BrickMesh((3, 2, 4)), 4, dtype=torch.float64, device="cpu")
    step = pt.HelmholtzOperator(ts, backend="stencil").fused_cg_step
    s = torch.as_tensor(np.random.default_rng(2).standard_normal((4, *ts.grid_shape)))
    scal = torch.tensor([0.3, 0.6, 0.5], dtype=torch.float64)
    a, da = step.iterate(s, torch.full_like(s, float("nan")), scal)
    b, db = step.iterate(s, torch.zeros_like(s), scal)
    assert torch.equal(a, b) and torch.equal(da, db) and torch.isfinite(a).all()
    want, wdots = cg.cg_step_reference(s, scal, step.tables)
    assert torch.equal(a, want) and torch.equal(da, cg.cg_next_scalars(wdots))
    with pytest.raises(ValueError, match="overlaps"):
        step(s, s, scal)
    with pytest.raises(ValueError):
        step(s, torch.empty_like(s), scal.float())  # scalars at the compute dtype
    with pytest.raises(TypeError):
        step(s.float(), torch.empty_like(s.float()), scal)  # f32 state with f64 tables


def test_next_scalars_safe_divides():
    """The finishing pass's plain version: the JAX solver's scalars, 0
    where a divisor is 0."""
    dots = torch.tensor([2.0, 3.0, -1.0, 4.0], dtype=torch.float64)  # d.h, h.h, g.h, g.g
    dh, hh, gh, gg = dots.tolist()
    alpha = gg / dh
    beta = alpha * (gh + alpha * hh) / gg
    want = [dh, hh, gh, gg, alpha, beta, alpha / beta, np.sqrt(gg + 2 * alpha * gh + alpha * alpha * hh)]
    np.testing.assert_allclose(cg.cg_next_scalars(dots).numpy(), want, rtol=1e-15)
    assert cg.cg_next_scalars(torch.zeros(4, dtype=torch.float64)).tolist() == [0.0] * 8


def test_cpu_step_counts_no_launch():
    ts = pt.FESpace.create(pt.BrickMesh((2, 2, 2)), 2, dtype=torch.float32, device="cpu")
    op = pt.PoissonOperator(ts, backend="stencil")
    b = torch.ones(ts.n_dofs)
    before = cg.LAUNCHES
    pt.solve_cg_fused(op, b, pt.IterationNumberControl(3, 0.0))
    assert cg.LAUNCHES == before
    with pytest.raises(NotImplementedError, match="stencil"):
        pt.PoissonOperator(ts, backend="separable").fused_cg_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 and K6 are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("value", [False, True])
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("storage,compute,tol", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_k5_matches_plain_on_card(cuda_device, p, value, storage, compute, tol):
    """From a NaN-filled write buffer (every entry written), on bricks whose
    grids are not a multiple of K5's tile in x, y or z and on one element:
    d', g', x' bitwise, h' and the next scalars within the tolerance."""
    for n_el in ((-(-40 // p), -(-36 // p), 3), (1, 1, 1), (4, 3, 6)):
        mesh = pt.BrickMesh(n_el, upper=(1.0, 0.8, 1.3))
        grid = tuple(m * p + 1 for m in reversed(mesh.n_elements))
        rng = np.random.default_rng(p)
        tables = StencilTables.create(
            mesh, pt.Basis1D.make(p), compute, cuda_device, value=0.5 + rng.random(grid) if value else None
        )
        step = cg.CGFusedStep(tables)
        s = torch.as_tensor(rng.standard_normal((4, *grid)), dtype=compute, device=cuda_device).to(storage)
        scal = torch.tensor([0.7, 0.4, 1.75], dtype=compute, device=cuda_device)
        before = cg.LAUNCHES
        got, summary = step.iterate(s, torch.full_like(s, float("nan")), scal)
        torch.cuda.synchronize()
        assert cg.LAUNCHES == before + 1
        want, wdots = cg.cg_step_reference(s, scal, tables)
        assert torch.isfinite(got).all(), n_el
        for k in (cg.D, cg.G, cg.X):
            assert torch.equal(got[k], want[k]), (n_el, k)
        err = (got[cg.H].double() - want[cg.H].double()).abs().max() / want[cg.H].double().abs().max()
        assert float(err) <= tol, n_el
        np.testing.assert_allclose(summary.cpu().double().numpy(), cg.cg_next_scalars(wdots).cpu().double().numpy(),
                                   rtol=1e-10 if compute == torch.float64 else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", range(copy.MAX_HALO + 1))
def test_k6_matches_plain_on_card(cuda_device, dtype, halo):
    """Bitwise from a NaN-filled output: several tiles, an odd nx, ny below
    one tile and nz below one z range, one point."""
    for shape in ((21, 37, 70), (5, 9, 481), (3, 40, 33), (1, 1, 1)):
        src = torch.as_tensor(np.random.default_rng(halo).standard_normal(shape), device=cuda_device).to(dtype)
        before = copy.LAUNCHES
        got = copy.copy_probe(src, halo, out=torch.full_like(src, float("nan")))
        torch.cuda.synchronize()
        assert copy.LAUNCHES == before + 1
        assert torch.equal(got, copy.copy_reference(src)), shape


@pytest.mark.cuda
def test_fused_solver_matches_merged_on_card(cuda_device):
    ts = pt.FESpace.create(pt.BrickMesh.bp5_cycle(10), 5, dtype=torch.float64, device=cuda_device)
    op = pt.PoissonOperator(ts, backend="stencil")
    b = assemble_rhs(ts, 1.0)
    ctrl = pt.SolverControl(1000, 1e-12 * float(torch.linalg.vector_norm(b)))
    xm, im = pt.solve_cg_merged(op.vmult, b, ctrl)
    xf, i_f = pt.solve_cg_fused(op, b, ctrl)
    assert abs(i_f["n_iterations"] - im["n_iterations"]) <= 1
    assert float(torch.linalg.vector_norm(xf - xm) / torch.linalg.vector_norm(xm)) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_k6_on_unaligned_views_on_card(cuda_device, dtype):
    """src and dst views that start off a 16-byte boundary, alike or not:
    bitwise, and nothing written outside dst."""
    shape, n = (21, 37, 70), 21 * 37 * 70
    for so, do in ((1, 0), (0, 1), (1, 1), (3, 0)):
        base = torch.as_tensor(np.random.default_rng(so).standard_normal(n + 8), device=cuda_device).to(dtype)
        buf = torch.full((n + 8,), float("nan"), dtype=dtype, device=cuda_device)
        src, dst = base[so : so + n].view(shape), buf[do : do + n].view(shape)
        for halo in (0, 5, 8):
            copy.copy_probe(src, halo, out=dst)
            torch.cuda.synchronize()
            assert torch.equal(dst, copy.copy_reference(src)), (so, do, halo)
            assert bool(torch.isnan(buf[:do]).all() and torch.isnan(buf[do + n :]).all())


def test_build_hash_covers_the_headers(tmp_path):
    """An edited header beside a source gives its library a new name, so a
    stale build is never reused (K3 and K4 share csrc/sweeps.cuh)."""
    from deal_and_ceed_on_gpu_torch.utils.cuda_build import source_digest

    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = source_digest(src)
    assert source_digest(src) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert source_digest(src) != first
    assert (copy.SOURCE.parent / "sweeps.cuh").exists()


def test_copy_probe_plain_on_cpu():
    src = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 4, 5)))
    before = copy.LAUNCHES
    assert torch.equal(copy.copy_probe(src, 5), 2 * src)
    assert copy.LAUNCHES == before
    with pytest.raises(ValueError):
        copy.copy_probe(src, 9)
    with pytest.raises(ValueError):
        copy.copy_probe(src.reshape(-1), 2)
