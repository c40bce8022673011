"""The fast-diagonalization solver of the port (solvers/fdm.py) against the
JAX package's, on the cases of tests/test_fdm.py: FDMSolver.apply on a
seeded input (1e-12), the direct solve against the port's own dense matrix,
FDM-preconditioned CG on Poisson (one or two iterations) and on Helmholtz
(iterations equal to JAX's), step-64 --precond fdm and bp5's fdm-direct
mode; on a card, the f32 apply with TF32 turned on by the caller."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.drivers import bp5 as bp5_t
from deal_and_ceed_on_gpu_torch.drivers import step64 as step64_t
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, PoissonOperator, assemble_dense, assemble_rhs

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.drivers import step64 as step64_j
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
    from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
    from deal_and_ceed_on_gpu_tpu.models import l2_norm_function as l2_j
    from deal_and_ceed_on_gpu_tpu.solvers import FDMSolver as FDMJ
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

TOL = 1e-12  # FDM applies, relative to max|want|
BREAKS = (np.array([0.0, 0.1, 0.35, 1.0]), np.linspace(0, 1, 4), np.linspace(0, 1, 4))
MESHES = {"brick": ((3, 2, 4), (1.0, 0.7, 1.3)), "graded": None}
DEGREES = [(2, "gauss_lobatto"), (4, "gauss_lobatto"), (3, "gauss")]


def _meshes(kind):
    if kind == "graded":
        return pt.BrickMesh.graded(*BREAKS), jx.BrickMesh.graded(*BREAKS)
    shape, upper = MESHES[kind]
    return pt.BrickMesh(shape, upper=upper), jx.BrickMesh(shape, upper=upper)


def _spaces(kind, p, rule, dtype=torch.float64):
    mt, mj = _meshes(kind)
    st = pt.FESpace.create(mt, p, rule=rule, dtype=dtype, device="cpu")
    sj = jx.FESpace.create(mj, p, rule=rule, dtype=jnp.float64)
    return st, sj


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("p,rule", DEGREES)
def test_fdm_apply_matches_jax(kind, p, rule):
    st, sj = _spaces(kind, p, rule)
    r = np.random.default_rng(p).standard_normal(st.n_dofs)
    got = pt.FDMSolver(st).apply(torch.as_tensor(r))
    _close(got.numpy(), FDMJ(sj).apply(jnp.asarray(r)))
    # identity on the constrained rows
    mask = st.dirichlet_mask.numpy()
    np.testing.assert_array_equal(got.numpy()[mask], r[mask])


@pytest.mark.parametrize("p,rule", DEGREES)
def test_fdm_is_exact_poisson_solver(p, rule):
    """The solve against the port's dense constrained matrix (1e-10), on the
    brick (the graded mesh's FDM equals JAX's, whose exactness its own tests
    hold)."""
    st, _ = _spaces("brick", p, rule)
    b = assemble_rhs(st, 1.0)
    x = pt.FDMSolver(st).solve(b).numpy()
    A = assemble_dense(PoissonOperator(st, backend="separable"))
    np.testing.assert_allclose(x, np.linalg.solve(A, b.numpy()), rtol=1e-10, atol=1e-12)


def test_fdm_preconditioned_cg_matches_jax():
    """FDM is the exact inverse of BP5's operator: CG converges in one or two
    iterations, as many as JAX's, to the same solution."""
    st = pt.FESpace.create(pt.BrickMesh((2, 3, 2)), 3, dtype=torch.float64, device="cpu")
    sj = jx.FESpace.create(jx.BrickMesh((2, 3, 2)), 3, dtype=jnp.float64)
    op_t, op_j = PoissonOperator(st, backend="separable"), PoissonJ(sj, backend="separable")
    b_t, b_j = assemble_rhs(st, 1.0), rhs_j(sj, 1.0)
    tol = 1e-10 * float(torch.linalg.vector_norm(b_t))
    x_t, i_t = pt.solve_cg(op_t.vmult, b_t, pt.SolverControl(50, tol), diag=pt.FDMSolver(st).apply)
    x_j, i_j = jx.solve_cg(op_j.vmult, b_j, jx.SolverControl(50, tol), diag=FDMJ(sj).apply)
    assert i_t["n_iterations"] == int(i_j["n_iterations"]) <= 2
    assert float(torch.linalg.vector_norm(b_t - op_t.vmult(x_t))) <= 1e-9 * float(torch.linalg.vector_norm(b_t))
    _close(x_t.numpy(), x_j, tol=1e-10)


@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
def test_fdm_preconditions_helmholtz_as_jax(rule):
    """The Poisson FDM as the preconditioner of step-64's Helmholtz system:
    the iterations of JAX's plain CG, the solution to 1e-8, and at least four
    times fewer iterations than the identity."""
    mt, mj = pt.BrickMesh.hyper_cube().refine_global(2), jx.BrickMesh.hyper_cube().refine_global(2)
    st = pt.FESpace.create(mt, 3, rule=rule, dtype=torch.float64, device="cpu")
    sj = jx.FESpace.create(mj, 3, rule=rule, dtype=jnp.float64)
    op_t, op_j = HelmholtzOperator(st), HelmholtzJ(sj)
    b_t, b_j = assemble_rhs(st, 1.0), rhs_j(sj, 1.0)
    tol = 1e-10 * float(torch.linalg.vector_norm(b_t))
    _, i_id = pt.solve_cg(op_t.vmult, b_t, pt.SolverControl(2000, tol))
    x_t, i_t = pt.solve_cg(op_t.vmult, b_t, pt.SolverControl(2000, tol), diag=pt.FDMSolver(st).apply)
    x_j, i_j = jx.solve_cg(op_j.vmult, b_j, jx.SolverControl(2000, tol), diag=FDMJ(sj).apply)
    assert i_t["n_iterations"] == int(i_j["n_iterations"])
    assert 4 * i_t["n_iterations"] <= i_id["n_iterations"]
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("backend", ["qgrid", "general", "structured"])
def test_step64_fdm_matches_jax(backend):
    """step-64 refine 2 --precond fdm: the JAX driver's iterations and L2
    norm (1e-10) on the kernel backends' plain versions."""
    want = step64_j.run(n_refine=2, degree=3, dtype="float64", precond="fdm")
    r = step64_t.run(2, precond="fdm", backend=backend, device="cpu")
    assert r["n_iterations"] == want["n_iterations"]
    assert abs(r["l2_norm"] - want["l2_norm"]) <= 1e-10 * want["l2_norm"]
    assert r["setup_s"]["eigh"] > 0


def test_bp5_fdm_direct_mode():
    """bp5 --modes fdm-direct at cycle 10 on the stencil backend: the true
    residual of an exact solve and the L2 norm of JAX's FDM solve."""
    r = bp5_t.run_cycle(10, modes=("fdm-direct",), backend="stencil", device="cpu", dtype="float64",
                        n_repetitions=1)
    assert r["true_rel_res"]["fdm-direct"] <= 1e-12
    assert r["finite"]["fdm-direct"] and r["fdm-direct"] > 0
    sj = jx.FESpace.create(jx.BrickMesh.bp5_cycle(10), 5, dtype=jnp.float64)
    want = float(l2_j(sj, FDMJ(sj).solve(rhs_j(sj, 1.0))))
    assert abs(r["l2_norm"] - want) <= 1e-12 * want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 check means something only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
def test_fdm_f32_with_tf32_on_on_card(cuda_device, rule):
    """TF32 turned on by the caller: FDM's f32 sweeps still agree with f64 to
    1e-5 (a TF32 sweep loses about three digits)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        mesh = pt.BrickMesh((6, 5, 7), upper=(1.0, 0.7, 1.3))
        r = np.random.default_rng(0).standard_normal(mesh.n_dofs(4))
        out = {}
        for dtype in (torch.float64, torch.float32):
            space = pt.FESpace.create(mesh, 4, rule=rule, dtype=dtype, device=cuda_device)
            out[dtype] = pt.FDMSolver(space).apply(torch.as_tensor(r, dtype=dtype, device=cuda_device)).double()
        want = out[torch.float64]
        assert float((out[torch.float32] - want).abs().max() / want.abs().max()) <= 1e-5
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting is back
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
