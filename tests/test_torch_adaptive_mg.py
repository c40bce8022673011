"""The adaptive multigrid of the port (solvers/adaptive_mg.py) against the
JAX package's, on the cases of tests/test_adaptive_mg.py: the hierarchy and
coarsen_adaptive exactly; the prolongation; the hand-written restriction
against torch.func.vjp of the prolongation and against JAX's
linear_transpose (1e-13); the level diagonals and bounds; the V-cycle
(symmetric, positive, against JAX); MG-CG iteration counts equal to JAX's
and the solution to 1e-10, Poisson and Helmholtz, with every level on K4's
plain version; the host dense coarse matrix against the chunked vmult
fallback; IR with the adaptive-MG inner solve; the 3-component
composition with VectorOperator; on a card, the default levels on K4 and a
bitwise repeated V-cycle."""

import functools

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch import adaptive as ta
from deal_and_ceed_on_gpu_torch.ops import general
from deal_and_ceed_on_gpu_torch.solvers import adaptive_mg as tmg
from deal_and_ceed_on_gpu_torch.solvers.multigrid import _dense_from_vmult

try:
    import jax
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu import adaptive as ja
    from deal_and_ceed_on_gpu_tpu.solvers import adaptive_mg as jmg
except ImportError:  # the card's machine has no jax
    jnp = None

TRANSFER_TOL = 1e-13  # relative to max|want|
SOLUTION_TOL = 1e-10


def _two_level(mod, amod, shape=(2, 2, 2)):
    m = amod.AdaptiveMesh.refine(mod.BrickMesh(shape), (0,))
    return m.refine_active((int(np.flatnonzero(m.levels == 1)[0]),))


@functools.cache
def _case(p, model="poisson", backend="general"):
    """(port space, op, MG; JAX space, op, MG) on the two-level mesh; every
    port level on ``backend``."""
    ts = ta.AdaptiveSpace(_two_level(pt, ta), p, device="cpu")
    js = ja.AdaptiveSpace(_two_level(jx, ja), p)
    tcls, jcls = ((ta.AdaptivePoissonOperator, ja.AdaptivePoissonOperator) if model == "poisson"
                  else (ta.AdaptiveHelmholtzOperator, ja.AdaptiveHelmholtzOperator))

    def make_op(s):
        return tcls(s, backend=backend)

    top = make_op(ts)
    jop = jcls(js, backend="xla")
    tmgo = pt.AdaptiveMultigrid(ts, fine_op=top, make_op=make_op)
    jmgo = jmg.AdaptiveMultigrid(js, fine_op=jop, make_op=lambda s: jcls(s, backend="xla"))
    return ts, top, tmgo, js, jop, jmgo


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


def test_hierarchy_and_coarsen_equal_jax():
    tm, jm = _two_level(pt, ta), _two_level(jx, ja)
    tmeshes, ttr = tmg.adaptive_hierarchy(tm)
    jmeshes, jtr = jmg.adaptive_hierarchy(jm)
    assert len(tmeshes) == len(jmeshes) == 3 and tmeshes[-1].n_cells == 8
    for a, b in zip(tmeshes, jmeshes):
        for attr in ("origins", "sizes", "levels"):
            assert np.array_equal(getattr(a, attr), getattr(b, attr))
        assert a.is_balanced()
    for (s1, p1), (s2, p2) in zip(ttr, jtr):
        assert np.array_equal(s1, s2) and np.array_equal(p1, p2)
    tm2 = ta.AdaptiveMesh.refine(pt.BrickMesh((2, 2, 2)), (0, 7))
    jm2 = ja.AdaptiveMesh.refine(jx.BrickMesh((2, 2, 2)), (0, 7))
    for a, b in zip(tmg.coarsen_adaptive(tm2), jmg.coarsen_adaptive(jm2)):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert np.array_equal(a.origins, b.origins) and np.array_equal(a.levels, b.levels)


@pytest.mark.parametrize("p", [2, 3])
def test_transfers_match_jax_and_vjp(p):
    """P against JAX's; R = P^T against torch.func.vjp of the port's P (its
    coarse constrained rows zeroed, as in JAX) and against JAX's
    linear_transpose; <P u, v> = <u, R v> on the coarse solve subspace."""
    ts, _, tmgo, js, _, jmgo = _case(p)
    rng = np.random.default_rng(3)
    for k, tr in enumerate(tmgo.transfers):
        cs = tmgo.spaces[k + 1]
        uc = rng.standard_normal(cs.n_dofs)
        rf = rng.standard_normal(tmgo.spaces[k].n_dofs)
        _close(tr.prolong(torch.as_tensor(uc)), jmgo.prolongs[k](jnp.asarray(uc)), TRANSFER_TOL)
        got = tr.restrict(torch.as_tensor(rf))
        _close(got, jmgo.restricts[k](jnp.asarray(rf)), TRANSFER_TOL)
        _, vjp = torch.func.vjp(tr.prolong, torch.as_tensor(uc))
        _close(got, vjp(torch.as_tensor(rf))[0].masked_fill(cs.constrained_mask, 0), TRANSFER_TOL)
        uc[cs.constrained_mask_np] = 0.0
        lhs = float(tr.prolong(torch.as_tensor(uc)) @ torch.as_tensor(rf))
        assert abs(lhs - float(torch.as_tensor(uc) @ got)) <= 1e-13 * max(1.0, abs(lhs))


def test_prolongation_reproduces_conforming_polynomials():
    _, _, tmgo, _, _, _ = _case(3)
    fine, coarse = tmgo.spaces[0], tmgo.spaces[1]

    def f(x):
        g = x * (1.0 - x)
        return g[:, 0] * g[:, 1] * g[:, 2] * (1.0 + x[:, 0] - 0.5 * x[:, 1])

    got = tmgo.transfers[0].prolong(torch.as_tensor(f(coarse.node_coords)))
    np.testing.assert_allclose(got.numpy(), f(fine.node_coords), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model", ["poisson", "helmholtz"])
def test_smoother_tables_and_vcycle_match_jax(model):
    """The level diagonals, the Chebyshev bounds (host floats), the coarse
    inverse and one V-cycle against JAX; the V-cycle symmetric positive."""
    ts, _, tmgo, _, _, jmgo = _case(2, model)
    assert tmgo.n_levels == jmgo.n_levels == 3
    for a, b in zip(tmgo.dinv, jmgo.dinv):
        _close(a, b, 1e-14)
    for a, b in zip(tmgo.bounds, jmgo.bounds):
        assert all(isinstance(v, float) for v in a)
        np.testing.assert_allclose(a, b, rtol=1e-12)
    _close(tmgo.coarse_inv_np, jmgo.coarse_inv_np, 1e-12)
    rng = np.random.default_rng(7)
    mask = ts.constrained_mask_np
    r1, r2 = rng.standard_normal(ts.n_dofs), rng.standard_normal(ts.n_dofs)
    r1[mask] = r2[mask] = 0.0
    z1 = tmgo.vcycle(torch.as_tensor(r1))
    _close(z1, jmgo.vcycle(jnp.asarray(r1)), 1e-11)
    a = float(z1 @ torch.as_tensor(r2))
    b = float(torch.as_tensor(r1) @ tmgo.vcycle(torch.as_tensor(r2)))
    assert abs(a - b) < 1e-10 * max(1.0, abs(a)) and float(z1 @ torch.as_tensor(r1)) > 0.0


@pytest.mark.parametrize("p,model", [(2, "poisson"), (3, "poisson"), (2, "helmholtz")])
def test_mgcg_matches_jax(p, model):
    """MG-CG to 1e-12 with every level on K4's plain version (its launches
    counted on a CUDA device only, so the levels' backends are checked):
    JAX's iteration count, the solution to 1e-10."""
    ts, top, tmgo, js, jop, jmgo = _case(p, model)
    assert {op.backend for op in tmgo.ops} == {"general"}
    assert all(s.device == ts.device for s in tmgo.spaces)
    bt, bj = ta.assemble_rhs_adaptive(ts, 1.0), ja.assemble_rhs_adaptive(js, 1.0)
    xj, ij = jx.solve_cg(jop.vmult, bj, jx.ReductionControl(60, tolerance=0.0, reduction=1e-12), diag=jmgo.vcycle)
    xt, it = pt.solve_cg(top.vmult, bt, pt.ReductionControl(60, tolerance=0.0, reduction=1e-12), diag=tmgo.vcycle)
    assert it["n_iterations"] == int(ij["n_iterations"]) <= 25
    _close(xt, xj, SOLUTION_TOL)


def test_levels_run_the_cell_kernel(monkeypatch):
    """Every level's smoother and residual go through general_apply (K4's
    wrapper) when the levels are on ``general``: one V-cycle calls it on
    the two smoothed levels' element counts."""
    ts, _, tmgo, _, _, _ = _case(2)
    seen = []
    real = general.general_apply

    def spy(ul, k, out=None):
        seen.append(k.n_cells)
        return real(ul, k, out)

    monkeypatch.setattr(general, "general_apply", spy)
    tmgo.vcycle(ta.assemble_rhs_adaptive(ts, 1.0))
    assert set(seen) == {s.mesh.n_cells for s in tmgo.spaces[:-1]}


def test_host_dense_coarse_matches_vmult_fallback():
    """dense_coarse_inverse's host assembly equals the chunked vmult
    materialization (multigrid._dense_from_vmult) for both operator classes."""
    space = ta.AdaptiveSpace(ta.AdaptiveMesh.from_brick(pt.BrickMesh((2, 2, 2))), 2, device="cpu")
    for op in (ta.AdaptivePoissonOperator(space), ta.AdaptiveHelmholtzOperator(space)):
        K = tmg._host_dense_constrained(op)
        A = _dense_from_vmult(op)
        assert K is not None and np.abs(K - A).max() < 1e-11 * max(1.0, np.abs(A).max())
    hanging = ta.AdaptivePoissonOperator(_case(2)[0])
    assert tmg._host_dense_constrained(hanging) is None
    with pytest.raises(ValueError, match="coarse_max_dofs"):
        tmg.dense_coarse_inverse(ta.AdaptivePoissonOperator(space), 10)


def test_ir_with_adaptive_mg_inner():
    """Mixed-precision IR: f32 adaptive-MG inner CG (every level on
    ``general``), f64 true residuals to 1e-10; JAX's outer and inner counts."""
    from deal_and_ceed_on_gpu_tpu.solvers import solve_cg_ir as ir_j

    tm, jm = _two_level(pt, ta), _two_level(jx, ja)
    s64, s32 = ta.AdaptiveSpace(tm, 2, device="cpu"), ta.AdaptiveSpace(tm, 2, dtype=torch.float32, device="cpu")
    op64 = ta.AdaptivePoissonOperator(s64, backend="general")
    op32 = ta.AdaptivePoissonOperator(s32, backend="general")
    mg32 = pt.AdaptiveMultigrid(s32, fine_op=op32, make_op=lambda s: ta.AdaptivePoissonOperator(s, backend="general"))
    b = ta.assemble_rhs_adaptive(s64, 1.0)
    x, info = pt.solve_cg_ir(op32, op64, b, rtol=1e-10, diag32=mg32.vcycle)
    assert info["res_rel"] <= 1e-10
    j64, j32 = ja.AdaptiveSpace(jm, 2), ja.AdaptiveSpace(jm, 2, dtype=jnp.float32)
    jmg32 = jmg.AdaptiveMultigrid(j32, fine_op=ja.AdaptivePoissonOperator(j32))
    xj, ij = ir_j(ja.AdaptivePoissonOperator(j32), ja.AdaptivePoissonOperator(j64), ja.assemble_rhs_adaptive(j64, 1.0),
                  rtol=1e-10, diag32=jmg32.vcycle)
    assert (info["n_outer"], info["n_inner"]) == (int(ij["n_outer"]), int(ij["n_inner"]))
    _close(x, xj, 1e-8)


def test_vector_composition():
    """The port's VectorOperator on an adaptive operator equals three scalar
    applies; a 3-component MG-CG solve (vcycle_vector) converges like the
    scalar one, against JAX's vmapped solve."""
    ts, top, tmgo, js, jop, jmgo = _case(2)
    vop = pt.models.VectorOperator(top, 3)
    u = np.random.default_rng(4).standard_normal((3, ts.n_dofs))
    got = vop.vmult(torch.as_tensor(u))
    for c in range(3):
        assert torch.equal(got[c], top.vmult(torch.as_tensor(u[c])))
    b = ta.assemble_rhs_adaptive(ts, 1.0)
    b3 = torch.stack([b, 2.0 * b, -b])
    control = pt.ReductionControl(60, tolerance=0.0, reduction=1e-11)
    x3, info = pt.solve_cg(vop.vmult, b3, control, diag=tmgo.vcycle_vector)
    from deal_and_ceed_on_gpu_tpu.models.vector import VectorOperator as VectorJ

    bj = ja.assemble_rhs_adaptive(js, 1.0)
    xj, ij = jx.solve_cg(VectorJ(jop, 3).vmult, jnp.stack([bj, 2.0 * bj, -bj]), jx.ReductionControl(
        60, tolerance=0.0, reduction=1e-11), diag=lambda r: jax.vmap(jmgo.vcycle)(r))
    assert info["n_iterations"] == int(ij["n_iterations"]) <= 25
    _close(x3, xj, 1e-8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_adaptive_mg_on_card(cuda_device, dtype):
    """On the card the default levels are K4 (``auto``) in both precisions:
    K4 launches in a V-cycle, two V-cycles bitwise equal, and the V-cycle
    agrees with the CPU's plain-loop V-cycle (1e-11 f64, 1e-4 f32)."""
    mesh = ta.AdaptiveMesh.refine(pt.BrickMesh((4, 4, 4)), (0, 9, 42))
    mesh = mesh.refine_active((int(np.flatnonzero(mesh.levels == 1)[0]),))
    space = ta.AdaptiveSpace(mesh, 2, dtype=dtype, device=cuda_device)
    mg = pt.AdaptiveMultigrid(space)
    assert {op.backend for op in mg.ops} == {"general"}
    r = ta.assemble_rhs_adaptive(space, 1.0)
    n0 = general.LAUNCHES
    z = mg.vcycle(r)
    assert general.LAUNCHES > n0 and torch.equal(z, mg.vcycle(r))
    cpu = pt.AdaptiveMultigrid(ta.AdaptiveSpace(mesh, 2, dtype=dtype, device="cpu"))
    want = cpu.vcycle(r.cpu())
    tol = 1e-11 if dtype == torch.float64 else 1e-4
    assert float((z.cpu() - want).abs().max()) <= tol * float(want.abs().max())
