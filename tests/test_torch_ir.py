"""Mixed-precision iterative refinement of the port (solvers/ir.py) against
the JAX package's, on the cases of tests/test_ir.py: f32 Jacobi merged CG
inside f64 refinement (n_outer equal, n_inner +-2, solutions to 1e-8, the
true f64 residual checked independently, not the inner recurrence's), the
zero right-hand side, FDM and multigrid as the inner preconditioner, bf16
inner vectors, NoConvergence, and bp5's pcg-ir mode. The JAX package caches
its jitted steps on the operator (its test_ir_jitted_steps_are_cached);
eager torch does not retrace, so the port has no such cache and no such
test."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.drivers import bp5 as bp5_t
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, PoissonOperator, assemble_rhs

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
    from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
    from deal_and_ceed_on_gpu_tpu.solvers import FDMSolver as FDMJ
    from deal_and_ceed_on_gpu_tpu.solvers import Multigrid as MultigridJ
    from deal_and_ceed_on_gpu_tpu.solvers import solve_cg_ir as ir_j
except ImportError:  # the card's machine has no jax
    jnp = None

INNER_SLACK = 2  # f32 inner iterations against JAX's (rounding order differs)


def _pair(cls_t, cls_j, shape, p, rule, backend_t, backend_j):
    """(op32, op64) of the port and of the JAX package on one mesh."""
    out = []
    for mod, cls, backend, f32, f64 in ((pt, cls_t, backend_t, torch.float32, torch.float64),
                                        (jx, cls_j, backend_j, jnp.float32, jnp.float64)):
        mesh = mod.BrickMesh(shape)
        kw = {} if mod is jx else {"device": "cpu"}
        ops = [cls(mod.FESpace.create(mesh, p, rule=rule, dtype=dt, **kw), backend=backend) for dt in (f32, f64)]
        out.append(ops)
    return out


def _true_rel(op64, b, x):
    return float(torch.linalg.vector_norm(b - op64.vmult(x)) / torch.linalg.vector_norm(b))


def _check(got, want, b, op64):
    (x, info), (xj, ij) = got, want
    assert info["n_outer"] == ij["n_outer"]
    assert abs(info["n_inner"] - ij["n_inner"]) <= INNER_SLACK
    assert info["res_rel"] <= 1e-10
    assert _true_rel(op64, b, x) <= 1e-10  # independently, in f64
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("p,shape", [(3, (3, 3, 3)), (2, (4, 3, 2))])
def test_ir_reaches_f64_accuracy_as_jax(p, shape):
    (o32, o64), (j32, j64) = _pair(PoissonOperator, PoissonJ, shape, p, "gauss_lobatto", "separable", "separable")
    b = assemble_rhs(o64.space, 1.0)
    _check(pt.solve_cg_ir(o32, o64, b, rtol=1e-10), ir_j(j32, j64, rhs_j(j64.space, 1.0), rtol=1e-10), b, o64)


@pytest.mark.parametrize("backend,rule", [("stencil", "gauss_lobatto"), ("banded", "gauss_lobatto"),
                                          ("general", "gauss_lobatto"), ("qgrid", "gauss")])
def test_ir_on_the_kernel_backends(backend, rule):
    """IR with both operators on a kernel backend (its plain version here):
    JAX's outer count on separable / structured and the solution to 1e-8.
    The f32 inner counts are not compared across backends: another
    formulation rounds otherwise in f32."""
    backend_j = "separable" if rule == "gauss_lobatto" else "structured"
    (o32, o64), (j32, j64) = _pair(PoissonOperator, PoissonJ, (3, 3, 3), 3, rule, backend, backend_j)
    b = assemble_rhs(o64.space, 1.0)
    x, info = pt.solve_cg_ir(o32, o64, b, rtol=1e-10)
    xj, ij = ir_j(j32, j64, rhs_j(j64.space, 1.0), rtol=1e-10)
    assert info["n_outer"] == ij["n_outer"]
    assert _true_rel(o64, b, x) <= 1e-10
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-10)


def test_ir_zero_rhs():
    (o32, o64), _ = _pair(PoissonOperator, PoissonJ, (2, 2, 2), 2, "gauss_lobatto", "separable", "separable")
    x, info = pt.solve_cg_ir(o32, o64, torch.zeros(o64.space.n_dofs, dtype=torch.float64))
    assert float(x.abs().max()) == 0.0 and info["n_outer"] == 0


def test_ir_rejects_f32_rhs_and_raises_no_convergence():
    (o32, o64), _ = _pair(PoissonOperator, PoissonJ, (2, 2, 2), 2, "gauss_lobatto", "separable", "separable")
    b = assemble_rhs(o64.space, 1.0)
    with pytest.raises(TypeError, match="float64"):
        pt.solve_cg_ir(o32, o64, b.float())
    with pytest.raises(pt.NoConvergence):
        pt.solve_cg_ir(o32, o64, b, rtol=1e-30, max_outer=2)


def test_ir_with_fdm_inner_as_jax():
    """A callable preconditioner (FDM) routes the inner solves through plain
    CG: the JAX counts, and far fewer inner iterations than Jacobi."""
    (o32, o64), (j32, j64) = _pair(HelmholtzOperator, HelmholtzJ, (3, 3, 3), 3, "gauss", "structured", "structured")
    b, bj = assemble_rhs(o64.space, 1.0), rhs_j(j64.space, 1.0)
    got_j = pt.solve_cg_ir(o32, o64, b, rtol=1e-10)
    got_f = pt.solve_cg_ir(o32, o64, b, rtol=1e-10, diag32=pt.FDMSolver(o32.space).apply)
    _check(got_f, ir_j(j32, j64, bj, rtol=1e-10, diag32=FDMJ(j32.space).apply), b, o64)
    assert got_f[1]["n_inner"] < got_j[1]["n_inner"] // 3
    np.testing.assert_allclose(got_f[0].numpy(), got_j[0].numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("backend_t", ["separable", "stencil"])
def test_ir_with_multigrid_inner_as_jax(backend_t):
    """IR + MG (inner_max = 40, the bench_solvers_r3 row): the f32 V-cycle
    inside. The JAX package's Chebyshev bounds are numpy float64 scalars,
    which under x64 would promote its f32 smoother to f64; as Python floats
    they keep it f32, as on a TPU (x64 off)."""
    shape = (4, 4, 8)
    (o32, o64), (j32, j64) = _pair(PoissonOperator, PoissonJ, shape, 3, "gauss_lobatto", backend_t, "separable")
    mg = pt.Multigrid(o32.space, make_op=lambda s: PoissonOperator(s, backend=backend_t), fine_op=o32,
                      coarse_max_dofs=1000)
    mg_j = MultigridJ(j32.space, fine_op=j32, coarse_max_dofs=1000)
    mg_j.bounds = [tuple(float(v) for v in bd) for bd in mg_j.bounds]
    assert mg.n_levels == mg_j.n_levels == 2
    b = assemble_rhs(o64.space, 1.0)
    got = pt.solve_cg_ir(o32, o64, b, diag32=mg.vcycle, inner_max=40)
    _check(got, ir_j(j32, j64, rhs_j(j64.space, 1.0), diag32=mg_j.vcycle, inner_max=40), b, o64)


def test_ir_with_bf16_inner_vectors():
    """bf16-streaming f32 operator inside (dots at f32): still the f64 true
    residual of 1e-10."""
    space64 = pt.FESpace.create(pt.BrickMesh((3, 3, 3)), 3, dtype=torch.float64, device="cpu")
    space32 = pt.FESpace.create(pt.BrickMesh((3, 3, 3)), 3, dtype=torch.float32, device="cpu")
    o64 = PoissonOperator(space64, backend="stencil")
    o32 = PoissonOperator(space32, backend="stencil", stream_dtype=torch.bfloat16)
    b = assemble_rhs(space64, 1.0)
    x, info = pt.solve_cg_ir(o32, o64, b, rtol=1e-10)
    assert info["res_rel"] <= 1e-10 and _true_rel(o64, b, x) <= 1e-10
    assert x.dtype == torch.float64


def test_bp5_pcg_ir_mode():
    """bp5 --modes pcg-ir at cycle 10 on the stencil backend: a true f64
    residual of 1e-10, and a skip line unless --dtype float64."""
    r = bp5_t.run_cycle(10, modes=("pcg-ir",), backend="stencil", device="cpu", dtype="float64", n_repetitions=1)
    assert r["true_rel_res"]["pcg-ir"] <= 1e-10 and r["finite"]["pcg-ir"]
    n_outer, n_inner = r["n_iterations"]["pcg-ir"]
    assert 1 <= n_outer <= 10 and n_inner > 0
    r = bp5_t.run_cycle(10, modes=("pcg-ir",), backend="stencil", device="cpu", dtype="float32", n_repetitions=1)
    assert "pcg-ir" not in r
