"""The port's CG solvers against the JAX package's, in f64 on the CPU: same
iteration counts (+-1, the residual recurrence may flip the last step) and
the same solutions, on the tests/test_solvers.py style Poisson systems."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
import deal_and_ceed_on_gpu_tpu as jx
from deal_and_ceed_on_gpu_torch.models import assemble_rhs as rhs_t
from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j


def _setup(p, shape, backend="separable"):
    js = jx.FESpace.create(jx.BrickMesh(shape), p, rule="gauss_lobatto", dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh(shape), p, rule="gauss_lobatto", dtype=torch.float64, device="cpu")
    jop = jx.PoissonOperator(js)
    top = pt.PoissonOperator(ts, backend=backend)
    return jop, rhs_j(js, 1.0), top, rhs_t(ts, 1.0)


def _solvers(deferred):
    return [
        ("cg", lambda A, b, c: jx.solve_cg(A, b, c), lambda A, b, c: pt.solve_cg(A, b, c)),
        (
            "merged",
            lambda A, b, c: jx.solve_cg_merged(A, b, c, deferred_x_update=deferred),
            lambda A, b, c: pt.solve_cg_merged(A, b, c, deferred_x_update=deferred),
        ),
    ]


@functools.cache
def _jax_solutions(p, shape, deferred):
    """JAX solutions and iteration counts per solver (shared by the port's
    backends)."""
    jop, jb, _, _ = _setup(p, shape)
    tol = 1e-10 * float(np.linalg.norm(np.asarray(jb)))
    out = {}
    for name, solve_j, _ in _solvers(deferred):
        xj, ij = solve_j(jop.vmult, jb, jx.SolverControl(500, tol))
        out[name] = (np.asarray(xj), int(ij["n_iterations"]))
    return np.asarray(jb), tol, out


@pytest.mark.parametrize("backend", ["separable", "stencil", "structured"])
@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("p,shape", [(2, (3, 3, 3)), (3, (2, 2, 2)), (5, (2, 1, 2))])
def test_tolerance_solves_match_jax(backend, deferred, p, shape):
    jb, tol, jax_out = _jax_solutions(p, shape, deferred)
    _, _, top, tb = _setup(p, shape, backend)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-13, atol=1e-15)
    for name, _, solve_t in _solvers(deferred):
        xj, it_j = jax_out[name]
        xt, it = solve_t(top.vmult, tb, pt.SolverControl(500, tol))
        assert abs(it["n_iterations"] - it_j) <= 1, name
        np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-9, atol=1e-12)
        pt.SolverControl(500, tol).check(it)


@pytest.mark.parametrize("max_steps", [1, 2, 3, 4, 5, 7, 8])
def test_deferred_x_update_at_any_stop(max_steps):
    """The two-step x update leaves x complete whatever the parity of the
    stopping iteration, and matches JAX's deferred solver."""
    jop, jb, top, tb = _setup(2, (2, 2, 2))
    xt_plain, _ = pt.solve_cg_merged(top.vmult, tb, pt.IterationNumberControl(max_steps, 0.0))
    xt_def, info = pt.solve_cg_merged(
        top.vmult, tb, pt.IterationNumberControl(max_steps, 0.0), deferred_x_update=True
    )
    assert info["n_iterations"] <= max_steps
    np.testing.assert_allclose(xt_def.numpy(), xt_plain.numpy(), rtol=1e-12, atol=1e-13)
    xj, _ = jx.solve_cg_merged(
        jop.vmult, jb, jx.IterationNumberControl(max_steps, 0.0), deferred_x_update=True
    )
    np.testing.assert_allclose(xt_def.numpy(), np.asarray(xj), rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("solver", ["cg", "merged"])
def test_reduction_control_matches_jax(solver):
    jop, jb, top, tb = _setup(3, (3, 3, 3))
    fj, ft = {n: (a, b) for n, a, b in _solvers(False)}[solver]
    xj, ij = fj(jop.vmult, jb, jx.ReductionControl(500, tolerance=0.0, reduction=1e-4))
    xt, it = ft(top.vmult, tb, pt.ReductionControl(500, tolerance=0.0, reduction=1e-4))
    assert abs(it["n_iterations"] - int(ij["n_iterations"])) <= 1
    assert float(it["res_norm"]) <= 1e-4 * float(it["res0"])
    assert it["n_iterations"] < 500
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_diag_and_x0_arguments():
    """A ones diagonal (vector or callable) and a nonzero x0 solve the same
    system as the identity preconditioner from zero."""
    _, _, top, tb = _setup(2, (2, 2, 2))
    c = pt.SolverControl(500, 1e-12 * float(torch.linalg.vector_norm(tb)))
    x_ref, _ = pt.solve_cg(top.vmult, tb, c)
    ones = top.diagonal()
    x0 = top.space.zero_constrained_values(torch.full_like(tb, 0.01))
    for x, _ in (
        pt.solve_cg(top.vmult, tb, c, diag=ones),
        pt.solve_cg(top.vmult, tb, c, diag=lambda r: r, x0=x0),
        pt.solve_cg_merged(top.vmult, tb, c, diag=ones),
        pt.solve_cg_merged(top.vmult, tb, c, diag=ones, x0=x0, deferred_x_update=True),
    ):
        np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=1e-9, atol=1e-12)


def test_exact_convergence_stops_cleanly():
    """Once the residual is exactly zero the safe divides end the loop with
    res == 0 (the reference would divide by zero, bp5/solver.h:501)."""
    _, _, top, tb = _setup(2, (2, 2, 2))
    x, info = pt.solve_cg_merged(top.vmult, tb, pt.IterationNumberControl(1000, 0.0))
    assert torch.isfinite(x).all()
    assert float(info["res_norm"]) == 0.0
    np.testing.assert_allclose(top.vmult(x).numpy(), tb.numpy(), rtol=1e-10, atol=1e-10)


def test_no_convergence_raises():
    _, _, top, tb = _setup(3, (2, 2, 2))
    c = pt.SolverControl(3, 1e-14)
    _, info = pt.solve_cg(top.vmult, tb, c)
    with pytest.raises(pt.NoConvergence):
        c.check(info)


def test_bf16_vectors_accumulate_in_f32():
    """bf16 solver vectors with f32 dots: the solve runs, stays finite and
    lands near the f32 solution (bf16 rounds the vectors to ~3 digits)."""
    ts = pt.FESpace.create(pt.BrickMesh((2, 2, 2)), 3, dtype=torch.float32, device="cpu")
    b = rhs_t(ts, 1.0)
    ref_op = pt.PoissonOperator(ts, backend="stencil")
    op = pt.PoissonOperator(ts, backend="stencil", stream_dtype=torch.bfloat16)
    c = pt.IterationNumberControl(40, 0.0)
    x_ref, _ = pt.solve_cg_merged(ref_op.vmult, b, c)
    x, info = pt.solve_cg_merged(op.vmult, b.to(torch.bfloat16), c, dot_dtype=torch.float32)
    assert x.dtype == torch.bfloat16 and info["res_norm"].dtype == torch.float32
    assert torch.isfinite(x).all()
    err = float((x.float() - x_ref).abs().max() / x_ref.abs().max())
    assert err < 5e-2


def _vector_rhs(space, rhs):
    """Three different right-hand sides, one per component."""
    fs = (1.0, lambda x: x[..., 0], lambda x: 1.0 + x[..., 1] * x[..., 2])
    return [rhs(space, f) for f in fs]


@pytest.mark.parametrize("solver", ["cg", "merged"])
def test_vector_rhs_solves_like_three_scalar_solves_and_jax(solver):
    """A [3, n] right-hand side (the vector BPs): the dots run over all
    entries, so the block solve converges to the three scalar solutions and
    matches JAX's shape-blind solver on the same [3, n] problem."""
    from deal_and_ceed_on_gpu_tpu.models.vector import VectorOperator as VecJ

    jop, _, top, _ = _setup(3, (3, 2, 2))
    bt = torch.stack(_vector_rhs(top.space, rhs_t))
    bj = jnp.stack(_vector_rhs(jop.space, rhs_j))
    tol = 1e-12 * float(torch.linalg.vector_norm(bt))
    solve_t = {"cg": pt.solve_cg, "merged": pt.solve_cg_merged}[solver]
    solve_j = {"cg": jx.solve_cg, "merged": jx.solve_cg_merged}[solver]
    def vmult3(v):
        return torch.stack([top.vmult(r) for r in v])

    xt, it = solve_t(vmult3, bt, pt.SolverControl(500, tol))
    assert tuple(xt.shape) == (3, top.space.n_dofs)
    for c in range(3):
        xc, _ = solve_t(top.vmult, bt[c], pt.SolverControl(500, 1e-13 * float(torch.linalg.vector_norm(bt[c]))))
        np.testing.assert_allclose(xt[c].numpy(), xc.numpy(), rtol=1e-9, atol=1e-12)
    xj, ij = solve_j(VecJ(jop).vmult, bj, jx.SolverControl(500, tol))
    assert abs(it["n_iterations"] - int(ij["n_iterations"])) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)
    # a 1-D vector keeps the same dots: the scalar solve is unchanged
    x1, i1 = solve_t(top.vmult, bt[0], pt.SolverControl(500, tol))
    x1j, i1j = solve_j(jop.vmult, bj[0], jx.SolverControl(500, tol))
    assert abs(i1["n_iterations"] - int(i1j["n_iterations"])) <= 1
