"""The BP5 slice as a whole: the port's driver against the JAX driver, the
RHS and L2-norm helpers, the operator backends against JAX's structured
cell loop, and the port's import and device contracts."""

import functools
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
import deal_and_ceed_on_gpu_tpu as jx
from deal_and_ceed_on_gpu_torch.drivers import bp5 as bp5_t
from deal_and_ceed_on_gpu_torch.models import assemble_rhs as rhs_t
from deal_and_ceed_on_gpu_torch.models import l2_norm_function as l2_t
from deal_and_ceed_on_gpu_tpu.drivers import bp5 as bp5_j
from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
from deal_and_ceed_on_gpu_tpu.models import l2_norm_function as l2_j

MODES = ("pcg-standard", "pcg-merged")


@functools.cache
def _jax_cycle(cycle):
    """JAX run_cycle (separable, f64): per-mode iteration counts, parsed
    from its "Solved in N iterations" lines, and the L2 norm."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = bp5_j.run_cycle(
            cycle, bp5_j.BP5Config(dtype="float64", backend="separable", modes=MODES, n_repetitions=1)
        )
    iters = [int(m) for m in re.findall(r"Solved in (\d+) iterations", buf.getvalue())]
    assert len(iters) == len(MODES)
    return dict(zip(MODES, iters)), r["l2_norm"]


# The driver stops at |r| <= 1e-6 |b|, where the solution is still ~1e-6
# off the converged one, so its L2 norm carries the roundoff history of the
# iteration: JAX's own separable/structured/pallas backends disagree by up
# to 7e-11 at cycles 8-10, the port by 1e-11..6.5e-10 depending on the
# summation order, and one more iteration (a 1-ulp change of b can add one)
# moves it by 5e-10 (cycle 10) to 2e-9 (cycle 8). The driver-level norm is
# held to 5e-9; the converged solutions below agree to 1e-10 and better.
DRIVER_L2_RTOL = 5e-9


@pytest.mark.parametrize("cycle", [8, 10])
@pytest.mark.parametrize("backend", ["stencil", "separable"])
def test_run_cycle_matches_jax(cycle, backend):
    iters_j, l2_j_val = _jax_cycle(cycle)
    r = bp5_t.run_cycle(
        cycle, dtype="float64", device="cpu", backend=backend, modes=MODES, n_repetitions=1
    )
    for mode in MODES:
        assert abs(r["n_iterations"][mode] - iters_j[mode]) <= 1, mode
        assert r["finite"][mode]
    assert abs(r["l2_norm"] - l2_j_val) <= DRIVER_L2_RTOL * l2_j_val


@functools.cache
def _jax_converged(cycle):
    js = jx.FESpace.create(jx.BrickMesh.bp5_cycle(cycle), 5, dtype=jnp.float64)
    b = rhs_j(js, 1.0)
    tol = 1e-12 * float(jnp.linalg.norm(b))
    x, info = jx.solve_cg_merged(jx.PoissonOperator(js, backend="separable").vmult, b, jx.SolverControl(1000, tol))
    return tol, int(info["n_iterations"]), float(l2_j(js, x))


@pytest.mark.parametrize("cycle", [8, 10])
@pytest.mark.parametrize("backend", ["stencil", "separable"])
def test_converged_l2_norm_matches_jax(cycle, backend):
    """The slice's pieces (mesh, RHS, operator, solvers, L2 norm) driven to
    a 1e-12 residual: the BP5 solution's L2 norm matches JAX's to 1e-10."""
    tol, it_j, l2_j_val = _jax_converged(cycle)
    ts = pt.FESpace.create(pt.BrickMesh.bp5_cycle(cycle), 5, dtype=torch.float64, device="cpu")
    op, b = pt.PoissonOperator(ts, backend=backend), rhs_t(ts, 1.0)
    for solver in (pt.solve_cg, pt.solve_cg_merged):
        x, info = solver(op.vmult, b, pt.SolverControl(1000, tol))
        assert abs(info["n_iterations"] - it_j) <= 1
        assert abs(float(l2_t(ts, x)) - l2_j_val) <= 1e-10 * l2_j_val


@pytest.mark.parametrize("p,extra,rule", [(3, None, "gauss_lobatto"), (5, None, "gauss_lobatto"), (3, 2, "gauss")])
def test_rhs_and_l2_norm_match_jax(p, extra, rule):
    shape, upper = (3, 2, 2), (1.0, 0.8, 1.3)
    n_q = None if extra is None else p + extra
    js = jx.FESpace.create(jx.BrickMesh(shape, upper=upper), p, n_q=n_q, rule=rule, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh(shape, upper=upper), p, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")

    def f(x):
        return 1.0 + x[..., 0] * x[..., 1] - np.sin(3.0 * x[..., 2])

    for load in (1.0, f):
        bj, bt = np.array(rhs_j(js, load)), rhs_t(ts, load).numpy()
        np.testing.assert_allclose(bt, bj, rtol=1e-13, atol=1e-15)
        assert abs(float(l2_t(ts, torch.as_tensor(bj))) - float(l2_j(js, jnp.asarray(bj)))) <= 1e-13 * float(
            l2_j(js, jnp.asarray(bj))
        )
    u = np.random.default_rng(0).standard_normal(ts.n_dofs)
    for n_q2 in (None, p + 3):
        want = float(l2_j(js, jnp.asarray(u), n_q2))
        assert abs(float(l2_t(ts, torch.as_tensor(u), n_q2)) - want) <= 1e-13 * want


@pytest.mark.parametrize("backend", ["structured", "separable", "stencil"])
@pytest.mark.parametrize("p", [2, 5])
def test_vmult_matches_jax_structured(backend, p):
    shape, upper = (3, 2, 4), (1.0, 0.8, 1.3)
    js = jx.FESpace.create(jx.BrickMesh(shape, upper=upper), p, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh(shape, upper=upper), p, dtype=torch.float64, device="cpu")
    u = np.random.default_rng(p).standard_normal(ts.n_dofs)
    want = np.asarray(jx.PoissonOperator(js, backend="structured").vmult(jnp.asarray(u)))
    op = pt.PoissonOperator(ts, backend=backend)
    np.testing.assert_allclose(op.vmult(torch.as_tensor(u)).numpy(), want, rtol=1e-12, atol=1e-12)
    # fold_scale on every backend: interior rows scale, identity rows stay
    op.fold_scale(2.0)
    got = op.vmult(torch.as_tensor(u)).numpy()
    mask = ts.mesh.boundary_dof_mask(p)
    np.testing.assert_allclose(got[~mask], 2.0 * want[~mask], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[mask], u[mask])


def test_graded_separable_matches_jax():
    breaks = ([0, 0.2, 0.7, 1.0], [0, 0.4, 1.0], [0, 0.3, 0.5, 1.2])
    js = jx.FESpace.create(jx.BrickMesh.graded(*breaks), 3, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh.graded(*breaks), 3, dtype=torch.float64, device="cpu")
    u = np.random.default_rng(7).standard_normal(ts.n_dofs)
    want = np.asarray(jx.PoissonOperator(js, backend="separable").vmult(jnp.asarray(u)))
    got = pt.PoissonOperator(ts, backend="separable").vmult(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the structured loop takes graded bricks too (the six-plane merged
    # coefficient); K1's stencil stays on uniform bricks
    got = pt.PoissonOperator(ts, backend="structured").vmult(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        pt.PoissonOperator(ts, backend="stencil")


def test_lambda_estimate_uses_the_jax_draws():
    js = jx.FESpace.create(jx.BrickMesh((2, 2, 3)), 3, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh((2, 2, 3)), 3, dtype=torch.float64, device="cpu")
    want = bp5_j.estimate_lambda_max(jx.PoissonOperator(js, backend="separable"), js.n_dofs)
    got = bp5_t.estimate_lambda_max(pt.PoissonOperator(ts, backend="stencil"), ts.n_dofs)
    assert abs(got - want) <= 1e-12 * want


def test_import_leaves_jax_and_triton_out():
    code = (
        "import sys, deal_and_ceed_on_gpu_torch, deal_and_ceed_on_gpu_torch.drivers.bp5, "
        "deal_and_ceed_on_gpu_torch.drivers.step64, deal_and_ceed_on_gpu_torch.ops.qgrid, "
        "deal_and_ceed_on_gpu_torch.models.helmholtz, "
        "deal_and_ceed_on_gpu_torch.ops.stencil, deal_and_ceed_on_gpu_torch.utils.convert, "
        "deal_and_ceed_on_gpu_torch.utils.cuda_build, deal_and_ceed_on_gpu_torch.ops.cg, "
        "deal_and_ceed_on_gpu_torch.ops.copy, deal_and_ceed_on_gpu_torch.solvers.cg_fused, "
        "deal_and_ceed_on_gpu_torch.scripts.exp_solver_budget, deal_and_ceed_on_gpu_torch.parallel, "
        "deal_and_ceed_on_gpu_torch.parallel.comm, deal_and_ceed_on_gpu_torch.parallel.dist_fdm, "
        "deal_and_ceed_on_gpu_torch.parallel.dist_multigrid, deal_and_ceed_on_gpu_torch.parallel.dist_adaptive, "
        "deal_and_ceed_on_gpu_torch.parallel.dist_adaptive_mg, deal_and_ceed_on_gpu_torch.parallel.dist_amr; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', "
        "'deal_and_ceed_on_gpu_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # nor nvcc: importing builds nothing
    assert "nvcc" not in proc.stdout + proc.stderr


def test_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bp5_t.main(["--cycle-min", "7", "--cycle-max", "7", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bp5_t.run_cycle(7, modes=("vmult",))  # the default device is cuda


def test_cli_on_cpu_prints_reference_lines_and_skips(capsys):
    bp5_t.main([
        "--cycle-min", "7", "--cycle-max", "7", "--iterations", "5", "--repetitions", "1",
        "--device", "cpu", "--dtype", "float32", "--stream-dtype", "bfloat16",
        "--modes", "pcg-merged,vmult,pcg-fused,pcg-mg",
    ])
    out = capsys.readouterr().out
    assert re.search(r"^pcg-merged \d+ \S+$", out, re.M)
    assert re.search(r"^vmult \d+ \S+$", out, re.M)
    assert re.search(r"^pcg-fused \d+ \S+$", out, re.M)  # bf16 state, f32 dots, on K5's plain version
    assert re.search(r"^pcg-mg \d+ \S+$", out, re.M)  # f32 V-cycle, bf16 vectors, f32 dots
    assert "solution L2 norm" in out
    with pytest.raises(ValueError):
        bp5_t.run_cycle(7, device="cpu", modes=("pcg-bogus",))


def test_pcg_fused_matches_the_golden():
    """pcg-fused (K5's plain version) at cycle 10 in f64: the JAX driver's
    iterations (+-1) and L2 norm (5e-9, see DRIVER_L2_RTOL)."""
    iters_j, l2_j_val = _jax_cycle(10)
    r = bp5_t.run_cycle(10, modes=("pcg-fused",), backend="stencil", device="cpu", dtype="float64", n_repetitions=1)
    assert abs(r["n_iterations"]["pcg-fused"] - iters_j["pcg-merged"]) <= 1
    assert r["finite"]["pcg-fused"]
    assert abs(r["l2_norm"] - l2_j_val) <= DRIVER_L2_RTOL * l2_j_val


def test_pcg_fused_needs_the_stencil_backend(capsys):
    r = bp5_t.run_cycle(7, modes=("pcg-fused",), backend="separable", device="cpu", n_iterations=3, n_repetitions=1)
    assert "pcg-fused requires --backend stencil — skipping" in capsys.readouterr().out
    assert "pcg-fused" not in r
    assert bp5_t.BP5Config().modes == bp5_t.DEFAULT_MODES == ("pcg-standard", "pcg-merged", "vmult")


def test_fe_space_matches_jax():
    js = jx.FESpace.create(jx.BrickMesh((3, 2, 2), upper=(1.0, 0.8, 1.3)), 3, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh((3, 2, 2), upper=(1.0, 0.8, 1.3)), 3, dtype=torch.float64, device="cpu")
    assert ts.grid_shape == js.grid_shape and ts.n_dofs == js.n_dofs
    np.testing.assert_array_equal(ts.node_coords(), js.node_coords())
    np.testing.assert_array_equal(ts.dirichlet_mask.numpy(), np.asarray(js.dirichlet_mask))
    v = ts.initialize_dof_vector()
    assert v.shape == (ts.n_dofs,) and v.dtype == torch.float64 and not v.any()
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(ts.n_dofs))
    w = torch.zeros_like(u)
    np.testing.assert_array_equal(
        ts.copy_constrained_values(u, w).numpy(), np.asarray(js.copy_constrained_values(jnp.asarray(u.numpy()), jnp.asarray(w.numpy())))
    )
    np.testing.assert_array_equal(
        ts.zero_constrained_values(u).numpy(), np.asarray(js.zero_constrained_values(jnp.asarray(u.numpy())))
    )


@pytest.mark.parametrize("p", [2, 4])
def test_separable_stencil_mode_matches_jax(p):
    """band_apply's shifted multiply-add mode ("stencil") against the JAX
    package's, on a graded brick."""
    breaks = ([0, 0.2, 0.7, 1.0], [0, 0.4, 1.0], [0, 0.3, 0.5, 1.2])
    js = jx.FESpace.create(jx.BrickMesh.graded(*breaks), p, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh.graded(*breaks), p, dtype=torch.float64, device="cpu")
    u = np.random.default_rng(p).standard_normal(ts.n_dofs)
    jop = jx.PoissonOperator(js, backend="separable")
    jop.sep_mode = "stencil"
    top = pt.PoissonOperator(ts, backend="separable")
    top.sep_mode = "stencil"
    want = np.asarray(jop.vmult(jnp.asarray(u)))
    np.testing.assert_allclose(top.vmult(torch.as_tensor(u)).numpy(), want, rtol=1e-12, atol=1e-12)
