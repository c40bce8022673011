"""The slice's entry points against live JAX runs at small sizes:
step-64 --precond mg, bp5's pcg-mg and pcg-ir on every backend, and the rows
of scripts/bench_solvers_r3 (Jacobi merged CG, MG-CG, IR, IR+MG, FDM) on a
uniform cube and a sine-mapped mesh, with every multigrid level on the
kernel backend (its plain version here).

``PYTHONPATH=. python tests/test_torch_solvers_r3.py goldens`` prints the
full-size goldens of chip_smoke.py (R3_GOLDEN, STEP64_PRECOND_GOLDEN): the
JAX package's scripts/bench_solvers_r3.py rows on the cycle-26 cube and the
sine-mapped 32^3 mesh at its default backends, f64 (IR: f32 inside) under
x64 on a CPU; about 65 s and 100 s on an 8-core CPU."""

import functools
import sys

import pytest

from deal_and_ceed_on_gpu_torch.drivers import bp5 as bp5_t
from deal_and_ceed_on_gpu_torch.drivers import step64 as step64_t
from deal_and_ceed_on_gpu_torch.scripts import bench_solvers_r3 as r3

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.drivers import bp5 as bp5_j
    from deal_and_ceed_on_gpu_tpu.drivers import step64 as step64_j
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
    from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
    from deal_and_ceed_on_gpu_tpu.models import l2_norm_function as l2_j
    from deal_and_ceed_on_gpu_tpu.solvers import FDMSolver as FDMJ
    from deal_and_ceed_on_gpu_tpu.solvers import multigrid as mgj
    from deal_and_ceed_on_gpu_tpu.solvers import solve_cg_ir as ir_j
except ImportError:  # the card's machine has no jax
    jnp = None

SOLUTION_TOL = 1e-8  # solutions' L2 norms, relative


@pytest.mark.parametrize("n_refine,backend", [(2, "qgrid"), (2, "general")])
def test_step64_mg_matches_jax(n_refine, backend):
    """step-64 --precond mg (every level a HelmholtzOperator on the
    backend): the JAX driver's iterations and L2 norm (1e-10)."""
    want = step64_j.run(n_refine=n_refine, degree=3, dtype="float64", precond="mg")
    r = step64_t.run(n_refine, precond="mg", backend=backend, device="cpu")
    assert r["n_iterations"] == want["n_iterations"]
    assert abs(r["l2_norm"] - want["l2_norm"]) <= 1e-10 * want["l2_norm"]
    assert {"levels", "coarse", "smoother", "total"} <= set(r["setup_s"])


def test_chip_smoke_step64_precond_goldens_are_the_jax_package_values():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for precond, (it, l2) in chip_smoke.STEP64_PRECOND_GOLDEN.items():
        got = jax_step64(2, precond)
        assert got[0] == it and abs(got[1] - l2) <= 1e-13 * l2, precond


def test_bp5_pcg_mg_mode_matches_jax():
    """bp5 --modes pcg-mg at cycle 10 in f64 on separable: the JAX driver's
    L2 norm; on stencil (K1's plain version on every level) the same."""
    want = bp5_j.run_cycle(10, bp5_j.BP5Config(dtype="float64", backend="separable", modes=("pcg-mg",),
                                               n_repetitions=1))["l2_norm"]
    for backend in ("separable", "stencil"):
        r = bp5_t.run_cycle(10, modes=("pcg-mg",), backend=backend, device="cpu", dtype="float64", n_repetitions=1)
        assert abs(r["l2_norm"] - want) <= 1e-10 * want, backend
        assert r["finite"]["pcg-mg"] and r["n_iterations"]["pcg-mg"] <= 10


@functools.cache
def _separable_cycle10(rule):
    """bp5 cycle 10 on separable, f64: pcg-ir's L2 norm and pcg-mg's
    iterations."""
    kw = dict(backend="separable", rule=rule, device="cpu", dtype="float64", n_repetitions=1)
    return (bp5_t.run_cycle(10, modes=("pcg-ir",), **kw)["l2_norm"],
            bp5_t.run_cycle(10, modes=("pcg-mg",), **kw)["n_iterations"]["pcg-mg"])


@pytest.mark.parametrize("backend,rule", [("banded", "gauss_lobatto"), ("general", "gauss_lobatto"),
                                          ("qgrid", "gauss")])
def test_bp5_new_backends_run_the_new_modes(backend, rule):
    """bp5 --backend banded | general | qgrid with pcg-ir and pcg-mg at cycle
    10: pcg-ir the separable backend's solution (L2 norm 1e-10, an f64
    residual of 1e-10), pcg-mg its iterations and the driver's 1e-6."""
    kw = dict(rule=rule, device="cpu", dtype="float64", n_repetitions=1)
    want_l2, want_its = _separable_cycle10(rule)
    r = bp5_t.run_cycle(10, modes=("pcg-ir",), backend=backend, **kw)
    assert r["true_rel_res"]["pcg-ir"] <= 1e-10
    assert abs(r["l2_norm"] - want_l2) <= 1e-10 * want_l2
    r = bp5_t.run_cycle(10, modes=("pcg-mg",), backend=backend, **kw)
    assert r["n_iterations"]["pcg-mg"] == want_its
    assert r["true_rel_res"]["pcg-mg"] <= 1e-6 and r["finite"]["pcg-mg"]


def _jax_rows(mesh, p, with_fdm):
    """The rows of JAX's scripts/bench_solvers_r3.run_case on ``mesh``, at
    its default backends: {row: (iterations, L2 norm)}."""
    space = jx.FESpace.create(mesh, p, rule="gauss_lobatto", dtype=jnp.float64)
    backend = "structured" if mesh.is_mapped else "separable"
    op = PoissonJ(space, backend=backend)
    b = rhs_j(space, 1.0)
    control = jx.ReductionControl(2000, tolerance=0.0, reduction=1e-10)
    out = {}

    def l2(x):
        return float(l2_j(space, x))

    x, info = jx.solve_cg_merged(op.vmult, b, control, diag=op.jacobi_preconditioner())
    out["jacobi"] = (int(info["n_iterations"]), l2(x))
    mg = mgj.Multigrid(space, fine_op=op)
    x, info = jx.solve_cg(op.vmult, b, control, diag=mg.vcycle)
    out["mg"] = (int(info["n_iterations"]), l2(x))
    sp32 = jx.FESpace.create(mesh, p, rule="gauss_lobatto", dtype=jnp.float32)
    op32 = PoissonJ(sp32, backend=backend)
    x, info = ir_j(op32, op, b)
    out["ir"] = ((info["n_outer"], info["n_inner"]), l2(x))
    mg32 = mgj.Multigrid(sp32, fine_op=op32)
    # numpy float64 bounds would promote the f32 smoother to f64 under x64
    # (a TPU run has x64 off); as Python floats they keep it f32
    mg32.bounds = [tuple(float(v) for v in bd) for bd in mg32.bounds]
    x, info = ir_j(op32, op, b, diag32=mg32.vcycle, inner_max=40)
    out["ir-mg"] = ((info["n_outer"], info["n_inner"]), l2(x))
    if with_fdm:
        x = FDMJ(space).solve(b)
        out["fdm"] = (1, l2(x))
    return space.n_dofs, out


def _check_rows(got, n_dofs, want):
    """chip_smoke.py's bars (the port runs a kernel backend, JAX its plain
    one): iterations +-1 (FDM equal); IR: n_outer equal, n_inner +-2 with the
    V-cycle inside, within 5 % with Jacobi (f32 merged CG's counts on the
    later outer steps follow the last digits of the f64 residual: 167
    against 173 on the mapped 8^3 mesh, the first outer step equal); true
    residuals 1.2e-10; L2 norms to 1e-8."""
    assert got["space"].n_dofs == n_dofs
    for row, (it_g, l2_g) in want.items():
        g = got["rows"][row]
        if row.startswith("ir"):
            slack = 2 if row == "ir-mg" else max(2, 0.05 * it_g[1])
            assert g["n_iterations"][0] == it_g[0] and abs(g["n_iterations"][1] - it_g[1]) <= slack, row
        else:
            assert abs(g["n_iterations"] - it_g) <= (0 if row == "fdm" else 1), row
        assert g["true_rel_res"] <= 1.2e-10, row
        assert abs(g["l2_norm"] - l2_g) <= SOLUTION_TOL * l2_g, row


def test_bench_solvers_r3_uniform_rows_match_jax():
    """The five rows at cycle 12 (9,261 DoFs, two levels) on stencil (K1's
    plain version on every multigrid level) against the JAX script's rows
    on separable."""
    got = r3.run_uniform(12, "stencil", "cpu")
    n, want = _jax_rows(jx.BrickMesh.bp5_cycle(12), 5, True)
    _check_rows(got, n, want)
    assert got["rows"]["mg"]["level_backends"] == ["stencil"] * 2


def test_bench_solvers_r3_mapped_rows_match_jax():
    """The four rows on the sine-mapped 8^3 mesh (15,625 DoFs, two levels) on
    general (K4's plain version on every level) against the JAX script's
    rows on structured."""
    got = r3.run_case(8, "general", device="cpu", rows=("jacobi", "mg", "ir", "ir-mg"))
    n, want = _jax_rows(jx.BrickMesh((8, 8, 8)).deform(*jx.sine_map(0.05)), 3, False)
    _check_rows(got, n, want)
    assert got["rows"]["ir-mg"]["level_backends"] == ["general"] * 2
    with pytest.raises(ValueError, match="unknown row"):
        r3.run_case(4, "general", device="cpu", rows=("ilu",))


# ----------------------------- goldens ----------------------------- #
def jax_step64(n_refine, precond):
    """(iterations, L2 norm) of the JAX step-64 driver, f64, plain CG."""
    r = step64_j.run(n_refine=n_refine, degree=3, dtype="float64", precond=precond)
    return r["n_iterations"], r["l2_norm"]


def jax_r3_goldens():
    """chip_smoke.py's R3_GOLDEN and STEP64_PRECOND_GOLDEN, computed with the
    JAX package at full size."""
    uniform = _jax_rows(jx.BrickMesh.bp5_cycle(26), 5, True)
    mapped = _jax_rows(jx.BrickMesh((32, 32, 32)).deform(*jx.sine_map(0.05)), 3, False)
    step64 = {pc: jax_step64(2, pc) for pc in ("fdm", "mg")}
    return {"uniform": uniform, "mapped": mapped, "step64 refine 2": step64}


if __name__ == "__main__" and sys.argv[1:] == ["goldens"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for k, v in jax_r3_goldens().items():
        print(k, v)
