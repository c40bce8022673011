"""The AMR loop of the port (adaptive.py: estimate_gradient_recovery,
mark_doerfler, evaluate_at_points, amr_loop; drivers/amr.py) against the JAX
package's, on the cases of tests/test_amr.py: the marked sets identical,
ties included; the estimator to 1e-12; the loop's history (cells, DoFs,
iterations, estimate) with precond none, mg and mg-ir on a 2^3 base over
two steps; the driver's CLI on the CPU against chip_smoke.py's AMR golden.

``PYTHONPATH=. python tests/test_torch_amr.py goldens`` prints chip_smoke.py's
ADAPTIVE_GOLDEN (ball rounds 2 and 3: cells, DoFs, hanging DoFs, |A u|_2 of
the seeded vector, MG-CG iterations, |x|_2) and AMR_GOLDEN (drivers.amr at
its defaults with --precond none, mg, mg-ir: per step cells, DoFs,
iterations, estimate), computed with the JAX package on the CPU under x64
(about 75 s on an 8-core CPU)."""

import re
import sys

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch import adaptive as ta
from deal_and_ceed_on_gpu_torch.drivers import amr as amr_t

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu import adaptive as ja
except ImportError:  # the card's machine has no jax
    jnp = None

CENTER = np.array([0.8, 0.8, 0.8])


def _f_peak(x):
    """Sharp localized source near CENTER (tests/test_amr.py)."""
    return np.exp(-((x - CENTER) ** 2).sum(axis=-1) / 0.01)


def test_mark_doerfler_same_set_as_jax_ties_included():
    """The JAX test's bulk sets, exact ties (a symmetric mesh's indicators),
    ties within last-bit noise (1e-15 relative) and non-finite entries:
    the port marks the very cells JAX marks."""
    cases = [(np.array([3.0, 1.0, 0.1, 2.0]), 0.6), (np.array([3.0, 1.0, 0.1, 2.0]), 0.9)]
    rng = np.random.default_rng(0)
    base = rng.random(40)
    tied = np.repeat(base[:10], 8)  # 8-fold exact ties
    noisy = tied * (1.0 + 1e-15 * rng.standard_normal(tied.size))
    cases += [(tied, 0.5), (noisy, 0.5), (noisy, 0.3), (base, 0.7)]
    bad = base.copy()
    bad[[3, 17]] = [np.nan, np.inf]
    cases += [(bad, 0.5)]
    for eta, theta in cases:
        assert np.array_equal(ta.mark_doerfler(eta, theta), ja.mark_doerfler(eta, theta))
    assert set(ta.mark_doerfler(np.array([3.0, 1.0, 0.1, 2.0]), 0.9).tolist()) == {0, 3}
    # last-bit noise does not move the set
    assert np.array_equal(ta.mark_doerfler(tied, 0.5), ta.mark_doerfler(noisy, 0.5))


@pytest.mark.parametrize("backend", ["gather", "general"])
def test_estimator_matches_jax(backend):
    """The Zienkiewicz-Zhu indicators of one solution (1e-12), zero for a
    linear field; point evaluation of the solution against JAX."""
    tm = ta.AdaptiveMesh.refine(pt.BrickMesh((2, 2, 2)), (0, 5))
    jm = ja.AdaptiveMesh.refine(jx.BrickMesh((2, 2, 2)), (0, 5))
    ts, js = ta.AdaptiveSpace(tm, 2, device="cpu"), ja.AdaptiveSpace(jm, 2)
    u = np.random.default_rng(1).standard_normal(ts.n_dofs)
    op = ta.AdaptivePoissonOperator(ts, backend=backend)
    got = ta.estimate_gradient_recovery(ts, op, torch.as_tensor(u))
    want = ja.estimate_gradient_recovery(js, ja.AdaptivePoissonOperator(js), jnp.asarray(u))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    lin = torch.as_tensor(ts.node_coords @ np.array([1.0, 2.0, -0.5]) + 0.3)
    assert np.abs(ta.estimate_gradient_recovery(ts, op, lin)).max() < 1e-12
    pts = CENTER[None] * np.random.default_rng(2).random((6, 3))
    np.testing.assert_allclose(ta.evaluate_at_points(ts, torch.as_tensor(u), pts),
                               ja.evaluate_at_points(js, jnp.asarray(u), pts), rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match="outside"):
        ta.evaluate_at_points(ts, torch.as_tensor(u), np.array([[2.0, 0.5, 0.5]]))


@pytest.mark.parametrize("precond", ["none", "mg", "mg-ir"])
def test_amr_loop_history_matches_jax(precond):
    """amr_loop on a 2^3 base, two steps (the mg loop with every operator
    on K4's plain version, the others on the plain loop): cells and DoFs
    exact, iterations equal, estimates to 1e-8, the same cells refined."""
    kw = dict(f=_f_peak, n_steps=2, theta=0.5, precond=precond)
    make_op = (lambda s: ta.AdaptivePoissonOperator(s, backend="general")) if precond == "mg" else None
    got = ta.amr_loop(pt.BrickMesh((2, 2, 2)), 2, make_op=make_op, device="cpu", **kw)
    want = ja.amr_loop(jx.BrickMesh((2, 2, 2)), 2, **kw)
    for a, b in zip(got, want, strict=True):
        assert (a["n_cells"], a["n_dofs"], a["n_iterations"]) == (b["n_cells"], b["n_dofs"], b["n_iterations"])
        assert abs(a["eta"] - b["eta"]) <= 1e-8 * b["eta"]
        assert np.array_equal(a["space"].mesh.origins, b["space"].mesh.origins)
    if precond == "mg":
        assert got[-1]["space"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="precond"):
        ta.amr_loop(pt.BrickMesh((2, 2, 2)), 2, precond="jacobi", device="cpu")


def test_driver_cli_on_cpu_matches_the_golden(capsys):
    """``python -m deal_and_ceed_on_gpu_torch.drivers.amr --precond none
    --device cpu`` at its defaults prints the history table of
    chip_smoke.AMR_GOLDEN (the JAX driver's values); --write-solution names
    slice H; --device cuda without a card raises."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    amr_t.main(["--precond", "none", "--device", "cpu"])
    rows = re.findall(r"^\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\S+)$", capsys.readouterr().out, re.M)
    golden = chip_smoke.AMR_GOLDEN["none"]
    assert len(rows) == len(golden)
    for (_, cells, dofs, its, eta), (g_cells, g_dofs, g_its, g_eta) in zip(rows, golden):
        assert (int(cells), int(dofs)) == (g_cells, g_dofs) and abs(int(its) - g_its) <= 1
        assert abs(float(eta) - g_eta) <= 1e-4 * g_eta  # the table prints 5 digits
    with pytest.raises(NotImplementedError, match="slice H"):
        amr_t.main(["--device", "cpu", "--write-solution", "out.vtu"])


def test_driver_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        amr_t.run(base=2, steps=0)  # the default device is cuda


def test_bench_adaptive_on_cpu(capsys):
    """scripts/bench_adaptive at ball rounds 1 on the CPU (the host clock):
    every line, K4's plain version equal to the plain loop, the MG-CG and
    IR solves to 1e-10 with every level on the plain loop (``auto``)."""
    from deal_and_ceed_on_gpu_torch.scripts import bench_adaptive

    r = bench_adaptive.run_size(1, "cpu", n_applies=1)
    assert (r["n_cells"], r["n_dofs"], r["n_hanging"]) == (1408, 13401, 2592)
    assert r["f64"]["rel_diff"] <= 1e-12 and r["f32"]["rel_diff"] <= 1e-5
    assert set(r["f64"]["split_ms"]) == {"zero+distribute", "gather", "cell", "scatter", "condense", "whole"}
    assert r["mgcg"]["n_iterations"] <= 10 and r["mgcg"]["true_rel_res"] <= 1e-10
    assert r["ir"]["true_rel_res"] <= 1e-10
    assert "rounds=1 on cpu" in capsys.readouterr().out


# ----------------------------- goldens ----------------------------- #
def jax_adaptive_goldens():
    """chip_smoke.py's ADAPTIVE_GOLDEN and AMR_GOLDEN, with the JAX package."""
    from deal_and_ceed_on_gpu_tpu.solvers import AdaptiveMultigrid, ReductionControl, solve_cg

    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import CENTER as BALL_C
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import RADIUS

    def ball(m):
        c = m.origins + 0.5 * m.sizes
        rad = 0.5 * np.linalg.norm(m.sizes, axis=1)
        return m.refine_active(np.flatnonzero(np.abs(np.linalg.norm(c - BALL_C, axis=1) - RADIUS) <= rad))

    adaptive = {}
    for rounds in (2, 3):
        m = ja.AdaptiveMesh.from_brick(jx.BrickMesh((8, 8, 8)))
        for _ in range(rounds):
            m = ball(m)
        s = ja.AdaptiveSpace(m, 2)
        op = ja.AdaptivePoissonOperator(s)
        vn = float(jnp.linalg.norm(op.vmult(jnp.asarray(np.random.default_rng(0).standard_normal(s.n_dofs)))))
        b = ja.assemble_rhs_adaptive(s, 1.0)
        x, info = solve_cg(op.vmult, b, ReductionControl(400, tolerance=0.0, reduction=1e-10),
                           diag=AdaptiveMultigrid(s, fine_op=op).vcycle)
        adaptive[rounds] = (m.n_cells, s.n_dofs, int(s.hanging_mask_np.sum()), vn, int(info["n_iterations"]),
                            float(jnp.linalg.norm(x)))
    amr = {}
    for precond in ("none", "mg", "mg-ir"):
        h = ja.amr_loop(jx.BrickMesh((4, 4, 4)), 2, f=_f_peak, n_steps=3, theta=0.5, precond=precond,
                        dtype="float64", reduction=1e-10)
        amr[precond] = [(r["n_cells"], r["n_dofs"], r["n_iterations"], r["eta"]) for r in h]
    return {"ADAPTIVE_GOLDEN": adaptive, "AMR_GOLDEN": amr}


if __name__ == "__main__" and sys.argv[1:] == ["goldens"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for k, v in jax_adaptive_goldens().items():
        print(k, v)
