"""Adaptive (hanging-node) meshes on the card: the vmult, its split, and the
time to 1e-10 by adaptive multigrid.

Counterpart of the JAX package's ``scripts/bench_adaptive_tpu.py`` and
``scripts/profile_adaptive_vmult.py`` (``RESULTS.md`` "Adaptive
(hanging-node) workload ON SILICON"): ball-surface-refined Q2 meshes
(``ball_refine``: every active cell crossing the sphere ``|x - (0.5, 0.5,
0.5)| = 0.3`` is refined, then the 2:1 balance) from an 8^3 base, over
``rounds`` (2: 49,529 DoFs, 3: 213,041, 4: 853,585, 5: 3,394,397). Per size
it prints

- cells, DoFs and hanging DoFs, and the host set-up seconds (mesh, space,
  operator; apart from every timed number);
- the f64 and f32 chained vmult ``x <- A x / |A x0|`` (50 applies, CUDA
  events; the host clock with ``--device cpu``), on K4 (``general``) and
  on the plain torch loop (``gather``), in turns (plain, K4, K4, plain),
  and their agreement;
- one apply's split (CUDA events): zero + ``distribute``, the indexed
  gather, the cell apply (K4), the sorted scatter, ``condense``;
- the f64 MG-CG solve to 1e-10 (``AdaptiveMultigrid`` on K4 at every level)
  and IR with an f32 adaptive-MG inner solve, each with its iterations,
  true relative residual ``|b - A x| / |b|`` and fenced seconds (first and
  warm), with the multigrid set-up seconds apart.

Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.bench_adaptive [rounds
...] [--device cpu] [--no-solve]`` (default rounds 2 3 4).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..adaptive import AdaptiveMesh, AdaptivePoissonOperator, AdaptiveSpace, assemble_rhs_adaptive
from ..drivers.bp5 import resolve_device
from ..mesh import BrickMesh
from ..solvers import AdaptiveMultigrid, ReductionControl, solve_cg, solve_cg_ir
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer, cuda_time_ms

__all__ = ["ball_refine", "ball_mesh", "build", "chained_vmult_ms", "apply_split_ms", "solve_mgcg", "solve_ir",
           "run_size"]

CENTER, RADIUS = np.array([0.5, 0.5, 0.5]), 0.3
BASE = 8
DEGREE = 2
N_APPLIES = 50


def ball_refine(mesh: AdaptiveMesh) -> AdaptiveMesh:
    """Refine every active cell crossing the sphere ``|x - CENTER| = RADIUS``."""
    centers = mesh.origins + 0.5 * mesh.sizes
    rad = 0.5 * np.linalg.norm(mesh.sizes, axis=1)
    d = np.abs(np.linalg.norm(centers - CENTER, axis=1) - RADIUS)
    return mesh.refine_active(np.flatnonzero(d <= rad))


def ball_mesh(rounds: int, base: int = BASE) -> AdaptiveMesh:
    mesh = AdaptiveMesh.from_brick(BrickMesh((base,) * 3))
    for _ in range(rounds):
        mesh = ball_refine(mesh)
    return mesh


def build(mesh: AdaptiveMesh, dtype=torch.float64, device="cuda"):
    """``(space, op, seconds)``: the Q2 space and Poisson operator
    (``auto``: K4 on the card) on ``mesh``, and the host seconds they took."""
    t0 = time.perf_counter()
    space = AdaptiveSpace(mesh, DEGREE, dtype=dtype, device=device)
    op = AdaptivePoissonOperator(space)
    return space, op, time.perf_counter() - t0


def _time_ms(fn, n: int, device) -> float:
    """ms per call of ``fn``: CUDA events on the card, the host clock on
    the CPU (the test path; no device number)."""
    if device.type == "cuda":
        return cuda_time_ms(fn, n)
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e3 * (time.perf_counter() - t0) / n


def _unit(space, seed=0):
    u = space.tensor(np.random.default_rng(seed).standard_normal(space.n_dofs))
    return u / torch.linalg.vector_norm(u)


def chained_vmult_ms(op, n_applies: int = N_APPLIES):
    """ms per apply of the chain ``x <- A x / |A x0|`` from a seeded unit
    vector (CUDA events over the chain, after one warm chain); returns
    ``(ms, A x0)``."""
    u = _unit(op.space)
    v = op.vmult(u)
    inv = 1.0 / float(torch.linalg.vector_norm(v))

    def chain():
        x = u
        for _ in range(n_applies):
            x = op.vmult(x) * inv
        return x

    return _time_ms(chain, 2, op.space.device) / n_applies, v


def apply_split_ms(op, n: int = 20) -> dict:
    """One apply's parts on the card, ms each (CUDA events over ``n``
    calls): zero + distribute, the indexed gather, the cell apply, the
    sorted scatter, condense, and the whole vmult."""
    s = op.space
    u = _unit(s, seed=1)
    uz = s.distribute(u.masked_fill(s.constrained_mask, 0))
    ul = op.gather(uz)
    vl = op.cell_apply(ul)
    v = op.scatter(vl)
    parts = {
        "zero+distribute": lambda: s.distribute(u.masked_fill(s.constrained_mask, 0)),
        "gather": lambda: op.gather(uz),
        "cell": lambda: op.cell_apply(ul),
        "scatter": lambda: op.scatter(vl),
        "condense": lambda: s.condense(v),
        "whole": lambda: op.vmult(u),
    }
    return {name: _time_ms(fn, n, s.device) for name, fn in parts.items()}


def _true_rel_res(op, b, x) -> float:
    return float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b))


def solve_mgcg(op, b, mg) -> dict:
    """Plain CG with ``mg.vcycle`` to a relative residual of 1e-10, solved
    twice; the iterations, the true relative residual, ``|x|_2`` and both
    fenced wall times."""
    control = ReductionControl(400, tolerance=0.0, reduction=1e-10)
    seconds = []
    for _ in range(2):
        t = Timer().start()
        x, info = solve_cg(op.vmult, b, control, diag=mg.vcycle)
        t.stop(fence=x)
        seconds.append(t.elapsed)
    return {"n_iterations": int(info["n_iterations"]), "true_rel_res": _true_rel_res(op, b, x),
            "x_norm": float(torch.linalg.vector_norm(x)), "solve_s": seconds, "x": x}


def solve_ir(op64, b, op32, mg32) -> dict:
    """Iterative refinement to a true relative residual of 1e-10 (f64
    residuals, f32 CG with the f32 adaptive V-cycle inside), solved twice,
    as :func:`solve_mgcg`."""
    seconds = []
    for _ in range(2):
        t = Timer().start()
        x, info = solve_cg_ir(op32, op64, b, rtol=1e-10, diag32=mg32.vcycle)
        t.stop(fence=x)
        seconds.append(t.elapsed)
    return {"n_iterations": (int(info["n_outer"]), int(info["n_inner"])), "true_rel_res": _true_rel_res(op64, b, x),
            "x_norm": float(torch.linalg.vector_norm(x)), "solve_s": seconds, "x": x}


def _setup_line(setup_s: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in setup_s.items())


def run_size(rounds: int, device="cuda", n_applies: int = N_APPLIES, solve: bool = True) -> dict:
    """Every line of one ball-refined size; returns its numbers."""
    out = {}
    t0 = time.perf_counter()
    mesh = ball_mesh(rounds)
    t_mesh = time.perf_counter() - t0
    space, op, t_space = build(mesh, torch.float64, device)
    n = space.n_dofs
    n_hang = int(space.hanging_mask_np.sum())
    pcout(f"rounds={rounds} on {space.device}: {mesh.n_cells} cells, {n} DoFs, {n_hang} hanging, "
          f"{int(mesh.levels.max())} levels; set-up: mesh {t_mesh:.3f} s, f64 space + operator {t_space:.3f} s")
    out.update(n_cells=mesh.n_cells, n_dofs=n, n_hanging=n_hang, setup_s={"mesh": t_mesh, "space64": t_space})

    spaces = {"f64": space}
    t0 = time.perf_counter()
    spaces["f32"] = AdaptiveSpace(mesh, DEGREE, dtype=torch.float32, device=device)
    out["setup_s"]["space32"] = time.perf_counter() - t0
    for label, s in spaces.items():
        plain = AdaptivePoissonOperator(s, backend="gather")
        k4 = AdaptivePoissonOperator(s, backend="general")
        ms = {"gather": [], "general": []}
        outs = {}
        for o in (plain, k4, k4, plain):  # in turns
            t, v = chained_vmult_ms(o, n_applies)
            ms[o.backend].append(t)
            outs[o.backend] = v
        rel = float((outs["general"] - outs["gather"]).abs().max() / outs["gather"].abs().max())
        pcout(f"  {label} vmult: K4 {ms['general'][0]:.4f} / {ms['general'][1]:.4f} ms an apply "
              f"({n / min(ms['general']) / 1e6:.3f} GDoF/s), plain {ms['gather'][0]:.4f} / {ms['gather'][1]:.4f} ms "
              f"({n / min(ms['gather']) / 1e6:.3f} GDoF/s), in turns; max rel diff {rel:.2e}")
        split = apply_split_ms(k4)
        pcout(f"  {label} one apply on K4, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        out[label] = {"vmult_ms": ms, "rel_diff": rel, "split_ms": split}

    if solve:
        b = assemble_rhs_adaptive(space, 1.0)
        mg = AdaptiveMultigrid(space, fine_op=op)
        r = solve_mgcg(op, b, mg)
        pcout(f"  f64 MG-CG: {r['n_iterations']} its, true rel res {r['true_rel_res']:.3e}, solve "
              f"{r['solve_s'][0]:.4f} s (first) / {r['solve_s'][1]:.4f} s (warm); MG set-up {_setup_line(mg.setup_s)}; "
              f"levels {[o.backend for o in mg.ops]}, E {[s.mesh.n_cells for s in mg.spaces]}")
        out["mgcg"] = {**r, "setup_s": dict(mg.setup_s)}
        s32 = spaces["f32"]
        op32 = AdaptivePoissonOperator(s32)
        # the Poisson coarse matrix is the same host f64 matrix at both precisions
        mg32 = AdaptiveMultigrid(s32, fine_op=op32, coarse_inv=mg.coarse_inv_np)
        r = solve_ir(op, b, op32, mg32)
        pcout(f"  f32 MG-IR: {r['n_iterations'][0]} outer / {r['n_iterations'][1]} inner, true rel res "
              f"{r['true_rel_res']:.3e}, solve {r['solve_s'][0]:.4f} s (first) / {r['solve_s'][1]:.4f} s (warm); "
              f"f32 MG set-up {_setup_line(mg32.setup_s)}")
        out["ir"] = {**r, "setup_s": dict(mg32.setup_s)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="adaptive vmult and MG solves (PyTorch + CUDA)")
    ap.add_argument("rounds", type=int, nargs="*", default=[2, 3, 4])
    ap.add_argument("--applies", type=int, default=N_APPLIES)
    ap.add_argument("--no-solve", action="store_true", help="vmult lines only")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        pcout(f"card: {card[0] if card else torch.cuda.get_device_name(dev)}")
    for rounds in args.rounds:
        run_size(rounds, dev, args.applies, solve=not args.no_solve)


if __name__ == "__main__":
    main()
