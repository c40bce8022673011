"""BP5 benchmark driver: mesh-size sweep, four benchmark modes, validation.

Counterpart of ``deal_and_ceed_on_gpu_tpu/drivers/bp5.py`` and of the
reference's ``PoissonProblem`` driver (``bp5/step-64.cu:280-679``). Output
lines match the reference format so result tables are comparable:

    pcg-standard <dofs/rank> <max_throughput>
    pcg-merged   <dofs/rank> <max_throughput>
    vmult        <dofs/rank> <max_throughput>
    pcg-fused    <dofs/rank> <max_throughput>   (K5, --backend stencil only)
    fdm-direct   <dofs/rank> <dofs / best solve time>
    pcg-ir       <dofs/rank> <max_throughput over inner iterations>
    pcg-mg       <dofs/rank> <max_throughput>

Throughput = DoFs * iterations / wall_time, max over repetitions
(``bp5/step-64.cu:458-463``); timing fences with ``torch.cuda.synchronize``.

Backends: ``stencil`` (K1), ``banded`` (K2), ``qgrid`` (K3), ``general``
(K4), and the plain torch ``separable``, ``structured`` and ``gather`` (the
indexed ``local_to_global`` transfer with the deterministic sorted scatter).

The vmult mode chains ``v <- A v`` with ``1/lambda_est`` folded into the
operator tables (``fold_scale``), so every step is one pure apply and f32
cannot overflow across the chain.

Beyond the reference: ``fdm-direct`` is the fast-diagonalization direct
solve (``solvers/fdm.py``, one apply), ``pcg-ir`` mixed-precision iterative
refinement to a true f64 relative residual of 1e-10 (``solvers/ir.py``,
``--dtype float64``: f32 inner merged CG on the same backend, with
``--stream-dtype bfloat16`` passed to the f32 operator; the f64 operator
runs on the same backend, the card's kernels being native f64), and
``pcg-mg`` plain CG with the geometric multigrid V-cycle
(``solvers/multigrid.py``) whose levels are built on the driver's backend.

``--device`` defaults to ``cuda`` and raises when no card is present: the
driver never drops to the CPU silently. ``--device cpu`` runs the plain
torch versions of the kernels (the test path).

Run: ``python -m deal_and_ceed_on_gpu_torch.drivers.bp5 --cycle-min 10
--cycle-max 12 --dtype float32 --backend stencil``; ``--modes
fdm-direct,pcg-ir,pcg-mg --dtype float64`` for the extra solvers.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import PoissonOperator, assemble_rhs, l2_norm_function
from ..solvers import (
    FDMSolver,
    IterationNumberControl,
    Multigrid,
    solve_cg,
    solve_cg_fused,
    solve_cg_ir,
    solve_cg_merged,
)
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer

__all__ = ["BP5Config", "run_cycle", "run", "main", "DEFAULT_MODES", "PORTED_MODES", "BACKENDS", "resolve_device"]

# the JAX driver's default modes (drivers/bp5.py BP5Config.modes)
DEFAULT_MODES = ("pcg-standard", "pcg-merged", "vmult")
# every mode of the JAX driver
PORTED_MODES = DEFAULT_MODES + ("pcg-fused", "fdm-direct", "pcg-ir", "pcg-mg")
# stencil: K1; banded: K2; qgrid: K3; general: K4; separable / structured /
# gather: plain torch
BACKENDS = ("stencil", "banded", "qgrid", "general", "separable", "structured", "gather")
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BP5Config:
    degree: int = 5
    n_iterations: int = 200
    n_repetitions: int = 10
    dtype: str = "float32"
    backend: str = "stencil"  # one of BACKENDS
    rule: str = "gauss_lobatto"  # BP5 collocation
    n_q: int | None = None
    modes: tuple = DEFAULT_MODES
    validate: bool = True
    # stream the solver vectors at this dtype ("bfloat16" halves their
    # bytes) while the apply, the dots and the recurrences run at ``dtype``
    stream_dtype: str | None = None
    device: str = "cuda"


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; the port "
            "never falls back to the CPU silently (pass --device cpu to run "
            "the plain torch versions)"
        )
    return dev


def _throughput_lines(label, n_dofs, times, iters):
    tp = [n_dofs * it / t for t, it in zip(times, iters)]
    for t, it, th in zip(times, iters, tp):
        pcout(f"   Solved in {it} iterations with time {t:.6f} and DoFs/s {th:.6g}")
    best = max(tp)
    pcout(f"{label} {n_dofs} {best:.6g}")
    pcout("")
    return best


def estimate_lambda_max(op, n_dofs, iters=12, seed=0):
    """Crude power-iteration bound on the operator spectral radius (used only
    to scale the chained vmult benchmark); the same numpy draws as the JAX
    driver."""
    s = op.space
    u = torch.as_tensor(
        np.random.default_rng(seed).standard_normal(n_dofs), dtype=s.dtype, device=s.device
    )
    u = u / torch.linalg.vector_norm(u)
    lam = torch.ones((), dtype=s.dtype, device=s.device)
    for _ in range(iters):
        # back to the probe dtype: bf16-streaming operators return bf16
        v = op.vmult(u).to(u.dtype)
        lam = torch.linalg.vector_norm(v)
        u = v / lam
    return float(lam)


def _true_rel_res(op, b, x) -> float:
    """``|b - A x| / |b|`` at the compute dtype."""
    dt = op.space.dtype
    b = b.to(dt)
    return float(torch.linalg.vector_norm(b - op.vmult(x).to(dt)) / torch.linalg.vector_norm(b))


def _repeat(label, solve, cfg, n_dofs, results):
    """Warm up, then time ``cfg.n_repetitions`` solves; record the
    throughput, the last iteration count and whether x stayed finite."""
    x, info = solve()
    times, iters = [], []
    for _ in range(cfg.n_repetitions):
        t = Timer().start()
        x, info = solve()
        t.stop(fence=x)
        times.append(t.elapsed)
        iters.append(int(info["n_iterations"]))
    results[label] = _throughput_lines(label, n_dofs, times, iters)
    results["n_iterations"][label] = iters[-1]
    results["finite"][label] = bool(torch.isfinite(x).all())
    return x


def run_cycle(cycle: int, cfg: BP5Config | None = None, **overrides):
    """One BP5 cycle; ``overrides`` replace fields of ``cfg``. Returns the
    per-mode throughputs plus ``n_iterations``, ``finite`` (per mode) and
    ``l2_norm`` (when validating)."""
    cfg = dataclasses.replace(cfg or BP5Config(), **overrides)
    unknown = set(cfg.modes) - set(PORTED_MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}: expected one of {BACKENDS}")
    device = resolve_device(cfg.device)
    dtype = DTYPES[cfg.dtype]
    stream32 = None if cfg.stream_dtype is None else DTYPES[cfg.stream_dtype]
    # bf16 vectors pair with f32 compute; with --dtype float64 the streaming
    # dtype goes to pcg-ir's f32 inner operator only
    stream = stream32 if stream32 is not None and dtype == torch.float32 else dtype
    mesh = BrickMesh.bp5_cycle(cycle)
    space = FESpace.create(
        mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule, dtype=dtype, device=device
    )
    op = PoissonOperator(space, backend=cfg.backend, stream_dtype=stream)
    pcout(f"Cycle {cycle}")
    pcout(f"   Number of active cells:       {mesh.n_cells}")
    pcout(f"   Number of degrees of freedom: {space.n_dofs}")
    pcout("")

    b = assemble_rhs(space, 1.0)
    norm_b = float(torch.linalg.vector_norm(b))
    control = IterationNumberControl(cfg.n_iterations, 1e-6 * norm_b)
    # the solves run on vectors at the streaming dtype; with bf16 vectors
    # the dots and recurrences accumulate at the compute dtype (bf16 sums
    # over 10^7 entries are meaningless). diag=None is the reference's
    # identity DiagonalMatrix without streaming a ones vector.
    b_solve = b.to(stream)
    dot_dtype = dtype if stream != dtype else None
    vm = op.vmult

    results = {"n_iterations": {}, "finite": {}, "true_rel_res": {}}
    solution = None

    if "pcg-standard" in cfg.modes:
        solution = _repeat(
            "pcg-standard",
            lambda: solve_cg(vm, b_solve, control, dot_dtype=dot_dtype),
            cfg, space.n_dofs, results,
        )

    if "pcg-merged" in cfg.modes:
        solution = _repeat(
            "pcg-merged",
            lambda: solve_cg_merged(vm, b_solve, control, dot_dtype=dot_dtype),
            cfg, space.n_dofs, results,
        )

    if "pcg-fused" in cfg.modes:
        # the whole iteration (update, apply, dots) in one K5 launch
        # (ops/cg.py); K5 is built on K1's tables, so stencil only
        if cfg.backend != "stencil":
            pcout("pcg-fused requires --backend stencil — skipping")
        else:
            solution = _repeat(
                "pcg-fused", lambda: solve_cg_fused(op, b_solve, control), cfg, space.n_dofs, results
            )

    if "fdm-direct" in cfg.modes:
        # the Kronecker fast-diagonalization direct solve: one apply replaces
        # the CG loop; the throughput line counts it as one iteration
        fdm = FDMSolver(space)
        x = fdm.solve(b)
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x = fdm.solve(b)
            t.stop(fence=x)
            times.append(t.elapsed)
        rel = _true_rel_res(op, b, x)
        for t in times:
            pcout(f"   FDM direct solve in time {t:.6f} (rel res {rel:.2e})")
        best = min(times)
        pcout(f"fdm-direct {space.n_dofs} {space.n_dofs / best:.6g}")
        pcout("")
        results["fdm-direct"] = space.n_dofs / best
        results["true_rel_res"]["fdm-direct"] = rel
        results["finite"]["fdm-direct"] = bool(torch.isfinite(x).all())
        solution = x

    if "pcg-ir" in cfg.modes:
        # mixed-precision iterative refinement to a true f64 relative
        # residual of 1e-10: f32 (or bf16-streaming) merged-CG inner solves
        # on the same backend, f64 residuals
        if dtype != torch.float64:
            pcout("pcg-ir requires --dtype float64 — skipping")
        else:
            space32 = FESpace.create(
                mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule, dtype=torch.float32, device=device
            )
            op32 = PoissonOperator(space32, backend=cfg.backend, stream_dtype=stream32)
            x, info = solve_cg_ir(op32, op, b, rtol=1e-10)
            times, its = [], []
            for _ in range(cfg.n_repetitions):
                t = Timer().start()
                x, info = solve_cg_ir(op32, op, b, rtol=1e-10)
                t.stop(fence=x)
                times.append(t.elapsed)
                its.append(int(info["n_inner"]))
            for t, it in zip(times, its):
                pcout(
                    f"   IR solved to true rel. res {info['res_rel']:.2e} "
                    f"({info['n_outer']} outer / {it} inner) in {t:.6f}"
                )
            tp = [space.n_dofs * it / t for t, it in zip(times, its)]
            pcout(f"pcg-ir {space.n_dofs} {max(tp):.6g}")
            pcout("")
            results["pcg-ir"] = max(tp)
            results["n_iterations"]["pcg-ir"] = (info["n_outer"], its[-1])
            results["true_rel_res"]["pcg-ir"] = info["res_rel"]
            results["finite"]["pcg-ir"] = bool(torch.isfinite(x).all())
            solution = x

    if "pcg-mg" in cfg.modes:
        # plain CG with the geometric multigrid V-cycle, every level on the
        # driver's backend (a level the kernel cannot take raises)
        fine = op if op.stream_dtype == dtype else PoissonOperator(space, backend=cfg.backend)
        mg = Multigrid(space, make_op=lambda s: PoissonOperator(s, backend=cfg.backend), fine_op=fine)
        solution = _repeat(
            "pcg-mg",
            lambda: solve_cg(vm, b_solve, control, diag=mg.vcycle, dot_dtype=dot_dtype),
            cfg, space.n_dofs, results,
        )
        results["true_rel_res"]["pcg-mg"] = _true_rel_res(op, b, solution)

    if "vmult" in cfg.modes:
        op.fold_scale(1.0 / estimate_lambda_max(op, space.n_dofs))
        b_c = b_solve.to(dtype)
        u0 = (b_c / torch.linalg.vector_norm(b_c)).to(stream)

        def chain(u):
            for _ in range(cfg.n_iterations):
                u = vm(u)
            return u

        out = chain(u0)
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            out = chain(u0)
            t.stop(fence=out)
            times.append(t.elapsed)
        tp = [space.n_dofs * cfg.n_iterations / t for t in times]
        for t, th in zip(times, tp):
            pcout(f"   {cfg.n_iterations} mat-vecs in time {t:.6f} and DoFs/s {th:.6g}")
        results["vmult"] = max(tp)
        results["finite"]["vmult"] = bool(torch.isfinite(out).all())
        pcout(f"vmult {space.n_dofs} {max(tp):.6g}")
        pcout("")

    if cfg.validate and solution is not None:
        norm = float(l2_norm_function(space, solution.to(dtype)))
        pcout(f"   solution L2 norm: {norm:.12g}")
        results["l2_norm"] = norm
        pcout("")

    return results


def run(cycle_min=7, cycle_max=40, cfg: BP5Config | None = None):
    cfg = cfg or BP5Config()
    return {cycle: run_cycle(cycle, cfg) for cycle in range(cycle_min, cycle_max + 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description="BP5 benchmark (PyTorch + CUDA)")
    ap.add_argument("--cycle-min", type=int, default=7)
    ap.add_argument("--cycle-max", type=int, default=40)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--repetitions", type=int, default=10)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument(
        "--backend", default="stencil", choices=BACKENDS,
        help="stencil: the K1 CUDA kernel (GLL collocation, uniform brick); banded: K2; "
        "qgrid: K3 (--rule gauss); general: K4; separable / structured / gather (indexed "
        "local_to_global, sorted scatter): plain torch",
    )
    ap.add_argument("--rule", default="gauss_lobatto", choices=["gauss_lobatto", "gauss"])
    ap.add_argument(
        "--modes", default=",".join(DEFAULT_MODES),
        help=f"comma list of {', '.join(PORTED_MODES)} (pcg-ir needs --dtype float64)",
    )
    ap.add_argument(
        "--stream-dtype", default=None, choices=["bfloat16"],
        help="store the solver vectors at this dtype; the apply and the dots "
        "accumulate at --dtype",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = BP5Config(
        degree=args.degree,
        n_iterations=args.iterations,
        n_repetitions=args.repetitions,
        dtype=args.dtype,
        backend=args.backend,
        rule=args.rule,
        modes=tuple(args.modes.split(",")),
        stream_dtype=args.stream_dtype,
        device=args.device,
    )
    run(args.cycle_min, args.cycle_max, cfg)


if __name__ == "__main__":
    main()
