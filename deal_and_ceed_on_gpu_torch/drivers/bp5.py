"""BP5 benchmark driver: mesh-size sweep, four benchmark modes, validation.

Counterpart of ``deal_and_ceed_on_gpu_tpu/drivers/bp5.py`` and of the
reference's ``PoissonProblem`` driver (``bp5/step-64.cu:280-679``). Output
lines match the reference format so result tables are comparable:

    pcg-standard <dofs/rank> <max_throughput>
    pcg-merged   <dofs/rank> <max_throughput>
    vmult        <dofs/rank> <max_throughput>
    pcg-fused    <dofs/rank> <max_throughput>   (K5, --backend stencil only)

Throughput = DoFs * iterations / wall_time, max over repetitions
(``bp5/step-64.cu:458-463``); timing fences with ``torch.cuda.synchronize``.

The vmult mode chains ``v <- A v`` with ``1/lambda_est`` folded into the
operator tables (``fold_scale``), so every step is one pure apply and f32
cannot overflow across the chain.

``--device`` defaults to ``cuda`` and raises when no card is present: the
driver never drops to the CPU silently. ``--device cpu`` runs the plain
torch versions of the kernels (the test path).

Run: ``python -m deal_and_ceed_on_gpu_torch.drivers.bp5 --cycle-min 10
--cycle-max 12 --dtype float32 --backend stencil``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import PoissonOperator, assemble_rhs, l2_norm_function
from ..solvers import IterationNumberControl, solve_cg, solve_cg_fused, solve_cg_merged
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer

__all__ = ["BP5Config", "run_cycle", "run", "main", "DEFAULT_MODES", "PORTED_MODES", "resolve_device"]

# the JAX driver's default modes (drivers/bp5.py BP5Config.modes)
DEFAULT_MODES = ("pcg-standard", "pcg-merged", "vmult")
PORTED_MODES = DEFAULT_MODES + ("pcg-fused",)
# modes of the JAX driver whose solvers or kernels the port does not have yet
NOT_PORTED_MODES = ("fdm-direct", "pcg-ir", "pcg-mg")
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BP5Config:
    degree: int = 5
    n_iterations: int = 200
    n_repetitions: int = 10
    dtype: str = "float32"
    backend: str = "stencil"  # stencil | separable | structured
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
    unknown = set(cfg.modes) - set(PORTED_MODES) - set(NOT_PORTED_MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}")
    device = resolve_device(cfg.device)
    dtype = DTYPES[cfg.dtype]
    stream = dtype if cfg.stream_dtype is None else DTYPES[cfg.stream_dtype]
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

    results = {"n_iterations": {}, "finite": {}}
    solution = None
    for mode in cfg.modes:
        if mode in NOT_PORTED_MODES:
            pcout(f"{mode}: not ported yet — skipping")

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
        "--backend", default="stencil", choices=["stencil", "separable", "structured"],
        help="stencil: the K1 CUDA kernel (GLL collocation, uniform brick); "
        "separable / structured: plain torch",
    )
    ap.add_argument(
        "--modes", default=",".join(DEFAULT_MODES),
        help=f"comma list of {', '.join(PORTED_MODES + NOT_PORTED_MODES)} "
        f"({', '.join(NOT_PORTED_MODES)} are not ported yet and print a skip line)",
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
        modes=tuple(args.modes.split(",")),
        stream_dtype=args.stream_dtype,
        device=args.device,
    )
    run(args.cycle_min, args.cycle_max, cfg)


if __name__ == "__main__":
    main()
