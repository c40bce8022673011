"""What the port's spans and counters (``utils/profiling``) cost on the host of one card, and what
recording costs a merged-CG solve there.

1. Host microseconds of one enter and exit of ``span`` off (no profiler, no ``record()``), of one
   ``count`` off, of ``span`` inside ``record()`` (the clock kept, no profiler) and of ``span`` under
   a running ``torch.profiler`` (its host event besides); the mean over 200,000 calls (20,000
   under the profiler), best of 5.
2. ``iter_ms`` of merged-CG solves of 200 iterations with ``record()`` off and on, in
   turns (off, on, on, off, ...) for ``--turns`` turns: BP5 (Q5 GLL, stencil K1, identity
   diagonal) at ``--cycle`` with bfloat16-stored float32 vectors, and step-64 (Q3 Gauss, its a(x),
   q-grid K3) at ``--refine`` in float64; each solve fenced. With ``record()`` on, the spans' host
   microseconds an iteration (self time) and ``host_syncs`` an iteration.

Prints one JSON line with the card's name and power limit:

    python -m deal_and_ceed_on_gpu_torch.scripts.bench_spans [--cycle 40] [--refine 7] [--turns 6]

(``--device cpu --cycle 3 --refine 2`` rehearses it on the CPU; its times are the CPU's.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

CALLS = 200_000  # span calls a timing of part 1
ITERATIONS = 200  # CG iterations a solve of part 2, BP5's


def _per_call_us(fn, calls: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / calls / 1e3)
    return best


def span_costs(calls: int = CALLS) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..utils import profiling

    def one_span():
        with profiling.span("cg.update"):
            pass

    out = {"span_off_us": _per_call_us(one_span, calls),
           "count_off_us": _per_call_us(lambda: profiling.count("host_syncs"), calls)}
    with profiling.record():
        out["span_record_us"] = _per_call_us(one_span, calls)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_profiler_us"] = _per_call_us(one_span, max(calls // 10, 1))
    profiling.reset()
    return out


def _problems(cycle: int, refine: int, device):
    import torch

    import deal_and_ceed_on_gpu_torch as pt

    from ..models import assemble_rhs

    bp5 = pt.FESpace.create(pt.BrickMesh.bp5_cycle(cycle), 5, dtype=torch.float32, device=device)
    op = pt.PoissonOperator(bp5, backend="stencil", stream_dtype=torch.bfloat16)
    b = assemble_rhs(bp5, 1.0).to(torch.bfloat16)
    yield f"bp5_c{cycle}_bf16", op, b, torch.float32
    del op, b, bp5
    s64 = pt.FESpace.create(pt.BrickMesh.hyper_cube().refine_global(refine), 3, rule="gauss", dtype=torch.float64,
                            device=device)
    op = pt.HelmholtzOperator(s64, backend="qgrid")
    yield f"step64_r{refine}_f64", op, assemble_rhs(s64, 1.0, backend="qgrid"), None


def solve_costs(cycle: int, refine: int, turns: int, device) -> dict:
    import torch

    import deal_and_ceed_on_gpu_torch as pt

    from ..utils import profiling

    out = {}
    for name, op, b, dot in _problems(cycle, refine, device):
        control = pt.IterationNumberControl(ITERATIONS, 0.0)

        def solve():
            t0 = time.perf_counter()
            _, info = pt.solve_cg_merged(op.vmult, b, control, dot_dtype=dot)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            control.check(info)
            return 1e3 * (time.perf_counter() - t0) / int(info["n_iterations"])

        solve()
        times = {"off": [], "on": []}
        profiling.reset()
        for k in range(turns):
            for mode in (("off", "on") if k % 2 == 0 else ("on", "off")):
                with profiling.record(mode == "on"):
                    times[mode].append(solve())
        rec = profiling.recorded()
        n_it = turns * ITERATIONS
        profiling.reset()
        off, on = statistics.median(times["off"]), statistics.median(times["on"])
        out[name] = {"iter_ms_off": times["off"], "iter_ms_on": times["on"], "median_off": off, "median_on": on,
                     "on_minus_off_us": 1e3 * (on - off),
                     "self_us_an_iteration": {k: v["self_ns"] / n_it / 1e3 for k, v in rec["spans"].items()},
                     "host_syncs_an_iteration": rec["counts"].get("host_syncs", 0) / n_it}
        del op, b
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="the cost of the port's spans and counters on the card's host")
    ap.add_argument("--cycle", type=int, default=40, help="BP5 cycle of the bf16 solves")
    ap.add_argument("--refine", type=int, default=7, help="step-64 refinement of the f64 solves")
    ap.add_argument("--turns", type=int, default=6, help="turns of (off, on) solves")
    ap.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (a rehearsal)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the costs are the card's host's")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    else:
        card = "cpu (a rehearsal: no card)"
    print(json.dumps({"card": card, "torch": torch.__version__, "spans": span_costs(),
                      "solves": solve_costs(args.cycle, args.refine, args.turns, device)}))


if __name__ == "__main__":
    main()
