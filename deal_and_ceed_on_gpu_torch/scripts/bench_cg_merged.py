"""K7, K8 and the pcg-merged iteration of one checkout of the port, for turns
between two checkouts (a change and its parent) in one run on one card.

For the checkout at ``--root`` (default: the one holding this file), in f64,
f32 and f32 with bf16 vectors, at BP5 cycle 33's length (12,468,001 points,
identity diagonal, no weight) and as that checkout's solver calls them:

- K7 in the modes ``plain`` (every iteration), ``two-step`` and ``no-x``
  (``deferred_x_update``'s even and odd iterations), on a ``DotsWorkspace``
  where the checkout's ``merged_update`` takes one (the summaries its rows),
  else without; the bound: the vectors it reads and writes once (7, 7 and 5)
  at 3.35 TB/s;
- K8 on a ``DotsWorkspace`` where the checkout has one, else allocating its
  summary each call (K8 and its finisher); the bound: 3 vectors read once.

Two times a call each: the card's (CUDA events around a chain of ``--chain``
calls that the host queued while the card was held, this file's own
``utils/timer.cuda_time_ms``, best of 3) and the host's (an unsynchronised
chain, best of 3). Then ``exp_solver_budget``'s line (h): ms an iteration of
``solve_cg_merged`` on K1 (stencil backend, the operator scaled to spectral
radius ~1) over ``--iterations`` fixed iterations, best of 3 fenced solves,
at each of ``--cycles``, and at cycle 33 again with ``deferred_x_update``.

Prints one JSON line (also written to ``--json``), with the card's name and
power limit. Run it by path, once a checkout, in turns:

    python deal_and_ceed_on_gpu_torch/scripts/bench_cg_merged.py --root <checkout> \\
        [--cycles 20,30,33] [--chain 50] [--iterations 100] [--json out.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
DEGREE, KERNEL_CYCLE, HBM_BYTES_PER_S = 5, 33, 3.35e12
# K7's modes timed, with the vectors each reads and writes once
K7_MODES = {"plain": 7, "two-step": 7, "no-x": 5}


def _timer():
    """This checkout's ``utils/timer.py``, whichever checkout is timed."""
    spec = importlib.util.spec_from_file_location("_bench_cg_merged_timer", HERE.parents[1] / "utils" / "timer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description="K7, K8 and pcg-merged of one checkout of the port, for turns")
    ap.add_argument("--root", default=str(HERE.parents[2]), help="the checkout whose package is timed")
    ap.add_argument("--cycles", default="20,30,33", help="BP5 cycles of line (h)")
    ap.add_argument("--chain", type=int, default=50, help="kernel calls a timed chain")
    ap.add_argument("--iterations", type=int, default=100, help="CG iterations of line (h)")
    ap.add_argument("--json", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import deal_and_ceed_on_gpu_torch as pt
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import estimate_lambda_max
    from deal_and_ceed_on_gpu_torch.ops import cg_merged as cm

    if not Path(pt.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {pt.__file__}, not the package of {root}: run this file by path")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the timings need the card")
    timer, device = _timer(), torch.device("cuda")
    precisions = {"f64": (torch.float64, torch.float64), "f32": (torch.float32, torch.float32),
                  "bf16": (torch.float32, torch.bfloat16)}

    def sync():
        torch.cuda.synchronize(device)

    def host_per_call(fn, n):
        fn()
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, time.perf_counter() - t0)
        sync()
        return best / n

    def times(fn, n_bytes):
        host = host_per_call(fn, args.chain)
        card = min(timer.cuda_time_ms(fn, args.chain, hold_s=2 * args.chain * host + 1e-3) for _ in range(3))
        return {"ms": card, "host_ms": 1e3 * host, "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S}

    k7_ws = "workspace" in inspect.signature(cm.merged_update).parameters
    record = {"root": str(root), "workspace": {"k7": k7_ws, "k8": hasattr(cm, "DotsWorkspace")}, "k7": {}, "k8": {},
              "h": {}, "h_deferred": {}}
    n = pt.BrickMesh.bp5_cycle(KERNEL_CYCLE).n_dofs(DEGREE)
    for label, (cd, sd) in precisions.items():
        rng = np.random.default_rng(33)
        x, g, d, h = (torch.as_tensor(rng.standard_normal(n), dtype=cd, device=device).to(sd) for _ in range(4))
        size = d.element_size()
        # K7's scalars fixed (alpha 1e-3, beta 0.5, the previous ratio 2e-3): a chain stays bounded
        values = torch.ones(cm.SUMMARY, dtype=cd, device=device)
        values[7:] = torch.tensor([1e-3, 0.5, 1.0, 2e-3], dtype=cd)
        ws = cm.DotsWorkspace(cd, device) if record["workspace"]["k8"] else None
        if k7_ws:
            scal, prev = ws.next_summary(), ws.next_summary()
            scal.copy_(values)
            prev.copy_(values)
        else:
            scal = prev = values
        record["k7"][label] = {}
        for mode, vectors in K7_MODES.items():
            kw = {"workspace": ws} if k7_ws else {}

            def k7():
                cm.merged_update(x, g, d, h, None, scal, prev, mode, **kw)

            record["k7"][label][mode] = times(k7, vectors * n * size)

        def k8():
            if ws is None:
                cm.merged_dots(d, g, h, None, None, cd)
            else:
                cm.merged_dots(d, g, h, None, None, cd, workspace=ws)

        record["k8"][label] = times(k8, 3 * n * size)
        del x, g, d, h

    def line_h(cycle, label, deferred):
        cd, sd = precisions[label]
        space = pt.FESpace.create(pt.BrickMesh.bp5_cycle(cycle), DEGREE, dtype=cd, device=device)
        op = pt.PoissonOperator(space, backend="stencil", stream_dtype=sd)
        op.fold_scale(1.0 / estimate_lambda_max(op, space.n_dofs))
        u0 = np.random.default_rng(0).standard_normal(space.n_dofs)
        u = torch.as_tensor(u0 / np.linalg.norm(u0), dtype=cd, device=device).to(sd)
        control = pt.IterationNumberControl(args.iterations, 0.0)
        dot_dtype = cd if sd != cd else None

        def solve():
            pt.solve_cg_merged(op.vmult, u, control, dot_dtype=dot_dtype, deferred_x_update=deferred)

        solve()
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            solve()
            sync()
            best = min(best, time.perf_counter() - t0)
        return 1e3 * best / args.iterations

    for cycle in (int(c) for c in args.cycles.split(",")):
        record["h"][cycle] = {label: line_h(cycle, label, False) for label in precisions}
    record["h_deferred"][KERNEL_CYCLE] = {label: line_h(KERNEL_CYCLE, label, True) for label in precisions}
    record["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True).stdout.strip()
    line = json.dumps(record)
    print(line)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    return record


if __name__ == "__main__":
    main()
