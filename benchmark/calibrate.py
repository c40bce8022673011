"""Readings for the check's limits: the program's numbers over many seeds and the controls'.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... --seconds 2 \\
        --control-seeds 3 --out <file.jsonl>

For each seed, one short run of the cell's own timed path at its own sizes
(``system.run``: inputs, set-up, a window of ``--seconds``, its seeded
sample) and the check's numbers against the float64 reference; then, on the
first ``--control-seeds`` seeds, each of the traffic's ``controls`` on the
same inputs (or each of ``--controls``), held to the same reference:

- ``program:<dtype>``: the program's own path at that precision (vectors and
  compute), the same timed path one precision down;
- any other name: the reference put in the program's place at that
  precision of ``reference/precision.py``.

One JSON line a seed goes to ``--out``; the limits in ``limits/<cell>.json``
are set from them (PERF.md gives the readings and each limit).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, control: str, seed: int, seconds: float, inputs: dict, samples, device):
    """The check's numbers of the control ``control`` on the inputs of ``samples``."""
    from benchmark.system import run

    if control.startswith("program:"):
        low = copy.copy(cell)
        dtype = control.split(":", 1)[1]
        low.traffic = {**cell.traffic, "vectors": dtype, "compute": dtype, "dot_dtype": None}
        _, low_samples, _, _ = run(low, seed, seconds, False, device, time.perf_counter())
        ctl = [(j, out, work) for j, out, work in low_samples]
    else:
        units = cell.kind.reference_units(cell, inputs, [j for j, _, _ in samples], device, control)
        ctl = [(j, out, work) for j, (out, work) in units.items()]
    return cell.kind.numbers(cell, ctl, inputs, device), [w for _, _, w in ctl]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--controls", default="", help="comma-separated controls (default: the traffic's)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.system import load_cell, run

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = args.controls.split(",") if args.controls else cell.traffic["controls"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        data, samples, inputs, peak = run(cell, seed, args.seconds, False, device, t0)
        t1 = time.perf_counter()
        row = {"cell": cell.name, "seed": seed, "units": len(data.units), "work": [u.work for u in data.units],
               "failed": data.failed, "setup_s": data.setup_s, "peak": peak,
               "program": cell.kind.numbers(cell, samples, inputs, device)}
        row["check_s"] = time.perf_counter() - t1
        del data
        if k < args.control_seeds:
            for control in controls:
                t2 = time.perf_counter()
                nums, work = control_numbers(cell, control, seed, args.seconds, inputs, samples, device)
                row[f"control {control}"] = {**nums, "work": work, "s": time.perf_counter() - t2}
        del samples, inputs
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
