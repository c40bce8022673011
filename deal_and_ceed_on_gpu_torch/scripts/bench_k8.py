"""K8 and the pcg-merged iteration of one checkout of the port, for turns
between two checkouts (a change and its parent) in one run on one card.

For the checkout at ``--root`` (default: the one holding this file), in f64,
f32 and f32 with bf16 vectors:

- K8 at BP5 cycle 33's length (12,468,001 points, identity diagonal, no
  weight) as that checkout's solver calls it: on a ``DotsWorkspace`` where
  the checkout has one, else allocating its summary each call (K8 and its
  finisher). Two times a call: the card's (CUDA events around a chain of
  ``--chain`` calls that the host queued while the card was held, this
  file's own ``utils/timer.cuda_time_ms``, best of 3) and the host's (an
  unsynchronised chain, best of 3); the bound (3 vectors read once at 3.35
  TB/s);
- ``exp_solver_budget``'s line (h): ms an iteration of ``solve_cg_merged``
  on K1 (stencil backend, the operator scaled to spectral radius ~1) over
  ``--iterations`` fixed iterations, best of 3 fenced solves, at each of
  ``--cycles``.

Prints one JSON line (also written to ``--json``), with the card's name and
power limit. Run it by path, once a checkout, in turns:

    python deal_and_ceed_on_gpu_torch/scripts/bench_k8.py --root <checkout> \\
        [--cycles 20,30,33] [--chain 50] [--iterations 100] [--json out.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
DEGREE, K8_CYCLE, HBM_BYTES_PER_S = 5, 33, 3.35e12


def _timer():
    """This checkout's ``utils/timer.py``, whichever checkout is timed."""
    spec = importlib.util.spec_from_file_location("_bench_k8_timer", HERE.parents[1] / "utils" / "timer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description="K8 and pcg-merged of one checkout of the port, for turns")
    ap.add_argument("--root", default=str(HERE.parents[2]), help="the checkout whose package is timed")
    ap.add_argument("--cycles", default="20,30,33", help="BP5 cycles of line (h)")
    ap.add_argument("--chain", type=int, default=50, help="K8 calls a timed chain")
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

    def fenced(fn):
        fn()
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    record = {"root": str(root), "workspace": hasattr(cm, "DotsWorkspace"), "k8": {}, "h": {}}
    n = pt.BrickMesh.bp5_cycle(K8_CYCLE).n_dofs(DEGREE)
    for label, (cd, sd) in precisions.items():
        rng = np.random.default_rng(33)
        d, g, h = (torch.as_tensor(rng.standard_normal(n), dtype=cd, device=device).to(sd) for _ in range(3))
        if record["workspace"]:
            ws = cm.DotsWorkspace(cd, device)

            def k8():
                cm.merged_dots(d, g, h, None, None, cd, workspace=ws)
        else:

            def k8():
                cm.merged_dots(d, g, h, None, None, cd)

        host = host_per_call(k8, args.chain)
        card = min(timer.cuda_time_ms(k8, args.chain, hold_s=2 * args.chain * host + 1e-3) for _ in range(3))
        record["k8"][label] = {"ms": card, "host_ms": 1e3 * host,
                               "bound_ms": 1e3 * 3 * n * d.element_size() / HBM_BYTES_PER_S}
        del d, g, h
    for cycle in (int(c) for c in args.cycles.split(",")):
        record["h"][cycle] = {}
        for label, (cd, sd) in precisions.items():
            space = pt.FESpace.create(pt.BrickMesh.bp5_cycle(cycle), DEGREE, dtype=cd, device=device)
            op = pt.PoissonOperator(space, backend="stencil", stream_dtype=sd)
            op.fold_scale(1.0 / estimate_lambda_max(op, space.n_dofs))
            u0 = np.random.default_rng(0).standard_normal(space.n_dofs)
            u = torch.as_tensor(u0 / np.linalg.norm(u0), dtype=cd, device=device).to(sd)
            control = pt.IterationNumberControl(args.iterations, 0.0)
            dot_dtype = cd if sd != cd else None
            t = fenced(lambda: pt.solve_cg_merged(op.vmult, u, control, dot_dtype=dot_dtype))
            record["h"][cycle][label] = 1e3 * t / args.iterations
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
