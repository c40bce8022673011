"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; ``benchmark/system.py`` says how a run goes. With ``--trace 0``
the result's metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer ones (a profiled stretch inside the window), each read by
``benchmark/metrics/<name>.py``. The check (the seeded sample of the
window's answers against the plain reference, ``benchmark/reference/``)
prints each number beside its limit as the last lines on standard error and
under the result's last key, ``checks``. The last line on standard output
is the result, one JSON object.

Exits with 2, printing no result, without a CUDA card or with fewer cards
than the cell asks for; with 3 if JAX, jaxlib, flax or the JAX package was
imported by the time the window closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "deal_and_ceed_on_gpu_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


# the perf_counter reading that stands for the process's start
T_ORIGIN = T_IMPORT - process_age_s()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, *, device=None, cell=None) -> int:
    """The run; ``device`` and ``cell`` stand in for the look for a card and
    for the cell of ``BENCHMARK.json`` (the tests drive a small cell on the
    CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.system import judge, load_cell, metric_reader, run

    cell = cell or load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"cell {cell.name} needs {chips} CUDA card(s); found {found}: no result", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    log(f"cell {cell.name}: {cell.entry['config']} x {cell.entry['traffic']}, seed {args.seed}, "
        f"{args.seconds} s, trace {args.trace}")

    data, samples, inputs, memory_peak = run(cell, args.seed, args.seconds, bool(args.trace), device, T_ORIGIN)
    kind = cell.traffic["kind"]
    works = [u.work for u in data.units]
    log(f"card: {power_limit() if on_card else 'none'}")
    log(f"window {data.window_s:.6f} s: {len(data.units)} {'solves' if kind == 'cg' else 'chains'}, "
        f"work a unit min {min(works)} max {max(works)} "
        f"mean {sum(works) / len(works):.4f}, failed {data.failed}; set-up {data.setup_s:.6f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in data.setup_parts.items())}); memory peak {memory_peak} bytes")
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        value = metric_reader(m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": chips,
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": len(data.units), "failed": data.failed, "metrics": metrics,
              "device": device_info}
    if args.trace:
        st = data.stretch
        if st is None or st["busy_s"] <= 0:
            log("the profiler recorded no device time in the traced stretch: no result")
            return 4
        device_info["busy_s"] = st["busy_s"]
        device_info["window_s"] = st["window_s"]
        result["breakdown"] = {"device_ops": st["device_ops"], "idle_gaps": st["idle_gaps"]}
        log(f"traced stretch: {data.stretch_units} units, {st['window_s']:.6f} s, device busy {st['busy_s']:.6f} s; "
            f"kernels {json.dumps(st['kernels'])}")

    # the check: the seeded sample of the window's answers against the reference
    t0 = time.perf_counter()
    checks, result["correct"] = judge(cell, cell.kind.numbers(cell, samples, inputs, device))
    result["checks"] = checks
    log(f"check: {len(samples)} sampled units of inputs {sorted(j for j, _, _ in samples)} (work "
        f"{[w for _, _, w in samples]}) against the reference in {time.perf_counter() - t0:.3f} s")
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark must not load: {', '.join(found)}: no result")
        return 3
    for name, c in checks.items():
        log(f"check {name} {c['value']:.6e} limit {c['limit']:.6e} {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
