"""Tracing and profiling utilities (reference aux subsystem: the
nvprof/NVVP workflow of its README.md:50-88, ``-lineinfo`` builds, Timer +
cudaDeviceSynchronize fencing).

Counterpart of ``deal_and_ceed_on_gpu_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and, where a card is present, CUDA activities) that exports a Chrome
  trace (``chrome://tracing``, Perfetto) into its log directory, the
  counterpart of the JAX package's xplane trace;
- :func:`busy_profile`: a solve run under :func:`trace`, printing its wall
  time, the device's busy time and share, and its costliest kernels;
- :func:`op_stats`: wall-clock numbers of a callable, fenced with
  ``torch.cuda.synchronize`` on its output's device (nothing to fence on
  the CPU);
- :func:`roofline`: the bandwidth and compute bounds of one BP5 apply.

The card's rates (``HBM_BYTES_PER_S``, ``PEAK_FLOPS``) are the NVIDIA H100
80GB HBM3 data sheet's at its 700 W power limit; a card set below it runs
slower under load. ``chip_smoke.py`` computes its bounds from them.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable

import torch

__all__ = ["CARD_RATES", "HBM_BYTES_PER_S", "PEAK_FLOPS", "TRACE_DIR", "busy_profile", "op_stats", "roofline",
           "trace"]

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM 3.35 TB/s; f64 67
# TFLOP/s (its tensor cores; 34 outside them), f32 67 TFLOP/s outside the
# tensor cores (what an exact f32 computation can use); a bf16-streaming
# apply computes in f32
CARD_RATES = "NVIDIA H100 80GB HBM3, 700 W (data sheet)"
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 67e12, "f32": 67e12, "bf16": 67e12}
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"


@contextlib.contextmanager
def trace(logdir=TRACE_DIR, name: str = "trace"):
    """Profile the block: ``with trace("build/t") as prof: f(x)``. Yields the
    ``torch.profiler.profile`` (``prof.key_averages()`` after the block);
    on exit writes the Chrome trace to ``<logdir>/<name>.json`` and sets
    ``prof.trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = logdir / f"{name}.json"
    prof.export_chrome_trace(str(prof.trace_path))


def _sync_all() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def busy_profile(tag: str, n_it: int, solve: Callable, repeats: int = 1, logdir=TRACE_DIR):
    """Run ``solve`` once to warm up, then ``repeats`` times under
    :func:`trace`; print each run's wall time, the device's busy time and
    share (and their ranges over the runs), and the device time per
    iteration (``n_it`` iterations a run) of the last run's eight costliest
    kernels. Returns ``[(wall s, busy s), ...]``."""
    from torch.autograd import DeviceType

    solve()
    _sync_all()
    readings = []
    head = tag.split(":")[0]
    for k in range(repeats):
        with trace(logdir, f"{head.replace(' ', '_')}_{os.getpid()}_{k}") as prof:
            t0 = time.perf_counter()
            solve()
            _sync_all()
            wall = time.perf_counter() - t0
        # device-side events only (the CPU ops that launched them carry the
        # same device time again)
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(t for _, t, _ in rows) / 1e6
        readings.append((wall, busy))
        print(f"{tag} under the profiler: wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms (busy share "
              f"{busy / wall:.3f}; the profiler's own host cost makes the idle share an upper bound)")
    if repeats > 1:
        shares = [b / w for w, b in readings]
        print(f"{head}: over {repeats} profiles: wall {min(w for w, _ in readings) * 1e3:.3f}-"
              f"{max(w for w, _ in readings) * 1e3:.3f} ms, device busy {min(b for _, b in readings) * 1e3:.3f}-"
              f"{max(b for _, b in readings) * 1e3:.3f} ms, busy share {min(shares):.3f}-{max(shares):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"{head}:   {t / 1e3 / n_it:8.4f} ms/iteration  {n:5d} calls  {key[:90]}")
    return readings


def _fence(out) -> None:
    """Wait for the device of the first tensor in ``out`` (nothing to wait
    for on the CPU)."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for t in items:
        if isinstance(t, torch.Tensor):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            return


def op_stats(fn: Callable, *args, n_warmup=2, n_iter=10, work_items=None):
    """Time ``fn(*args)`` with fencing; returns ``best_s``, ``mean_s``,
    ``n_iter`` and, with ``work_items``, ``items_per_s`` (at the best)."""
    out = None
    for _ in range(n_warmup):
        out = fn(*args)
    _fence(out)
    times = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        out = fn(*args)
        _fence(out)
        times.append(time.perf_counter() - t0)
    best = min(times)
    stats = {"best_s": best, "mean_s": sum(times) / len(times), "n_iter": n_iter}
    if work_items:
        stats["items_per_s"] = work_items / best
    return stats


def roofline(n_dofs, degree, dtype_bytes=4, hbm_gbps=HBM_BYTES_PER_S / 1e9, flops_tps=PEAK_FLOPS["f32"] / 1e12):
    """Bounds of one BP5 operator apply on the stencil / separable paths, in
    GDoF/s: ideal traffic = one read and one write of the nodal grid; FLOPs
    = three banded 1D sweeps (2 (2p+1) each). The defaults are the card's
    data-sheet rates (``CARD_RATES``)."""
    traffic = 2 * n_dofs * dtype_bytes
    flops = 6 * (2 * degree + 1) * n_dofs
    return {
        "bandwidth_bound_gdofs": n_dofs / (traffic / (hbm_gbps * 1e9)) / 1e9,
        "compute_bound_gdofs": n_dofs / (flops / (flops_tps * 1e12)) / 1e9,
    }
