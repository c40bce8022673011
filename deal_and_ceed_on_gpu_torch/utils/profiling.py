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
- :func:`roofline`: the bandwidth and compute bounds of one BP5 apply;
- the program's own spans and counters: :func:`span`, :func:`count`,
  :func:`recorded`, :func:`reset`, :func:`record`.

Spans and counters record only while a ``torch.profiler`` records (not in
its warm-up step) or inside :func:`record`. Off, ``span`` returns one
shared no-op context and reads no clock; on, a span keeps its calls, total
and self nanoseconds (total less what its child spans cover) and its parent
span from ``time.perf_counter_ns``, and under a profiler it is also a
record function (``HOST_EVENT``), so its name is a host event on the
profiler's clock beside the device's activity. The recorder is the
process's, for one thread: the solver's.

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
import torch.autograd.profiler as _autograd_profiler

__all__ = ["CARD_RATES", "HBM_BYTES_PER_S", "PEAK_FLOPS", "TRACE_DIR", "busy_profile", "count", "record",
           "recorded", "reset", "roofline", "span", "trace"]

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM 3.35 TB/s; f64 34 TFLOP/s
# outside the tensor cores (the port's kernels run on the CUDA cores; the
# tensor cores' 67 is out of their reach), f32 67 TFLOP/s outside the
# tensor cores (what an exact f32 computation can use); a bf16-streaming
# apply computes in f32
CARD_RATES = "NVIDIA H100 80GB HBM3, 700 W (data sheet)"
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12, "bf16": 67e12}
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


# ------------------------------------------------------------ spans, counters
class _Recorder:
    """The spans' aggregates by name (``[calls, total ns, self ns,
    parent]``), the counters, the open spans innermost last, and how many
    :func:`record` blocks are open."""

    def __init__(self):
        self.spans: dict[str, list] = {}
        self.counts: dict[str, int] = {}
        self.open: list[_Span] = []
        self.forced = 0


_REC = _Recorder()
_OFF = contextlib.nullcontext()
# the profiler's host event of a span: PyTorch's C++ record function costs a span 1-2 us under a
# profiler, ``torch.profiler.record_function`` 12-14 us; that much between two spans of the
# critical path would take the middle of a short idle gap out of both
HOST_EVENT = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("name", "fn", "parent", "child_ns", "t0")

    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn

    def __enter__(self):
        # the host event first and closed last: the bookkeeping stays inside it, out of the
        # stretch between two spans, where the middle of a short idle gap may fall
        if self.fn is not None:
            self.fn.__enter__()
        self.parent = _REC.open[-1].name if _REC.open else None
        self.child_ns = 0
        _REC.open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        try:
            # drop self, and any span above it that was left open
            while _REC.open and _REC.open.pop() is not self:
                pass
            if _REC.open:
                _REC.open[-1].child_ns += dt
            agg = _REC.spans.get(self.name)
            if agg is None:
                agg = _REC.spans[self.name] = [0, 0, 0, self.parent]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child_ns
        finally:
            if self.fn is not None:
                self.fn.__exit__(*exc)
        return False


def span(name: str):
    """``with span("cg.update"): ...``: a span of the program's host time,
    under a profiler also its host event (``HOST_EVENT``). Off (no profiler
    recording, no :func:`record` open) it is one shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, HOST_EVENT(name))
    if _REC.forced:
        return _Span(name, None)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, under the spans' gate."""
    if _autograd_profiler._is_profiler_enabled or _REC.forced:
        _REC.counts[name] = _REC.counts.get(name, 0) + n


def recorded() -> dict:
    """``{"spans": {name: {"calls", "total_ns", "self_ns", "parent"}},
    "counts": {name: n}}`` since the last :func:`reset`. A span's parent is
    the span open around its first call (None at the top)."""
    return {
        "spans": {k: {"calls": c, "total_ns": t, "self_ns": s, "parent": p} for k, (c, t, s, p) in _REC.spans.items()},
        "counts": dict(_REC.counts),
    }


def reset() -> None:
    """Forget every span's aggregate and every counter (open spans stay open)."""
    _REC.spans.clear()
    _REC.counts.clear()


@contextlib.contextmanager
def record(on: bool = True):
    """Record spans and counters inside the block without a profiler (with
    ``on`` False the block records as it would without it)."""
    _REC.forced += bool(on)
    try:
        yield
    finally:
        _REC.forced -= bool(on)
