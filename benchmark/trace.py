"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` over whole
solves or chains inside the window, read in memory (nothing is exported).

``Stretch.read`` turns the profiler's events into what the per-layer readers
take: the device's busy seconds (the union of its kernels', copies' and
fills' intervals), the launches and device seconds of each kernel of the
cell's own path (``kernels/<label>.py``'s ``MATCH``, for the cell's labels
only), the costliest device operations,
and the device's idle gaps by what the host was doing meanwhile (the
innermost host event that spans the gap's middle).

The profiler's own start-up stays out of the stretch: it runs a warm-up
step (the profiler on, nothing kept) over one operator apply, and records
from the next step on.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from . import roofline

__all__ = ["Stretch"]


def _ns(e, what):
    """A kineto event's start or duration in ns (older releases give us)."""
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1000 * getattr(e, f"{what}_us")()


class Stretch:
    """Profiles the units run between ``start`` and ``stop``."""

    def __init__(self, device: torch.device, labels):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.device = device
        self.labels = {label: roofline.kernel(label).MATCH for label in labels}
        self.prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.wall_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, warm):
        """The profiler's warm-up step over ``warm()``, then recording."""
        self.prof.start()
        warm()
        self._sync()
        self.prof.step()
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def read(self) -> dict:
        """``busy_s``, ``window_s``, ``kernels`` {label: (launches, s)},
        ``device_ops`` and ``idle_gaps`` (lists of [name, s], at most 10,
        largest first)."""
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((start, start + dur, e.name()))
            elif not e.name().startswith("ProfilerStep#"):  # the schedule's step spans the whole stretch
                host.append((start, start + dur, e.name()))
        # a host annotation (record_function) comes back on the device's
        # timeline too, spanning the kernels it launched: not an operation
        annotations = {h[2] for h in host} | {d[2] for d in dev if d[2].startswith("ProfilerStep#")}
        dev = sorted(d for d in dev if d[2] not in annotations)
        by_label = defaultdict(lambda: [0, 0.0])
        by_op = defaultdict(float)
        for s, t, name in dev:
            label = next((k for k, m in self.labels.items() if m in name), None)
            if label is not None:
                by_label[label][0] += 1
                by_label[label][1] += (t - s) / 1e9
            by_op[f"{label} {name}"[:120] if label else name[:120]] += (t - s) / 1e9
        # busy: the union of the device's intervals; gaps: what lies between
        busy_ns, gaps, end = 0, [], None
        for s, t, _ in dev:
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy_ns += t - s
                end = t
            elif t > end:
                busy_ns += t - end
                end = t
        host.sort()
        starts = [h[0] for h in host]
        by_host = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            # the latest-starting host event still running at the middle
            name = next((host[j][2] for j in range(i - 1, max(i - 200, 0) - 1, -1) if host[j][1] >= mid),
                        "host code outside traced calls")
            by_host[name] += (b - a) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {
            "busy_s": busy_ns / 1e9,
            "window_s": self.wall_s,
            "kernels": {k: tuple(v) for k, v in by_label.items()},
            "device_ops": top(by_op),
            "idle_gaps": top(by_host),
        }
