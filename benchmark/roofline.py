"""Peaks of one NVIDIA H100 80GB HBM3 and the least time of a kernel's work.

The rates are the data sheet's (SXM part, 700 W): HBM 3.35 TB/s; the
CUDA cores' 34 TFLOP/s in float64 and 67 TFLOP/s in float32 (the port's
kernels are FMAs on the CUDA cores, not tensor-core products; a kernel
that streams bfloat16 computes in float32). A card set below 700 W runs
slower under load: the run prints its power limit beside the shares.

Each kernel's work is counted in its own file under ``kernels/``, named by
its label (``K1.py``, ...): ``MATCH``, the substring of the device kernel's
name that identifies it in a profiler trace, and ``bound_s(ctx, calls,
units)``, the least time of ``calls`` launches in ``units`` solves or
chains of a cell, from the bytes it must move (each input read once, each
output written once) and its operations, whichever takes longer.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "bound_s", "kernel"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
KERNEL_DIR = Path(__file__).resolve().parent / "kernels"


def bound_s(n_bytes: float, flops: float, compute: str) -> float:
    """The least seconds for ``n_bytes`` of HBM traffic and ``flops``
    operations at ``compute``'s peak: the larger of the two."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[compute])


@functools.cache
def kernel(label: str):
    """The module ``kernels/<label>.py``."""
    path = KERNEL_DIR / f"{label}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_kernel_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
