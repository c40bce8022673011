"""Host allocator tuning for hosts where fresh pages fault in slowly.

Counterpart of ``deal_and_ceed_on_gpu_tpu/utils/host_memory.py``, with the
same behaviour. Measured there on a Firecracker VM whose memory is served
through a fault handler: fresh anonymous pages faulted in at ~25-90 MB/s
while warm pages streamed at 2-4.5 GB/s, and glibc hands every large
(above the mmap threshold) buffer back to the OS on free, so each large
numpy allocation paid the slow fault path again.

``tune_host_allocator`` raises glibc's mmap and trim thresholds so large
buffers live on the brk heap and stay resident across malloc/free cycles:
the fault cost is paid once per high-water mark. numpy's own transparent
huge page advice composes with this. No-op on non-glibc platforms. The
port calls it at import, as the JAX package does; ``chip_smoke.py`` times
the host set-up of a mapped operator with and without it.
"""

from __future__ import annotations

import ctypes
import os

__all__ = ["OPT_OUT", "tune_host_allocator"]

OPT_OUT = "DCG_TORCH_MALLOPT"  # set to 0 before import to leave glibc's thresholds alone

_done = False


def tune_host_allocator(mmap_threshold: int = 1 << 30, trim_threshold: int = 1 << 30) -> bool:
    """Idempotent; returns True if glibc accepted the thresholds.

    Process-global: raised thresholds keep freed large buffers on the brk
    heap (a heap the size of the peak stays resident for the process's
    lifetime). That is the right trade where this framework owns the
    process; an embedding application opts out by setting
    ``DCG_TORCH_MALLOPT=0`` before the import."""
    global _done
    if _done:
        return True
    if os.environ.get(OPT_OUT, "1") == "0":
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):  # not glibc
        return False
    M_MMAP_THRESHOLD, M_TRIM_THRESHOLD = -3, -1
    _done = bool(mallopt(M_MMAP_THRESHOLD, mmap_threshold)) and bool(mallopt(M_TRIM_THRESHOLD, trim_threshold))
    return _done
