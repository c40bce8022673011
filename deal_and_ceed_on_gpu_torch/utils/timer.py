"""Wall-clock timing with device fencing (reference ``Timer`` +
``cudaDeviceSynchronize``, ``bp5/step-64.cu:442-457``): PyTorch returns
before the card finishes, so ``stop`` synchronises the device of the fenced
tensors before it reads the clock. As a context manager (``with Timer() as
t:``) it synchronises the current CUDA device, when CUDA is initialised,
on exit. ``cuda_time_ms`` times a callable on the card with CUDA events."""

from __future__ import annotations

import time

import torch

__all__ = ["Timer", "cuda_time_ms"]


class Timer:
    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence=None):
        """Stop the clock; ``fence``: a tensor or tensors whose CUDA device
        is synchronised first."""
        tensors = () if fence is None else (fence,) if torch.is_tensor(fence) else fence
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.stop()
        return False


def cuda_time_ms(fn, n: int = 20, hold_s: float = 0.0) -> float:
    """Mean ms of ``fn`` on the current CUDA stream over ``n`` calls after
    one warm-up, between two CUDA events. With ``hold_s`` the card first
    spins for that long (``torch.cuda._sleep``, counted at 2 GHz, the H100's
    top clock) while the host queues the n calls, so the events time the
    card alone where the host enqueues slower than the card runs."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold_s > 0:
        torch.cuda._sleep(int(hold_s * 2e9))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n
