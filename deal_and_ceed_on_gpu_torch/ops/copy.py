"""K6, the window-shaped copy probe: CUDA wrapper and plain version.

Counterpart of ``copy_kernel`` in ``scripts/exp_solver_budget.py`` (the
JAX package's solver-budget experiment): ``dst = 2 src`` on a ``[nz, ny,
nx]`` grid, read with K1's and K5's tiling (each block reads its tile plus
the y/x halo of width ``halo``, the degree, and writes only its tile), so
its time is the bandwidth ceiling of a kernel tiled like them.
``copy_probe`` launches the CUDA kernel (``csrc/copy.cu``) for a CUDA tensor
and computes ``2 * src`` for a CPU tensor; ``LAUNCHES`` counts kernel
launches. The library call that computes the same function is
``torch.mul(src, 2, out=dst)``; the port never calls it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "SOURCE", "copy_probe", "copy_reference"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "copy.cu"
MAX_HALO = 8

# kernel launches made by copy_probe (a run resets it to 0 to count its own)
LAUNCHES = 0

_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}


def copy_reference(src: torch.Tensor) -> torch.Tensor:
    """The plain version of K6."""
    return 2 * src


def _launcher():
    from ..utils.cuda_build import load_library

    fn = load_library(SOURCE).copy_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def copy_probe(src: torch.Tensor, halo: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """``2 * src`` for a contiguous ``[nz, ny, nx]`` tensor (f64, f32 or
    bf16), read with a halo of ``halo`` (0..8) rows and columns; into
    ``out`` if given (it must not overlap ``src``)."""
    global LAUNCHES
    code = _DTYPE_CODES.get(src.dtype)
    if code is None or src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"copy probe: want a contiguous 3D f64/f32/bf16 grid, got {src.dtype} {tuple(src.shape)}")
    if not 0 <= halo <= MAX_HALO:
        raise ValueError(f"copy probe: halo {halo} outside 0..{MAX_HALO}")
    if out is None:
        out = torch.empty_like(src)
    elif out.shape != src.shape or out.dtype != src.dtype or out.device != src.device or not out.is_contiguous():
        raise ValueError("copy probe: out must match src")
    if src.device.type == "cpu":
        return out.copy_(copy_reference(src))
    if src.device.type != "cuda":
        raise ValueError(f"copy probe: unsupported device {src.device}")
    if out.data_ptr() == src.data_ptr():
        raise ValueError("copy probe: out aliases src (other blocks read the halo)")
    nz, ny, nx = src.shape
    with torch.cuda.device(src.device):
        rc = _launcher()(code, halo, src.data_ptr(), out.data_ptr(), nz, ny, nx,
                         torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"copy kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
