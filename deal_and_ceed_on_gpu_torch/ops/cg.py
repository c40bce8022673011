"""K5, the fused merged-CG iteration: CUDA wrapper, plain torch version, state helpers.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/pallas_cg.py``: one call runs a
whole iteration of the merged CG (``SolverCGFullMerge``,
``bp5/solver.h:48-311``) in one pass over the stacked state ``s = [D, G, H,
X]`` (each ``[nz, ny, nx]`` at the storage dtype, the port's unpadded grid)
with the scalars ``scal = [alpha, beta, xa]`` (a device tensor at the
compute dtype):

    g' = g + alpha h              d' = beta d - g'   (from the unrounded g')
    h' = S (Bz + By + Bx [+ a]) S d'   inside, d' on the six faces
    x' = x + xa (d' + g')         (== x + alpha_prev d_prev)
    dots = (d'.h', h'.h', g'.h', g'.g')

with K1's tables (``ops/stencil.py``, the value term included). ``d'`` and
``g'`` are rounded to the storage dtype before the taps, the x update and
the dots use them; the dots take ``h'`` before its rounding (bf16 storage:
``pallas_cg.py:128-137,213-251``). Identity diagonal only, as in JAX.

``CGFusedStep.__call__(s, sw, scal)`` writes the new state into ``sw``,
which must not overlap ``s`` (a block's halo reads the read side while
other blocks write: the solver ping-pongs the two), and returns ``(sw,
dots)``. ``iterate`` returns ``(sw, summary)`` instead, ``summary = [dots,
alpha, beta, xa, res]`` with the scalars of the next iteration (the JAX
solver's epilogue, ``cg_next_scalars``): ``summary[4:7]`` is the next
call's ``scal``. A CUDA state launches the kernel (``csrc/cg.cu``), whose
per-block partial dots a second one-block kernel of the same source sums in
a fixed order into ``summary``; a CPU state runs the plain versions
``cg_step_reference`` and ``cg_next_scalars``. ``LAUNCHES`` counts K5
launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..solvers.cg import safe_div
from .stencil import StencilTables, _check, apply_plain

__all__ = ["D", "G", "H", "X", "LAUNCHES", "SOURCE", "CGFusedStep", "cg_next_scalars", "cg_step_reference"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cg.cu"

# stacked-state plane indices (pallas_cg.py:76)
D, G, H, X = 0, 1, 2, 3

# kernel launches made by CGFusedStep (a run resets it to 0 to count its own)
LAUNCHES = 0


def cg_step_reference(s: torch.Tensor, scal: torch.Tensor, tables: StencilTables):
    """The plain torch version of K5: the same iteration in torch ops.
    Returns ``(s_new, dots)``, ``dots`` ``[4]`` at the compute dtype."""
    _check(s[0], tables)
    cd, sd = tables.dtype, s.dtype
    alpha, beta, xa = scal.to(cd).unbind(0)
    g_new = s[G].to(cd) + alpha * s[H].to(cd)
    d_s = (beta * s[D].to(cd) - g_new).to(sd)
    g_s = g_new.to(sd)
    dc, gc = d_s.to(cd), g_s.to(cd)
    h = apply_plain(dc, tables)
    x = s[X].to(cd) + xa * (dc + gc)
    dots = torch.stack([torch.sum(dc * h), torch.sum(h * h), torch.sum(gc * h), torch.sum(gc * gc)])
    return torch.stack([d_s, g_s, h.to(sd), x.to(sd)]), dots


def cg_next_scalars(dots: torch.Tensor) -> torch.Tensor:
    """The plain version of K5's finishing pass: ``[d.h, h.h, g.h, g.g]``
    -> ``[dots, alpha, beta, xa, res]``, the scalars of the next iteration
    and the reduction-free residual ``|g + alpha h|``
    (``solvers/cg_fused.py`` of the JAX package, lines 119-143)."""
    dh, hh, gh, gg = dots.unbind(0)
    alpha = safe_div(gg, dh)
    beta = safe_div(alpha * (gh + alpha * hh), gg)
    res = torch.sqrt(torch.clamp_min(gg + 2.0 * alpha * gh + alpha * alpha * hh, 0.0))
    return torch.stack([dh, hh, gh, gg, alpha, beta, safe_div(alpha, beta), res])


_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _library():
    from ..utils.cuda_build import load_library

    lib = load_library(SOURCE)
    lib.cg_step_launch.argtypes = _ARGTYPES
    lib.cg_step_launch.restype = ctypes.c_int
    lib.cg_step_blocks.argtypes = [ctypes.c_int] * 6
    lib.cg_step_blocks.restype = ctypes.c_int
    lib.cg_finish_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.cg_finish_launch.restype = ctypes.c_int
    return lib


class CGFusedStep:
    """K5 on one operator's K1 tables (``StencilTables``, value term
    included when they carry ``a``). Single device, identity diagonal."""

    def __init__(self, tables: StencilTables):
        if tables.ident is not None:
            raise ValueError("K5 runs on one device's tables (the six faces): shard tables (ident) have none")
        self.tables = tables

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the dots' and the scalars'."""
        return self.tables.dtype

    def stack_state(self, d, g, h, x) -> torch.Tensor:
        """Four flat vectors -> one stacked state ``[4, nz, ny, nx]``."""
        return torch.stack([v.reshape(self.tables.shape) for v in (d, g, h, x)])

    def unstack(self, s: torch.Tensor, plane: int) -> torch.Tensor:
        return s[plane].reshape(-1)

    def _check(self, s, sw, scal) -> int:
        code = _check(s[0], self.tables)
        shape = (4, *self.tables.shape)
        if tuple(s.shape) != shape or tuple(sw.shape) != shape:
            raise ValueError(f"cg step: states {tuple(s.shape)} / {tuple(sw.shape)}, want {shape}")
        if sw.dtype != s.dtype or sw.device != s.device:
            raise ValueError("cg step: the write buffer must match the state's dtype and device")
        if not (s.is_contiguous() and sw.is_contiguous() and scal.is_contiguous()):
            raise ValueError("cg step: the states and scal must be contiguous")
        if tuple(scal.shape) != (3,) or scal.dtype != self.dtype or scal.device != s.device:
            raise ValueError(f"cg step: scal must be [3] {self.dtype} on {s.device}")
        lo, hi = s.data_ptr(), s.data_ptr() + s.numel() * s.element_size()
        wlo, whi = sw.data_ptr(), sw.data_ptr() + sw.numel() * sw.element_size()
        if wlo < hi and lo < whi:
            raise ValueError("cg step: the write buffer overlaps the read state")
        return code

    def __call__(self, s: torch.Tensor, sw: torch.Tensor, scal: torch.Tensor):
        """One fused iteration from ``s`` into ``sw``; returns ``(sw,
        dots)``, ``dots = [d.h, h.h, g.h, g.g]`` at the compute dtype."""
        sw, summary = self.iterate(s, sw, scal)
        return sw, summary[:4]

    def iterate(self, s: torch.Tensor, sw: torch.Tensor, scal: torch.Tensor):
        """One fused iteration from ``s`` into ``sw``; returns ``(sw,
        summary)``, ``summary = [d.h, h.h, g.h, g.g, alpha, beta, xa, res]``
        at the compute dtype, ``summary[4:7]`` the next call's ``scal``. CUDA
        tensors launch K5 and its finishing pass (or raise); CPU tensors run
        the plain versions."""
        global LAUNCHES
        code = self._check(s, sw, scal)
        if s.device.type == "cpu":
            s_new, dots = cg_step_reference(s, scal, self.tables)
            sw.copy_(s_new)
            return sw, cg_next_scalars(dots)
        if s.device.type != "cuda":
            raise ValueError(f"cg step: unsupported device {s.device}")
        t = self.tables
        nz, ny, nx = t.shape
        lib = _library()
        with torch.cuda.device(s.device):
            stream = torch.cuda.current_stream(s.device).cuda_stream
            n_blocks = lib.cg_step_blocks(code, t.p, int(t.a is not None), nz, ny, nx)
            if n_blocks < 1:
                raise ValueError(f"cg step: no launch grid for degree {t.p}")
            partials = torch.empty((n_blocks, 4), dtype=self.dtype, device=s.device)
            summary = torch.empty(8, dtype=self.dtype, device=s.device)
            rc = lib.cg_step_launch(
                code, t.p, s.data_ptr(), sw.data_ptr(), scal.data_ptr(),
                t.bz.data_ptr(), t.by.data_ptr(), t.bx.data_ptr(),
                t.sz.data_ptr(), t.sy.data_ptr(), t.sx.data_ptr(),
                None if t.a is None else t.a.data_ptr(), partials.data_ptr(),
                nz, ny, nx, stream,
            )
            if rc == 0:
                LAUNCHES += 1
                rc = lib.cg_finish_launch(code, partials.data_ptr(), n_blocks, summary.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"cg kernel launch failed: cudaError {rc}")
        return sw, summary
