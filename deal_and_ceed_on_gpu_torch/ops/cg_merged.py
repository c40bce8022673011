"""K7 and K8, the merged CG's update pass and seven-dot pass: CUDA wrappers and plain versions.

No Pallas kernel stands behind them: they are the counterparts of the JAX
solver's two XLA-fused passes (``deal_and_ceed_on_gpu_tpu/solvers/cg_merged.py``,
the updates at lines 239-260 and ``update_a0`` at 209, the seven dots at
182-201) and of the CUDA original's ``update_a*`` / ``update_b`` kernels
(``bp5/solver.h:48-336``). ``solvers/cg_merged.py`` runs an iteration as
K7, the operator apply and K8 (and K8's finisher where ranks all-reduce).

``merged_update(x, g, d, h, diag, scal, prev, mode)`` is K7: it updates x,
g and d in place (``mode`` one of ``MODES``; ``"init"`` only writes d =
-diag g from g), reading h, the Jacobi ``diag`` (or None, the identity),
this iteration's summary ``scal`` (alpha, beta) and, in ``"two-step"``, the
previous one's ``prev`` (its alpha / beta). ``merged_dots(d, g, h, diag,
weight, dot_dtype, comm, out, workspace)`` is K8, one launch: it returns
the summary ``[11]`` at the dot dtype, the seven sums of ``update_b`` (d.h,
h.h, g.h, g.g, g.(diag h), h.(diag h), g.diag.g, each weighted by
``weight`` where given, summed over the ranks of ``comm`` where given)
followed by alpha, beta, the reduction-free residual and alpha / beta
(``S_ALPHA``, ...); with ``comm``, K8 writes the local sums and the
one-thread finisher the scalars after the all-reduce. A ``DotsWorkspace``
holds K8's scratch for a solve. CUDA tensors launch the kernels
(``csrc/cg_merged.cu``) or raise; CPU tensors run the plain versions, the
parent solver's torch expressions unchanged: ``merged_update_plain``,
``merged_dots_plain`` and ``merged_scalars_plain``. ``UPDATE_LAUNCHES``,
``DOTS_LAUNCHES`` and ``FINISH_LAUNCHES`` count kernel launches.

Vectors are contiguous and of one shape (any: the kernels see a flat
length). Their types: g and h at the right-hand side's storage type T, x,
d and diag at X, the dots at C: (f64, f64, f64), (f32, f32, f32), (bf16,
bf16, f32), and the mixed (bf16, f32, f32) of a bf16 solve with an f32
Jacobi diagonal (torch's promotion of ``diag * g``). The CPU takes any
types the plain expressions take. K7 updates in place, so an ``h`` or
``diag`` that overlaps x, g or d is refused.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..solvers.cg import safe_div

__all__ = [
    "DOTS_LAUNCHES",
    "DOTS_WAVE",
    "DotsWorkspace",
    "FINISH_LAUNCHES",
    "MODES",
    "SOURCE",
    "SUMMARY",
    "S_ALPHA",
    "S_BETA",
    "S_RATIO",
    "S_RES",
    "UPDATE_LAUNCHES",
    "dots_blocks",
    "merged_dots",
    "merged_dots_plain",
    "merged_scalars_plain",
    "merged_update",
    "merged_update_plain",
    "overlaps",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cg_merged.cu"

# the summary [s0..s6, alpha, beta, res, ratio] (csrc/cg_merged.cu)
N_DOTS, S_ALPHA, S_BETA, S_RES, S_RATIO, SUMMARY = 7, 7, 8, 9, 10, 11
# K7's modes -> the kernel's: plain and odd-stop are both x += a d
MODES = {"init": 0, "plain": 1, "two-step": 2, "odd-stop": 1, "no-x": 3}
# K8's grid (csrc/cg_merged.cu: DOT_WAVE, DOT_POINTS_PER_BLOCK): a block per
# 2048 points, at most one whole wave of 3 blocks on each of 132 SMs
DOTS_WAVE, DOT_POINTS_PER_BLOCK = 132 * 3, 2048

# kernel launches (a run resets them to 0 to count its own)
UPDATE_LAUNCHES = 0
DOTS_LAUNCHES = 0
FINISH_LAUNCHES = 0

# (g and h, x d and diag, dots) -> the kernels' pair code
_PAIRS = {
    (torch.float64, torch.float64, torch.float64): 0,
    (torch.float32, torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.bfloat16, torch.float32): 2,
    (torch.bfloat16, torch.float32, torch.float32): 3,
}


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the storage spans of two tensors meet."""
    lo, hi = a.data_ptr(), a.data_ptr() + a.numel() * a.element_size()
    blo, bhi = b.data_ptr(), b.data_ptr() + b.numel() * b.element_size()
    return a.numel() > 0 and b.numel() > 0 and blo < hi and lo < bhi


def dots_blocks(n: int) -> int:
    """K8's block count for n points, the rows of its partials: from n
    alone (so the order of its sums is too), at most ``DOTS_WAVE``; the
    kernel's own ``cg_merged_dots_blocks``."""
    return max(1, min(-(-n // DOT_POINTS_PER_BLOCK), DOTS_WAVE))


def _mdiag(diag, v):
    return v if diag is None else diag * v


def merged_update_plain(x, g, d, h, diag, scal, prev, mode):
    """The plain version of K7: the parent solver's update lines
    (``update_a0``, ``update_a<true>``, ``update_a1``, ``update_c``), each
    written back into x, g and d."""
    if mode == "init":
        d.copy_(-_mdiag(diag, g))  # update_a0 (bp5/solver.h:48-72)
        return
    dt = g.dtype
    a = scal[S_ALPHA].to(dt)
    if mode in ("plain", "odd-stop"):
        x.copy_(x + a * d)  # update_a<true> (bp5/solver.h:74-104), update_c on an odd stop
    elif mode == "two-step":
        ratio = prev[S_RATIO].to(dt)
        x.copy_(x + (a + ratio) * d + ratio * _mdiag(diag, g))
    g_new = g + a * h
    d.copy_(scal[S_BETA].to(dt) * d - _mdiag(diag, g_new))
    g.copy_(g_new)


def merged_dots_plain(d, g, h, diag=None, weight=None, dot_dtype=None, comm=None):
    """The plain version of K8: the parent solver's ``dots7``, the
    update_b seven-way reduction at ``dot_dtype`` (``weight`` at it) with
    one all-reduce over ``comm``; with the identity diagonal the last three
    are g.h, h.h and g.g. Returns the seven 0-dim sums."""
    dd = dot_dtype or g.dtype

    def dot(u, v):
        # over all entries: a [3, n] vector solves like a flat one
        return torch.dot(u.reshape(-1), v.reshape(-1))

    def wt(u):
        return u if weight is None else u * weight

    def reduce(*s):
        if comm is None:
            return s
        return comm.allreduce_sum_(torch.stack(s)).unbind()

    dq, gq, hq = d.to(dd), g.to(dd), h.to(dd)
    hw = wt(hq)
    dh, hh, gh, gg = dot(dq, hw), dot(hq, hw), dot(gq, hw), dot(gq, wt(gq))
    if diag is None:
        dh, hh, gh, gg = reduce(dh, hh, gh, gg)
        return dh, hh, gh, gg, gh, hh, gg
    mq = diag.to(dd)
    mh = mq * hw
    return reduce(dh, hh, gh, gg, dot(gq, mh), dot(hq, mh), dot(gq, mq * wt(gq)))


def merged_scalars_plain(s):
    """The plain version of the finisher's scalars: alpha, the
    reduction-free residual ``|g + alpha h|`` (``bp5/solver.h:504-505``),
    beta (``bp5/solver.h:533``) and alpha / beta, from the seven sums."""
    s0, s1, s2, s3, s4, s5, s6 = s
    alpha = safe_div(s6, s0)
    # reduction-free |g + alpha h|; clamp tiny negative roundoff
    res = torch.sqrt(torch.clamp_min(s3 + 2.0 * alpha * s2 + alpha * alpha * s1, 0.0))
    beta = safe_div(alpha * (s4 + alpha * s5), s6)
    return alpha, beta, res, safe_div(alpha, beta)


@functools.cache
def _library():
    from ..utils.cuda_build import load_library

    lib = load_library(SOURCE)
    lib.cg_merged_update_launch.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.cg_merged_update_launch.restype = ctypes.c_int
    lib.cg_merged_dots_blocks.argtypes = [ctypes.c_longlong]
    lib.cg_merged_dots_blocks.restype = ctypes.c_int
    lib.cg_merged_dots_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.cg_merged_dots_launch.restype = ctypes.c_int
    lib.cg_merged_finish_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p]
    lib.cg_merged_finish_launch.restype = ctypes.c_int
    return lib


def _check_vectors(what, vecs, written, dot_dtype):
    """The checks both routes share: one device (CPU or CUDA), one shape,
    contiguous, floating, g and h of one type, x and d of one type, and no
    vector overlapping one that is ``written``. On CUDA also a type pair the
    kernels have, diag at d's type; returns its code (None on the CPU)."""
    g, d, h = vecs["g"], vecs["d"], vecs.get("h")
    dev = g.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, v in vecs.items():
        if v is None:
            continue
        if v.device != dev:
            raise ValueError(f"{what}: {name} is on {v.device}, g on {dev}")
        if v.shape != g.shape:
            raise ValueError(f"{what}: {name} has shape {tuple(v.shape)}, g {tuple(g.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if not v.is_floating_point():
            raise ValueError(f"{what}: {name} is {v.dtype}, not a floating type")
    if h is not None and h.dtype != g.dtype:
        raise ValueError(f"{what}: h is {h.dtype}, g {g.dtype}")
    x, diag = vecs.get("x"), vecs.get("diag")
    if x is not None and x.dtype != d.dtype:
        raise ValueError(f"{what}: x is {x.dtype}, d {d.dtype}")
    for name, v in vecs.items():
        hit = [k for k in written if v is not None and k != name and overlaps(v, vecs[k])]
        if hit:
            raise ValueError(f"{what}: {name} overlaps {hit[0]}, which it updates")
    if dev.type == "cpu":
        return None
    pair = _PAIRS.get((g.dtype, d.dtype, dot_dtype))
    if pair is None or diag is not None and diag.dtype != d.dtype:
        raise ValueError(f"{what}: no kernel for g/h {g.dtype}, x/d {d.dtype}, diag "
                         f"{None if diag is None else diag.dtype}, dots {dot_dtype}")
    return pair


def _check_summary(what, s, like, dd):
    if s is None or s.shape != (SUMMARY,) or s.dtype != dd or s.device != like.device or not s.is_contiguous():
        raise ValueError(f"{what}: want a contiguous [{SUMMARY}] summary at {dd} on {like.device}")


def merged_update(x, g, d, h, diag, scal, prev, mode: str):
    """K7: one update pass in place (see the module docstring); ``mode`` is
    ``"init"`` (d = -diag g; x, h, scal and prev unused), ``"plain"`` or
    ``"odd-stop"`` (x += a d), ``"two-step"`` (x += (a + r) d + r diag g,
    r from ``prev``) or ``"no-x"``, each then g += a h and d = b d - diag
    g. CUDA tensors launch the kernel (or raise), CPU tensors run
    ``merged_update_plain``."""
    global UPDATE_LAUNCHES
    if mode not in MODES:
        raise ValueError(f"cg update: mode {mode!r}, want one of {sorted(MODES)}")
    init, uses_x, two_step = mode == "init", mode in ("plain", "odd-stop", "two-step"), mode == "two-step"
    if init:  # the dots' type does not enter d = -diag g: the pair's own
        vecs, written = {"g": g, "d": d, "diag": diag}, ("d",)
        dd = torch.float64 if g.dtype == torch.float64 else torch.float32
    else:
        if h is None or scal is None:
            raise ValueError("cg update: h and scal are required")
        vecs = {"x": x if uses_x else None, "g": g, "d": d, "h": h, "diag": diag}
        written = ("x", "g", "d") if uses_x else ("g", "d")
        dd = scal.dtype
        _check_summary("cg update", scal, g, dd)
        if two_step:
            _check_summary("cg update (prev)", prev, g, dd)
    pair = _check_vectors("cg update", vecs, written, dd)
    if g.device.type == "cpu":
        merged_update_plain(x, g, d, h, diag, scal, prev, mode)
        return
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(g.device):
        rc = _library().cg_merged_update_launch(
            pair, MODES[mode], ptr(x) if uses_x else None, g.data_ptr(), d.data_ptr(),
            None if init else h.data_ptr(), ptr(diag), None if init else scal.data_ptr(),
            prev.data_ptr() if two_step else None, g.numel(), torch.cuda.current_stream(g.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cg update kernel launch failed: cudaError {rc}")
    UPDATE_LAUNCHES += 1


class DotsWorkspace:
    """K8's scratch for one solve on one stream, made once and passed to every
    ``merged_dots`` call: ``partials`` ``[rows, 7]`` at the dot dtype (rows
    >= ``dots_blocks(n)``; ``DOTS_WAVE``, enough for any n, by default), the
    ticket counter ``ticket`` (int32, 0 between launches), ``sums`` ``[7]``
    (the local sums before an all-reduce) and ``summaries`` ``[2, 11]``, which
    the calls without an ``out`` fill in turn: a solve reads this iteration's
    summary and the previous one's without allocating, and a returned summary
    stays as it is until the second call after it. It also keeps the d, g,
    diagonal and weight it was last called with, checked, and their
    pointers."""

    def __init__(self, dtype: torch.dtype, device, rows: int = DOTS_WAVE):
        self.partials = torch.empty((rows, N_DOTS), dtype=dtype, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.sums = torch.empty(N_DOTS, dtype=dtype, device=device)
        self.summaries = torch.zeros((2, SUMMARY), dtype=dtype, device=device)
        self._rows = self.summaries.unbind()
        self._turn = 0
        self._key = None  # (d, g, diag, weight, dot dtype) of the last checked call
        self._launch = None  # that call's kernel arguments but h's, out's and the stream

    def next_summary(self) -> torch.Tensor:
        self._turn ^= 1
        return self._rows[self._turn]


def _check_workspace(ws, dd, g):
    if not isinstance(ws, DotsWorkspace):
        raise ValueError(f"cg dots: the workspace is a {type(ws).__name__}, not a DotsWorkspace")
    if ws.partials.dtype != dd or ws.partials.device != g.device:
        raise ValueError(f"cg dots: the workspace is {ws.partials.dtype} on {ws.partials.device}, want {dd} on "
                         f"{g.device}")
    if ws.partials.shape[0] < dots_blocks(g.numel()):
        raise ValueError(f"cg dots: the workspace has {ws.partials.shape[0]} rows, {g.numel()} points need "
                         f"{dots_blocks(g.numel())}")


def _raw_stream(index):
    """The current CUDA stream of device ``index``, as an int."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def merged_dots(d, g, h, diag=None, weight=None, dot_dtype=None, comm=None, out=None, workspace=None):
    """K8 (and, with ``comm``, its finisher): the summary ``[11]`` at
    ``dot_dtype`` (default g's type) — the seven sums (over ``comm``'s
    ranks where given) and the scalars alpha, beta, res and alpha / beta.
    ``weight`` is at ``dot_dtype`` and of the vectors' shape. Into ``out``
    if given, else into the next of ``workspace``'s two summaries (a
    ``DotsWorkspace`` of ``dot_dtype`` on g's device: a solve makes one and
    passes it to every call; without one the call makes its own). With a
    workspace, d, g, ``diag`` and ``weight`` are checked when they change,
    h at every call. CUDA tensors launch the kernels (or raise), CPU
    tensors run the plain versions."""
    global DOTS_LAUNCHES, FINISH_LAUNCHES
    dd = dot_dtype or g.dtype
    ws = workspace
    key = ws._key if isinstance(ws, DotsWorkspace) else None
    if key is not None and key[0] is d and key[1] is g and key[2] is diag and key[3] is weight and key[4] == dd:
        # the solve's own d, g, diag and weight, checked at an earlier call: h alone
        if h.shape != g.shape or h.dtype != g.dtype or h.device != g.device or not h.is_contiguous():
            raise ValueError(f"cg dots: h is a {tuple(h.shape)} {h.dtype} tensor on {h.device} (contiguous "
                             f"{h.is_contiguous()}), want a contiguous {tuple(g.shape)} {g.dtype} one on {g.device}")
    else:
        pair = _check_vectors("cg dots", {"d": d, "g": g, "h": h, "diag": diag}, (), dd)
        if weight is not None and (weight.shape != g.shape or weight.dtype != dd or weight.device != g.device
                                   or not weight.is_contiguous()):
            raise ValueError(f"cg dots: the weight must be a contiguous {tuple(g.shape)} {dd} tensor on {g.device}")
        if ws is None:
            ws = DotsWorkspace(dd, g.device)
        else:
            _check_workspace(ws, dd, g)
        ws._key = (d, g, diag, weight, dd)
        ws._launch = None if pair is None else (
            pair, 0 if dd == torch.float64 else 1, g.device.index, d.data_ptr(), g.data_ptr(),
            None if diag is None else diag.data_ptr(), None if weight is None else weight.data_ptr(),
            ws.partials.data_ptr(), ws.ticket.data_ptr(), g.numel())
    if out is None:
        out = ws.next_summary()
    else:
        _check_summary("cg dots (out)", out, g, dd)
    if ws._launch is None:  # the CPU
        s = merged_dots_plain(d, g, h, diag, weight, dd, comm)
        return out.copy_(torch.stack([*s, *merged_scalars_plain(s)]))
    lib = _library()
    pair, code, index, d_ptr, g_ptr, m_ptr, w_ptr, partials, ticket, n = ws._launch
    stream = _raw_stream(index)
    sums = out if comm is None else ws.sums
    rc = lib.cg_merged_dots_launch(pair, d_ptr, g_ptr, h.data_ptr(), m_ptr, w_ptr, partials, ticket,
                                   sums.data_ptr(), int(comm is None), n, index, stream)
    if rc != 0:
        raise RuntimeError(f"cg dots kernel launch failed: cudaError {rc}")
    DOTS_LAUNCHES += 1
    if comm is not None:
        # the local sums, one all-reduce of the stacked seven, the scalars from the reduced row
        comm.allreduce_sum_(sums)
        rc = lib.cg_merged_finish_launch(code, sums.data_ptr(), out.data_ptr(), index, stream)
        if rc != 0:
            raise RuntimeError(f"cg dots finisher launch failed: cudaError {rc}")
        FINISH_LAUNCHES += 1
    return out
