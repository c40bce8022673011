"""K4, the element-major general cell apply: host tables, CUDA wrapper, plain version.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/pallas_general.py``: the cell
apply of any quadrature rule (Gauss q = p+1, p+2, GLL) on any geometry
(uniform, graded, mapped), on explicit local vectors ``[E, (p+1)^3]``
(local DoFs (k, j, i), x fastest; q points (qz, qy, qx), x fastest):

    g_d = U G_d,  f_d = coefficient contraction,  W = sum_d f_d G_d^T (+ (U V) v V^T)

Coefficients are JxW-weighted, as the JAX ``GeneralCellKernel`` takes them:

- grad ``const`` (three scalars ``(cx, cy, cz)``, multiplied here by the
  reference weights ``w3d`` into ``cw [3, Q]``), ``diag3`` (``[E, Q, 3]``)
  or ``full6`` (``[E, Q, 6]``, symmetric order xx xy xz yy yz zz); the
  streamed ones are stored ``C [K, E, Q]``;
- val ``const`` (``c * det``, stored ``vw = c * w3d [Q]``) or ``table``
  (``a(x) * JxW``, ``av [E, Q]``).

These are not K3's conventions: K3 (``ops/qgrid.py``) takes weightless
coefficients (the weights sit in its backward tables), K4 weighted ones.

``general_apply`` launches the CUDA kernel (``csrc/general.cu``: even-odd
sum factorization, a thread a 1D line, the 1D ``S``/``D`` tables passed by
value with each launch from host memory, ``S_host``/``D_host``; symmetric
rules only, ``symmetric``) for a CUDA tensor and calls
the plain version ``general_apply_reference`` (the JAX kernel body: dense
``V``/``G`` tables and ``torch.matmul``) for a CPU tensor; ``LAUNCHES``
counts kernel launches. ``build_general_operator`` wraps the cell apply in
the structured gather and overlap-add scatter of ``ops/local_global.py``
(torch ops, deterministic, no atomics).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..basis import is_symmetric_rule
from . import local_global as lg
from .sum_factorization import full_f32

__all__ = [
    "LAUNCHES",
    "SOURCE",
    "GeneralCellKernel",
    "build_general_operator",
    "general_apply",
    "general_apply_reference",
    "general_tables_np",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "general.cu"
MAX_DEGREE = 8
Q_OFFSETS = (1, 2, 3)  # q - p of the rules the kernel is built for

GRAD_KINDS = {None: 0, "const": 1, "diag3": 2, "full6": 3}
VAL_KINDS = {None: 0, "const": 1, "table": 2}
_GRAD_PLANES = {"diag3": 3, "full6": 6}

# kernel launches made by general_apply (a run resets it to 0 to count its own)
LAUNCHES = 0

_DTYPE_CODES = {torch.float64: 0, torch.float32: 1}
_TABLES = ("cw", "C", "vw", "av")  # the coefficient tables, on the device


def general_tables_np(basis, n_cells: int, grad=None, val=None, w3d=None) -> dict:
    """K4's host tables in float64 from the JAX-style term specs
    ``grad = (mode, data)`` (``const``: three scalars in x, y, z order;
    ``diag3``/``full6``: ``[E, Q, 3|6]``) and ``val = (mode, data)``
    (``const``: a scalar; ``table``: ``[E, Q]``); ``w3d`` defaults to the
    tensor product of ``basis.q_weights``."""
    p, q = basis.degree, basis.n_q
    if not (1 <= p <= MAX_DEGREE and q - p in Q_OFFSETS):
        raise ValueError(f"general kernel: built for p = 1..{MAX_DEGREE}, q - p in {Q_OFFSETS}; got p={p}, q={q}")
    E, Q = int(n_cells), q**3
    if w3d is None:
        w = np.asarray(basis.q_weights, dtype=np.float64)
        w3d = w[:, None, None] * w[None, :, None] * w[None, None, :]
    w3d = np.asarray(w3d, dtype=np.float64).reshape(-1)
    out = {
        "p": p, "q": q, "n_cells": E, "grad_kind": 0, "val_kind": 0,
        "S": np.asarray(basis.S, dtype=np.float64), "D": np.asarray(basis.D, dtype=np.float64),
        "cw": None, "C": None, "vw": None, "av": None,
    }
    if grad is not None:
        mode, data = grad
        if mode not in ("const", "diag3", "full6"):
            raise ValueError(f"unknown grad mode {mode!r}")
        out["grad_kind"] = GRAD_KINDS[mode]
        if mode == "const":
            out["cw"] = np.stack([float(c) * w3d for c in data])
        else:
            C = np.asarray(data, dtype=np.float64)
            if C.shape != (E, Q, _GRAD_PLANES[mode]):
                raise ValueError(f"general kernel: {mode} table is {C.shape}, not {(E, Q, _GRAD_PLANES[mode])}")
            out["C"] = np.ascontiguousarray(np.moveaxis(C, 2, 0))
    if val is not None:
        mode, data = val
        if mode not in ("const", "table"):
            raise ValueError(f"unknown val mode {mode!r}")
        out["val_kind"] = VAL_KINDS[mode]
        if mode == "const":
            out["vw"] = float(data) * w3d
        else:
            out["av"] = np.asarray(data, dtype=np.float64).reshape(E, Q)
    if not (out["grad_kind"] or out["val_kind"]):
        raise ValueError("need at least one of grad/val")
    return out


class GeneralCellKernel:
    """K4 on explicit local cell vectors ``[E, (p+1)^3]``: no mesh, no
    local<->global transfer (the adaptive operators of the JAX package batch
    their cells through the same contract). Parameters as the JAX class:
    ``basis`` (any rule; the CUDA kernel takes the symmetric ones, Gauss and
    GLL), ``n_cells``, ``dtype``, ``grad``, ``val``, ``w3d``; the TPU-only
    knobs (``block_e``, ``precision``, ``vmem_limit_bytes``) have no
    counterpart: K4 computes exactly at f64 or f32 and picks its own
    tiling."""

    def __init__(self, basis, n_cells, dtype, grad=None, val=None, w3d=None, device="cuda"):
        self._load(general_tables_np(basis, n_cells, grad, val, w3d), dtype, device)

    @classmethod
    def from_numpy(cls, tabs: dict, dtype: torch.dtype, device="cuda") -> "GeneralCellKernel":
        """A kernel from host tables (``general_tables_np`` keys)."""
        k = GeneralCellKernel.__new__(GeneralCellKernel)
        k._load(tabs, dtype, device)
        return k

    def _load(self, tabs: dict, dtype: torch.dtype, device) -> None:
        self.p, self.q, self.n_cells = int(tabs["p"]), int(tabs["q"]), int(tabs["n_cells"])
        self.grad_kind, self.val_kind = int(tabs["grad_kind"]), int(tabs["val_kind"])
        for name in _TABLES:
            a = tabs[name]
            setattr(self, name, None if a is None else torch.as_tensor(
                np.array(a, dtype=np.float64), dtype=dtype, device=device))
        # the 1D tables stay in host memory: the kernel takes them by value with each launch
        self.S_host, self.D_host = (np.array(tabs[n], dtype=np.float64, order="C") for n in ("S", "D"))
        # its even-odd sweeps need symmetric rules (Gauss, GLL)
        self.symmetric = is_symmetric_rule(self.S_host, self.D_host)

    @property
    def n_local(self) -> int:
        return (self.p + 1) ** 3

    @property
    def n_q(self) -> int:
        return self.q**3

    @property
    def coefficients(self) -> list[torch.Tensor]:
        """The coefficient tables the kernel reads (``cw``, ``C``, ``vw``,
        ``av``; at least one is set)."""
        return [t for t in (self.cw, self.C, self.vw, self.av) if t is not None]

    @property
    def dtype(self) -> torch.dtype:
        return self.coefficients[0].dtype

    @property
    def device(self) -> torch.device:
        return self.coefficients[0].device

    def apply_local(self, ul: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """Per-cell apply on local vectors: ``[E, (p+1)^3]`` -> same."""
        return general_apply(ul, self, out)

    def fold_scale(self, s: float) -> None:
        """``A <- s * A``: rescales the coefficients the kernel reads, in place."""
        for t in self.coefficients:
            t.mul_(s)

    @functools.cached_property
    def dense_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain version's dense ``V [N, Q]`` and ``G [3, N, Q]``
        (``basis.basis_tables_3d`` of the kernel's 1D tables, rounded to
        its dtype as the kernel rounds them)."""
        S, D = (torch.as_tensor(t).to(self.dtype).double().numpy().tobytes() for t in (self.S_host, self.D_host))
        V, G = _dense_np(S, D, self.q, self.p + 1)
        return (torch.as_tensor(V, dtype=self.dtype, device=self.device),
                torch.as_tensor(G, dtype=self.dtype, device=self.device))


@functools.lru_cache(maxsize=8)
def _dense_np(S_bytes: bytes, D_bytes: bytes, q: int, p1: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense 3D tables of 1D tables ``S``/``D`` ``[q, p+1]`` (given as
    bytes, so that equal tables share one build)."""
    S = np.frombuffer(S_bytes).reshape(q, p1)
    D = np.frombuffer(D_bytes).reshape(q, p1)
    N, Q = p1**3, q**3
    V = np.einsum("ck,bj,ai->kjicba", S, S, S).reshape(N, Q)
    G = np.stack([np.einsum("ck,bj,ai->kjicba", *m).reshape(N, Q) for m in ((S, S, D), (S, D, S), (D, S, S))])
    return V, G


def _check(ul: torch.Tensor, k: GeneralCellKernel) -> int:
    """Validate ``ul`` against the kernel's tables; return the dtype code."""
    code = _DTYPE_CODES.get(ul.dtype)
    if code is None or ul.dtype != k.dtype:
        raise TypeError(f"general: u is {ul.dtype}, tables {k.dtype}; float64 or float32, the same for both")
    E, N, Q = k.n_cells, k.n_local, k.n_q
    if tuple(ul.shape) != (E, N):
        raise ValueError(f"general: u has shape {tuple(ul.shape)}, want [{E}, {N}]")
    if ul.device != k.device:
        raise ValueError(f"general: u on {ul.device}, tables on {k.device}")
    want = {
        "cw": (3, Q) if k.grad_kind == 1 else None,
        "C": ({2: 3, 3: 6}[k.grad_kind], E, Q) if k.grad_kind in (2, 3) else None,
        "vw": (Q,) if k.val_kind == 1 else None,
        "av": (E, Q) if k.val_kind == 2 else None,
    }
    for name, shape in want.items():
        t = getattr(k, name)
        if shape is not None and (t is None or tuple(t.shape) != shape):
            raise ValueError(f"general: table {name} is not {list(shape)}")
        if t is not None and not (t.is_contiguous() and t.dtype == ul.dtype):
            raise ValueError(f"general: table {name} must be contiguous and of u's dtype")
    if not ul.is_contiguous():
        raise ValueError("general: u must be contiguous")
    return code


@full_f32()
def general_apply_reference(ul: torch.Tensor, k: GeneralCellKernel) -> torch.Tensor:
    """The plain torch version of K4, the JAX kernel body: ``g_d = U G_d``
    with the dense tables, the coefficient contraction, ``W = sum_d f_d
    G_d^T (+ (U V) v V^T)``. f32 products run in full f32
    (``sum_factorization.full_f32``, whatever the caller's TF32 setting)."""
    _check(ul, k)
    V, G = k.dense_tables
    acc = None
    if k.grad_kind:
        gx, gy, gz = ul @ G[0], ul @ G[1], ul @ G[2]
        if k.grad_kind == 1:
            fx, fy, fz = gx * k.cw[0:1], gy * k.cw[1:2], gz * k.cw[2:3]
        elif k.grad_kind == 2:
            fx, fy, fz = gx * k.C[0], gy * k.C[1], gz * k.C[2]
        else:
            c0, c1, c2, c3, c4, c5 = k.C
            # symmetric 3x3 contraction (bp5/step-64.cu:164-188)
            fx = c0 * gx + c1 * gy + c2 * gz
            fy = c1 * gx + c3 * gy + c4 * gz
            fz = c2 * gx + c4 * gy + c5 * gz
        acc = fx @ G[0].T + fy @ G[1].T + fz @ G[2].T
    if k.val_kind:
        v = ul @ V
        v = v * (k.vw[None, :] if k.val_kind == 1 else k.av)
        t = v @ V.T
        acc = t if acc is None else acc + t
    return acc


def _launcher():
    from ..utils.cuda_build import load_library

    fn = load_library(SOURCE).general_apply_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def general_apply(ul: torch.Tensor, k: GeneralCellKernel, out: torch.Tensor | None = None) -> torch.Tensor:
    """``W = K4(U)`` on ``[E, (p+1)^3]`` local vectors: the CUDA kernel for
    a CUDA tensor (raises if it cannot launch), the plain version for a CPU
    tensor. ``out`` (optional, ``U``'s shape and dtype) receives the
    result; the kernel writes every entry of it."""
    global LAUNCHES
    code = _check(ul, k)
    if out is not None and (out.shape != ul.shape or out.dtype != ul.dtype or out.device != ul.device
                            or not out.is_contiguous()):
        raise ValueError("general: out must be a contiguous tensor of u's shape, dtype and device")
    if ul.device.type == "cpu":
        w = general_apply_reference(ul, k)
        return w if out is None else out.copy_(w)
    if ul.device.type != "cuda":
        raise ValueError(f"general: unsupported device {ul.device}")
    if not k.symmetric:
        raise ValueError("general: the CUDA kernel needs a symmetric 1D rule (Gauss or GLL): S[q-1-a, p-i] = S[a, i], "
                         "D[q-1-a, p-i] = -D[a, i]")
    launch = _launcher()
    if out is None:
        out = torch.empty_like(ul)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(ul.device):
        rc = launch(
            code, k.p, k.q, k.grad_kind, k.val_kind, k.n_cells, ul.data_ptr(), out.data_ptr(),
            None, None, ptr(k.cw), ptr(k.C), ptr(k.vw), ptr(k.av),
            torch.cuda.current_stream(ul.device).cuda_stream, k.S_host.ctypes.data, k.D_host.ctypes.data,
        )
    if rc != 0:
        raise RuntimeError(f"general kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


class build_general_operator(GeneralCellKernel):
    """Callable cell loop on a structured ``FESpace``: flat nodal ``u`` ->
    flat ``A_cell_loop(u)``, :class:`GeneralCellKernel` between the
    element-major gather and overlap-add scatter of ``ops/local_global.py``
    (``pallas_general.py:337-372``). Parameters: ``space`` (any rule and
    geometry), ``grad``, ``val``."""

    def __init__(self, space, grad=None, val=None):
        super().__init__(space.basis, space.mesh.n_cells, space.dtype, grad=grad, val=val,
                         w3d=space.geometry.w3d, device=space.device)
        self.space = space

    def __call__(self, u_flat: torch.Tensor) -> torch.Tensor:
        s = self.space
        ul = lg.gather_elements(u_flat.reshape(s.grid_shape), s.mesh.n_elements, s.degree)
        wl = self.apply_local(ul)
        return lg.scatter_elements(wl, s.mesh.n_elements, s.degree).reshape(-1)
