"""K3, the q-grid operator apply: host tables, CUDA wrapper, plain version.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py``: the cell
loop of a Gauss-type rule (q >= p+1) on a brick, computed without an
element-major layout. Per axis the node -> quadrature map is block-diagonal
over elements (element ``e`` reads nodes ``e*p .. e*p+p`` and owns q points
``e*q .. e*q+q-1``), so

    nodal grid u --S/D per axis--> q grid --coefficients--> q grid
                 <--weighted transposes, summed over shared nodes--

with gradients ``gx = Sz Sy Dx u``, ``gy = Sz Dy Sx u``, ``gz = Dz Sy Sx u``
and values ``v = Sz Sy Sx u``. The coefficients are weightless (the
quadrature weights are folded into the backward tables):

- grad ``const`` (three scalars ``det * diag(J^{-1} J^{-T})`` on a uniform
  brick), ``diag3`` or ``full6`` (streamed tables, symmetric order xx xy xz
  yy yz zz);
- val ``const`` (``c * det``) or ``table`` (``a(x_q) * det`` per q point).

Layout, chosen by the port: vectors are the unpadded nodal grid
``[nz, ny, nx]`` (z slowest, the real-DoF order of both packages); q-grid
tables are ``C [K, mz*q, my*q, mx*q]`` and ``a_q [mz*q, my*q, mx*q]`` with
element ``(ez, ey, ex)``, q point ``(rz, ry, rx)`` at ``[ez*q+rz, ey*q+ry,
ex*q+rx]``. That is the TPU's ``[K, ZQ, YQ, MXQ]`` without its block and
128-lane padding (``utils/convert.qgrid_tables_from_jax`` slices it).

``qgrid_apply`` launches the CUDA kernel (``csrc/qgrid_kernel.cuh``:
even-odd sweeps in registers, the 1D ``S``/``D``/``w`` tables passed by
value with each launch from host memory, ``S_host``/``D_host``/``w_host``;
symmetric rules only, ``QGridTables.symmetric``) for a CUDA tensor and calls
the plain version ``qgrid_apply_reference`` for a CPU tensor; ``LAUNCHES``
counts kernel launches. ``constrained=True`` is the operator's ``vmult``:
``M A M`` plus identity rows on the six boundary faces, in the one launch.
f32 products in the plain version run in full f32
(``sum_factorization.sweep`` scopes ``full_f32`` to each product).

The coefficient stream may be stored narrower than the vectors: f32
vectors with bf16 planes (``coef_dtype=torch.bfloat16``, the JAX layout's
``coef_stream_dtype``) halve the bytes of the planes, the widest stream of
a mapped apply; the kernel widens each value to f32 where it reads it
(``csrc/qgrid_bf16.cu``, a library of its own), the plain version widens
the tables and runs the f32 apply. The pairs are (f64, f64), (f32, f32)
and (f32, bf16); f64 vectors with bf16 planes raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..basis import is_symmetric_rule
from .sum_factorization import sweep

__all__ = [
    "LAUNCHES",
    "SOURCE",
    "SOURCE_BF16",
    "QGridTables",
    "qgrid_apply",
    "qgrid_apply_reference",
    "qgrid_tables_np",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "qgrid.cu"
SOURCE_BF16 = SOURCE.with_name("qgrid_bf16.cu")  # f32 vectors, bf16 coefficient planes
MAX_DEGREE = 8
Q_OFFSETS = (1, 2, 3)  # q - p of the rules the kernel is built for

GRAD_KINDS = {None: 0, "const": 1, "diag3": 2, "full6": 3}
VAL_KINDS = {None: 0, "const": 1, "table": 2}
_GRAD_PLANES = {2: 3, 3: 6}

# kernel launches made by qgrid_apply (a run resets it to 0 to count its own)
LAUNCHES = 0

_DTYPE_CODES = {torch.float64: 0, torch.float32: 1}
_COEF_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
# (vectors, coefficient planes) -> the library and its launcher
_PAIRS = {
    (torch.float64, torch.float64): (SOURCE, "qgrid_apply_launch"),
    (torch.float32, torch.float32): (SOURCE, "qgrid_apply_launch"),
    (torch.float32, torch.bfloat16): (SOURCE_BF16, "qgrid_bf16_apply_launch"),
}


def _check_pair(dtype: torch.dtype, coef_dtype: torch.dtype) -> None:
    if (dtype, coef_dtype) not in _PAIRS:
        raise ValueError(f"qgrid: vectors {dtype} with coefficient planes {coef_dtype}: the pairs are f64/f64, "
                         "f32/f32 and f32/bf16 (f64 vectors with bf16 planes are no configuration of the kernel)")


def _to_qgrid(tab: np.ndarray, n_elements, q: int) -> np.ndarray:
    """``[E, n_q, K]`` (cell order ez, ey, ex; q order qz, qy, qx) ->
    ``[K, mz*q, my*q, mx*q]``."""
    mx, my, mz = n_elements
    K = tab.shape[-1]
    t = tab.reshape(mz, my, mx, q, q, q, K)
    return np.ascontiguousarray(t.transpose(6, 0, 3, 1, 4, 2, 5)).reshape(K, mz * q, my * q, mx * q)


def qgrid_tables_np(mesh, basis, grad=None, val=None) -> dict:
    """K3's host tables in float64, from the JAX-style term specs
    ``grad = (mode, data)`` with mode ``const`` (three scalars in x, y, z
    order), ``diag3`` (``[E, n_q, 3]``) or ``full6`` (``[E, n_q, 6]``), and
    ``val = (mode, data)`` with mode ``const`` (a scalar) or ``table``
    (``[E, n_q]``); the data are weightless, as ``QGridLayout`` takes them.
    ``coef_dtype`` is None: the streams are stored at the vectors' dtype
    unless ``QGridTables.from_numpy`` is told otherwise."""
    p, q = basis.degree, basis.n_q
    if not (1 <= p <= MAX_DEGREE and q - p in Q_OFFSETS):
        raise ValueError(f"qgrid kernel: built for p = 1..{MAX_DEGREE}, q - p in {Q_OFFSETS}; got p={p}, q={q}")
    out = {
        "p": p, "q": q, "n_elements": tuple(mesh.n_elements),
        "S": np.asarray(basis.S, dtype=np.float64), "D": np.asarray(basis.D, dtype=np.float64),
        "w": np.asarray(basis.q_weights, dtype=np.float64),
        "grad_kind": 0, "val_kind": 0, "c_grad": (0.0, 0.0, 0.0), "c_val": 0.0, "C": None, "a_q": None,
        "coef_dtype": None,
    }
    if grad is not None:
        mode, data = grad
        if mode not in ("const", "diag3", "full6"):
            raise ValueError(f"unknown grad mode {mode!r}")
        out["grad_kind"] = GRAD_KINDS[mode]
        if mode == "const":
            if not mesh.is_uniform:
                raise ValueError("const grad coefficients require a uniform brick (use diag3)")
            out["c_grad"] = tuple(float(c) for c in data)
        else:
            out["C"] = _to_qgrid(np.asarray(data, dtype=np.float64), mesh.n_elements, q)
    if val is not None:
        mode, data = val
        if mode not in ("const", "table"):
            raise ValueError(f"unknown val mode {mode!r}")
        out["val_kind"] = VAL_KINDS[mode]
        if mode == "const":
            if not mesh.is_uniform:
                raise ValueError("a const val coefficient (c*det) requires a uniform brick (use a table)")
            out["c_val"] = float(data)
        else:
            out["a_q"] = _to_qgrid(np.asarray(data, dtype=np.float64)[:, :, None], mesh.n_elements, q)[0]
    if not (out["grad_kind"] or out["val_kind"]):
        raise ValueError("need at least one of grad/val")
    return out


def _block_matrix(m: int, p: int, M: np.ndarray) -> np.ndarray:
    """The global node -> q map of one axis, ``[m*q, m*p+1]``: block-diagonal
    over elements (``pallas_qgrid._x_chunk_tables``' ``dense`` form)."""
    q = M.shape[0]
    A = np.zeros((m * q, m * p + 1))
    for e in range(m):
        A[e * q : (e + 1) * q, e * p : e * p + p + 1] = M
    return A


@dataclasses.dataclass
class QGridTables:
    """K3's tables: the 1D tables in host memory (the only copy: the kernel
    takes them by value with each launch, the plain version builds its dense
    matrices from them), the coefficient streams on the device, stored at
    ``coef_dtype`` (the vectors' ``dtype``, or bf16 beside f32 vectors).
    ``fold_scale`` rescales the coefficients the kernel reads, in place."""

    p: int
    q: int
    n_elements: tuple[int, int, int]  # (mx, my, mz)
    S_host: np.ndarray  # [q, p+1] float64
    D_host: np.ndarray  # [q, p+1] float64
    w_host: np.ndarray  # [q] float64
    grad_kind: int
    val_kind: int
    c_grad: tuple[float, float, float]
    c_val: float
    C: torch.Tensor | None  # [K, mz*q, my*q, mx*q]
    a_q: torch.Tensor | None  # [mz*q, my*q, mx*q]
    dtype: torch.dtype
    device: torch.device
    coef_dtype: torch.dtype | None = None  # None: dtype
    _dense: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.coef_dtype is None:
            self.coef_dtype = self.dtype
        _check_pair(self.dtype, self.coef_dtype)

    @staticmethod
    def from_numpy(tabs: dict, dtype: torch.dtype, device="cuda", coef_dtype=None) -> "QGridTables":
        """The tables of ``tabs`` (``qgrid_tables_np`` keys) on ``device``,
        for vectors of ``dtype``; the streams stored at ``coef_dtype`` (a
        torch dtype or its name; None: ``tabs["coef_dtype"]``, else
        ``dtype``), rounded from float64 as the JAX layout rounds them."""
        coef_dtype = coef_dtype or tabs.get("coef_dtype") or dtype
        if isinstance(coef_dtype, str):
            coef_dtype = getattr(torch, coef_dtype)
        _check_pair(dtype, coef_dtype)

        def dev(a):
            return None if a is None else torch.as_tensor(np.array(a, dtype=np.float64), dtype=coef_dtype,
                                                          device=device)

        def host(a):
            return np.array(a, dtype=np.float64, order="C")

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:  # as a tensor's device reads
            device = torch.device("cuda", torch.cuda.current_device())

        return QGridTables(
            tabs["p"], tabs["q"], tuple(tabs["n_elements"]), host(tabs["S"]), host(tabs["D"]), host(tabs["w"]),
            int(tabs["grad_kind"]), int(tabs["val_kind"]), tuple(float(c) for c in tabs["c_grad"]),
            float(tabs["c_val"]), dev(tabs["C"]), dev(tabs["a_q"]), dtype, device, coef_dtype,
        )

    @property
    def symmetric(self) -> bool:
        """Whether the rule is symmetric (``basis.is_symmetric_rule``): the
        CUDA kernel's even-odd sweeps need it."""
        return is_symmetric_rule(self.S_host, self.D_host)

    @staticmethod
    def create(mesh, basis, dtype: torch.dtype, grad=None, val=None, device="cuda", coef_dtype=None) -> "QGridTables":
        return QGridTables.from_numpy(qgrid_tables_np(mesh, basis, grad, val), dtype, device, coef_dtype)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(nz, ny, nx) nodal grid."""
        mx, my, mz = self.n_elements
        return (mz * self.p + 1, my * self.p + 1, mx * self.p + 1)

    @property
    def q_shape(self) -> tuple[int, int, int]:
        mx, my, mz = self.n_elements
        return (mz * self.q, my * self.q, mx * self.q)

    def fold_scale(self, s: float) -> None:
        """``A <- s * A`` (identity rows of the constrained apply unaffected).
        The streams are multiplied in their own dtype, ``s`` rounded to it
        first, as the JAX layout multiplies them (a bf16 plane times a
        Python float is a bf16 product there)."""
        self.c_grad = tuple(c * s for c in self.c_grad)
        self.c_val *= s
        for t in (self.C, self.a_q):
            if t is not None:
                t.mul_(float(torch.tensor(s, dtype=t.dtype)))

    def axis_matrix(self, axis: int, kind: str) -> torch.Tensor:
        """The plain version's node -> q matrix of grid axis ``axis`` (0 = z),
        ``kind`` "S"/"D", or "SW"/"DW" with the q weights folded into the rows."""
        key = (axis, kind)
        if key not in self._dense:
            mx, my, mz = self.n_elements
            m = (mz, my, mx)[axis]
            def rounded(a):  # to the compute type, as the kernel rounds its tables
                return torch.as_tensor(a).to(self.dtype).double().numpy()

            M = rounded(self.S_host if kind[0] == "S" else self.D_host)
            if kind.endswith("W"):
                M = M * rounded(self.w_host)[:, None]
            self._dense[key] = torch.as_tensor(_block_matrix(m, self.p, M), dtype=self.dtype, device=self.device)
        return self._dense[key]


def _check(u: torch.Tensor, tables: QGridTables) -> int:
    """Validate ``u`` against the tables; return the launcher's dtype code."""
    code = _DTYPE_CODES.get(u.dtype)
    if code is None or u.dtype != tables.dtype:
        raise TypeError(f"qgrid: u is {u.dtype}, tables {tables.dtype}; float64 or float32, the same for both")
    _check_pair(tables.dtype, tables.coef_dtype)
    if tuple(u.shape) != tables.shape:
        raise ValueError(f"qgrid: u has shape {tuple(u.shape)}, tables {tables.shape}")
    if u.device != tables.device:
        raise ValueError(f"qgrid: u on {u.device}, tables on {tables.device}")
    p1 = tables.p + 1
    if tables.S_host.shape != (tables.q, p1) or tables.D_host.shape != (tables.q, p1) or tables.w_host.shape != (
            tables.q,):
        raise ValueError(f"qgrid: basis tables are not [{tables.q}, {p1}] and [{tables.q}]")
    if tables.grad_kind in _GRAD_PLANES:
        want = (_GRAD_PLANES[tables.grad_kind],) + tables.q_shape
        if tables.C is None or tuple(tables.C.shape) != want:
            raise ValueError(f"qgrid: grad table is not {list(want)}")
    if tables.val_kind == 2 and (tables.a_q is None or tuple(tables.a_q.shape) != tables.q_shape):
        raise ValueError(f"qgrid: val table is not {list(tables.q_shape)}")
    streams = [t for t in (tables.C, tables.a_q) if t is not None]
    if not (u.is_contiguous() and all(t.is_contiguous() and t.dtype == tables.coef_dtype for t in streams)):
        raise ValueError(f"qgrid: u and the tables must be contiguous, the tables of {tables.coef_dtype}")
    return code


def _face_mask(shape, device) -> torch.Tensor:
    face = torch.zeros(shape, dtype=torch.bool, device=device)
    for axis, n in enumerate(shape):
        face.narrow(axis, 0, 1).fill_(True)
        face.narrow(axis, n - 1, 1).fill_(True)
    return face


def qgrid_apply_reference(u: torch.Tensor, tables: QGridTables, constrained: bool = False) -> torch.Tensor:
    """The plain torch version of K3: the same function with dense per-axis
    node -> q matrices (block-diagonal over elements) and one ``tensordot``
    per axis and term, summed in the TPU kernel's order. Narrower streams
    (bf16 planes) are widened to ``u``'s dtype first."""
    _check(u, tables)
    t = tables
    C = None if t.C is None else t.C.to(u.dtype)
    a_q = None if t.a_q is None else t.a_q.to(u.dtype)
    gk, vk = t.grad_kind, t.val_kind
    face = _face_mask(t.shape, u.device) if constrained else None
    uin = u.masked_fill(face, 0) if constrained else u

    def fwd(x, axis, kind):
        return sweep(x, t.axis_matrix(axis, kind), axis)

    def bwd(x, axis, kind):
        return sweep(x, t.axis_matrix(axis, kind), axis, transpose=True)

    az = fwd(uin, 0, "S")
    ay = fwd(az, 1, "S")
    if gk:
        bz = fwd(uin, 0, "D")
        gx = fwd(ay, 2, "D")
        gy = fwd(fwd(az, 1, "D"), 2, "S")
        gz = fwd(fwd(bz, 1, "S"), 2, "S")
        if gk == 1:
            cx, cy, cz = t.c_grad
            fx, fy, fz = cx * gx, cy * gy, cz * gz
        elif gk == 2:
            fx, fy, fz = C[0] * gx, C[1] * gy, C[2] * gz
        else:
            fx = C[0] * gx + C[1] * gy + C[2] * gz
            fy = C[1] * gx + C[3] * gy + C[4] * gz
            fz = C[2] * gx + C[4] * gy + C[5] * gz
    u14 = None
    if gk:
        u14 = bwd(fx, 2, "DW")
    if vk:
        v = fwd(ay, 2, "S")
        fv = t.c_val * v if vk == 1 else a_q * v
        uv = bwd(fv, 2, "SW")
        u14 = uv if u14 is None else u14 + uv
    sA = bwd(u14, 1, "SW")
    if gk:
        sA = sA + bwd(bwd(fy, 2, "SW"), 1, "DW")
        sC = bwd(bwd(fz, 2, "SW"), 1, "SW")
    out = bwd(sA, 0, "SW")
    if gk:
        out = out + bwd(sC, 0, "DW")
    return torch.where(face, u, out) if constrained else out


_ARGTYPES = (
    [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4 + [ctypes.c_double] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
)


def _launcher(dtype: torch.dtype, coef_dtype: torch.dtype):
    """The launcher of the library that holds this pair's instantiations."""
    from ..utils.cuda_build import load_library

    source, name = _PAIRS[(dtype, coef_dtype)]
    fn = getattr(load_library(source), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def qgrid_apply(u: torch.Tensor, tables: QGridTables, constrained: bool = False,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``out = K3(u)`` on a ``[nz, ny, nx]`` tensor (``constrained``: the
    operator's ``M A M`` plus identity rows): the CUDA kernel for a CUDA
    tensor (raises if it cannot launch; it takes symmetric rules only,
    ``QGridTables.symmetric``), the plain version for a CPU tensor. ``out``
    (optional, ``u``'s shape, dtype and device, not overlapping ``u``)
    receives the result; the kernel writes every entry of it."""
    global LAUNCHES
    code = _check(u, tables)
    if out is not None and (out.shape != u.shape or out.dtype != u.dtype or out.device != u.device
                            or not out.is_contiguous()):
        raise ValueError("qgrid: out must be a contiguous tensor of u's shape, dtype and device")
    if u.device.type == "cpu":
        w = qgrid_apply_reference(u, tables, constrained)
        return w if out is None else out.copy_(w)
    if u.device.type != "cuda":
        raise ValueError(f"qgrid: unsupported device {u.device}")
    if not tables.symmetric:
        raise ValueError("qgrid: the CUDA kernel needs a symmetric 1D rule (Gauss or GLL): S[q-1-a, p-i] = S[a, i], "
                         "D[q-1-a, p-i] = -D[a, i]")
    if out is None:
        out = torch.empty_like(u)
    elif out.data_ptr() == u.data_ptr():
        raise ValueError("qgrid: out aliases u (other blocks read the nodes a block writes)")
    launch = _launcher(tables.dtype, tables.coef_dtype)
    mx, my, mz = tables.n_elements
    cx, cy, cz = tables.c_grad

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(u.device):
        rc = launch(
            code, _COEF_CODES[tables.coef_dtype], tables.p, tables.q, tables.grad_kind, tables.val_kind, int(constrained),
            u.data_ptr(), out.data_ptr(), ptr(tables.C), ptr(tables.a_q), cx, cy, cz, tables.c_val, mx, my, mz,
            torch.cuda.current_stream(u.device).cuda_stream, tables.S_host.ctypes.data, tables.D_host.ctypes.data,
            tables.w_host.ctypes.data,
        )
    if rc != 0:
        raise RuntimeError(f"qgrid kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
