"""K2, the banded Kronecker apply of the Gauss-rule BPs: host tables, CUDA wrapper, plain version.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/pallas_banded.py``. On a
uniform or graded brick the constrained operator of BP1-BP4 (any Gauss
rule) is exactly a sum of Kronecker products of banded 1D factors
(half-bandwidth p):

    stiffness:  A = Mz (x) My (x) Ax  +  Mz (x) Ay (x) Mx  +  Gz (x) My (x) Mx
    mass:       M = Gz (x) My (x) Mx

with ``A_a = Z^T diag(1/h_e) K_e Z`` and ``M_a = Z^T diag(h_e) B_e Z`` the
assembled 1D stiffness and mass factors of axis a (per-element widths of a
graded brick absorbed per axis), ``Gz = Az + c Mz`` for stiffness (a
constant value coefficient c folded into the z factor, 0 without one) and
``Gz = c Mz`` for mass (c = 1 without one). The Dirichlet rows and columns
of every factor are zero, so the apply is the constrained ``M A M``; the
kernel also writes the identity rows (``out = u`` on the six faces), so one
``vmult`` is one launch. The plain version runs z -> y -> x, as the TPU
kernel (the CUDA kernel runs x -> y -> z, element by element):

    w1 = Mz u,  w2 = Gz u                         (z; w1 stiffness only)
    q1 = My w1, q2 = My w2 + Ay w1                (y; mass: q2 = My w2)
    out = Mx q2 + Ax q1                           (x; mass: Mx q2)

Two forms of the same tables, in the compute dtype:

- the band form, per axis ``[n_d, 2p+1]`` with ``table[i, t] = A[i, i - p +
  t]`` (the transpose of the band layout of ``ops/separable.py``): ``mx, my,
  gz`` for mass, plus ``ax, ay, mz`` for stiffness, Dirichlet rows and
  columns zero. The plain version reads it (``banded_tables_np``; the JAX
  layout's, ``utils/convert.banded_tables_from_jax``);
- the element form the CUDA kernel reads: the element matrices ``B = S^T W
  S`` and ``K = D^T W D`` (``[p+1, p+1]``, float64 in host memory: the kernel
  takes them by value with each launch) and per axis the factors of each
  element, ``ex [4, mx]`` (``s h``, ``s / h``, ``s`` the fold factor of
  ``scale_``, then the ratios of those two rows to element e-1's, 0 for
  e = 0), ``ey [2, my]`` (``h``, ``1 / h``) and ``ez [3, mz]`` (Mz's ``h``,
  then Gz's K and B factors: ``1 / h`` and ``c h`` for stiffness, ``0``
  and ``c h`` for mass), on the device (``element_tables_np``). The
  kernel applies the Dirichlet rows and columns as masks; its even-odd
  sweeps need centrosymmetric ``B`` and ``K`` (symmetric rules: Gauss, GLL).

Shard mode (``parallel/dist_banded.py``): a block of a partition takes
the tables of its physical elements (``phys_elems``; dead elements get
zero factors and zero band rows) with Dirichlet rows and columns zeroed on
its global walls only (``faces``), as the JAX ``BandedLayout(phys_elems=,
faces=)``; ``BandedTables.ident`` gives the kernel the identity rows per
axis (``parallel.BlockPartition.ident``): only those read ``u`` as 0 and write
``out = u``, and a shared face holds the block's partial sums.

The port works on the unpadded ``[nz, ny, nx]`` grid, with an optional
leading component count ``nc`` (the vector BPs: one launch for all
components, shared tables), the port's form of ``StackedBandedOperator``.

``banded_apply`` launches the CUDA kernel (``csrc/banded.cu``) for a CUDA
tensor (tables without the element form, or from an asymmetric rule, raise)
and calls the plain version ``banded_apply_reference`` for a CPU tensor;
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from .separable import _bands_from_dense, band_matrix_1d
from .stencil import identity_mask

__all__ = [
    "KINDS",
    "LAUNCHES",
    "MAX_DEGREE",
    "SHARD_LAUNCHES",
    "SOURCE",
    "BandedTables",
    "banded_apply",
    "banded_apply_reference",
    "banded_tables_np",
    "element_tables_np",
    "kernel_args",
    "kernel_tile",
    "library_tile",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "banded.cu"
MAX_DEGREE = 8
# the tables of each kind, in the launcher's argument order
KINDS = {"stiffness": ("mx", "ax", "my", "ay", "mz", "gz"), "mass": ("mx", "my", "gz")}

# kernel launches made by banded_apply (a run resets it to 0 to count its own)
LAUNCHES = 0
# of those, the launches on a shard's tables (``ident`` set)
SHARD_LAUNCHES = 0

# (storage dtype, compute dtype) -> the launcher's dtype code
_DTYPE_CODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


def _validate(mesh, basis, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"banded kernel: kind {kind!r} is not one of {sorted(KINDS)}")
    if not 1 <= basis.degree <= MAX_DEGREE:
        raise ValueError(f"banded kernel: degree {basis.degree} outside 1..{MAX_DEGREE}")
    if mesh.is_mapped:
        raise ValueError("banded kernel: uniform or graded bricks only (mapped meshes: use general or qgrid)")


def _element_matrices(basis) -> tuple[np.ndarray, np.ndarray]:
    """``B = S^T W S`` and ``K = D^T W D``, ``[p+1, p+1]`` float64."""
    w, S, D = basis.q_weights, basis.S, basis.D
    return np.einsum("q,qa,qb->ab", w, S, S), np.einsum("q,qa,qb->ab", w, D, D)


def _shard_args(mesh, phys_elems, faces):
    """Per axis (x, y, z): the physical element count and the lower and
    upper wall flags (one device: all elements, all walls)."""
    mx, my, mz = mesh.n_elements
    mx_p, my_p, mz_p = (mx, my, mz) if phys_elems is None else phys_elems
    z_lo, z_hi, y_lo, y_hi = (True,) * 4 if faces is None else faces
    if mx_p != mx:
        raise ValueError("banded shard tables: the x axis is never partitioned")
    for m, m_p, hi in ((my, my_p, y_hi), (mz, mz_p, z_hi)):
        if 0 < m_p < m and not hi:
            raise ValueError("banded shard tables: only a block on the upper wall holds dead elements")
    return (mx, True, True), (my_p, y_lo, y_hi), (mz_p, z_lo, z_hi)


def banded_tables_np(mesh, basis, kind: str = "stiffness", value_const: float | None = None,
                     phys_elems=None, faces=None) -> dict[str, np.ndarray]:
    """Host tables of K2 in float64, built as ``pallas_banded.BandedLayout``
    builds them (on the real rows only): per axis the mass and stiffness
    factors assembled with the per-element widths, Dirichlet rows and
    columns zeroed, as ``[n_d, 2p+1]`` band tables; the z table is
    ``gz = Az + c Mz`` (stiffness) or ``c Mz`` (mass).

    A shard's tables (``pallas_banded.py:184-210``): ``phys_elems = (mx,
    my_p, mz_p)`` assembles y and z over the first ``m_p`` physical
    elements (dead rows zero), ``faces = (z_lo, z_hi, y_lo, y_hi)`` zeroes
    the rows and columns of global walls only (the upper wall at the
    physical extent, dead rows beyond it)."""
    _validate(mesh, basis, kind)
    p = basis.degree
    B_e, K_e = _element_matrices(basis)
    hx, hy, hz = mesh.h_axes()
    mx, my, mz = mesh.n_elements
    (_, _, _), (my_p, y_lo, y_hi), (mz_p, z_lo, z_hi) = _shard_args(mesh, phys_elems, faces)

    def axis(m, m_p, h, lo, hi):
        """(mass bands, stiffness bands) of one axis, Dirichlet rows and
        columns zeroed on its walls: the per-axis factor of M A M."""
        h = np.broadcast_to(np.asarray(h, float).reshape(-1), (m,))
        n1 = m * p + 1
        A1, M1 = np.zeros((n1, n1)), np.zeros((n1, n1))
        if m_p > 0:
            n_p = m_p * p + 1
            A1[:n_p, :n_p] = band_matrix_1d(m_p, p, K_e, scale=1.0 / h[:m_p])
            M1[:n_p, :n_p] = band_matrix_1d(m_p, p, B_e, scale=h[:m_p])
        for mat in (A1, M1):
            if lo:
                mat[0, :] = mat[:, 0] = 0.0
            if hi:
                mat[m_p * p:, :] = mat[:, m_p * p:] = 0.0
        return (np.ascontiguousarray(_bands_from_dense(M1, p).T),
                np.ascontiguousarray(_bands_from_dense(A1, p).T))

    tabs = {}
    tabs["mx"], tabs["ax"] = axis(mx, mx, hx, True, True)
    tabs["my"], tabs["ay"] = axis(my, my_p, hy, y_lo, y_hi)
    tabs["mz"], az = axis(mz, mz_p, hz, z_lo, z_hi)
    c = 0.0 if value_const is None else float(value_const)
    if kind == "stiffness":
        tabs["gz"] = az + c * tabs["mz"]  # the value term folded into the z factor
        return tabs
    return {"mx": tabs["mx"], "my": tabs["my"], "gz": (1.0 if value_const is None else c) * tabs["mz"]}


def element_tables_np(mesh, basis, kind: str = "stiffness", value_const: float | None = None,
                      phys_elems=None) -> dict[str, np.ndarray]:
    """The element form of K2's tables in float64 (the same operator as
    ``banded_tables_np``): ``B``, ``K`` and the per-element factors ``ex [4,
    mx]``, ``ey [2, my]``, ``ez [3, mz]`` of the module docstring, fold
    factor 1. ``phys_elems``: a shard's physical element counts; the dead
    elements past them get zero factors (the walls are the kernel's
    identity rows, ``BandedTables.ident``)."""
    _validate(mesh, basis, kind)
    B, K = _element_matrices(basis)
    hx, hy, hz = (np.broadcast_to(np.asarray(h, float).reshape(-1), (m,))
                  for h, m in zip(mesh.h_axes(), mesh.n_elements))
    (_, _, _), (my_p, _, _), (mz_p, _, _) = _shard_args(mesh, phys_elems, None)
    if kind == "stiffness":
        c = 0.0 if value_const is None else float(value_const)
        gk = 1.0 / hz
    else:
        c = 1.0 if value_const is None else float(value_const)
        gk = np.zeros_like(hz)
    below = np.concatenate([[0.0], hx[:-1] / hx[1:]])  # h_{e-1} / h_e: the ratios of ex rows 0 and 1 to element e-1
    live_y = (np.arange(hy.size) < my_p)[None]
    live_z = (np.arange(hz.size) < mz_p)[None]
    return {"B": B, "K": K, "ex": np.stack([hx, 1.0 / hx, below, np.concatenate([[0.0], 1.0 / below[1:]])]),
            "ey": np.stack([hy, 1.0 / hy]) * live_y, "ez": np.stack([hz, gk, c * hz]) * live_z}


def kernel_tile(p: int) -> int:
    """The CUDA kernel's tile width in elements at degree p (``Tile::TE`` of
    ``csrc/banded.cu``): the largest te with (te p)^2 owned columns within
    two a thread of a 256-thread block. A restatement for hosts without the
    library (the tests' brick sizes); ``library_tile`` asks the library."""
    te = 32
    while te > 1 and (te * p) ** 2 > 2 * 256:
        te -= 1
    return te


def library_tile(p: int) -> int:
    """The tile width the built library uses at degree p (``banded_tile`` of
    ``csrc/banded.cu``; builds it on first use), 0 outside 1..MAX_DEGREE."""
    from ..utils.cuda_build import load_library

    fn = load_library(SOURCE).banded_tile
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(p)


def _centrosymmetric(M: np.ndarray) -> bool:
    """``M[p-i, p-j] = M[i, j]`` to 1e-12 of its largest entry (the kernel's
    own test)."""
    return bool(np.abs(M[::-1, ::-1] - M).max() <= 1e-12 * np.abs(M).max())


@dataclasses.dataclass
class BandedTables:
    """K2's tables: the band form the plain version reads (``ax, ay, mz``
    None for the mass kind) and the element form the CUDA kernel reads
    (``B_host``, ``K_host``, ``ex``, ``ey``, ``ez``; None for tables built
    from band tables alone, which run the plain version only). Both forms
    are checked once, when the tables are made; ``symmetric`` is set then.
    ``scale_`` rescales both, in place."""

    p: int
    mx: torch.Tensor
    my: torch.Tensor
    gz: torch.Tensor
    ax: torch.Tensor | None = None
    ay: torch.Tensor | None = None
    mz: torch.Tensor | None = None
    B_host: np.ndarray | None = None
    K_host: np.ndarray | None = None
    ex: torch.Tensor | None = None
    ey: torch.Tensor | None = None
    ez: torch.Tensor | None = None
    ident: tuple[int, ...] | None = None
    """The identity rows of a shard, ``(zlo, zhi, ylo, yhi, xlo, xhi)``
    (``parallel.BlockPartition.ident``; x keeps its two faces), None for the six
    faces."""
    symmetric: bool = dataclasses.field(init=False, repr=False)
    """Whether the element form exists and its ``B`` and ``K`` are
    centrosymmetric (symmetric rules): what the CUDA kernel needs."""

    def __post_init__(self):
        _check_bands(self)
        if self.ident is not None:
            self.ident = tuple(int(i) for i in self.ident)
            if len(self.ident) != 6 or self.ident[4:] != (1, self.shape[2] - 1):
                raise ValueError(f"banded: ident must be (zlo, zhi, ylo, yhi, 1, nx - 1), not {self.ident}")
        element = (self.B_host, self.K_host, self.ex, self.ey, self.ez)
        if all(t is None for t in element):
            self.symmetric = False
            return
        if any(t is None for t in element):
            raise ValueError("banded: the element form needs all of B_host, K_host, ex, ey and ez")
        p1 = self.p + 1
        if self.B_host.shape != (p1, p1) or self.K_host.shape != (p1, p1):
            raise ValueError(f"banded: element matrices B and K are not [{p1}, {p1}]")
        m = [(n - 1) // self.p for n in self.shape]  # (mz, my, mx)
        for name, shape in {"ex": (4, m[2]), "ey": (2, m[1]), "ez": (3, m[0])}.items():
            t = getattr(self, name)
            if tuple(t.shape) != shape or t.dtype != self.dtype or t.device != self.device or not t.is_contiguous():
                raise ValueError(f"banded: element factors {name} are not a contiguous {list(shape)} {self.dtype} "
                                 f"tensor on {self.device}")
        self.symmetric = _centrosymmetric(self.B_host) and _centrosymmetric(self.K_host)

    @staticmethod
    def from_numpy(tabs: dict, p: int, dtype: torch.dtype, device="cuda", element: dict | None = None,
                   ident=None) -> "BandedTables":
        """Tables from ``banded_tables_np`` keys (the kind follows from them)
        and, for the CUDA kernel, ``element_tables_np``'s ``element``; copied:
        ``scale_`` never reaches the caller's arrays."""
        bands = {k: torch.tensor(np.asarray(v), dtype=dtype, device=device) for k, v in tabs.items()}
        if element is None:
            return BandedTables(p, **bands, ident=ident)
        return BandedTables(
            p, **bands, ident=ident,
            **{f"{k}_host": np.array(element[k], dtype=np.float64, order="C") for k in ("B", "K")},
            **{k: torch.tensor(np.asarray(element[k]), dtype=dtype, device=device) for k in ("ex", "ey", "ez")},
        )

    @staticmethod
    def create(mesh, basis, dtype: torch.dtype, device="cuda", kind="stiffness", value_const=None) -> "BandedTables":
        """Both forms, from the mesh."""
        return BandedTables.from_numpy(banded_tables_np(mesh, basis, kind, value_const), basis.degree, dtype, device,
                                       element=element_tables_np(mesh, basis, kind, value_const))

    @property
    def kind(self) -> str:
        return "mass" if self.ax is None else "stiffness"

    @property
    def identity(self) -> tuple[int, ...]:
        """The identity rows the kernel is given: ``ident``, or the six faces."""
        if self.ident is not None:
            return self.ident
        nz, ny, nx = self.shape
        return (1, nz - 1, 1, ny - 1, 1, nx - 1)

    @property
    def tables(self) -> tuple[torch.Tensor, ...]:
        """The band tables of the kind, in ``KINDS`` order."""
        return tuple(getattr(self, k) for k in KINDS[self.kind])

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.gz.shape[0], self.my.shape[0], self.mx.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.gz.dtype

    @property
    def device(self) -> torch.device:
        return self.gz.device

    def scale_(self, s: float) -> None:
        """``A <- s A``: every Kronecker term carries exactly one x factor,
        so scaling the x tables scales the apply (identity faces unaffected),
        as ``BandedLayout.fold_bands`` does: ``mx``, ``ax`` and the factor
        rows of ``ex`` (not their ratios)."""
        self.mx.mul_(s)
        if self.ax is not None:
            self.ax.mul_(s)
        if self.ex is not None:
            self.ex[:2].mul_(s)


def _check_bands(tables: BandedTables) -> None:
    """The band tables' shapes, type, device and layout."""
    nt = 2 * tables.p + 1
    for name, t in zip(KINDS[tables.kind], tables.tables):
        n = {"x": tables.shape[2], "y": tables.shape[1], "z": tables.shape[0]}[name[1]]
        if tuple(t.shape) != (n, nt) or t.dtype != tables.dtype or t.device != tables.device:
            raise ValueError(f"banded: table {name} is not [{n}, {nt}] {tables.dtype} on {tables.device}")
        if not t.is_contiguous():
            raise ValueError("banded: the tables must be contiguous")


def _check(u: torch.Tensor, tables: BandedTables, out: torch.Tensor | None = None) -> int:
    """Validate ``u`` (and ``out``) against the tables (checked when they
    were made); return the launcher's dtype code."""
    code = _DTYPE_CODES.get((u.dtype, tables.dtype))
    if code is None:
        raise TypeError(
            f"banded: storage {u.dtype} with compute {tables.dtype} is not one "
            f"of {[tuple(str(d) for d in k) for k in _DTYPE_CODES]}"
        )
    if u.dim() not in (3, 4) or tuple(u.shape[-3:]) != tables.shape or u.dim() == 4 and u.shape[0] < 1:
        raise ValueError(f"banded: u has shape {tuple(u.shape)}, tables {tables.shape} (or [nc, ...])")
    if u.device != tables.device:
        raise ValueError(f"banded: u on {u.device}, tables on {tables.device}")
    if not u.is_contiguous():
        raise ValueError("banded: u must be contiguous")
    if out is not None:
        if out.shape != u.shape or out.dtype != u.dtype or out.device != u.device or not out.is_contiguous():
            raise ValueError("banded: out must be a contiguous tensor of u's shape, dtype and device")
        lo, hi = u.data_ptr(), u.data_ptr() + u.numel() * u.element_size()
        olo = out.data_ptr()
        if olo < hi and lo < olo + out.numel() * out.element_size():
            raise ValueError("banded: out must not overlap u")
    return code


def _sweep(v: torch.Tensor, table: torch.Tensor, axis: int, p: int):
    """The 2p+1 terms ``table[i, t] * v[i - p + t]`` along ``axis`` (-3, -2
    or -1) of ``v``, zero outside the grid, in tap order (a generator: the
    caller's sum holds one term at a time)."""
    n = v.shape[axis]
    pad = [0, 0] * (-axis - 1) + [p, p]
    vp = torch.nn.functional.pad(v, pad)
    shape = [n if a == axis else 1 for a in (-3, -2, -1)]
    return (table[:, t].reshape(shape) * vp.narrow(axis, t, n) for t in range(2 * p + 1))


def apply_plain(uc: torch.Tensor, tables: BandedTables) -> torch.Tensor:
    """K2's arithmetic in torch ops on a grid (or a stack of grids) at the
    compute dtype, the taps summed in the TPU kernel's order: z taps, then
    y, then x, each tap's pair of products added before it enters the sum
    (``pallas_banded.py:374-431``); ``uc`` on the faces."""
    p = tables.p
    stiff = tables.kind == "stiffness"
    w2 = sum(_sweep(uc, tables.gz, -3, p), torch.zeros_like(uc))
    if stiff:
        w1 = sum(_sweep(uc, tables.mz, -3, p), torch.zeros_like(uc))
        q1 = sum(_sweep(w1, tables.my, -2, p), torch.zeros_like(uc))
        q2 = sum((a + b for a, b in zip(_sweep(w2, tables.my, -2, p), _sweep(w1, tables.ay, -2, p))),
                 torch.zeros_like(uc))
        acc = sum((a + b for a, b in zip(_sweep(q2, tables.mx, -1, p), _sweep(q1, tables.ax, -1, p))),
                  torch.zeros_like(uc))
    else:
        q2 = sum(_sweep(w2, tables.my, -2, p), torch.zeros_like(uc))
        acc = sum(_sweep(q2, tables.mx, -1, p), torch.zeros_like(uc))
    return torch.where(identity_mask(tables.shape, tables.identity, uc.device), uc, acc)


def banded_apply_reference(u: torch.Tensor, tables: BandedTables) -> torch.Tensor:
    """The plain torch version of K2: the same formula in torch ops on the
    band tables (checked again here: the plain version reads them)."""
    _check(u, tables)
    _check_bands(tables)
    return apply_plain(u.to(tables.dtype), tables).to(u.dtype)


def kernel_args(tables: BandedTables) -> tuple[int, int, int, int, int]:
    """The addresses of what the CUDA kernel reads, ``(ex, ey, ez)`` on the
    device and ``(B_host, K_host)`` in host memory: raises ``ValueError`` for
    band tables alone (no element form) or an asymmetric rule."""
    if tables.B_host is None:
        raise ValueError("banded: these tables hold the band form only (BandedTables.from_numpy without element=): "
                         "the CUDA kernel reads the element form; build the tables with BandedTables.create")
    if not tables.symmetric:
        raise ValueError("banded: the CUDA kernel needs a symmetric rule (Gauss or GLL): centrosymmetric element "
                         "matrices B and K, M[p-i, p-j] = M[i, j]")
    return (tables.ex.data_ptr(), tables.ey.data_ptr(), tables.ez.data_ptr(),
            tables.B_host.ctypes.data, tables.K_host.ctypes.data)


_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4


@functools.cache
def _launcher():
    from ..utils.cuda_build import load_library

    fn = load_library(SOURCE).banded_apply_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def banded_apply(u: torch.Tensor, tables: BandedTables, out: torch.Tensor | None = None) -> torch.Tensor:
    """``out = K2(u)`` on a ``[nz, ny, nx]`` or ``[nc, nz, ny, nx]`` tensor
    (one launch for all components): the CUDA kernel for a CUDA tensor
    (raises if it cannot launch), the plain version for a CPU tensor.
    ``out``: a buffer of u's shape and dtype to write (every entry is
    written), else a new tensor."""
    global LAUNCHES, SHARD_LAUNCHES
    code = _check(u, tables, out)
    if u.device.type == "cpu":
        want = banded_apply_reference(u, tables)
        return want if out is None else out.copy_(want)
    if u.device.type != "cuda":
        raise ValueError(f"banded: unsupported device {u.device}")
    ex, ey, ez, b_host, k_host = kernel_args(tables)
    launch = _launcher()
    out = torch.empty_like(u) if out is None else out
    nc = 1 if u.dim() == 3 else u.shape[0]
    nz, ny, nx = tables.shape
    ident = None if tables.ident is None else (ctypes.c_int * 4)(*tables.ident[:4])
    with torch.cuda.device(u.device):
        rc = launch(
            code, tables.p, int(tables.kind == "stiffness"), u.data_ptr(), out.data_ptr(), ex, ey, ez,
            nc, nz, ny, nx, torch.cuda.current_stream(u.device).cuda_stream, b_host, k_host, ident,
        )
    if rc != 0:
        raise RuntimeError(f"banded kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    if tables.ident is not None:
        SHARD_LAUNCHES += 1
    return out
