"""K1, the collocated GLL stiffness stencil: host tables, CUDA wrapper, plain twin.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py``. On a
uniform brick with GLL collocation the Poisson apply is the symmetrically
rescaled stencil

    v = S .* u,   out = S .* (Bz_z v + By_y v + Bx_x v),   S = sz (x) sy (x) sx

with ``B_d = c_d d^{-1/2} A1_d d^{-1/2}`` the weight-normalised banded 1D
stiffness factors (2p+1 taps) and ``s_d = sqrt(d)`` the assembled pointwise
quadrature weights, zeroed on the Dirichlet rows, so the stencil computes
the constrained ``M A M``. The kernel also writes the identity rows
(``out = u`` on the six boundary faces): one ``vmult`` is one launch.

Shard mode (``parallel/dist_stencil.py``): on a block of a partition the
tables are assembled over the block's physical elements only
(``stencil_tables_np(..., phys_elems=, faces=)``, as the JAX
``StencilLayout(phys_elems=, faces=)`` builds them): shared faces keep
their partial ``sqrt(d)``, rows at or beyond the global extent get ``s =
0``. The identity rows are then given per axis, ``StencilTables.ident =
(zlo, zhi, ylo, yhi, xlo, xhi)``: row i of an axis is one when ``i < lo``
or ``i >= hi``, the global walls and the dead rows (``None``: the six
faces). ``(0, n)`` on every axis is the raw apply with no identity row.

Unlike the TPU kernel, the port works on the unpadded ``[nz, ny, nx]`` grid;
the 128-lane x rounding, the y sublane pad and the VMEM windows were
Mosaic's constraints. Tables: ``bz [nz, 2p+1]``, ``by [ny, 2p+1]``,
``bx [nx, 2p+1]``, ``sz [nz]``, ``sy [ny]``, ``sx [nx]`` in the compute dtype,
and optionally the value coefficient ``a [nz, ny, nx]``: the collocated
Helmholtz mass term ``diag(d3 a) u = S diag(a) S u`` (the JAX kernel's
``has_value``), added to the taps as ``a * v`` before the final scaling.

K1 also takes a stack ``[nc, nz, ny, nx]`` of nc components that share the
tables (and ``a``), with identity faces per component, in one launch: the
vector BP6, the port's form of ``StackedStencilOperator``
(``pallas_stencil.py:701-864``; a batch index, not z-stacked slabs).
``NC_LAUNCHES`` counts the launches with more than one component.

``stencil_apply`` launches the CUDA kernel (``csrc/stencil.cu``) for a CUDA
tensor and calls the plain twin ``stencil_apply_reference`` for a CPU
tensor; ``LAUNCHES`` counts kernel launches, ``VALUE_LAUNCHES`` those with
the value term.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from .separable import _bands_from_dense, band_matrix_1d, diag_vector_1d

__all__ = [
    "LAUNCHES",
    "MAX_DEGREE",
    "NC_LAUNCHES",
    "PLANE_LAUNCHES",
    "SHARD_LAUNCHES",
    "VALUE_LAUNCHES",
    "SOURCE",
    "StencilTables",
    "identity_mask",
    "plane_partial",
    "plane_slab",
    "stencil_apply",
    "stencil_apply_reference",
    "stencil_tables_np",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "stencil.cu"
MAX_DEGREE = 8

# kernel launches made by stencil_apply (a run resets it to 0 to count its own)
LAUNCHES = 0
# of those, the launches with the value term
VALUE_LAUNCHES = 0
# of those, the launches with more than one component
NC_LAUNCHES = 0
# of those, the launches on a shard's tables (``ident`` set), and the plane
# partials among them (``plane_partial``)
SHARD_LAUNCHES = 0
PLANE_LAUNCHES = 0

# (storage dtype, compute dtype) -> the launcher's dtype code
_DTYPE_CODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


def stencil_tables_np(mesh, basis, phys_elems=None, faces=None) -> dict[str, np.ndarray]:
    """Host tables of K1 for a uniform brick and a collocated basis, in
    float64 (built as ``pallas_stencil.StencilLayout`` builds them, on the
    real rows only): band tables ``b{z,y,x} [n_d, 2p+1]`` and scaling
    vectors ``s{z,y,x} [n_d]``.

    A shard's tables (``pallas_stencil.py:278-313``): ``phys_elems = (mx_p,
    my_p, mz_p)`` assembles each axis over its first ``m_p`` physical
    elements only (the rest are dead padding past the global extent, zero
    rows), and ``faces = (z_lo, z_hi, y_lo, y_hi)`` says which block faces
    are global Dirichlet walls (x always is: it is never partitioned). A
    shared face keeps its partial ``sqrt(d)``; rows at or beyond the
    global extent get ``s = 0``."""
    if not basis.collocation:
        raise ValueError("stencil kernel requires GLL collocation (q = p+1)")
    if not mesh.is_uniform:
        raise ValueError("stencil kernel: uniform meshes only (use separable)")
    p = basis.degree
    if not 1 <= p <= MAX_DEGREE:
        raise ValueError(f"stencil kernel: degree {p} outside 1..{MAX_DEGREE}")
    w, D = basis.q_weights, basis.D
    K_e = np.einsum("q,qa,qb->ab", w, D, D)
    hx, hy, hz = mesh.h
    det = hx * hy * hz
    mx, my, mz = mesh.n_elements
    mx_p, my_p, mz_p = (mx, my, mz) if phys_elems is None else phys_elems
    z_lo, z_hi, y_lo, y_hi = (True,) * 4 if faces is None else faces
    if mx_p != mx:
        raise ValueError("stencil shard tables: the x axis is never partitioned")
    out = {}
    for name, m, m_p, c, lo, hi in (("x", mx, mx, det / hx**2, True, True),
                                    ("y", my, my_p, det / hy**2, y_lo, y_hi),
                                    ("z", mz, mz_p, det / hz**2, z_lo, z_hi)):
        n1 = m * p + 1
        A1, d = np.zeros((n1, n1)), np.zeros(n1)
        if m_p > 0:
            n_p = m_p * p + 1
            A1[:n_p, :n_p] = band_matrix_1d(m_p, p, K_e)
            d[:n_p] = diag_vector_1d(m_p, p, w)
        if 0 < m_p < m and not hi:
            raise ValueError("stencil shard tables: only a block on the upper wall holds dead elements")
        inv_s = np.where(d > 0, 1.0 / np.sqrt(np.where(d > 0, d, 1.0)), 0.0)
        B = c * (inv_s[:, None] * A1 * inv_s[None, :])
        s = np.sqrt(d)
        # Dirichlet masking baked into the scaling: S vanishes exactly on the
        # constrained set (walls and dead rows), so the stencil computes M A M
        if lo:
            s[0] = 0.0
        if hi:
            s[m_p * p:] = 0.0
        out["b" + name] = np.ascontiguousarray(_bands_from_dense(B, p).T)
        out["s" + name] = s
    return out


@dataclasses.dataclass
class StencilTables:
    """K1's device tables; ``scale_`` rescales the tables the kernel reads,
    in place. ``a``: the optional value coefficient ``[nz, ny, nx]``.
    ``ident``: the identity rows ``(zlo, zhi, ylo, yhi, xlo, xhi)`` of a
    shard (``parallel.BlockPartition.ident``), None for the six boundary faces."""

    p: int
    bz: torch.Tensor
    by: torch.Tensor
    bx: torch.Tensor
    sz: torch.Tensor
    sy: torch.Tensor
    sx: torch.Tensor
    a: torch.Tensor | None = None
    ident: tuple[int, ...] | None = None

    @staticmethod
    def from_numpy(tabs: dict, p: int, dtype: torch.dtype, device="cuda", ident=None) -> "StencilTables":
        """Tables from ``stencil_tables_np`` keys, plus ``"a"`` if present."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        a = tabs.get("a")
        return StencilTables(
            p, *(dev(tabs[k]) for k in ("bz", "by", "bx", "sz", "sy", "sx")),
            a=None if a is None else dev(a), ident=None if ident is None else tuple(int(i) for i in ident),
        )

    @staticmethod
    def create(mesh, basis, dtype: torch.dtype, device="cuda", value=None) -> "StencilTables":
        """``value``: a nodal coefficient ``[nz, ny, nx]`` (host array) for
        the value term, or None."""
        tabs = stencil_tables_np(mesh, basis)
        if value is not None:
            tabs["a"] = value
        return StencilTables.from_numpy(tabs, basis.degree, dtype, device)

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.sz.shape[0], self.sy.shape[0], self.sx.shape[0])

    @property
    def identity(self) -> tuple[int, ...]:
        """The identity rows ``(zlo, zhi, ylo, yhi, xlo, xhi)`` the kernel is
        given: ``ident``, or the six faces."""
        if self.ident is not None:
            return self.ident
        nz, ny, nx = self.shape
        return (1, nz - 1, 1, ny - 1, 1, nx - 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.bz.dtype

    @property
    def device(self) -> torch.device:
        return self.bz.device

    def scale_(self, s: float) -> None:
        """``out = S (Bz + By + Bx + a) S u``: scaling every band table and
        the value table by s scales the whole apply by s (identity faces
        unaffected)."""
        for t in (self.bz, self.by, self.bx, self.a):
            if t is not None:
                t.mul_(s)


def _check(u: torch.Tensor, tables: StencilTables, out: torch.Tensor | None = None) -> int:
    """Validate ``u`` (and ``out``) against the tables; return the
    launcher's dtype code."""
    code = _DTYPE_CODES.get((u.dtype, tables.dtype))
    if code is None:
        raise TypeError(
            f"stencil: storage {u.dtype} with compute {tables.dtype} is not one "
            f"of {[tuple(str(d) for d in k) for k in _DTYPE_CODES]}"
        )
    if u.dim() not in (3, 4) or tuple(u.shape[-3:]) != tables.shape or u.dim() == 4 and u.shape[0] < 1:
        raise ValueError(f"stencil: u has shape {tuple(u.shape)}, tables {tables.shape} (or [nc, ...])")
    if u.device != tables.device:
        raise ValueError(f"stencil: u on {u.device}, tables on {tables.device}")
    nt = 2 * tables.p + 1
    for name, n in zip(("bz", "by", "bx"), tables.shape):
        if tuple(getattr(tables, name).shape) != (n, nt):
            raise ValueError(f"stencil: table {name} is not [{n}, {nt}]")
    if tables.ident is not None and len(tables.ident) != 6:
        raise ValueError(f"stencil: ident must be six ints (zlo, zhi, ylo, yhi, xlo, xhi), not {tables.ident}")
    if tables.ident is not None and u.dim() == 4 and u.shape[0] > 1:
        raise ValueError("stencil: shard mode (ident) takes one component")
    if tables.a is not None and tuple(tables.a.shape) != tables.shape:
        raise ValueError(f"stencil: value table is {tuple(tables.a.shape)}, not {tables.shape}")
    if not u.is_contiguous() or not all(
        t.is_contiguous()
        for t in (tables.bz, tables.by, tables.bx, tables.sz, tables.sy, tables.sx, tables.a)
        if t is not None
    ):
        raise ValueError("stencil: u and the tables must be contiguous")
    if out is not None:
        if out.shape != u.shape or out.dtype != u.dtype or out.device != u.device or not out.is_contiguous():
            raise ValueError("stencil: out must be a contiguous tensor of u's shape, dtype and device")
        lo, hi = u.data_ptr(), u.data_ptr() + u.numel() * u.element_size()
        olo = out.data_ptr()
        if olo < hi and lo < olo + out.numel() * out.element_size():
            raise ValueError("stencil: out must not overlap u")
    return code


def face_mask(shape, device) -> torch.Tensor:
    """bool ``[nz, ny, nx]``, True on the six boundary faces."""
    nz, ny, nx = shape
    return identity_mask(shape, (1, nz - 1, 1, ny - 1, 1, nx - 1), device)


def identity_mask(shape, ident, device) -> torch.Tensor:
    """bool ``[nz, ny, nx]``, True on the identity rows ``ident = (zlo, zhi,
    ylo, yhi, xlo, xhi)``: index i of an axis when ``i < lo`` or ``i >=
    hi``."""
    masks = []
    for axis, n in enumerate(shape):
        i = torch.arange(n, device=device)
        shape1 = [1, 1, 1]
        shape1[axis] = n
        masks.append(((i < ident[2 * axis]) | (i >= ident[2 * axis + 1])).reshape(shape1))
    return (masks[0] | masks[1] | masks[2]).expand(tuple(shape))


def apply_plain(uc: torch.Tensor, tables: StencilTables) -> torch.Tensor:
    """K1's arithmetic in torch ops on a grid (or a stack of grids) at the
    compute dtype: ``S (Bz + By + Bx [+ a]) S uc`` inside, ``uc`` on the
    faces."""
    p = tables.p
    nz, ny, nx = tables.shape
    sz = tables.sz[:, None, None]
    syx = tables.sy[:, None] * tables.sx[None, :]
    v = uc * sz * syx
    vp = torch.nn.functional.pad(v, (p, p, p, p, p, p))
    # z taps, then y taps, then x taps, then the value term, as the TPU
    # kernel sums them
    acc = torch.zeros_like(uc)
    for t in range(2 * p + 1):
        acc += tables.bz[:, t, None, None] * vp[..., t : t + nz, p : p + ny, p : p + nx]
    for t in range(2 * p + 1):
        acc += tables.by[None, :, t, None] * vp[..., p : p + nz, t : t + ny, p : p + nx]
    for t in range(2 * p + 1):
        acc += tables.bx[None, None, :, t] * vp[..., p : p + nz, p : p + ny, t : t + nx]
    if tables.a is not None:
        acc += tables.a * v
    return torch.where(identity_mask((nz, ny, nx), tables.identity, uc.device), uc, acc * sz * syx)


def stencil_apply_reference(u: torch.Tensor, tables: StencilTables) -> torch.Tensor:
    """The plain torch twin of K1: the same formula in torch ops."""
    _check(u, tables)
    return apply_plain(u.to(tables.dtype), tables).to(u.dtype)


_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def _launcher():
    from ..utils.cuda_build import load_library

    fn = load_library(SOURCE).stencil_apply_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def stencil_apply(u: torch.Tensor, tables: StencilTables, out: torch.Tensor | None = None) -> torch.Tensor:
    """``out = K1(u)`` on a ``[nz, ny, nx]`` or ``[nc, nz, ny, nx]`` tensor
    (one launch for all components): the CUDA kernel for a CUDA tensor
    (raises if it cannot launch), the plain twin for a CPU tensor.
    ``out``: a buffer of u's shape and dtype, not overlapping u, to write
    (every entry is written), else a new tensor."""
    global LAUNCHES, VALUE_LAUNCHES, NC_LAUNCHES, SHARD_LAUNCHES
    code = _check(u, tables, out)
    if u.device.type == "cpu":
        want = stencil_apply_reference(u, tables)
        return want if out is None else out.copy_(want)
    if u.device.type != "cuda":
        raise ValueError(f"stencil: unsupported device {u.device}")
    launch = _launcher()
    out = torch.empty_like(u) if out is None else out
    nz, ny, nx = tables.shape
    nc = 1 if u.dim() == 3 else u.shape[0]
    ident = None if tables.ident is None else (ctypes.c_int * 6)(*tables.ident)
    with torch.cuda.device(u.device):
        rc = launch(
            code, tables.p, u.data_ptr(), out.data_ptr(),
            tables.bz.data_ptr(), tables.by.data_ptr(), tables.bx.data_ptr(),
            tables.sz.data_ptr(), tables.sy.data_ptr(), tables.sx.data_ptr(),
            None if tables.a is None else tables.a.data_ptr(),
            nc, nz, ny, nx, torch.cuda.current_stream(u.device).cuda_stream, ident,
        )
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    if tables.a is not None:
        VALUE_LAUNCHES += 1
    if nc > 1:
        NC_LAUNCHES += 1
    if tables.ident is not None:
        SHARD_LAUNCHES += 1
    return out


def plane_partial(u: torch.Tensor, tables: StencilTables, axis: int, side: int) -> torch.Tensor:
    """The first (``side = 0``) or last (``side = -1``) output plane along
    ``axis`` (0 = z, 1 = y) of K1's raw apply (no identity row) at the
    compute dtype, from the p+1 planes next to it: the boundary partial a
    shard sends before its full apply (the counterpart of the JAX
    ``stencil_plane_padded``, ``pallas_stencil.py:386-440``). One K1 launch
    on the slab, at the compute dtype (bf16 vectors give f32 partials, to
    be rounded once after the sum), with the slab's rows of the tables;
    returns the plane ``[ny, nx]`` (z) or ``[nz, nx]`` (y). Zero on the
    identity rows of ``tables`` (their scalings are 0)."""
    global PLANE_LAUNCHES
    slab, sub = plane_slab(u, tables, axis, side)
    out = stencil_apply(slab, sub)
    if u.device.type == "cuda":
        PLANE_LAUNCHES += 1
    dim = u.dim() - 3 + axis
    return out.select(dim, 0 if side == 0 else slab.shape[dim] - 1)


def plane_slab(u: torch.Tensor, tables: StencilTables, axis: int, side: int):
    """What ``plane_partial`` launches K1 on: the (p+1)-plane slab of ``u``
    next to its first (``side = 0``) or last (``side = -1``) plane along
    ``axis``, at the compute dtype, and the raw tables of the slab (its rows
    of the tables, no identity row). Returns ``(slab, tables)``."""
    p = tables.p
    n = tables.shape[axis]
    k = min(p + 1, n)
    lo = 0 if side == 0 else n - k
    slab = u.narrow(u.dim() - 3 + axis, lo, k).to(tables.dtype).contiguous()
    names = ("bz", "sz") if axis == 0 else ("by", "sy")
    nz, ny, nx = (k if d == axis else n_d for d, n_d in enumerate(tables.shape))
    sub = dataclasses.replace(
        tables, **{name: getattr(tables, name).narrow(0, lo, k) for name in names},
        a=None if tables.a is None else tables.a.narrow(axis, lo, k).contiguous(),
        ident=(0, nz, 0, ny, 0, nx),
    )
    return slab, sub
