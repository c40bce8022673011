"""Separable (Kronecker) global operator apply — the plain uniform-brick path.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/separable.py``. On a brick
mesh with a per-axis coefficient, gather -> sum-factorize -> scatter
collapses globally: for each tensor direction "scatter o (1D element
matrix) o gather" is a global banded 1D operator, and "scatter o diag(w) o
gather" a global diagonal. Hence (3D Poisson, reference BP5 configuration):

    A  =  Dz (x) Dy (x) A1x  +  Dz (x) A1y (x) Dx  +  A1z (x) Dy (x) Dx

with A1 = Z^T (D^T diag(w) D) Z banded (half-bandwidth p) and D diagonal,
the geometry absorbed per axis. The apply is three 1D-operator sweeps plus
one elementwise combine, with no gather and no scatter. A sweep is either a
dense ``[n1, n1]`` contraction (``"matmul"``, one batched GEMM) or 2p+1
shifted multiply-adds over the band representation (``"stencil"``).

The host tables (``band_matrix_1d`` ... ``poisson_terms``' assembly) are
numpy copies of the JAX package's; the parity tests assert equality.
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch

from ..basis import Basis1D
from .sum_factorization import sweep

__all__ = [
    "band_matrix_1d",
    "diag_vector_1d",
    "apply_separable",
    "apply_separable_plane",
    "band_apply",
    "mass_terms",
    "poisson_terms",
]


def band_matrix_1d(m: int, p: int, elem_mat: np.ndarray, scale=None) -> np.ndarray:
    """Assemble the global 1D operator ``Z^T diag(scale) E Z`` for ``m``
    elements of degree p from the (p+1)x(p+1) element matrix E: dense
    ``[n1, n1]`` with n1 = m*p+1 (banded, half-bandwidth p). ``scale``:
    optional per-element factor (graded tensor meshes)."""
    n1 = m * p + 1
    A = np.zeros((n1, n1))
    for e in range(m):
        s = e * p
        c = 1.0 if scale is None else float(scale[e])
        A[s : s + p + 1, s : s + p + 1] += c * elem_mat
    return A


def diag_vector_1d(m: int, p: int, w: np.ndarray, scale=None) -> np.ndarray:
    """Assemble the global diagonal ``Z^T diag(scale_e * w) Z``: shared
    nodes sum the weights of both adjacent elements."""
    n1 = m * p + 1
    d = np.zeros(n1)
    for e in range(m):
        c = 1.0 if scale is None else float(scale[e])
        d[e * p : e * p + p + 1] += c * w
    return d


def band_apply(
    u: torch.Tensor,
    mat: torch.Tensor,
    bands: torch.Tensor,
    axis: int,
    mode: Literal["matmul", "stencil"],
    p: int,
) -> torch.Tensor:
    """Apply a banded global 1D operator along ``axis``.

    mode="matmul": one dense contraction (wasteful in FLOPs for large n1,
        but a single GEMM).
    mode="stencil": 2p+1 shifted multiply-adds using the band
        representation ``bands[2p+1, n1]`` (bands[p+k][i] = A[i, i+k]).
    """
    if mode == "matmul":
        return sweep(u, mat, axis)
    n1 = u.shape[axis]
    shape = [1] * u.dim()
    shape[axis] = n1
    up = torch.movedim(
        torch.nn.functional.pad(torch.movedim(u, axis, -1), (p, p)), -1, axis
    )
    out = None
    for k in range(-p, p + 1):
        contrib = up.narrow(axis, p + k, n1) * bands[p + k].reshape(shape)
        out = contrib if out is None else out + contrib
    return out


def apply_separable(
    u: torch.Tensor,
    terms: Sequence[dict],
    mode: Literal["matmul", "stencil"] = "matmul",
) -> torch.Tensor:
    """u: ``[nz, ny, nx]`` nodal grid. ``terms``: list of dicts with keys
    ``coef`` (scalar), ``band`` (list of (axis, mat, bands, p)) and ``diag``
    (broadcastable diagonal tensor for the remaining axes, may be None).
    Returns the sum of all terms."""
    out = None
    for t in terms:
        v = u
        for axis, mat, bands, p in t["band"]:
            v = band_apply(v, mat, bands, axis, mode, p)
        if t["diag"] is not None:
            v = v * t["diag"]
        v = t["coef"] * v
        out = v if out is None else out + v
    return out


def apply_separable_plane(
    u: torch.Tensor,
    terms: Sequence[dict],
    axis: int,
    side: int,
    mode: Literal["matmul", "stencil"] = "matmul",
) -> torch.Tensor:
    """The first (``side == 0``) or last (``side == -1``) output plane of
    :func:`apply_separable` along ``axis``, from the p+1 nearest input
    planes only: one plane's work instead of a full apply (JAX
    ``ops/separable.py:128``). The distributed boundary partial: the shared
    plane a rank must send depends on this alone, so the halo exchange can
    start before the full local apply. Returns the plane with ``keepdims``
    (size 1 along ``axis``)."""
    n = u.shape[axis]
    out = None
    for t in terms:
        on_axis = [b for b in t["band"] if b[0] == axis]
        others = [b for b in t["band"] if b[0] != axis]
        if on_axis:
            _, mat, _, p = on_axis[0]
            lo = 0 if side == 0 else n - p - 1
            row = mat[0, 0 : p + 1] if side == 0 else mat[n - 1, n - p - 1 : n]
            shape = [1] * u.dim()
            shape[axis] = p + 1
            v = torch.sum(u.narrow(axis, lo, p + 1) * row.reshape(shape), dim=axis, keepdim=True)
        else:
            v = u.narrow(axis, 0 if side == 0 else n - 1, 1)
        for ax2, mat2, bands2, p2 in others:
            v = band_apply(v, mat2, bands2, ax2, mode, p2)
        if t["diag"] is not None:
            d = t["diag"]
            if d.dim() == u.dim() and d.shape[axis] == n:
                d = d.narrow(axis, 0 if side == 0 else n - 1, 1)
            v = v * d
        v = t["coef"] * v
        out = v if out is None else out + v
    return out


# --------------------------------------------------------------------- #
# term builders
# --------------------------------------------------------------------- #
def _bands_from_dense(A: np.ndarray, p: int) -> np.ndarray:
    """bands[p+k, i] = A[i, i+k] for k in [-p, p] (zero outside)."""
    n1 = A.shape[0]
    bands = np.zeros((2 * p + 1, n1))
    for k in range(-p, p + 1):
        lo, hi = max(0, -k), min(n1, n1 - k)
        idx = np.arange(lo, hi)
        bands[p + k, idx] = A[idx, idx + k]
    return bands


def _axis_tables(mesh, basis):
    """Per grid axis (0=z, 1=y, 2=x): the assembled global 1D tables with
    all geometric scaling absorbed per axis (so the Kronecker terms carry
    coefficient 1.0; this keeps graded tensor meshes on the fast path):

      A1 = Z^T diag(1/h_e) K Z   (stiffness factor)
      B  = Z^T diag(h_e)  M  Z   (value factor, Gauss rules)
      d  = Z^T diag(h_e * w) Z   (pointwise weights, GLL collocation)
    """
    if mesh.is_mapped:
        raise ValueError(
            "separable backend: uniform or graded bricks only (mapped meshes have "
            "non-separable metric terms: use structured, qgrid or general)"
        )
    p = basis.degree
    S, D, w = basis.S, basis.D, basis.q_weights
    K_e = np.einsum("q,qa,qb->ab", w, D, D)
    B_e = np.einsum("q,qa,qb->ab", w, S, S)
    hx, hy, hz = mesh.h_axes()
    mx, my, mz = mesh.n_elements
    axis_data = {0: (mz, hz), 1: (my, hy), 2: (mx, hx)}
    out = {}
    for ax, (m, h) in axis_data.items():
        out[ax] = {
            "A1": band_matrix_1d(m, p, K_e, scale=1.0 / h),
            "B": band_matrix_1d(m, p, B_e, scale=h),
            # pointwise weights only exist at collocation (q == p+1, GLL)
            "d": diag_vector_1d(m, p, w, scale=h) if basis.collocation else None,
        }
    return out


def _bshape(vec: np.ndarray, axis: int) -> np.ndarray:
    shape = [1, 1, 1]
    shape[axis] = vec.shape[0]
    return vec.reshape(shape)


def poisson_terms(mesh, basis: Basis1D, dtype: torch.dtype, device="cuda") -> list[dict]:
    """BP5/BP3 stiffness on a (uniform or graded) tensor brick: 3
    Kronecker terms, geometry absorbed into the per-axis tables."""
    p = basis.degree
    tabs = _axis_tables(mesh, basis)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    terms = []
    for ax in (2, 1, 0):
        others = [a for a in (0, 1, 2) if a != ax]
        A1 = tabs[ax]["A1"]
        band = [(ax, dev(A1), dev(_bands_from_dense(A1, p)), p)]
        if basis.collocation:
            diag = dev(
                _bshape(tabs[others[0]]["d"], others[0])
                * _bshape(tabs[others[1]]["d"], others[1])
            )
        else:
            for a in others:
                B = tabs[a]["B"]
                band.append((a, dev(B), dev(_bands_from_dense(B, p)), p))
            diag = None
        terms.append({"coef": 1.0, "band": band, "diag": diag})
    return terms


def mass_terms(mesh, basis: Basis1D, dtype: torch.dtype, device="cuda") -> list[dict]:
    """BP1 mass on a (uniform or graded) tensor brick: one Kronecker term
    (fully diagonal at GLL collocation, the lumped spectral-element mass;
    three banded factors for Gauss rules)."""
    p = basis.degree
    tabs = _axis_tables(mesh, basis)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if basis.collocation:
        diag = _bshape(tabs[0]["d"], 0) * _bshape(tabs[1]["d"], 1) * _bshape(tabs[2]["d"], 2)
        return [{"coef": 1.0, "band": [], "diag": dev(diag)}]
    band = [(a, dev(tabs[a]["B"]), dev(_bands_from_dense(tabs[a]["B"], p)), p) for a in (0, 1, 2)]
    return [{"coef": 1.0, "band": band, "diag": None}]
