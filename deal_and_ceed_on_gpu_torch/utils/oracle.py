"""Dense/sparse assembly oracle (numpy/scipy, CPU, float64).

Copy of ``deal_and_ceed_on_gpu_tpu/utils/oracle.py`` (that package's
``__init__`` imports jax): assemble the actual global sparse matrix of a
small mesh with the quadrature the matrix-free operator uses, so operator
outputs agree to roundoff. Host set-up and test infrastructure only; the
adaptive multigrid assembles its coarse level from :func:`element_matrix`
(``solvers/adaptive_mg.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp

from ..basis import Basis1D, basis_tables_3d
from ..geometry import Geometry
from ..mesh import BrickMesh

__all__ = [
    "element_matrix",
    "assemble_sparse",
    "assemble_sparse_general",
    "apply_constrained",
    "constrained_matrix",
]


def _kron3(az, ay, ax):
    return np.kron(az, np.kron(ay, ax))


def element_matrix(
    mesh: BrickMesh,
    basis: Basis1D,
    kind: str,
    cell_qpoints: Optional[np.ndarray] = None,
    coefficient_fn: Optional[Callable] = None,
    h_cell=None,
) -> np.ndarray:
    """Per-element matrix ``[(p+1)^3, (p+1)^3]`` (local lexicographic
    z,y,x order, x fastest) using the basis's quadrature rule.

    kind: "stiffness" | "mass" | "helmholtz" (stiffness + a(x) mass).
    For "helmholtz", ``cell_qpoints [n_q, 3]`` gives physical quadrature
    points of the specific cell (the matrix is then cell-dependent).
    ``h_cell``: (hx, hy, hz) of the specific cell (graded meshes).
    """
    hx, hy, hz = h_cell if h_cell is not None else mesh.h
    det = hx * hy * hz
    S, D, w = basis.S, basis.D, basis.q_weights
    # 1D quadrature-evaluated matrices on [0,1]
    M1 = np.einsum("q,qa,qb->ab", w, S, S)
    K1 = np.einsum("q,qa,qb->ab", w, D, D)
    if kind == "mass":
        return det * _kron3(M1, M1, M1)
    stiff = det * (
        (1.0 / hx**2) * _kron3(M1, M1, K1)
        + (1.0 / hy**2) * _kron3(M1, K1, M1)
        + (1.0 / hz**2) * _kron3(K1, M1, M1)
    )
    if kind == "stiffness":
        return stiff
    if kind == "helmholtz":
        assert cell_qpoints is not None and coefficient_fn is not None
        a_q = coefficient_fn(cell_qpoints)  # [n_q]
        Phi = _kron3(S, S, S)  # [n_q3, ndof]
        w3 = np.einsum("i,j,k->ijk", w, w, w).reshape(-1)
        Mass_a = det * np.einsum("q,q,qa,qb->ab", w3, a_q, Phi, Phi)
        return stiff + Mass_a
    raise ValueError(kind)


def assemble_sparse(
    mesh: BrickMesh,
    basis: Basis1D,
    kind: str,
    coefficient_fn: Optional[Callable] = None,
) -> sp.csr_matrix:
    """Global sparse operator (no constraints applied)."""
    p = basis.degree
    dof_map = mesh.element_dof_map(p)  # [E, ndof]
    n = mesh.n_dofs(p)
    rows, cols, vals = [], [], []
    if kind == "helmholtz":
        qpts = Geometry.from_mesh(mesh, basis).q_points_phys()  # [E, n_q, 3]
    hx, hy, hz = mesh.h_axes()
    mx, my, mz = mesh.n_elements
    for e in range(mesh.n_cells):
        ez, rem = divmod(e, my * mx)
        ey, ex = divmod(rem, mx)
        h_cell = (hx[ex], hy[ey], hz[ez])
        if kind == "helmholtz":
            Ae = element_matrix(mesh, basis, kind, qpts[e], coefficient_fn, h_cell)
        else:
            Ae = element_matrix(mesh, basis, kind, h_cell=h_cell)
        idx = dof_map[e]
        rows.append(np.repeat(idx, idx.size))
        cols.append(np.tile(idx, idx.size))
        vals.append(Ae.reshape(-1))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return A.tocsr()


def assemble_sparse_general(
    mesh: BrickMesh,
    basis: Basis1D,
    kind: str,
    coefficient_fn: Optional[Callable] = None,
) -> sp.csr_matrix:
    """Global sparse operator from the *geometry tables* (merged
    6-plane coefficients + JxW) and dense 3D basis tables — valid on any
    mesh kind including mapped (deformed) ones, and independent of the
    sum-factorization sweep / gather-scatter code paths it oracles.

    ``A_e[a,b] = sum_q grad phi_a(q)^T C_e(q) grad phi_b(q)
                 (+ sum_q a(x_q) phi_a phi_b JxW for mass terms)``
    — the assembled form of the reference kernel's contraction
    (``bp5/step-64.cu:164-188``)."""
    p = basis.degree
    geo = Geometry.from_mesh(mesh, basis)
    V, G = basis_tables_3d(basis)
    n_loc = V.shape[0]
    n_e = mesh.n_cells
    Ae = np.zeros((n_e, n_loc, n_loc))
    if kind in ("stiffness", "helmholtz"):
        C = geo.merged_coef_full()  # [E, n_q, 6]
        for plane, (r, s) in enumerate(
            [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
        ):
            Ae += np.einsum("aq,eq,bq->eab", G[r], C[:, :, plane], G[s], optimize=True)
            if r != s:
                Ae += np.einsum(
                    "aq,eq,bq->eab", G[s], C[:, :, plane], G[r], optimize=True
                )
    if kind in ("mass", "helmholtz"):
        jxw = geo.jxw_full()
        if kind == "helmholtz":
            assert coefficient_fn is not None
            jxw = jxw * coefficient_fn(geo.q_points_phys())
        Ae += np.einsum("aq,eq,bq->eab", V, jxw, V, optimize=True)

    dof_map = mesh.element_dof_map(p)
    n = mesh.n_dofs(p)
    rows = np.repeat(dof_map, n_loc, axis=1).reshape(-1)
    cols = np.tile(dof_map, (1, n_loc)).reshape(-1)
    A = sp.coo_matrix((Ae.reshape(-1), (rows, cols)), shape=(n, n))
    return A.tocsr()


def apply_constrained(A: sp.csr_matrix, mask: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Reference semantics of ``vmult`` with zero-Dirichlet constraints:
    zero constrained inputs, apply, then identity on constrained rows
    (``copy_constrained_values``, ``bp5/step-64.cu:275``)."""
    ui = np.where(mask, 0.0, u)
    out = A @ ui
    return np.where(mask, u, out)


def constrained_matrix(A: sp.csr_matrix, mask: np.ndarray) -> sp.csr_matrix:
    """The effective SPD matrix: identity on constrained DoFs, interior block
    elsewhere (columns and rows of constrained DoFs zeroed)."""
    n = A.shape[0]
    P = sp.diags((~mask).astype(float))
    Ic = sp.diags(mask.astype(float))
    return (P @ A @ P + Ic).tocsr()
