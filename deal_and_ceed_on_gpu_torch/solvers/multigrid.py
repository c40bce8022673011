"""Geometric h-multigrid V-cycle preconditioner.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/multigrid.py``:

- **Hierarchy**: the brick coarsens by 2 per axis while all element counts
  stay even (graded meshes sum adjacent widths; mapped meshes keep their
  mapping, and each level re-interpolates it at its own nodes).
- **Transfers are exact and separable**: the coarse space nests in the fine
  one, so prolongation is the 1D nodal interpolation ``P = Pz (x) Py (x)
  Px``, three dense sweeps on the nodal grid; restriction is the transposed
  sweeps (R = P^T), which keeps the V-cycle symmetric. No scatter, no
  atomics: the transfers are deterministic.
- **Smoother**: Chebyshev polynomial in the Jacobi-preconditioned operator
  (the true ``compute_diagonal``); a fixed polynomial, so the V-cycle is a
  linear symmetric operator, legal inside plain CG. The eigenvalue bound
  comes from a host power iteration on the coarsest level's dense matrix
  (:func:`bounds_from_dense`).
- **Coarse solve**: the coarsest constrained operator is assembled densely
  on the host (``models.operator_base.assemble_dense``) and inverted in f64
  at set-up; in the cycle it is one small product.

Every level's operator comes from ``make_op``. Its default keeps the JAX
package's (``structured`` on mapped meshes, ``separable`` otherwise); on
the card the drivers pass a ``make_op`` that builds each level on the
fine operator's kernel backend (K1 ``stencil``, K3 ``qgrid``, K4
``general``), so every smoother apply and every residual runs the kernel.
A level that the kernel cannot take raises; it never drops to a plain
backend. The f32 products (transfers, coarse solve) run inside
``sum_factorization.full_f32`` (no TF32).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..basis import lagrange_eval
from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..ops.sum_factorization import full_f32, sweep

__all__ = [
    "Multigrid",
    "coarsen_mesh",
    "prolongation_1d",
    "chebyshev_smooth",
    "bounds_from_dense",
]


def chebyshev_smooth(vmult, dinv, bounds, degree, r, z0=None):
    """``degree`` steps of Chebyshev iteration on ``A z = r`` (initial guess
    ``z0``), the fixed polynomial in the Jacobi-preconditioned operator.
    ``dinv`` may be a vector or anything broadcastable; ``bounds`` is
    ``(lam_min, lam_max)`` as host numbers."""
    lam_min, lam_max = (float(v) for v in bounds)
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta

    res = r if z0 is None else r - vmult(z0)
    d = (1.0 / theta) * (dinv * res)
    z = d if z0 is None else z0 + d
    rho_old = 1.0 / sigma
    for _ in range(1, degree):
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv * (r - vmult(z)))
        z = z + d
        rho_old = rho
    return z


def coarsen_mesh(mesh: BrickMesh) -> BrickMesh:
    """The mesh with every axis coarsened by 2 (inverse of
    ``refine_global(1)``); graded meshes merge adjacent element pairs, mapped
    meshes keep their mapping (``dataclasses.replace`` keeps the class)."""
    mx, my, mz = mesh.n_elements
    assert mx % 2 == 0 and my % 2 == 0 and mz % 2 == 0, mesh.n_elements
    widths = None
    if mesh.widths is not None:
        widths = tuple(np.asarray(w).reshape(-1, 2).sum(axis=1) for w in mesh.widths)
    return dataclasses.replace(mesh, n_elements=(mx // 2, my // 2, mz // 2), widths=widths)


def prolongation_1d(mc: int, p: int, nodes: np.ndarray, fine_widths: Optional[np.ndarray] = None) -> np.ndarray:
    """1D nodal prolongation ``P[nf, nc]`` from a ``mc``-element degree-p grid
    to its 2x refinement (nf = 2 mc p + 1, nc = mc p + 1). Exact: each coarse
    basis polynomial is evaluated at the fine nodal points (graded meshes
    split each coarse cell at the true width ratio)."""
    nf, nc = 2 * mc * p + 1, mc * p + 1
    P = np.zeros((nf, nc))
    for e in range(mc):
        if fine_widths is None:
            t = 0.5
        else:
            w0, w1 = fine_widths[2 * e], fine_widths[2 * e + 1]
            t = w0 / (w0 + w1)
        # coarse-reference coordinates of the 2p+1 fine nodes in this cell
        pts = np.concatenate([t * nodes, t + (1.0 - t) * nodes[1:]])
        S, _ = lagrange_eval(nodes, pts)  # [2p+1, p+1]
        P[2 * e * p : 2 * e * p + 2 * p + 1, e * p : e * p + p + 1] = S
    return P


def _chebyshev_bounds(vmult, dinv, space, smoothing_range, n_power=12):
    """(lambda_min, lambda_max) for the Chebyshev smoother from a device power
    iteration on ``D^-1 A`` over the constrained-zero subspace (deal.II's
    1.2x safety factor, lambda_min = lambda_max / smoothing_range): the
    ``bounds="per-level"`` mode."""
    u = space.tensor(np.random.default_rng(42).standard_normal(space.n_dofs))
    mask = space.dirichlet_mask
    u = u.masked_fill(mask, 0)
    u = u / torch.linalg.vector_norm(u)
    lam = torch.ones((), dtype=u.dtype, device=u.device)
    for _ in range(n_power):
        v = (dinv * vmult(u)).masked_fill(mask, 0)
        lam = torch.linalg.vector_norm(v)
        u = v / lam
    lam_max = 1.2 * float(lam)
    return lam_max / smoothing_range, lam_max


def bounds_from_dense(A: np.ndarray, smoothing_range: float, safety: float = 1.35):
    """Chebyshev bounds from a host power iteration on the dense
    Jacobi-preconditioned matrix ``D^-1 A`` (the coarsest level). The top
    eigenvalue of a Jacobi-preconditioned FEM operator is set by element-local
    properties, so one coarse estimate serves every level; ``safety`` covers
    the drift between levels (an overestimate only softens the smoother)."""
    d = np.diag(A).copy()
    rng = np.random.default_rng(42)
    u = rng.standard_normal(A.shape[0])
    u /= np.linalg.norm(u)
    lam = 1.0
    for _ in range(50):
        v = (A @ u) / d
        lam = np.linalg.norm(v)
        u = v / lam
    lam_max = safety * lam
    return lam_max / smoothing_range, lam_max


def _dense_from_vmult(op, chunk: int = 256) -> np.ndarray:
    """The matrix of ``op.vmult`` materialised column by column over identity
    chunks (operators without a ``weak_form``)."""
    s = op.space
    n = s.n_dofs
    cols = []
    for j0 in range(0, n, chunk):
        eye = torch.zeros((min(chunk, n - j0), n), dtype=s.dtype, device=s.device)
        eye[torch.arange(eye.shape[0]), torch.arange(j0, j0 + eye.shape[0])] = 1
        cols += [op.vmult(e).to(torch.float64).cpu().numpy() for e in eye]
    return np.stack(cols, axis=1)


class Multigrid:
    """Geometric multigrid V-cycle; ``mg.vcycle`` is the callable
    preconditioner of :func:`solve_cg` (or of the inner solves of
    ``solvers/ir.py``).

    make_op: ``FESpace -> operator`` with ``vmult`` and ``compute_diagonal``.
    Default: Poisson on ``structured`` (mapped meshes) or ``separable``.

    bounds: ``"coarse"`` (default: one host estimate on the coarsest dense
    matrix, shared by all levels), ``"per-level"`` (a device power iteration
    on each level), or an explicit ``(lo, hi)`` pair.

    fine_op: the finest level's operator, already built on ``space`` (the one
    the solver applies); passing it skips rebuilding level 0.
    """

    def __init__(
        self,
        space: FESpace,
        make_op: Optional[Callable[[FESpace], object]] = None,
        smooth_degree: int = 3,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 4000,
        fine_op=None,
        bounds="coarse",
    ):
        if make_op is None:
            from ..models import PoissonOperator

            def make_op(s):
                return PoissonOperator(s, backend="structured" if s.mesh.is_mapped else "separable")

        self.smooth_degree = smooth_degree
        self.setup_s = {}  # host set-up seconds by step
        t0 = time.perf_counter()
        # ---------------- hierarchy ---------------- #
        spaces = [space]
        while all(m % 2 == 0 for m in spaces[-1].mesh.n_elements) and spaces[-1].n_dofs > coarse_max_dofs:
            # the levels live on the fine space's device
            spaces.append(FESpace(coarsen_mesh(spaces[-1].mesh), space.basis, space.dtype, space.device))
        if len(spaces) == 1 and space.n_dofs > coarse_max_dofs:
            raise ValueError(
                f"mesh {space.mesh.n_elements} cannot coarsen: "
                f"{space.n_dofs} DoFs in a single level (need even element "
                "counts to build a hierarchy). A mesh at or below "
                f"coarse_max_dofs={coarse_max_dofs} would instead use the "
                "exact dense solve as a single-level preconditioner."
            )
        if spaces[-1].n_dofs > max(coarse_max_dofs, 8000):
            raise ValueError(
                f"coarsest level {spaces[-1].mesh.n_elements} still has "
                f"{spaces[-1].n_dofs} DoFs (> {max(coarse_max_dofs, 8000)}) "
                "— element counts stop halving too early for a dense "
                "coarse solve; choose a mesh with more powers of two"
            )
        self.spaces = spaces
        self.ops = [make_op(s) for s in spaces[1:]]
        if fine_op is not None:
            if fine_op.space is not space:
                raise ValueError("fine_op must be built on `space`")
            self.ops.insert(0, fine_op)
        else:
            self.ops.insert(0, make_op(space))
        t1 = time.perf_counter()
        self.setup_s["levels"] = t1 - t0

        # ---------------- dense coarse matrix (host) ---------------- #
        from ..models.operator_base import assemble_dense

        try:
            A_c = assemble_dense(self.ops[-1], max_dofs=max(coarse_max_dofs, 8000))
        except NotImplementedError:
            # operators without a weak_form(): materialise vmult over the
            # identity columns (slower set-up, same matrix)
            A_c = _dense_from_vmult(self.ops[-1])
        self._coarse_inv = spaces[-1].tensor(np.linalg.inv(A_c))
        t2 = time.perf_counter()
        self.setup_s["coarse"] = t2 - t1

        # per-level Jacobi diagonals and Chebyshev bounds (the coarsest level
        # uses the dense inverse: no smoother there)
        self.dinv = [op.jacobi_preconditioner() for op in self.ops[:-1]]
        if bounds == "coarse":
            b = bounds_from_dense(A_c, smoothing_range)
            self.bounds = [b] * (len(self.ops) - 1)
        elif bounds == "per-level":
            self.bounds = [
                _chebyshev_bounds(op.vmult, dinv, s, smoothing_range)
                for op, dinv, s in zip(self.ops[:-1], self.dinv, spaces[:-1])
            ]
        elif isinstance(bounds, str):
            raise ValueError(
                f"bounds={bounds!r}: expected 'coarse', 'per-level', or an explicit (lam_min, lam_max) pair"
            )
        else:  # explicit (lam_min, lam_max)
            lam = tuple(float(v) for v in bounds)
            if len(lam) != 2:
                raise ValueError(f"explicit bounds must be (lam_min, lam_max), got {bounds!r}")
            self.bounds = [lam] * (len(self.ops) - 1)

        # per-level-pair 1D prolongation tables (coarse -> fine), in the
        # sweep convention mat[out, in]; grid axes (z, y, x) = mesh axes
        # (2, 1, 0)
        p = space.degree
        nodes = space.basis.nodes
        self.prolong_mats = []
        for fine, coarse in zip(spaces[:-1], spaces[1:]):
            mats = []
            for ax, mc in enumerate(coarse.mesh.n_elements):  # (mx, my, mz)
                fw = None if fine.mesh.widths is None else fine.mesh.widths[ax]
                mats.append(space.tensor(prolongation_1d(mc, p, nodes, fw)))
            self.prolong_mats.append((mats[2], mats[1], mats[0]))
        self.setup_s["smoother"] = time.perf_counter() - t2

    @property
    def n_levels(self) -> int:
        return len(self.spaces)

    # ------------------------- components ------------------------- #
    def _prolong(self, level: int, u_c: torch.Tensor) -> torch.Tensor:
        """coarse (level + 1) -> fine (level) nodal interpolation."""
        Pz, Py, Px = self.prolong_mats[level]
        u = u_c.reshape(self.spaces[level + 1].grid_shape)
        return sweep(sweep(sweep(u, Px, 2), Py, 1), Pz, 0).reshape(-1)

    def _restrict(self, level: int, r_f: torch.Tensor) -> torch.Tensor:
        """fine (level) -> coarse (level + 1): R = P^T (transposed sweeps),
        then zero the coarse constrained rows."""
        Pz, Py, Px = self.prolong_mats[level]
        r = r_f.reshape(self.spaces[level].grid_shape)
        r = sweep(sweep(sweep(r, Px, 2, transpose=True), Py, 1, transpose=True), Pz, 0, transpose=True)
        return self.spaces[level + 1].zero_constrained_values(r.reshape(-1))

    def _smooth(self, level: int, r: torch.Tensor, z0=None) -> torch.Tensor:
        return chebyshev_smooth(
            self.ops[level].vmult, self.dinv[level], self.bounds[level], self.smooth_degree, r, z0
        )

    # --------------------------- V-cycle --------------------------- #
    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V(k,k) cycle applied to a residual: the
        preconditioner callable (``solve_cg``'s ``diag`` slot). Computes at
        the space's dtype and returns ``r``'s (bfloat16 solver vectors)."""
        s = self.spaces[0]
        return self._vcycle(0, s.zero_constrained_values(r.to(s.dtype))).to(r.dtype)

    def _vcycle(self, level: int, r: torch.Tensor) -> torch.Tensor:
        if level == self.n_levels - 1:
            with full_f32():  # a TF32 coarse correction costs ~1e-3
                return self._coarse_inv @ r
        z = self._smooth(level, r)  # pre-smooth from zero
        res = r - self.ops[level].vmult(z)
        zc = self._vcycle(level + 1, self._restrict(level, res))
        z = z + self._prolong(level, zc)
        return self._smooth(level, r, z0=z)  # post-smooth

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.vcycle(r)

    def vcycle_vector(self, r: torch.Tensor) -> torch.Tensor:
        """The V-cycle per component of a ``[n_components, n]`` vector (the
        vector operator is block-diagonal with identical scalar blocks)."""
        return torch.stack([self.vcycle(ri) for ri in r])
