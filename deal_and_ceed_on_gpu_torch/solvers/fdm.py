"""Fast-diagonalization (FDM) tensor solver / preconditioner.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/fdm.py``. On tensor-product
brick meshes the constrained Poisson operator restricted to the interior
separates as

    A_int = Dz (x) Dy (x) A1x + Dz (x) A1y (x) Dx + A1z (x) Dy (x) Dx

(the Kronecker form of ``ops/separable.py``, interior rows and columns).
With the per-axis generalized eigenproblems ``A1 V = D V Lambda``
(normalized ``V^T D V = I``; small host-side scipy solves) the exact inverse
is

    A_int^{-1} = (Vz (x) Vy (x) Vx) diag(1/(lx+ly+lz)) (Vz^T (x) Vy^T (x) Vx^T)

i.e. six dense 1D sweeps and one diagonal scale (the Lynch-Rice-Thomas fast
Poisson method): the exact direct solve of BP5 in one apply, and a
preconditioner for the variable-coefficient step-64 Helmholtz system. The
sweeps are ``ops/sum_factorization.sweep`` (full float32 or float64 torch
products, no TF32), as the JAX package computes them in plain XLA.

Works for uniform and graded tensor meshes (geometry is absorbed in the
assembled 1D tables); requires the full-Dirichlet brick.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.linalg
import torch

from ..fe_space import FESpace
from ..ops.separable import _axis_tables
from ..ops.sum_factorization import sweep

__all__ = ["FDMSolver"]


class FDMSolver:
    def __init__(self, space: FESpace):
        self.space = space
        t0 = time.perf_counter()
        tabs = _axis_tables(space.mesh, space.basis)
        evecs, evals = [], []
        for ax in (0, 1, 2):  # z, y, x grid axes
            A1 = tabs[ax]["A1"][1:-1, 1:-1]  # interior block
            # value factor: pointwise weights at GLL collocation, the banded
            # 1D mass matrix for Gauss rules
            if space.basis.collocation:
                B = np.diag(tabs[ax]["d"][1:-1])
            else:
                B = tabs[ax]["B"][1:-1, 1:-1]
            lam, V = scipy.linalg.eigh(A1, B)  # V^T B V = I
            evals.append(lam)
            evecs.append(V)
        self.setup_s = {"eigh": time.perf_counter() - t0}  # host tables and eigh
        lz, ly, lx = evals
        inv = 1.0 / (lz[:, None, None] + ly[None, :, None] + lx[None, None, :])
        self._inv = space.tensor(inv)
        self._V = tuple(space.tensor(V) for V in evecs)  # (Vz, Vy, Vx)
        self._mask3 = space.dirichlet_mask.reshape(space.grid_shape)

    def apply_interior(self, r_int: torch.Tensor) -> torch.Tensor:
        """``A_int^{-1} r`` on the interior grid ``[nz-2, ny-2, nx-2]``."""
        Vz, Vy, Vx = self._V
        # forward: V^T along each axis (sweep contracts with mat[q, a])
        t = sweep(sweep(sweep(r_int, Vz.T, 0), Vy.T, 1), Vx.T, 2)
        t = t * self._inv
        return sweep(sweep(sweep(t, Vz, 0), Vy, 1), Vx, 2)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Preconditioner action on a full flat vector: FDM on the interior,
        identity on constrained rows (SPD on the full space)."""
        s = self.space
        r3 = r.reshape(s.grid_shape)
        out = torch.zeros_like(r3)
        out[1:-1, 1:-1, 1:-1] = self.apply_interior(r3[1:-1, 1:-1, 1:-1])
        return torch.where(self._mask3, r3, out).reshape(-1)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Exact direct solve of the constrained Poisson system (one apply)."""
        return self.apply(b)
