"""Distributed fast-diagonalization (FDM) solver: the spectral transpose over ranks.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_fdm.py``. The
single-device FDM (``solvers/fdm.py``) solves the separable BP5 system
exactly with six dense 1D eigenvector sweeps and one diagonal scale. Under
the (z, y) block partition the z and y sweeps contract across ranks, so
each is done on a transposed layout: an ``all_to_all`` over the rank's
*line* (``ShardComm.all_to_all``: the ranks that share its other block
coordinate) trades x chunks for the full axis, the sweep runs locally and
a second ``all_to_all`` trades back. Eight ``all_to_all``s an apply (4
forward, 4 inverse), each moving the field once, the data movement of a
distributed 3D FFT Poisson solver.

- The sweeps run on the padded owned layout ``[sz, sy, nxp]`` with
  *block-extended* eigenvector matrices (:func:`_extended`: identity on the
  wall and dead rows, the interior eigenbasis in the middle), so every
  layout stays rectangular; the constrained rows are restored from ``r``
  at the end, as ``FDMSolver.apply`` does.
- A rank transforms only the planes it owns: its ghost-duplicated last
  plane of each axis is dropped on entry and refilled from the owner on
  exit, one plane exchange an axis, y first, then z (which carries the
  corner line), so the copy is bitwise the owner's.
- x is padded to a multiple of ``lcm(pz, py)`` so that both transposes
  chunk it evenly; the padded lanes ride identity rows and are cut off.
- The sweeps are dense matrix products (``ops/sum_factorization.sweep``,
  full f32 or f64), as the JAX package computes them outside any Pallas
  kernel. The eigen tables are the single-device solver's
  (``solvers/fdm.axis_eigen`` on ``ops/separable._axis_tables``).

Uniform and graded tensor meshes (the scope of ``FDMSolver``); the x axis
is never partitioned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..basis import Basis1D
from ..ops.sum_factorization import sweep
from ..solvers.cg import solve_cg
from ..solvers.control import SolverControl
from ..solvers.fdm import axis_eigen
from .comm import ShardComm
from .partition import BlockPartition

__all__ = ["DistFDM", "solve_cg_fdm_dist"]


def _extended(V: np.ndarray, n_pad: int) -> np.ndarray:
    """``[n_pad, n_pad]`` identity with the interior eigenbasis ``V``
    (``[n - 2, n - 2]``) in rows and columns ``1 : n - 1``."""
    E = np.eye(n_pad)
    n_int = V.shape[0]
    E[1:1 + n_int, 1:1 + n_int] = V
    return E


class DistFDM:
    """The exact FDM solve (or preconditioner) of a rank's block of a ``pz
    x py`` partition; ``comm``: the rank's :class:`ShardComm` (its
    coordinates and device). ``apply`` acts on the rank's ghosted block
    ``[nz_loc, ny_loc, nx]``; every rank of the group calls it."""

    def __init__(self, part: BlockPartition, comm: ShardComm, dtype: torch.dtype = torch.float64,
                 rule: str = "gauss_lobatto", n_q: int | None = None):
        if part.mesh.is_mapped:
            raise ValueError("FDM requires a tensor-product (separable) mesh")
        if part.px > 1:
            raise ValueError("DistFDM transposes the x axis against the z/y shard axes and needs the x axis "
                             "unpartitioned: use px=1 (the same rank count as pz*py)")
        self.part, self.comm, self.dtype = part, comm, dtype
        self.device = comm.device
        iz, iy, _ = comm.coords
        p = part.degree
        nz, ny, nx = part.global_grid_shape
        sz, sy = part.mz_local * p, part.my_local * p
        Nz, Ny = part.pz * sz, part.py * sy
        chunk = math.lcm(part.pz, part.py)
        nxp = -(-nx // chunk) * chunk
        self._sz, self._sy, self._nx, self._nxp = sz, sy, nx, nxp

        (lz, ly, lx), evecs = axis_eigen(part.mesh, Basis1D.make(p, n_q, rule))

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        # extended (padded full-grid) eigen matrices; walls and dead rows: identity
        self._V = (dev(_extended(evecs[0], Nz)), dev(_extended(evecs[1], Ny)), dev(_extended(evecs[2], nxp)))
        # the diagonal scale on this rank's owned padded block: 1 outside the
        # physical interior box (the JAX inv_stack's slice for this rank)
        gz, gy, gx = iz * sz + np.arange(sz), iy * sy + np.arange(sy), np.arange(nxp)
        inner = [(g >= 1) & (g <= n - 2) for g, n in ((gz, nz), (gy, ny), (gx, nx))]
        lam = [np.where(m, lv[np.clip(g - 1, 0, lv.size - 1)], 0.0) for m, g, lv in zip(inner, (gz, gy, gx),
                                                                                          (lz, ly, lx))]
        box = inner[0][:, None, None] & inner[1][None, :, None] & inner[2][None, None, :]
        total = lam[0][:, None, None] + lam[1][None, :, None] + lam[2][None, None, :]
        self.inv_own = dev(np.where(box, 1.0 / np.where(box, total, 1.0), 1.0))
        self.mask = part.local_dirichlet_mask(iz, iy, device=self.device)

    # ------------------------- transposed sweeps ------------------------ #
    def _axis_sweep(self, u: torch.Tensor, V: torch.Tensor, axis: int, n_shards: int, transpose: bool):
        """Sweep axis 0 of ``u`` (``[s, m, nxp]``, this rank's rows of a
        partitioned grid axis) with the full ``V``: an all-to-all over the
        line of ``axis`` gives each rank the whole axis for one x chunk,
        the sweep runs there, a second all-to-all returns the rows."""
        mat = V.T if transpose else V
        if n_shards == 1:
            return sweep(u, mat, 0)
        s, c = u.shape[0], self._nxp // n_shards
        # chunk k of x goes to the k-th rank of the line; from each rank
        # its rows of this rank's chunk come back, in axis order
        t = torch.cat(self.comm.all_to_all(axis, list(u.split(c, dim=2))), dim=0)  # [n s, m, c]
        t = sweep(t, mat, 0)
        # rows k s .. (k+1) s go back to rank k; chunks arrive in x order
        return torch.cat(self.comm.all_to_all(axis, list(t.split(s, dim=0))), dim=2)

    def _transform(self, u: torch.Tensor, transpose: bool) -> torch.Tensor:
        """``V^T`` (transpose) or ``V`` along all three axes on the owned
        padded layout ``[sz, sy, nxp]``."""
        part = self.part
        Vz, Vy, Vx = self._V
        uz = self._axis_sweep(u, Vz, 0, part.pz, transpose)
        uy = self._axis_sweep(uz.movedim(1, 0), Vy, 1, part.py, transpose).movedim(0, 1)
        return sweep(uy, Vx.T if transpose else Vx, 2)

    # ----------------------------- apply ------------------------------- #
    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """The FDM apply on the rank's ghosted block ``r``: ``A^{-1} r`` on
        the interior, ``r`` on the constrained rows; shared planes bitwise
        equal on their sharers."""
        part, comm = self.part, self.comm
        sz, sy, nx, nxp = self._sz, self._sy, self._nx, self._nxp
        u = torch.nn.functional.pad(r[:sz, :sy, :], (0, nxp - nx))
        t = self._transform(u, transpose=True) * self.inv_own
        out = torch.zeros_like(r)
        out[:sz, :sy, :] = self._transform(t, transpose=False)[:, :, :nx]
        # the ghost planes from their owners: y first, then z carries the corner
        if part.py > 1:
            _, from_next = comm.exchange(1, out[:sz, 0, :], out[:sz, -1, :])
            if from_next is not None:
                out[:sz, sy, :] = from_next
        if part.pz > 1:
            _, from_next = comm.exchange(0, out[0], out[-1])
            if from_next is not None:
                out[sz] = from_next
        return torch.where(self.mask, r, out)

    def solve_direct(self, b: torch.Tensor) -> torch.Tensor:
        """The exact distributed direct solve of the constrained Poisson
        system on the rank's block (one apply)."""
        return self.apply(b)


def solve_cg_fdm_dist(dist_fdm: DistFDM, dist_op, b_local: torch.Tensor, control: SolverControl):
    """FDM-preconditioned plain CG on the rank's block (the step-64 use on
    variable-coefficient operators): ``dist_op`` is the rank's distributed
    operator on the same partition. Returns ``(x_local, info)``."""
    return solve_cg(dist_op.vmult, b_local, control, diag=dist_fdm.apply, dot_weight=dist_op.dot_weight,
                    comm=dist_op.comm)
