"""Distributed geometric multigrid: the V-cycle on every rank's block.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_multigrid.py``:
the single-device V-cycle (``solvers/multigrid.py``) over a
:class:`~.partition.BlockPartition`. The 2:1 coarsening is block-aligned
(each level's rank owns exactly the parents of its fine cells, the
hierarchy guard of :func:`_can_coarsen`), so every piece maps onto the
distributed primitives:

- **Smoothing**: Chebyshev over the level's distributed operator, which
  runs the fine operator's kernel (``backend="auto"``): K1 in shard mode
  (``DistStencilOperator``) on a uniform GLL brick under a ``pz x py``
  partition, K4 (``DistOperator(backend="general")``) on a uniform brick
  with a Gauss rule or a partitioned x axis, ``structured`` (the plain
  cell loop with the rank's slice of the global tables) on graded and
  mapped meshes, as in JAX. A level the kernel cannot take raises.
- **Prolongation needs no messages**: a fine cell's coarse parent lives on
  the same rank, and the interpolation row of a fine node on a shared
  plane reads only coarse nodes on that plane (consistent duplicates), so
  both sharers compute the same bits. Graded meshes take per-rank 1D
  matrices (the rank's own widths).
- **Restriction**: the ghost duplicates weighted out (each shared fine
  plane counted once), the local transposed sweeps, then the operator's
  ``halo_combine`` (partial coarse sums on shared planes added across
  neighbours), the coarse constrained rows zeroed.
- **Coarse solve**: the coarsest residual is all-gathered
  (``ShardComm.all_gather``: it is small by construction), the dense
  inverse is applied on every rank and each rank cuts its block back out.

Set-up (the per-level Jacobi diagonals, the Chebyshev bounds, the dense
coarse inverse) runs on the host on the global operator of each level, as
in JAX: the spectrum is the same and set-up is done once
(``solvers/multigrid.bounds_from_dense``, ``models/operator_base
.assemble_dense``). Transfers and the coarse product run inside
``sum_factorization.full_f32`` (no TF32).
"""

from __future__ import annotations

from typing import Type

import numpy as np
import torch

from ..fe_space import FESpace
from ..models.helmholtz import HelmholtzOperator
from ..models.operator_base import MatrixFreeOperator, assemble_dense
from ..models.poisson import PoissonOperator
from ..ops.sum_factorization import full_f32, sweep
from ..solvers.cg import solve_cg
from ..solvers.control import SolverControl
from ..solvers.multigrid import bounds_from_dense, chebyshev_smooth, coarsen_mesh, prolongation_1d
from .comm import ShardComm
from .dist_operator import DistOperator, halo_combine
from .dist_stencil import DistStencilOperator
from .partition import BlockPartition

__all__ = ["DistMultigrid", "solve_cg_mg_dist"]


def _coarse_partition(part: BlockPartition) -> BlockPartition:
    return BlockPartition(coarsen_mesh(part.mesh), part.degree, part.pz, part.py, part.px)


def _can_coarsen(part: BlockPartition) -> bool:
    """Block-aligned 2:1 coarsening: every global axis even, and each
    rank's element block halves exactly (parents stay on the rank, dead
    padding coarsens to dead padding)."""
    mx, my, mz = part.mesh.n_elements
    if mx % 2 or my % 2 or mz % 2:
        return False
    if part.mz_local % 2 or part.my_local % 2:
        return False
    if part.px > 1 and part.mx_local % 2:
        return False
    cpart = _coarse_partition(part)
    return (cpart.mz_local == part.mz_local // 2 and cpart.my_local == part.my_local // 2
            and cpart.mx_local == part.mx_local // 2)


def level_backend(part: BlockPartition, op_cls, rule: str, backend: str = "auto", n_q: int | None = None) -> str:
    """The backend of a level's distributed operator: ``backend`` unless it
    is ``auto``, which takes the fine operator's kernel: ``stencil`` (K1 in
    shard mode) on a uniform brick with the GLL collocation rule and an
    unpartitioned x axis, ``general`` (K4) for Poisson on other uniform
    bricks, ``structured`` on graded and mapped meshes (and for Helmholtz
    off the stencil: its a(x) tables depend on the position)."""
    if backend != "auto":
        return backend
    if not part.mesh.is_uniform:
        return "structured"
    if (rule == "gauss_lobatto" and n_q in (None, part.degree + 1) and part.px == 1
            and op_cls in (PoissonOperator, HelmholtzOperator)):
        return "stencil"
    return "general" if op_cls is PoissonOperator else "structured"


class DistMultigrid:
    """The V-cycle preconditioner of a rank's block of a ``pz x py [x px]``
    partition. ``comm``: the rank's :class:`ShardComm` (its device; the
    levels share its group and tags). The other parameters mirror
    :class:`~.dist_operator.DistOperator` (``op_cls``, ``dtype``,
    ``backend``, ``rule``, ``n_q``, ``op_kwargs``) and the
    :class:`~..solvers.multigrid.Multigrid` knobs; ``vcycle`` is the
    ``diag`` callable of :func:`solve_cg_mg_dist`."""

    def __init__(
        self,
        part: BlockPartition,
        comm: ShardComm,
        op_cls: Type[MatrixFreeOperator] = PoissonOperator,
        dtype: torch.dtype = torch.float64,
        backend: str = "auto",
        rule: str = "gauss_lobatto",
        n_q: int | None = None,
        smooth_degree: int = 3,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 4000,
        **op_kwargs,
    ):
        self.smooth_degree = smooth_degree
        self.dtype, self.comm = dtype, comm

        # ---------------- level hierarchy ---------------- #
        parts = [part]
        while parts[-1].mesh.n_dofs(part.degree) > coarse_max_dofs and _can_coarsen(parts[-1]):
            parts.append(_coarse_partition(parts[-1]))
        if len(parts) < 2:
            raise ValueError(f"mesh {part.mesh.n_elements} over {part.pz}x{part.py} shards cannot build a "
                             "block-aligned hierarchy")
        if parts[-1].mesh.n_dofs(part.degree) > max(coarse_max_dofs, 8000):
            # the single-device Multigrid guard: refuse rather than build an
            # n^2 dense coarse inverse that every rank all-gathers and applies
            raise ValueError(
                f"coarsest level {parts[-1].mesh.n_elements} still has {parts[-1].mesh.n_dofs(part.degree)} DoFs "
                f"(> {max(coarse_max_dofs, 8000)}) — block-aligned coarsening stops too early for a dense coarse "
                "solve; choose a mesh/shard layout with more halvable element counts"
            )
        self.parts = parts
        self.device, self.coords = comm.device, comm.coords
        self.comms = [comm if k == 0 else comm.with_partition(pl) for k, pl in enumerate(parts)]
        self.backend = level_backend(part, op_cls, rule, backend, n_q)
        self.dist_ops = [self._level_op(pl, c, op_cls, rule, n_q, op_kwargs)
                         for pl, c in zip(parts[:-1], self.comms[:-1])]

        # the per-level global operator on the host (f64): the Jacobi blocks
        # (the distributed operator's spectrum), the dense coarse matrix and
        # the Chebyshev bounds from one estimate on it
        gbackend = "structured" if part.mesh.is_mapped else "separable"
        gops = [op_cls(FESpace.create(pl.mesh, pl.degree, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu"),
                       backend=gbackend, **op_kwargs) for pl in parts]
        rank = comm.rank
        self.dinv = []
        for gop, pl in zip(gops[:-1], parts[:-1]):
            jac = gop.jacobi_preconditioner().numpy().reshape(gop.space.grid_shape)
            blk = pl.block(jac, rank)
            blk[blk == 0.0] = 1.0  # identity on the dead padding
            self.dinv.append(torch.as_tensor(blk, dtype=dtype, device=self.device))
        A_c = assemble_dense(gops[-1], max_dofs=max(coarse_max_dofs, 8000))
        self._coarse_inv = torch.as_tensor(np.linalg.inv(A_c), dtype=dtype, device=self.device)
        self.bounds = [bounds_from_dense(A_c, smoothing_range)] * (len(parts) - 1)

        # per level pair this rank's 1D prolongation matrices (Pz, Py, Px):
        # per-rank along the partitioned axes (a graded mesh splits each
        # coarse cell at its true width ratio; dead padding cells take unit
        # widths, their rows only ever see zeros), global along x when it is
        # not partitioned
        p = part.degree
        nodes = gops[0].space.basis.nodes
        iz, iy, ix = self.coords
        self.prolong_mats = []
        for fine, coarse in zip(parts[:-1], parts[1:]):
            mats = []
            for ax, (k, n_sh, mloc_c) in enumerate(((ix, fine.px, coarse.mx_local), (iy, fine.py, coarse.my_local),
                                                    (iz, fine.pz, coarse.mz_local))):
                w = None if fine.mesh.widths is None else np.asarray(fine.mesh.widths[ax])
                if ax == 0 and n_sh == 1:
                    mats.append(prolongation_1d(coarse.mesh.n_elements[0], p, nodes, w))
                    continue
                if w is not None:
                    w = np.pad(w, (0, n_sh * 2 * mloc_c - w.size), constant_values=1.0)
                    w = w[k * 2 * mloc_c:(k + 1) * 2 * mloc_c]
                mats.append(prolongation_1d(mloc_c, p, nodes, w))
            Px, Py, Pz = (torch.as_tensor(m, dtype=dtype, device=self.device) for m in mats)
            self.prolong_mats.append((Pz, Py, Px))
        self.weights = [pl.local_dot_weight(*self.coords, dtype=dtype, device=self.device) for pl in parts[:-1]]
        self.masks = [pl.local_dirichlet_mask(*self.coords, device=self.device) for pl in parts]

    def _level_op(self, pl, comm, op_cls, rule, n_q, op_kwargs):
        if self.backend == "stencil":
            other = sorted(set(op_kwargs) - {"coefficient_fn"})
            if other or n_q not in (None, pl.degree + 1):
                raise ValueError(f"the stencil levels take the GLL collocation rule and no operator option but "
                                 f"coefficient_fn (got {other}, n_q {n_q})")
            operator = "helmholtz" if op_cls is HelmholtzOperator else "poisson"
            return DistStencilOperator(pl, comm, self.dtype, operator=operator,
                                       coefficient_fn=op_kwargs.get("coefficient_fn"))
        return DistOperator(pl, comm, op_cls, self.dtype, backend=self.backend, rule=rule, n_q=n_q, **op_kwargs)

    @property
    def n_levels(self) -> int:
        return len(self.parts)

    # ----------------------- a rank's components ----------------------- #
    def _smooth(self, level, r, z0=None):
        return chebyshev_smooth(self.dist_ops[level].vmult, self.dinv[level], self.bounds[level],
                                self.smooth_degree, r, z0)

    def _restrict(self, level, r):
        """fine level -> level + 1: each shared fine plane counted once, the
        local transposed sweeps, the partial coarse sums added across
        neighbours, the coarse constrained rows zeroed."""
        Pz, Py, Px = self.prolong_mats[level]
        rc = sweep(sweep(sweep(r * self.weights[level], Px, 2, transpose=True), Py, 1, transpose=True), Pz, 0,
                   transpose=True)
        rc = halo_combine(rc, self.comms[level + 1])
        return rc.masked_fill(self.masks[level + 1], 0)

    def _prolong(self, level, u_c):
        """level + 1 -> fine level: local sweeps, no messages (ghost planes
        come out bitwise equal on every sharer)."""
        Pz, Py, Px = self.prolong_mats[level]
        return sweep(sweep(sweep(u_c, Px, 2), Py, 1), Pz, 0)

    def _coarse_solve(self, r):
        """The coarsest residual all-gathered, the dense inverse applied on
        every rank, this rank's ghosted block cut back out."""
        part = self.parts[-1]
        p = part.degree
        nzl, nyl, nxl = part.local_grid_shape
        nz, ny, nx = part.global_grid_shape
        sz, sy, sx = part.mz_local * p, part.my_local * p, part.mx_local * p
        g = self.comm.all_gather(r)  # [n_shards, nzl, nyl, nxl], group rank order
        pad = ((part.pz - 1) * sz + nzl, (part.py - 1) * sy + nyl, (part.px - 1) * sx + nxl)
        glob = r.new_zeros(pad)
        for rank in range(part.n_shards):
            iz, iy, ix = part.coords(rank)
            glob[iz * sz:iz * sz + nzl, iy * sy:iy * sy + nyl, ix * sx:ix * sx + nxl] = g[rank]
        with full_f32():  # a TF32 coarse correction costs ~1e-3
            x = self._coarse_inv @ glob[:nz, :ny, :nx].reshape(-1)
        xp = r.new_zeros(pad)
        xp[:nz, :ny, :nx] = x.reshape(nz, ny, nx)
        iz, iy, ix = self.coords
        return xp[iz * sz:iz * sz + nzl, iy * sy:iy * sy + nyl, ix * sx:ix * sx + nxl].contiguous()

    # --------------------------- V-cycle --------------------------- #
    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V(k,k) cycle on the rank's block of a residual
        (``solve_cg``'s ``diag`` slot); every rank calls it. Computes at
        the hierarchy's dtype and returns ``r``'s."""
        return self._vcycle(0, r.to(self.dtype)).to(r.dtype)

    def _vcycle(self, level, r):
        if level == self.n_levels - 1:
            return self._coarse_solve(r)
        z = self._smooth(level, r)
        res = r - self.dist_ops[level].vmult(z)
        zc = self._vcycle(level + 1, self._restrict(level, res))
        z = z + self._prolong(level, zc)
        return self._smooth(level, r, z0=z)


def solve_cg_mg_dist(dist_mg: DistMultigrid, b_local: torch.Tensor, control: SolverControl):
    """Multigrid-preconditioned plain CG on the rank's block ``b_local``
    (the ``BlockPartition.block`` layout) over the fine level's operator.
    Returns ``(x_local, info)``."""
    op = dist_mg.dist_ops[0]
    return solve_cg(op.vmult, b_local, control, diag=dist_mg.vcycle, dot_weight=op.dot_weight, comm=dist_mg.comm)
