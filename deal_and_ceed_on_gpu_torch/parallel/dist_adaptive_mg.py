"""Distributed adaptive multigrid: global-coarsening h-MG on every rank's slab.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_adaptive_mg.py``:
the single-device :class:`~..solvers.adaptive_mg.AdaptiveMultigrid`
(clamped-level hierarchy, nodal-embedding transfers, Chebyshev smoothing)
over the shared-surface partition of :mod:`.dist_adaptive`. Every level
has its own :class:`~.dist_adaptive.AdaptivePartition` and
:class:`~.dist_adaptive.DistAdaptivePoisson` (the smoother's vmult, K4 on
the card). The transfers between levels use the same dense pattern:

- **Prolongation**: coarse hanging fill (one SIGMA round) -> one
  transfer-SIGMA round (the coarse DoFs that remote fine cells read) ->
  per-fine-cell gather -> three per-axis embedding products (the child-half
  Lagrange matrices picked per cell) -> sorted scatter into the fine
  ``[owned | SIGMA | trash]`` space and SIGMA sum -> average of duplicate
  writes -> boundary mask -> fine hanging fill.
- **Restriction** is the exact transpose of that chain, written out step
  by step (condense for distribute, gather and scatter, exchange and sum
  swapped, the embedding matrices transposed), as the single-device
  ``AdaptiveTransfer.restrict`` does; then the coarse constrained rows are
  zeroed.
- **Coarse solve**: the base-brick residual slabs all-gathered
  (``SlabComm.all_gather``), the permuted dense f64 inverse applied on
  every rank, the owned slab cut back out.

Set-up (the level diagonals, the Chebyshev bounds, the dense coarse
inverse) runs on the global single-device operators of every level, on the
rank's device (``AdaptiveMultigrid._level_dinv``, ``_power_bounds``,
``dense_coarse_inverse``), as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..adaptive import AdaptiveHelmholtzOperator, AdaptivePoissonOperator, AdaptiveSpace
from ..ops.sum_factorization import full_f32
from ..solvers.adaptive_mg import (AdaptiveMultigrid, _embed_mats, _power_bounds, adaptive_hierarchy,
                                   dense_coarse_inverse)
from ..solvers.cg import solve_cg
from ..solvers.control import SolverControl
from ..solvers.multigrid import chebyshev_smooth
from .comm import SlabComm
from .dist_adaptive import (AdaptivePartition, DistAdaptivePoisson, SigmaExchange, _cat, _scatter_plan,
                            build_sigma_exchange, hang_fill, hang_fill_T, pack_by_owner, scatter_cells)

__all__ = ["DistAdaptiveMultigrid", "solve_cg_mg_dist_adaptive"]


class _Transfer:
    """A rank's tables of one fine -> coarse level pair. The transfer work
    is packed cell by cell in the order of ``part_f``'s cell map (ascending
    fine cell within each rank), so the fine side reuses ``part_f``'s cell
    scatter plan and SIGMA exchange."""

    def __init__(self, part_c: AdaptivePartition, part_f: AdaptivePartition, src_cell, axis_pick, comm: SlabComm,
                 dtype):
        fine, coarse = part_f.space, part_c.space
        n_sh, k, dev = part_f.n_shards, comm.rank, comm.device

        cmap_src = part_c.perm[coarse._dof_map_np][np.asarray(src_cell)]  # [E_f, P3] coarse new ids
        owner_c = part_c.owner
        cell_owner = part_f.cell_owner
        # the transfer SIGMA: coarse DoFs that a fine cell reads on a rank
        # that does not own them
        remote = owner_c[cmap_src] != cell_owner[:, None]
        sigT = np.unique(cmap_src[remote])
        S_T = sigT.size
        self.n_sigma = S_T
        slotT = np.full(part_c.n_pad, -1, dtype=np.int64)
        slotT[sigT] = np.arange(S_T)
        n_c = part_c.n_loc
        # per-cell coarse gather ids in [owned_c | SIGMA_T | trash], packed
        # in part_f.cell_map's order
        g = np.where(remote, n_c + slotT[cmap_src], cmap_src - cell_owner[:, None] * n_c).astype(np.int32)
        tc, pk = pack_by_owner(cell_owner, [g, np.asarray(axis_pick, dtype=np.int32)],
                               [np.int32(n_c + S_T), np.int32(0)], n_sh, min_len=part_f.n_cells_local)
        self.tc_map = torch.as_tensor(tc[k].reshape(-1), device=dev)
        # the coarse-side scatter of the restriction (the transpose of the gather)
        self.tc_plan = _scatter_plan(tc[k], n_c + S_T, dev)
        osl, oss = build_sigma_exchange(sigT, owner_c, n_c, n_sh)
        self.sigma = SigmaExchange(osl[k], oss[k], S_T, n_c, comm, dev)
        E = torch.as_tensor(_embed_mats(fine.basis), dtype=dtype, device=dev)
        pick = torch.as_tensor(pk[k].astype(np.int64), device=dev)
        self.Mz, self.My, self.Mx = (E[pick[:, d]] for d in (2, 1, 0))  # [L_f, p1, p1] each

        # the fine global DoF multiplicity (average of duplicate writes) and
        # the boundary mask, as owned slabs with a dead slot
        mult = np.bincount(part_f.perm[fine._dof_map_np].reshape(-1), minlength=part_f.n_pad).astype(np.float64)
        inv_mult = (1.0 / np.maximum(mult, 1.0)).reshape(n_sh, part_f.n_loc)[k]
        self.inv_mult = torch.as_tensor(np.concatenate([inv_mult, [1.0]]), dtype=dtype, device=dev)
        bnd = np.zeros(part_f.n_pad, dtype=bool)
        bnd[part_f.perm[np.flatnonzero(fine.boundary_mask_np)]] = True
        bnd[fine.n_dofs:] = True  # padding DoFs stay zero
        self.bnd = torch.as_tensor(np.concatenate([bnd.reshape(n_sh, part_f.n_loc)[k], [True]]), device=dev)


class DistAdaptiveMultigrid:
    """The global-coarsening V-cycle of a rank's slab of an
    :class:`~.dist_adaptive.AdaptivePartition`; ``vcycle`` is the ``diag``
    callable of :func:`solve_cg_mg_dist_adaptive`. Knobs as
    :class:`~..solvers.adaptive_mg.AdaptiveMultigrid`; ``a``: the optional
    Helmholtz coefficient, rediscretised on every level. Every level's
    cell loop is K4 (``DistAdaptivePoisson``)."""

    def __init__(self, part: AdaptivePartition, comm: SlabComm, dtype: torch.dtype = torch.float64, n_smooth: int = 3,
                 smoothing_range: float = 20.0, coarse_max_dofs: int = 8000, a=None):
        space = part.space
        self.dtype, self.comm, self.n_smooth = dtype, comm, n_smooth
        self.device = comm.device
        meshes, transfers = adaptive_hierarchy(space.mesh)
        self.spaces = [space] + [AdaptiveSpace(m, space.degree, dtype=dtype, device=self.device) for m in meshes[1:]]
        self.parts = [part] + [AdaptivePartition(s, part.n_shards) for s in self.spaces[1:]]
        self.dist_ops = [DistAdaptivePoisson(pl, comm, dtype, a=a) for pl in self.parts]
        self.transfers = [_Transfer(self.parts[k + 1], self.parts[k], src, pick, comm, dtype)
                          for k, (src, pick) in enumerate(transfers)]

        # set-up on the single-device global operators (the same spectrum)
        if a is not None:
            gops = [AdaptiveHelmholtzOperator(s, a=a) for s in self.spaces]
        else:
            gops = [AdaptivePoissonOperator(s) for s in self.spaces]
        self.bounds, self.dinv = [], []
        for op, pl in zip(gops[:-1], self.parts[:-1]):
            dinv_g = AdaptiveMultigrid._level_dinv(op)
            self.bounds.append(_power_bounds(op, dinv_g, smoothing_range))
            slab = pl.to_shards(dinv_g.double().cpu().numpy())[comm.rank]
            slab[slab == 0.0] = 1.0  # identity on the dead padding
            self.dinv.append(torch.as_tensor(slab, dtype=dtype, device=self.device))

        # the permuted, padded dense coarse inverse (applied after an
        # all-gather in every V-cycle; hence the lower default cap than the
        # single-device class's)
        A_inv = dense_coarse_inverse(gops[-1], coarse_max_dofs)
        pc = self.parts[-1]
        B = np.zeros((pc.n_pad, pc.n_pad))
        B[np.ix_(pc.perm, pc.perm)] = A_inv
        self._coarse_inv = torch.as_tensor(B, dtype=dtype, device=self.device)

    @property
    def n_levels(self) -> int:
        return len(self.parts)

    # ------------------------ a rank's pieces ------------------------ #
    def _tabs(self, level) -> dict:
        return self.dist_ops[level].tables

    def _smooth(self, level, r, z0=None):
        return chebyshev_smooth(self.dist_ops[level].vmult, self.dinv[level], self.bounds[level], self.n_smooth, r,
                                z0)

    def _prolong(self, level, uc):
        """coarse slab ``[n_c]`` -> fine slab ``[n_f]``, step by step as the
        single-device ``AdaptiveTransfer.prolong``."""
        part_c, part_f = self.parts[level + 1], self.parts[level]
        n_c, n_f = part_c.n_loc, part_f.n_loc
        tr, tc, tf = self.transfers[level], self._tabs(level + 1), self._tabs(level)
        p1 = part_f.space.degree + 1
        # 1. the conforming coarse fill (hanging rows from their masters)
        u1 = hang_fill(torch.cat([uc, uc.new_zeros(1)]), tc, n_c)
        # 2. the transfer-SIGMA round and 3. the per-cell embedding
        u_cat = _cat(u1, tr.sigma.gather(u1), n_c)
        ul = u_cat.index_select(0, tr.tc_map).reshape(-1, p1, p1, p1)
        with full_f32():
            ul = torch.einsum("eok,ekji->eoji", tr.Mz, ul)
            ul = torch.einsum("eoj,ekji->ekoi", tr.My, ul)
            ul = torch.einsum("eoi,ekji->ekjo", tr.Mx, ul)
        # 4. the fine sorted scatter and SIGMA sum (the fine operator's plan)
        v1 = scatter_cells(ul, tf, n_f)
        # 5. the multiplicity average and the boundary mask
        v1 = (v1 * tr.inv_mult).masked_fill(tr.bnd, 0)
        # 6. the fine hanging fill
        return hang_fill(v1, tf, n_f)[:n_f]

    def _restrict(self, level, r):
        """fine slab -> coarse slab: the exact transpose of :meth:`_prolong`
        (steps 6..1 reversed), then the coarse constrained rows zeroed."""
        part_c, part_f = self.parts[level + 1], self.parts[level]
        n_c, n_f = part_c.n_loc, part_f.n_loc
        tr, tc, tf = self.transfers[level], self._tabs(level + 1), self._tabs(level)
        p1 = part_f.space.degree + 1
        # 6^T: the fine condense
        r1 = hang_fill_T(torch.cat([r, r.new_zeros(1)]), tf, n_f)
        # 5^T: the boundary mask and the multiplicity
        r1 = r1.masked_fill(tr.bnd, 0) * tr.inv_mult
        # 4^T: the SIGMA round (the transpose of the sum) and the fine gather
        s_cat = _cat(r1, tf["sigma"].gather(r1), n_f)
        ul = s_cat.index_select(0, tf["cmap"].reshape(-1)).reshape(-1, p1, p1, p1)
        # 3^T: the transposed embedding products
        with full_f32():
            ul = torch.einsum("eok,eoji->ekji", tr.Mz, ul)
            ul = torch.einsum("eoj,ekoi->ekji", tr.My, ul)
            ul = torch.einsum("eoi,ekjo->ekji", tr.Mx, ul)
        # 2^T: the coarse sorted scatter and the transfer-SIGMA sum
        c = tr.tc_plan.sums(ul.reshape(-1))
        rc = tr.sigma.fold(torch.cat([c[:n_c], c.new_zeros(1)]), c[n_c:])
        # 1^T: the coarse condense, then the solve subspace
        rc = hang_fill_T(rc, tc, n_c)
        return rc.masked_fill(tc["con"], 0)[:n_c]

    def _coarse_solve(self, r):
        """The base-brick residual slabs all-gathered, the permuted dense
        inverse applied on every rank, the owned slab cut out."""
        n = self.parts[-1].n_loc
        g = self.comm.all_gather(r).reshape(-1)
        with full_f32():  # a TF32 coarse correction costs ~1e-3
            x = self._coarse_inv @ g
        k = self.comm.rank
        return x[k * n:(k + 1) * n]

    # ---------------------------- V-cycle ---------------------------- #
    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V(k,k) cycle on the rank's slab; the constrained
        rows are projected out before and after, as the single-device
        ``AdaptiveMultigrid.vcycle``. Every rank calls it."""
        con = self._tabs(0)["con"][:self.parts[0].n_loc]
        z = self._vcycle(0, r.masked_fill(con, 0))
        return z.masked_fill(con, 0)

    def _vcycle(self, level, r):
        if level == self.n_levels - 1:
            return self._coarse_solve(r)
        z = self._smooth(level, r)
        con = self._tabs(level)["con"][:self.parts[level].n_loc]
        res = (r - self.dist_ops[level].vmult(z)).masked_fill(con, 0)
        zc = self._vcycle(level + 1, self._restrict(level, res))
        z = z + self._prolong(level, zc)
        return self._smooth(level, r, z0=z)


def solve_cg_mg_dist_adaptive(dist_mg: DistAdaptiveMultigrid, b_local: torch.Tensor, control: SolverControl):
    """Adaptive-MG-preconditioned plain CG on the rank's owned slab
    (``AdaptivePartition.to_shards(b)[rank]``). Returns ``(x_local, info)``."""
    return solve_cg(dist_mg.dist_ops[0].vmult, b_local, control, diag=dist_mg.vcycle, comm=dist_mg.comm)
