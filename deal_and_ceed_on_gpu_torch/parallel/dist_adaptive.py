"""Distributed adaptive (hanging-node) meshes over ranks.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_adaptive.py``. The
reference distributes adaptivity with p4est and deal.II index sets
(``bp5/step-64.cu:310,345-348``) and point-to-point ghost exchange; the
JAX package, and this port, replace the irregular ghost graph with one
dense **shared-surface buffer**:

- DoFs are renumbered by (z, y, x) node position and cut into equal owned
  slabs, the last padded with dead DoFs: an exact partition, no
  duplicated ownership, so the dots need no weights.
- An active cell goes to the rank that owns its smallest DoF; every rank's
  cell table is padded to the same count with dead cells whose coefficient
  tables are zero, so they add exactly nothing.
- SIGMA is the set of DoFs that a rank other than the owner reads (the
  cells across a slab boundary and the remote hanging-node masters). Each
  round of an apply sums a SIGMA-sized buffer over the ranks with one
  all-reduce (``SlabComm.allreduce_sum_``, the JAX ``psum``): the owners
  write their values and the sum hands them to every reader, or the
  readers write their partial sums and the sum hands them to the owner. A
  rank's cell indices point into ``[owned | SIGMA | trash]``, so every
  gather is one ``index_select`` and every scatter one deterministic
  :class:`~..ops.local_global.SumPlan` (a fixed order, no ``index_add_``,
  no atomics).
- Hanging constraints run on the owner's side with (masters, weights)
  rows; the masters are conforming (chains resolved on the host), so one
  SIGMA round supplies them, and the transposed condense sends hanging
  residuals back to possibly remote masters through SIGMA.

The cell loop is K4 (``GeneralCellKernel.apply_local``, per-cell ``diag3``
coefficients, the ``a(x) JxW`` value table for Helmholtz), as in the
single-device adaptive operator (``adaptive.py``); on CPU tensors its
wrapper runs the plain version. The partition's set-up is host numpy,
the JAX package's; each rank then moves its own row of the packed tables
to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..adaptive import AdaptiveSpace, _cell_qpoints
from ..ops import local_global as lg
from ..ops.general import GeneralCellKernel
from ..solvers.cg_merged import solve_cg_merged
from ..solvers.control import SolverControl
from .comm import SlabComm

__all__ = ["AdaptivePartition", "DistAdaptivePoisson", "solve_cg_merged_dist_adaptive", "pack_by_owner",
           "build_sigma_exchange"]


def pack_by_owner(owner_of_item, arrays, fills, n_shards, min_len=1):
    """Pack per-item rows into ``[n_shards, L, ...]`` tables, ascending item
    order within each owner (one fancy-index assignment). ``L = max(min_len,
    most items of one owner)``; pad rows hold ``fills[i]``."""
    owner_of_item = np.asarray(owner_of_item, dtype=np.int64)
    n = owner_of_item.size
    counts = np.bincount(owner_of_item, minlength=n_shards)
    L = max(min_len, int(counts.max()) if n else 0)
    order = np.argsort(owner_of_item, kind="stable")
    starts = np.zeros(n_shards + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    ow = owner_of_item[order]
    intra = np.arange(n, dtype=np.int64) - starts[ow]
    outs = []
    for arr, fill in zip(arrays, fills):
        arr = np.asarray(arr)
        out = np.full((n_shards, L) + arr.shape[1:], fill, dtype=arr.dtype)
        out[ow, intra] = arr[order]
        outs.append(out)
    return outs


def build_sigma_exchange(sigma, owner, n_loc, n_shards):
    """Per-rank owned <-> SIGMA tables of a SIGMA set: ``(osl, oss)``,
    ``osl[k, i]`` the owner-local index (pad: the dead slot ``n_loc``) and
    ``oss[k, i]`` the SIGMA slot (pad: the trash slot ``S``). Shared by the
    operator's SIGMA and the multigrid transfers'."""
    sigma = np.asarray(sigma, dtype=np.int64)
    S = sigma.size
    loc = (sigma - owner[sigma] * n_loc).astype(np.int32)
    slots = np.arange(S, dtype=np.int32)
    return pack_by_owner(owner[sigma] if S else np.zeros(0, np.int64), [loc, slots], [np.int32(n_loc), np.int32(S)],
                         n_shards)


class SigmaExchange:
    """A rank's side of one SIGMA set: the owned entries it writes (``osl``,
    owner-local indices, pads cut off) into the SIGMA slots ``oss``, ``S``
    slots in all. ``gather(vals)``: owned values (dead slot last) -> the
    full SIGMA ``[S]`` on every rank, one all-reduce; ``fold(v, sig)``: add
    the summed SIGMA partials into their owners' rows of ``v``."""

    def __init__(self, osl_k, oss_k, S, n_loc, comm, device):
        keep = osl_k != n_loc
        self.osl = torch.as_tensor(osl_k[keep].astype(np.int64), device=device)
        self.oss = torch.as_tensor(oss_k[keep].astype(np.int64), device=device)
        self.S, self.comm = S, comm

    def gather(self, vals: torch.Tensor) -> torch.Tensor:
        sig = vals.new_zeros(self.S)
        sig[self.oss] = vals[self.osl]
        return self.comm.allreduce_sum_(sig)

    def fold(self, v: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
        """``v`` (owned, dead slot last) plus the ranks' summed SIGMA
        ``partials`` on the rows this rank owns; the owned rows are unique,
        so no two writes meet."""
        sig = self.comm.allreduce_sum_(partials.contiguous())
        v = v.clone()
        v[self.osl] += sig[self.oss]
        return v


class AdaptivePartition:
    """Host-side construction of the distributed tables of an
    :class:`~..adaptive.AdaptiveSpace` over ``n_shards`` ranks (every rank
    builds the same, from the same space); :meth:`rank_tables` moves one
    rank's row to its device."""

    def __init__(self, space: AdaptiveSpace, n_shards: int):
        self.space = space
        self.n_shards = n_shards
        n = space.n_dofs

        # ---- DoF permutation (z, y, x) and exact owned partition ----
        X = space.node_coords
        order = np.lexsort((X[:, 0], X[:, 1], X[:, 2]))  # z major
        self.perm = np.empty(n, dtype=np.int64)  # old id -> new id
        self.perm[order] = np.arange(n)
        n_loc = -(-n // n_shards)
        self.n_loc = n_loc
        self.n_pad = n_loc * n_shards
        owner = np.minimum(np.arange(self.n_pad) // n_loc, n_shards - 1)

        dof_map = self.perm[space._dof_map_np]  # [E, p1^3] new ids
        cell_owner = owner[dof_map.min(axis=1)]
        hang_rows, hang_cols, hang_w = space._hang_np
        hang_rows = self.perm[np.asarray(hang_rows, dtype=np.int64)]
        hang_cols = self.perm[np.asarray(hang_cols, dtype=np.int64)]
        hang_w = np.asarray(hang_w, dtype=np.float64)

        # ---- SIGMA: every DoF a non-owner references ----
        remote_cell = owner[dof_map] != cell_owner[:, None]  # [E, p1^3]
        sigma = np.unique(dof_map[remote_cell])
        if hang_rows.size:
            rm = owner[hang_cols] != owner[hang_rows]
            sigma = np.union1d(sigma, hang_cols[rm])
        sigma = sigma.astype(np.int64)
        S = sigma.size
        self.n_sigma = S
        slot = np.full(self.n_pad, -1, dtype=np.int64)
        slot[sigma] = np.arange(S)
        # host tables the multigrid transfers reuse
        self.owner = owner
        self.cell_owner = cell_owner
        self.sigma = sigma

        # a rank's index space: [0, n_loc) owned | [n_loc, n_loc + S) SIGMA | n_loc + S trash
        trash = n_loc + S

        # ---- per-rank cell tables (padded with dead cells) ----
        in_sig = slot[dof_map] >= 0
        assert (remote_cell <= in_sig).all(), "non-sigma dof referenced by non-owner"
        g = np.where(in_sig, n_loc + slot[dof_map], dof_map - cell_owner[:, None] * n_loc).astype(np.int32)
        h = space.mesh.sizes
        det = h.prod(axis=1)
        md = np.stack([det / h[:, 0] ** 2, det / h[:, 1] ** 2, det / h[:, 2] ** 2], -1)
        self.cell_map, self.cell_coef = pack_by_owner(cell_owner, [g, md], [np.int32(trash), 0.0], n_shards)

        # ---- per-rank owned <-> SIGMA exchange tables ----
        self.own_sig_local, self.own_sig_slot = build_sigma_exchange(sigma, owner, n_loc, n_shards)

        # ---- per-rank hanging tables (the owner's rows) ----
        # the (row, master, weight) triplets grouped by hanging row, the
        # rows packed by owner
        uh, inv_h = (np.unique(hang_rows, return_inverse=True) if hang_rows.size
                     else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        counts_h = np.bincount(inv_h, minlength=uh.size)
        K = max(1, int(counts_h.max()) if uh.size else 1)
        order_h = np.argsort(inv_h, kind="stable")
        starts_h = np.zeros(uh.size + 1, dtype=np.int64)
        starts_h[1:] = np.cumsum(counts_h)
        jrank = np.arange(inv_h.size) - starts_h[inv_h[order_h]]
        k_row = owner[hang_rows] if hang_rows.size else np.zeros(0, np.int64)
        rc_sig = slot[hang_cols] >= 0 if hang_rows.size else np.zeros(0, bool)
        rc = np.where(rc_sig, n_loc + slot[hang_cols], hang_cols - k_row * n_loc).astype(np.int32)
        masters_d = np.full((uh.size, K), trash, dtype=np.int32)
        weights_d = np.zeros((uh.size, K))
        masters_d[inv_h[order_h], jrank] = rc[order_h]
        weights_d[inv_h[order_h], jrank] = hang_w[order_h]
        self.h_local, self.h_masters, self.h_weights = pack_by_owner(
            owner[uh] if uh.size else np.zeros(0, np.int64),
            [(uh - owner[uh] * n_loc).astype(np.int32), masters_d, weights_d],
            [np.int32(n_loc), np.int32(trash), 0.0],
            n_shards,
        )

        # ---- per-rank masks over the owned slab (+ the dead slot) ----
        con = np.zeros(self.n_pad, dtype=bool)
        hngm = np.zeros(self.n_pad, dtype=bool)
        con[self.perm[np.flatnonzero(space.constrained_mask_np)]] = True
        hngm[self.perm[np.flatnonzero(space.hanging_mask_np)]] = True
        con[n:] = True  # padding DoFs act constrained (stay zero)
        self.constrained = np.concatenate([con.reshape(n_shards, n_loc), np.ones((n_shards, 1), bool)], 1)
        self.hanging = np.concatenate([hngm.reshape(n_shards, n_loc), np.zeros((n_shards, 1), bool)], 1)
        self._rank_cache = {}

    @property
    def n_cells_local(self) -> int:
        """A rank's packed cell count (its active cells and dead padding)."""
        return self.cell_map.shape[1]

    # ------------------------- host conversions ----------------------- #
    def to_shards(self, u: np.ndarray) -> np.ndarray:
        """Global ``[n_dofs]`` vector -> ``[n_shards, n_loc]`` owned slabs in
        the permuted order."""
        up = np.zeros(self.n_pad, dtype=np.asarray(u).dtype)
        up[self.perm] = np.asarray(u)
        return up.reshape(self.n_shards, self.n_loc)

    def from_shards(self, slabs: np.ndarray) -> np.ndarray:
        return np.asarray(slabs).reshape(-1)[self.perm]

    # --------------------------- a rank's side --------------------------- #
    def rank_tables(self, comm: SlabComm, dtype: torch.dtype) -> dict:
        """Rank ``comm.rank``'s tables on ``comm.device`` (cached): the cell
        map and its scatter plan onto ``[owned | SIGMA | trash]``, the SIGMA
        exchange, the hanging rows with their fill and transposed-fill
        plans, the masks."""
        key = (id(comm), dtype)
        if key in self._rank_cache:
            return self._rank_cache[key]
        k, dev, n_loc, S = comm.rank, comm.device, self.n_loc, self.n_sigma
        cmap = self.cell_map[k]
        hl = self.h_local[k]
        real = hl != n_loc
        hm, hw = self.h_masters[k][real], self.h_weights[k][real]
        live = hm != n_loc + S  # padded masters (weight 0) point at the trash slot
        ids, src = hm[live], np.repeat(np.arange(hm.shape[0]), hm.shape[1]).reshape(hm.shape)[live]
        t = {
            "cmap": torch.as_tensor(cmap, device=dev),
            "cell_plan": _scatter_plan(cmap, n_loc + S, dev),
            "sigma": SigmaExchange(self.own_sig_local[k], self.own_sig_slot[k], S, n_loc, comm, dev),
            "hl": torch.as_tensor(hl[real].astype(np.int64), device=dev),
            "hm": torch.as_tensor(hm.astype(np.int64), device=dev),
            "hw": torch.as_tensor(hw, dtype=dtype, device=dev),
            # condense: the hanging residuals (rows of hl) into their masters' slots
            "hang_T": (lg.make_sum_plan(ids, n_loc + S, weights=hw[live], rows=np.unique(ids), src=src,
                                        n_in=hm.shape[0], dtype=dtype, device=dev) if ids.size else None),
            "con": torch.as_tensor(self.constrained[k], device=dev),
            "hng": torch.as_tensor(self.hanging[k], device=dev),
        }
        self._rank_cache[key] = t
        return t


def _scatter_plan(cmap: np.ndarray, n_out: int, device) -> lg.SumPlan:
    """The sorted scatter of a rank's packed local vectors onto its first
    ``n_out`` slots (``[owned | SIGMA]``): the entries that point past them
    (the trash slot of the dead cells) are left out, so no row of the plan
    is as wide as the dead cells."""
    flat = cmap.reshape(-1)
    keep = np.flatnonzero(flat < n_out)
    return lg.make_sum_plan(flat[keep], n_out, src=keep, n_in=flat.size, device=device)


def _cat(owned_dead: torch.Tensor, sig: torch.Tensor, n_loc: int) -> torch.Tensor:
    """``[owned | SIGMA | dead]``: the index space of a rank's cell tables."""
    return torch.cat([owned_dead[:n_loc], sig, owned_dead[n_loc:]])


def hang_fill(u_dead: torch.Tensor, t: dict, n_loc: int) -> torch.Tensor:
    """distribute: the hanging rows of ``u_dead`` (owned, dead slot last)
    from the weighted sums of their masters (one SIGMA round; the masters
    are conforming, chains resolved)."""
    u_cat = _cat(u_dead, t["sigma"].gather(u_dead), n_loc)
    out = u_dead.clone()
    if t["hl"].numel():
        out[t["hl"]] = (t["hw"] * u_cat[t["hm"]]).sum(dim=-1)
    return out


def hang_fill_T(r_dead: torch.Tensor, t: dict, n_loc: int) -> torch.Tensor:
    """The exact transpose of :func:`hang_fill` (condense): hanging
    residuals go to their possibly remote masters, the hanging rows are
    zeroed."""
    c_cat = r_dead.new_zeros(n_loc + t["sigma"].S)  # [owned | SIGMA]
    plan = t["hang_T"]
    if plan is not None:
        c_cat[plan.rows] = plan.sums(r_dead[t["hl"]])
    r1 = r_dead + torch.cat([c_cat[:n_loc], c_cat.new_zeros(1)])
    r1 = t["sigma"].fold(r1, c_cat[n_loc:])
    return r1.masked_fill(t["hng"], 0)


def scatter_cells(vl: torch.Tensor, t: dict, n_loc: int) -> torch.Tensor:
    """The cells' local vectors summed onto the owned slab (dead slot
    last): the sorted scatter onto ``[owned | SIGMA | trash]``, then the
    SIGMA partials summed over the ranks and added at their owners."""
    v_cat = t["cell_plan"].sums(vl.reshape(-1))
    return t["sigma"].fold(torch.cat([v_cat[:n_loc], v_cat.new_zeros(1)]), v_cat[n_loc:])


class DistAdaptivePoisson:
    """A rank's adaptive vmult (Poisson, or Helmholtz with ``a``) on its
    owned slab ``[n_loc]``; every rank of the group calls it. The cell loop
    is K4 on the rank's packed cells (``kernel``)."""

    def __init__(self, part: AdaptivePartition, comm: SlabComm, dtype: torch.dtype = torch.float64, a=None):
        if comm.n_shards != part.n_shards:
            raise ValueError(f"the comm has {comm.n_shards} ranks, the partition {part.n_shards}")
        self.part, self.comm, self.dtype = part, comm, dtype
        self.device = comm.device
        space = part.space
        b = space.basis
        k = comm.rank
        self.tables = part.rank_tables(comm, dtype)
        w = b.q_weights
        w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]
        coef = part.cell_coef[k]  # [L, 3] per-axis coefficients (x, y, z), zero on dead cells
        L = part.n_cells_local
        val = None
        if a is not None:
            # the value term a(x_q) JxW per packed cell (dead cells: zero)
            aq = np.asarray(a(_cell_qpoints(space)), dtype=np.float64)
            det = space.mesh.sizes.prod(axis=1)
            (packed,) = pack_by_owner(part.cell_owner, [aq * det[:, None, None, None] * w3[None]], [0.0],
                                      part.n_shards, min_len=L)
            val = ("table", packed[k].reshape(L, -1))
        C = coef[:, None, :] * w3.reshape(1, -1, 1)  # [L, Q, 3]
        self.kernel = GeneralCellKernel(b, L, dtype, grad=("diag3", C), val=val, device=self.device)

    def cell_apply(self, ul: torch.Tensor) -> torch.Tensor:
        """The rank's packed cells: local vectors ``[L, p1, p1, p1]``."""
        k = self.kernel
        return k.apply_local(ul.reshape(k.n_cells, k.n_local)).reshape(ul.shape)

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """The rank's slab of ``A u``: zero constrained -> hanging fill ->
        SIGMA round -> gather -> cell loop -> sorted scatter + SIGMA sum ->
        condense -> identity on constrained rows."""
        part, t = self.part, self.tables
        n_loc = part.n_loc
        p1 = part.space.degree + 1
        u_pad = torch.cat([u.reshape(-1), u.new_zeros(1)])
        u1 = u_pad.masked_fill(t["con"], 0)
        u1 = hang_fill(u1, t, n_loc)
        u_cat = _cat(u1, t["sigma"].gather(u1), n_loc)
        ul = u_cat.index_select(0, t["cmap"].reshape(-1)).reshape(-1, p1, p1, p1)
        v1 = scatter_cells(self.cell_apply(ul), t, n_loc)
        v1 = hang_fill_T(v1, t, n_loc)
        return torch.where(t["con"], u_pad, v1)[:n_loc].reshape(u.shape)


def solve_cg_merged_dist_adaptive(dist_op: DistAdaptivePoisson, b_local: torch.Tensor, control: SolverControl):
    """Merged CG on the rank's owned slab ``b_local``
    (``AdaptivePartition.to_shards(b)[rank]``). Returns ``(x_local, info)``."""
    return solve_cg_merged(dist_op.vmult, b_local, control, comm=dist_op.comm)
