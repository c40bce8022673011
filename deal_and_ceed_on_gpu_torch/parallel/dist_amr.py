"""Distributed AMR: the solve -> estimate -> mark -> refine loop on every rank.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_amr.py``. Each step
repartitions the current adaptive space (exact owned slabs and the
shared-surface SIGMA exchange, :class:`.dist_adaptive.AdaptivePartition`,
with a new :class:`~.comm.SlabComm` on the same process group) and solves
it distributed: global-coarsening multigrid CG by default, or plain merged
CG. The estimate runs on every rank too
(:func:`estimate_gradient_recovery_dist`: ZZ gradient recovery on its
owned cells over the partition's SIGMA exchange), so the only traffic a
step needs beyond the solve is one indicator per cell, all-gathered.
Marking is a global decision on the host (``adaptive.mark_doerfler``, as
p4est repartitions on the host, ``bp5/step-64.cu:310``); every rank makes
it from the same bits, so every rank refines the same cells.
"""

from __future__ import annotations

import numpy as np
import torch

from ..adaptive import AdaptiveMesh, AdaptiveSpace, assemble_rhs_adaptive, mark_doerfler
from ..mesh import BrickMesh
from ..ops import sum_factorization as sf
from ..solvers.control import ReductionControl
from .comm import SlabComm, rank_device
from .dist_adaptive import (AdaptivePartition, DistAdaptivePoisson, _cat, hang_fill, pack_by_owner, scatter_cells,
                            solve_cg_merged_dist_adaptive)
from .dist_adaptive_mg import DistAdaptiveMultigrid, solve_cg_mg_dist_adaptive

__all__ = ["amr_loop_distributed", "estimate_gradient_recovery_dist"]


def estimate_gradient_recovery_dist(part: AdaptivePartition, comm: SlabComm, u_local: torch.Tensor,
                                    dtype: torch.dtype = torch.float64) -> np.ndarray:
    """The distributed :func:`~..adaptive.estimate_gradient_recovery` (ZZ
    recovery, ``eta_K^2 = int_K |grad u_h - R(grad u_h)|^2``): each rank
    evaluates the discontinuous gradient on its packed cells, node-averages
    it through the partition's SIGMA sums (the multiplicity counts and the
    recovered-gradient sums ride the cell scatter plan) and reduces one
    ``eta_K^2`` a cell; the ranks' indicators are all-gathered. Nodes inside
    a rank's slab sum in the host estimator's order; SIGMA nodes differ by
    the all-reduce's association (~1e-16 relative), which cannot change the
    marked set (``mark_doerfler`` groups ties at 1e-12). Returns the host
    ``[n_cells]`` eta, the same on every rank."""
    s = part.space
    t = part.rank_tables(comm, dtype)
    n_loc = part.n_loc
    b = s.basis
    p1 = s.degree + 1
    dev = comm.device
    w = b.q_weights
    w3 = w[:, None, None] * w[None, :, None] * w[None, None, :]
    h = s.mesh.sizes  # [E, 3]
    inv_h, jxw, ids = pack_by_owner(part.cell_owner, [1.0 / h, h.prod(axis=1)[:, None, None, None] * w3[None],
                                                      np.arange(s.mesh.n_cells, dtype=np.int64)],
                                    [0.0, 0.0, np.int64(-1)], part.n_shards, min_len=part.n_cells_local)
    k = comm.rank
    inv_h = torch.as_tensor(inv_h[k], dtype=dtype, device=dev)
    jxw = torch.as_tensor(jxw[k], dtype=dtype, device=dev)
    S = torch.as_tensor(np.array(b.S), dtype=dtype, device=dev)
    D = torch.as_tensor(np.array(b.D), dtype=dtype, device=dev)
    cmap = t["cmap"].reshape(-1)

    u1 = hang_fill(torch.cat([u_local.reshape(-1).to(dtype), u_local.new_zeros(1, dtype=dtype)]), t, n_loc)
    ul = _cat(u1, t["sigma"].gather(u1), n_loc).index_select(0, cmap).reshape(-1, p1, p1, p1)
    _, grads = sf.evaluate(ul, S, D, (1, 2, 3), False, True, True)
    counts = scatter_cells(torch.ones_like(ul), t, n_loc)
    counts = torch.where(counts > 0, counts, torch.ones_like(counts))
    eta2 = ul.new_zeros(ul.shape[0])
    for d in range(3):
        g = grads[d] * inv_h[:, d, None, None, None]
        R = scatter_cells(g, t, n_loc) / counts
        diff = g - _cat(R, t["sigma"].gather(R), n_loc).index_select(0, cmap).reshape(g.shape)
        eta2 = eta2 + torch.sum(diff * diff * jxw, dim=(1, 2, 3))
    eta2_all = comm.all_gather(eta2).cpu().numpy()  # [n_shards, L]
    eta = np.zeros(s.mesh.n_cells)
    real = ids >= 0
    eta[ids[real]] = np.sqrt(np.maximum(eta2_all[real], 0.0))
    return eta


def amr_loop_distributed(
    base: BrickMesh,
    degree: int,
    n_shards: int,
    f=1.0,
    n_steps: int = 3,
    theta: float = 0.5,
    reduction: float = 1e-10,
    max_iterations: int = 800,
    precond: str = "mg",
    dtype: torch.dtype = torch.float64,
    keep_solutions: bool = True,
    device=None,
    group=None,
):
    """The distributed :func:`~..adaptive.amr_loop`, called by every rank of
    ``group`` (None: the default group; ``n_shards`` ranks); the same
    history records plus ``n_shards``, on every rank. ``precond``: ``mg``
    (the distributed global-coarsening V-cycle) or ``none`` (distributed
    merged CG). ``keep_solutions=False`` leaves out the all-gathered
    global field (``"x": None``): the loop's decisions then move one scalar
    a cell. ``device``: the rank's (``cuda`` by default, which raises
    without a card)."""
    if precond not in ("none", "mg"):
        raise ValueError(f"precond {precond!r}: expected none or mg")
    device = rank_device(None, device)
    mesh = AdaptiveMesh.from_brick(base)
    history = []
    for step in range(n_steps + 1):
        space = AdaptiveSpace(mesh, degree, dtype=dtype, device=device)
        part = AdaptivePartition(space, n_shards)
        comm = SlabComm(n_shards, device, group)
        b = part.to_shards(assemble_rhs_adaptive(space, f).cpu().numpy())[comm.rank]
        b = torch.as_tensor(b, dtype=dtype, device=device)
        control = ReductionControl(max_iterations, tolerance=0.0, reduction=reduction)
        if precond == "mg" and int(mesh.levels.max()) > 0:
            mg = DistAdaptiveMultigrid(part, comm, dtype=dtype)
            x, info = solve_cg_mg_dist_adaptive(mg, b, control)
        else:
            op = DistAdaptivePoisson(part, comm, dtype=dtype)
            x, info = solve_cg_merged_dist_adaptive(op, b, control)
        eta = estimate_gradient_recovery_dist(part, comm, x, dtype=dtype)
        x_global = None
        if keep_solutions:
            x_global = torch.as_tensor(part.from_shards(comm.all_gather(x).cpu().numpy()), device=device)
        history.append({
            "space": space,
            "x": x_global,
            "n_dofs": space.n_dofs,
            "n_cells": mesh.n_cells,
            "n_shards": n_shards,
            "eta": float(np.sqrt((eta**2).sum())),
            "eta_cells": eta,
            "n_iterations": int(info["n_iterations"]),
        })
        if step < n_steps:
            mesh = mesh.refine_active(mark_doerfler(eta, theta))
    return history
