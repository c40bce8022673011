"""Geometric multigrid on adaptively refined (hanging-node) meshes.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/adaptive_mg.py``:
global-coarsening h-multigrid (the deal.II ``MGTransferGlobalCoarsening``
family) for :class:`~..adaptive.AdaptiveSpace` problems. Levels are formed
by CLAMPING the refinement level: ``M_k`` replaces every active cell finer
than ``k`` with its level-``k`` ancestor. Clamping a 2:1-balanced octree
stays balanced, and every level-``k`` cell of ``M_k`` either exists
identically in ``M_{k-1}`` or is one of 8 siblings of an active parent
there — so the conforming (hanging-constrained) spaces nest exactly and the
transfer is plain per-cell nodal embedding.

- **Prolongation** ``P = D_f B_mask M^-1 G_f^T E G_c D_c``: ``distribute``
  on the coarse level, gather of each fine cell's coarse parent, three 1D
  embedding sweeps picked per cell from a ``[3, p1, p1]`` stack, the sorted
  scatter onto the fine level, the average of duplicate nodal writes, the
  boundary zeroed, ``distribute`` on the fine level.
- **Restriction** is its exact transpose, written out (the JAX package
  takes ``jax.linear_transpose``): ``condense`` is the transpose of
  ``distribute``, so ``R = P^T`` is fine ``condense``, the boundary mask
  and the inverse multiplicity, the fine gather, the transposed sweeps, the
  sorted scatter onto the coarse parents and coarse ``condense``; then the
  coarse constrained rows are zeroed, as in JAX. R = P^T keeps the V-cycle
  symmetric (legal inside plain CG).
- **Smoother**: Chebyshev (the shared :func:`~.multigrid.chebyshev_smooth`)
  in the Jacobi-preconditioned operator; the level diagonals apply the
  hanging-node weights deal.II-style (squared-weight distribution of the
  local cell diagonals), and the eigenvalue bound comes from a per-level
  device power iteration, brought back as a Python float.
- **Coarse solve**: level 0 is the conforming base brick; its constrained
  operator is assembled on the host from oracle element matrices (or, for
  other operator classes, from ``vmult`` over identity columns) and
  inverted densely in f64 at set-up.

Every level is an ``AdaptiveSpace`` on the fine space's device, and its
operator comes from ``make_op`` (default ``AdaptivePoissonOperator`` on
``auto``: K4 on the card). The embedding sweeps and the coarse product run
inside ``sum_factorization.full_f32`` (no TF32).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..adaptive import AdaptiveMesh, AdaptivePoissonOperator, AdaptiveSpace
from ..basis import lagrange_eval
from ..ops import local_global as lg
from ..ops.sum_factorization import full_f32
from .multigrid import _dense_from_vmult, chebyshev_smooth

__all__ = ["coarsen_adaptive", "adaptive_hierarchy", "make_prolongation", "AdaptiveTransfer", "AdaptiveMultigrid"]


def dense_coarse_inverse(op, coarse_max_dofs: int) -> np.ndarray:
    """Dense f64 inverse of the (conforming base-brick) coarse operator,
    assembled on the host from per-cell oracle element matrices for the
    known operator classes; other operator classes go through ``vmult``
    over identity columns (``multigrid._dense_from_vmult``). Raises when
    the base brick is too large for a dense coarse solve."""
    cs = op.space
    if cs.n_dofs > coarse_max_dofs:
        raise ValueError(
            f"adaptive MG coarse level has {cs.n_dofs} DoFs > "
            f"coarse_max_dofs={coarse_max_dofs}; refine from a smaller "
            "base brick"
        )
    A_c = _host_dense_constrained(op)
    if A_c is None:
        A_c = _dense_from_vmult(op)
    return np.linalg.inv(A_c)


def _host_dense_constrained(op) -> np.ndarray | None:
    """Dense CONSTRAINED matrix (``vmult`` semantics: zero constrained
    columns, cell loop, identity on constrained rows) of a CONFORMING
    adaptive operator, assembled with numpy element matrices. Returns
    ``None`` for operator classes it does not know or non-conforming
    spaces (hanging nodes)."""
    from ..adaptive import AdaptiveHelmholtzOperator, _cell_qpoints
    from ..mesh import BrickMesh
    from ..utils.oracle import element_matrix

    s = op.space
    if s.hang_rows.numel():
        return None
    helm = type(op) is AdaptiveHelmholtzOperator
    if not (helm or type(op) is AdaptivePoissonOperator):
        return None
    n = s.n_dofs
    base = BrickMesh((1, 1, 1))
    K = np.zeros((n, n))
    dof_map = s._dof_map_np
    if helm:
        # recover a(x_q) from the stored JxW-weighted table
        aq = op._aq_jxw.double().cpu().numpy() / op._jxw.double().cpu().numpy()
        Xq = _cell_qpoints(s)
    for e in range(s.mesh.n_cells):
        if helm:
            a_e = aq[e].reshape(-1)
            Ke = element_matrix(
                base,
                s.basis,
                "helmholtz",
                cell_qpoints=Xq[e].reshape(-1, 3),
                coefficient_fn=lambda X, a_e=a_e: a_e,
                h_cell=tuple(s.mesh.sizes[e]),
            )
        else:
            Ke = element_matrix(
                base, s.basis, "stiffness", h_cell=tuple(s.mesh.sizes[e])
            )
        idx = dof_map[e].reshape(-1)
        K[np.ix_(idx, idx)] += Ke
    m = s.constrained_mask_np
    K[m, :] = 0.0
    K[:, m] = 0.0
    K[m, m] = 1.0
    return K


def coarsen_adaptive(mesh: AdaptiveMesh):
    """One global-coarsening step: replace every finest-level cell octet
    with its parent. Returns ``(coarse_mesh, src_cell, axis_pick)`` where
    ``src_cell[f]`` is the coarse-mesh cell each fine cell maps to and
    ``axis_pick[f, d]`` selects the per-axis transfer matrix
    (0 = identity/same cell, 1 = lower child half, 2 = upper child half).
    """
    L = int(mesh.levels.max())
    assert L > 0, "base mesh cannot be coarsened"
    base_h, m_base = mesh._base_geometry()
    lower = np.asarray(mesh.lower, dtype=np.float64)
    fine = mesh.levels == L
    keep = ~fine
    n_f = mesh.n_cells

    # parents of the finest cells on the level-(L-1) integer lattice
    hL = base_h / 2.0**L
    ic = np.round((mesh.origins[fine] - lower) / hL).astype(np.int64)
    child = ic & 1  # [n_fine_L, 3] octant within the parent
    pc = ic >> 1
    n_axp = m_base * 2 ** (L - 1)
    pkey = (pc[:, 2] * n_axp[1] + pc[:, 1]) * n_axp[0] + pc[:, 0]
    uniq_keys, inv = np.unique(pkey, return_inverse=True)
    n_kept = int(keep.sum())
    n_parents = uniq_keys.size

    # coarse mesh = kept cells (original order) then the new parents;
    # any sibling is a valid representative (all 8 share the parent
    # lattice coordinate pc)
    rep = np.zeros(n_parents, dtype=np.int64)
    np.maximum.at(rep, inv, np.arange(inv.size))
    p_orig = lower[None, :] + (pc[rep] * (2.0 * hL)[None, :])
    origins = np.concatenate([mesh.origins[keep], p_orig])
    sizes = np.concatenate(
        [mesh.sizes[keep], np.tile(2.0 * hL, (n_parents, 1))]
    )
    levels = np.concatenate(
        [mesh.levels[keep], np.full(n_parents, L - 1, dtype=np.int64)]
    )
    coarse = AdaptiveMesh(origins, sizes, levels, mesh.lower, mesh.upper)

    src_cell = np.empty(n_f, dtype=np.int64)
    src_cell[keep] = np.arange(n_kept)
    src_cell[fine] = n_kept + inv
    axis_pick = np.zeros((n_f, 3), dtype=np.int64)
    axis_pick[fine] = child + 1  # 1 = lower half, 2 = upper half
    return coarse, src_cell, axis_pick


def adaptive_hierarchy(mesh: AdaptiveMesh):
    """``(meshes, transfers)``: meshes[0] is the input (finest), meshes[-1]
    the base brick; transfers[k] = (src_cell, axis_pick) mapping
    meshes[k] cells into meshes[k+1]."""
    meshes, transfers = [mesh], []
    while int(meshes[-1].levels.max()) > 0:
        coarse, src, pick = coarsen_adaptive(meshes[-1])
        meshes.append(coarse)
        transfers.append((src, pick))
    return meshes, transfers


def _embed_mats(basis) -> np.ndarray:
    """[3, p1, p1] per-axis transfer stack (host float64): identity, and
    the Lagrange embedding onto each child half (rows = fine nodes)."""
    gll = basis.nodes
    E0 = lagrange_eval(gll, 0.5 * gll)[0]
    E1 = lagrange_eval(gll, 0.5 * (gll + 1.0))[0]
    return np.stack([np.eye(basis.n_dofs), E0, E1])


class AdaptiveTransfer:
    """The level transfer between a coarse and a fine adaptive space:
    :meth:`prolong` (coarse nodal ``[n_c]`` -> fine nodal ``[n_f]``, the
    exact nodal embedding of the conforming coarse function) and
    :meth:`restrict`, its transpose written out, with the coarse
    constrained rows zeroed."""

    def __init__(self, coarse: AdaptiveSpace, fine: AdaptiveSpace, src_cell, axis_pick):
        self.coarse, self.fine = coarse, fine
        E = fine.tensor(_embed_mats(fine.basis))
        pick = torch.as_tensor(np.asarray(axis_pick), device=fine.device)
        self.Mz, self.My, self.Mx = (E[pick[:, d]] for d in (2, 1, 0))  # [Ef, p1, p1] each
        coarse_map = coarse._dof_map_np[np.asarray(src_cell)]  # [Ef, P3]
        self.coarse_map = torch.as_tensor(coarse_map.astype(np.int32), device=fine.device)
        # the transpose of the parent gather: a sorted scatter onto the coarse level
        self.coarse_plan = lg.make_scatter_plan(coarse_map, coarse.n_dofs, device=fine.device)
        mult = np.bincount(fine._dof_map_np.reshape(-1), minlength=fine.n_dofs)
        self.inv_mult = 1.0 / fine.tensor(mult)
        self.bmask = torch.as_tensor(fine.boundary_mask_np, device=fine.device)

    def prolong(self, uc: torch.Tensor) -> torch.Tensor:
        c, f = self.coarse, self.fine
        uc = c.distribute(uc)  # conforming coarse function
        ul = lg.gather_indexed(uc, self.coarse_map, f.degree)  # [Ef, p1, p1, p1]
        with full_f32():
            ul = torch.einsum("eok,ekji->eoji", self.Mz, ul)
            ul = torch.einsum("eoj,ekji->ekoi", self.My, ul)
            ul = torch.einsum("eoi,ekji->ekjo", self.Mx, ul)
        uf = lg.scatter_indexed_sorted(ul, f.scatter_plan, f.n_dofs)
        uf = uf * self.inv_mult  # duplicates hold equal values -> average
        uf = uf.masked_fill(self.bmask, 0)
        return f.distribute(uf)  # exact hanging consistency

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        c, f = self.coarse, self.fine
        r = f.condense(rf)  # the transpose of the fine distribute
        r = r.masked_fill(self.bmask, 0) * self.inv_mult
        rl = lg.gather_indexed(r, f.elem_dof_map, f.degree)  # the transpose of the sorted scatter
        with full_f32():
            rl = torch.einsum("eoi,ekjo->ekji", self.Mx, rl)
            rl = torch.einsum("eoj,ekoi->ekji", self.My, rl)
            rl = torch.einsum("eok,eoji->ekji", self.Mz, rl)
        rc = lg.scatter_indexed_sorted(rl, self.coarse_plan, c.n_dofs)  # the transpose of the parent gather
        rc = c.condense(rc)  # the transpose of the coarse distribute
        # P reads coarse constrained rows (interior fine nodes carry
        # boundary-node embedding weights), so P^T deposits residual there:
        # zero it, constrained rows live outside the solve subspace
        return rc.masked_fill(c.constrained_mask, 0)


def make_prolongation(coarse: AdaptiveSpace, fine: AdaptiveSpace, src_cell, axis_pick):
    """The linear function ``coarse nodal [n_c] -> fine nodal [n_f]`` (JAX
    ``make_prolongation``); its transpose is
    :meth:`AdaptiveTransfer.restrict`."""
    return AdaptiveTransfer(coarse, fine, src_cell, axis_pick).prolong


class AdaptiveMultigrid:
    """V-cycle preconditioner for :class:`AdaptivePoissonOperator`
    systems. Same calling convention as :class:`~.multigrid.Multigrid`:
    ``mg.vcycle`` plugs into the CG solvers' ``diag`` slot."""

    def __init__(
        self,
        space: AdaptiveSpace,
        n_smooth: int = 3,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 30000,
        fine_op: AdaptivePoissonOperator | None = None,
        make_op=None,
        coarse_inv: np.ndarray | None = None,
    ):
        """``make_op(space) -> operator`` rediscretizes each level
        (default :class:`AdaptivePoissonOperator` on ``auto``; pass e.g.
        ``AdaptiveHelmholtzOperator`` for variable-coefficient levels —
        the coefficient re-evaluates at every level's own qpoints).
        ``coarse_inv``: a precomputed :func:`dense_coarse_inverse` of the
        SAME base brick / operator class — the coarsest level is always
        the conforming base, so AMR loops reuse one inverse across every
        refinement step (exposed as ``mg.coarse_inv_np``).
        ``setup_s``: host set-up seconds by step (levels, transfers,
        smoother, coarse)."""
        make_op = make_op or AdaptivePoissonOperator
        self.setup_s = {}
        t0 = time.perf_counter()
        meshes, transfers = adaptive_hierarchy(space.mesh)
        self.spaces = [space] + [
            AdaptiveSpace(m, space.degree, dtype=space.dtype, device=space.device)
            for m in meshes[1:]
        ]
        if fine_op is not None and fine_op.space is not space:
            raise ValueError("fine_op must be built on `space`")
        self.ops = [fine_op or make_op(space)] + [
            make_op(s) for s in self.spaces[1:]
        ]
        self.n_smooth = n_smooth
        cs = self.spaces[-1]
        t1 = time.perf_counter()
        self.setup_s["levels"] = t1 - t0

        self.transfers = [
            AdaptiveTransfer(self.spaces[k + 1], self.spaces[k], src, pick)
            for k, (src, pick) in enumerate(transfers)
        ]
        t2 = time.perf_counter()
        self.setup_s["transfers"] = t2 - t1

        # deal.II-style constrained level diagonals: distribute the local
        # cell diagonals with SQUARED hanging weights, identity on
        # constrained rows
        self.dinv = [self._level_dinv(op) for op in self.ops[:-1]]
        self.bounds = [
            _power_bounds(op, dinv, smoothing_range)
            for op, dinv in zip(self.ops[:-1], self.dinv)
        ]
        t3 = time.perf_counter()
        self.setup_s["smoother"] = t3 - t2

        # dense coarse inverse (conforming base brick); reusable across
        # AMR steps via the coarse_inv kwarg (same base, same operator)
        self.coarse_inv_np = (
            dense_coarse_inverse(self.ops[-1], coarse_max_dofs)
            if coarse_inv is None
            else coarse_inv
        )
        if self.coarse_inv_np.shape != (cs.n_dofs, cs.n_dofs):
            raise ValueError(f"coarse_inv is {self.coarse_inv_np.shape}, the base level has {cs.n_dofs} DoFs")
        self._coarse_inv = cs.tensor(self.coarse_inv_np)
        self.setup_s["coarse"] = time.perf_counter() - t3

    @staticmethod
    def _level_dinv(op: AdaptivePoissonOperator) -> torch.Tensor:
        s = op.space
        b = s.basis
        w = b.q_weights
        K1 = np.einsum("q,qa,qb->ab", w, b.D, b.D)  # 1D stiffness (GLL colloc)
        kd, wd = np.diag(K1), w
        h = s.mesh.sizes
        det = h.prod(axis=1)
        mdx, mdy, mdz = (det / h[:, d] ** 2 for d in range(3))
        # local diag [E, p1, p1, p1] (k, j, i) = (z, y, x)
        dloc = (
            mdx[:, None, None, None] * (wd[:, None, None] * wd[None, :, None] * kd[None, None, :])[None]
            + mdy[:, None, None, None] * (wd[:, None, None] * kd[None, :, None] * wd[None, None, :])[None]
            + mdz[:, None, None, None] * (kd[:, None, None] * wd[None, :, None] * wd[None, None, :])[None]
        )
        dloc = s.tensor(dloc)
        aq_jxw = getattr(op, "_aq_jxw", None)
        if aq_jxw is not None:
            # Helmholtz value term: with GLL collocation the local mass
            # matrix is diagonal and its diagonal IS a(x_q) * JxW
            dloc = dloc + aq_jxw
        d = lg.scatter_indexed_sorted(dloc, s.scatter_plan, s.n_dofs)
        plan = s._condense_plan
        if plan is not None:
            # the masters receive the hanging diagonals times the squared weights
            sq = dataclasses.replace(plan, weights=plan.weights**2)
            d = d.clone()
            d[sq.rows] = d[sq.rows] + sq.sums(d)
        d = d.masked_fill(s.constrained_mask, 1)
        return 1.0 / d

    @property
    def n_levels(self) -> int:
        return len(self.ops)

    def _smooth(self, level, r, z0=None):
        return chebyshev_smooth(
            self.ops[level].vmult,
            self.dinv[level],
            self.bounds[level],
            self.n_smooth,
            r,
            z0=z0,
        )

    def _vcycle(self, level, r):
        if level == self.n_levels - 1:
            with full_f32():  # a TF32 coarse correction costs ~1e-3
                return self._coarse_inv @ r
        z = self._smooth(level, r)
        res = r - self.ops[level].vmult(z)
        res = res.masked_fill(self.spaces[level].constrained_mask, 0)
        zc = self._vcycle(level + 1, self.transfers[level].restrict(res))
        z = z + self.transfers[level].prolong(zc)
        return self._smooth(level, r, z0=z)

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric V(k,k) cycle; linear and symmetric (R = P^T), so
        plain CG is sound."""
        mask = self.spaces[0].constrained_mask
        z = self._vcycle(0, r.masked_fill(mask, 0))
        return z.masked_fill(mask, 0)

    def __call__(self, r):
        return self.vcycle(r)

    def vcycle_vector(self, r: torch.Tensor) -> torch.Tensor:
        """The V-cycle per component of a ``[n_components, n]`` vector."""
        return torch.stack([self.vcycle(ri) for ri in r])


def _power_bounds(op, dinv, smoothing_range, n_power=12):
    """lambda_max(D^-1 A) over the constrained-zero subspace by a device
    power iteration; deal.II 1.2x safety factor. Returns host floats (the
    f32 smoother takes its coefficients as Python numbers)."""
    s = op.space
    mask = s.constrained_mask
    u = s.tensor(np.random.default_rng(42).standard_normal(s.n_dofs))
    u = u.masked_fill(mask, 0)
    u = u / torch.linalg.vector_norm(u)
    lam = 1.0
    for _ in range(n_power):
        v = (dinv * op.vmult(u)).masked_fill(mask, 0)
        lam = float(torch.linalg.vector_norm(v))
        u = v / lam

    lam_max = 1.2 * lam
    return lam_max / smoothing_range, lam_max
