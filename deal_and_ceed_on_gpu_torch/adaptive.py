"""Adaptive (2:1-refined) meshes with hanging-node constraints.

Counterpart of ``deal_and_ceed_on_gpu_tpu/adaptive.py``: deal.II's
``make_hanging_node_constraints`` (reference L-15) and the device-side
``internal::resolve_hanging_nodes`` hooks of the collocation evaluator
(``bp5/fe_evaluation_gl.h:150-151,167-168``), kept global and
dense-indexed as the JAX package keeps them: one weighted gather fills the
hanging DoFs from their coarse-side masters before the cell loop
(``distribute``), its transpose accumulates hanging residuals back onto the
masters after it (``condense``), and constrained rows act as identity. The
operator is ``C^T A C`` on the conforming subspace.

Scope: arbitrary-depth isotropic refinement of a uniform brick under a
vertex 2:1 balance (enforced automatically, like p4est's balance step),
zero Dirichlet boundary, Q_p with GLL nodes; constraint chains across
levels are resolved by substitution. The mesh and the DoF numbering are
host numpy, copied from the JAX package; the apply is the indexed gather,
the cell apply on the active cells and the sorted scatter of
``ops/local_global.py``. Every sum of the apply (the scatter,
``distribute``, ``condense``) is a :class:`~.ops.local_global.SumPlan`: a
fixed order, no atomics, bitwise repeatable on the card.

Cell apply backends of :class:`AdaptivePoissonOperator`:

- ``general``: K4 (``ops/general.py``), the active cells batched through
  ``GeneralCellKernel.apply_local`` with per-cell ``diag3`` coefficients
  (and the ``a(x) JxW`` value table for :class:`AdaptiveHelmholtzOperator`);
  the JAX ``pallas`` / ``pallas_general``;
- ``gather``: the plain torch sum-factorized loop (``ops/sum_factorization``);
  the JAX ``xla``;
- ``auto``: ``general`` on a CUDA device (f64 and f32 alike: the card's K4
  is native in both), ``gather`` on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .basis import Basis1D, lagrange_eval
from .mesh import BrickMesh
from .ops import local_global as lg
from .ops import sum_factorization as sf

__all__ = [
    "AdaptiveMesh",
    "AdaptiveSpace",
    "AdaptivePoissonOperator",
    "AdaptiveHelmholtzOperator",
    "assemble_rhs_adaptive",
    "estimate_gradient_recovery",
    "mark_doerfler",
    "evaluate_at_points",
    "amr_loop",
]

_TOL = 1e-9


def _key(x):
    return tuple(np.round(np.asarray(x, dtype=np.float64) / _TOL).astype(np.int64))


def _unique_rows_inverse(keys: np.ndarray) -> np.ndarray:
    """Inverse indices of the unique rows of an int64 ``[n, 3]`` array,
    ordered by first occurrence-free group id (row-sorted order).
    ``np.unique(axis=0)`` goes through a void-dtype sort that is ~40x
    slower; this encodes two columns into one int64 and 2-key lexsorts."""
    if keys.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    lo = keys.min(axis=0)
    k = keys - lo
    ey = int(k[:, 1].max()) + 1
    ez = int(k[:, 2].max()) + 1
    if float(ez) * float(ey) < 2**62:
        enc = k[:, 2] * ey + k[:, 1]
        order = np.lexsort((k[:, 0], enc))
    else:  # pathological extents: fall back to a 3-key lexsort
        order = np.lexsort((k[:, 0], k[:, 1], k[:, 2]))
    ks = k[order]
    new = np.empty(ks.shape[0], dtype=bool)
    new[0] = True
    np.any(ks[1:] != ks[:-1], axis=1, out=new[1:])
    group = np.cumsum(new) - 1
    inv = np.empty(ks.shape[0], dtype=np.int64)
    inv[order] = group
    return inv


@dataclasses.dataclass(frozen=True)
class AdaptiveMesh:
    """Active cells of an adaptively refined brick: ``cells[i] = (origin,
    h, level)`` with ``h`` the per-axis cell extents. Supports arbitrary
    refinement depth under a *vertex* 2:1 balance (any two active cells
    with touching closures differ by at most one level — the invariant
    p4est maintains for the reference, ``bp5/step-64.cu:310``)."""

    origins: np.ndarray  # [n_cells, 3]
    sizes: np.ndarray  # [n_cells, 3]
    levels: np.ndarray  # [n_cells]
    lower: tuple
    upper: tuple

    @staticmethod
    def from_brick(base: BrickMesh) -> "AdaptiveMesh":
        assert base.is_uniform and not base.is_mapped
        mx, my, mz = base.n_elements
        hx, hy, hz = base.h
        origins = []
        for e in range(base.n_cells):
            ez, rem = divmod(e, my * mx)
            ey, ex = divmod(rem, mx)
            origins.append(
                [
                    base.lower[0] + ex * hx,
                    base.lower[1] + ey * hy,
                    base.lower[2] + ez * hz,
                ]
            )
        n = base.n_cells
        return AdaptiveMesh(
            np.asarray(origins),
            np.tile(np.array([hx, hy, hz]), (n, 1)),
            np.zeros(n, dtype=np.int64),
            base.lower,
            base.upper,
        )

    @staticmethod
    def refine(base: BrickMesh, marks) -> "AdaptiveMesh":
        """Refine the marked coarse cells of a uniform brick once (8
        children each)."""
        return AdaptiveMesh.from_brick(base).refine_active(marks)

    def refine_active(self, marks) -> "AdaptiveMesh":
        """Refine the marked *active* cells (8 children each), then restore
        the vertex 2:1 balance by refining any active cell whose closure
        touches a cell two or more levels finer (the p4est balance step).
        Fully vectorized; preserves the original interleaved cell order
        (children replace their parent in place)."""
        marks = np.asarray(marks)
        if marks.dtype == bool:
            marked = marks.copy()
        else:
            marked = np.zeros(self.n_cells, dtype=bool)
            marked[marks] = True
        counts = np.where(marked, 8, 1)
        parent = np.repeat(np.arange(self.n_cells), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(counts.sum()) - starts[parent]
        # child rank order (cz, cy, cx) with cx fastest
        offs = np.array(
            [[cx, cy, cz] for cz in range(2) for cy in range(2) for cx in range(2)],
            dtype=np.float64,
        )
        is_m = marked[parent]
        origins = self.origins[parent] + np.where(
            is_m[:, None], 0.5 * self.sizes[parent] * offs[rank], 0.0
        )
        sizes = self.sizes[parent] * np.where(is_m, 0.5, 1.0)[:, None]
        levels = self.levels[parent] + is_m
        out = AdaptiveMesh(
            origins, sizes, levels.astype(np.int64), self.lower, self.upper
        )
        return out._balance()

    # ------------- integer octree lattice (scalable lookups) ----------- #
    def _base_geometry(self):
        """(base cell size [3], base element counts [3]): every active cell
        at level L sits on the integer lattice of spacing base_h / 2^L."""
        base_h = self.sizes[0] * 2.0 ** int(self.levels[0])
        lower = np.asarray(self.lower, dtype=np.float64)
        upper = np.asarray(self.upper, dtype=np.float64)
        m_base = np.maximum(np.round((upper - lower) / base_h), 1).astype(
            np.int64
        )
        return base_h, m_base

    def _level_tables(self):
        """Per refinement level: (sorted lattice keys, cell ids in key
        order, per-axis lattice extents) — O(1) hashed cell lookup by
        integer coordinates, replacing all-pairs geometry tests."""
        base_h, m_base = self._base_geometry()
        lower = np.asarray(self.lower, dtype=np.float64)
        tables = {}
        for lv in np.unique(self.levels):
            sel = np.flatnonzero(self.levels == lv)
            h = base_h / 2.0 ** int(lv)
            n_ax = m_base * 2 ** int(lv)
            ic = np.round((self.origins[sel] - lower) / h).astype(np.int64)
            key = (ic[:, 2] * n_ax[1] + ic[:, 1]) * n_ax[0] + ic[:, 0]
            order = np.argsort(key)
            tables[int(lv)] = (key[order], sel[order], n_ax)
        return tables

    @staticmethod
    def _lookup(table, ii: np.ndarray) -> np.ndarray:
        """Cell ids for integer coords ``ii [n, 3]`` (-1 where absent)."""
        keys, ids, n_ax = table
        valid = np.all((ii >= 0) & (ii < n_ax[None, :]), axis=1)
        k = (ii[:, 2] * n_ax[1] + ii[:, 1]) * n_ax[0] + ii[:, 0]
        pos = np.clip(np.searchsorted(keys, k), 0, max(keys.size - 1, 0))
        if keys.size == 0:
            return np.full(ii.shape[0], -1, dtype=np.int64)
        hit = valid & (keys[pos] == k)
        return np.where(hit, ids[pos], -1)

    def _violators(self) -> np.ndarray:
        """Active cells whose closure touches a cell >= 2 levels finer:
        for every fine cell, the <= 8 coarse lattice cells its (tolerance-
        inflated) bounding box overlaps are looked up per coarser level."""
        tables = self._level_tables()
        base_h, _ = self._base_geometry()
        lower = np.asarray(self.lower, dtype=np.float64)
        viol = np.zeros(self.n_cells, dtype=bool)
        lvs = sorted(tables)
        for lf in lvs:
            sel = tables[lf][1]
            lo = self.origins[sel] - lower
            hi = lo + self.sizes[sel]
            for lc in lvs:
                if lc > lf - 2:
                    continue
                hc = base_h / 2.0**lc
                a = np.floor((lo - _TOL) / hc).astype(np.int64)
                b = np.floor((hi + _TOL) / hc).astype(np.int64)
                for c in range(8):
                    ii = np.stack(
                        [
                            np.minimum(a[:, d] + ((c >> d) & 1), b[:, d])
                            for d in range(3)
                        ],
                        axis=1,
                    )
                    found = self._lookup(tables[lc], ii)
                    viol[found[found >= 0]] = True
        return viol

    def _balance(self) -> "AdaptiveMesh":
        """Refine until no two closure-touching active cells differ by
        more than one level."""
        mesh = self
        while True:
            viol = mesh._violators()
            if not viol.any():
                return mesh
            mesh = mesh.refine_active(viol)

    def is_balanced(self) -> bool:
        return not self._violators().any()

    @property
    def n_cells(self) -> int:
        return self.origins.shape[0]


class AdaptiveSpace:
    """DoF handler + hanging-node constraints for an AdaptiveMesh.

    DoFs = unique nodal points over all active cells. A node is *hanging*
    iff it lies on the closure of a coarse active cell without being one
    of its nodes; its masters are that coarse cell's nodes with tensor
    Lagrange weights (nonzero only on the shared face/edge). The host
    tables are the JAX package's; the device tables (``elem_dof_map``, the
    scatter plan, the constraint plans, the masks) live on ``device``."""

    def __init__(self, mesh: AdaptiveMesh, degree: int, dtype=torch.float64, device="cuda"):
        self.mesh = mesh
        self.degree = degree
        self.dtype = dtype
        self.device = torch.device(device)
        self.basis = Basis1D.make(degree, rule="gauss_lobatto")
        p1 = degree + 1
        gll = self.basis.nodes
        n_cells = mesh.n_cells
        P3 = p1**3

        # ---- global DoF ids by unique nodal coordinates (vectorized) ----
        o, h = mesh.origins, mesh.sizes
        axpts = [o[:, d, None] + h[:, d, None] * gll[None, :] for d in range(3)]
        X = np.empty((n_cells, p1, p1, p1, 3))
        X[..., 0] = axpts[0][:, None, None, :]  # local (k, j, i) = (z, y, x)
        X[..., 1] = axpts[1][:, None, :, None]
        X[..., 2] = axpts[2][:, :, None, None]
        Xf = X.reshape(-1, 3)
        keys = np.round(Xf / _TOL).astype(np.int64)
        inv = _unique_rows_inverse(keys)
        n_u = int(inv.max()) + 1 if inv.size else 0
        coords_arr = np.zeros((n_u, 3))
        coords_arr[inv] = Xf
        # Bucket-keyed dedupe can split two fp representations of the same
        # geometric node across adjacent 1e-9 buckets; merge any remaining
        # near-duplicates with a true tolerance query (on the already-unique
        # coords, so this stays cheap at scale).
        from scipy.spatial import cKDTree

        pairs = cKDTree(coords_arr).query_pairs(10 * _TOL, output_type="ndarray")
        if len(pairs):
            parent = np.arange(coords_arr.shape[0])

            def find(i):
                while parent[i] != i:
                    parent[i] = parent[parent[i]]
                    i = parent[i]
                return i

            for a, b in pairs:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
            roots = np.array([find(i) for i in range(coords_arr.shape[0])])
            uniq, new_ids = np.unique(roots, return_inverse=True)
            coords_arr = coords_arr[uniq]
            inv = new_ids[inv]
        dof_map = inv.reshape(n_cells, P3)

        self.n_dofs = coords_arr.shape[0]
        self.node_coords = coords_arr
        self._dof_map_np = dof_map
        self.elem_dof_map = torch.as_tensor(dof_map.astype(np.int32), device=self.device)
        # the deterministic scatter-add plan (ops.local_global.SumPlan)
        self.scatter_plan = lg.make_scatter_plan(dof_map, self.n_dofs, device=self.device)

        # ---- hanging-node constraints (multi-level, chain-resolved) ----
        # A node is hanging iff it is NOT a node of any *coarsest*-level
        # active cell whose closure contains it; its raw masters are that
        # cell's nodes with tensor Lagrange weights. The coarsest containing
        # cell is found by integer lattice lookup per level (<= 8 candidate
        # cells each), and node-of-cell membership is the arithmetic test
        # "every local coordinate is a GLL point".
        tables = mesh._level_tables()
        base_h, _ = mesh._base_geometry()
        lower = np.asarray(mesh.lower, dtype=np.float64)
        N = self.n_dofs

        # minimum level over the cells having each node AS A NODE: a
        # closure-containing cell at a level BELOW this cannot have the
        # node as one of its own (it would lower the minimum), so
        #   hanging(g)  <=>  exists a closure-containing cell at some
        #                    level < lev_node[g],
        # and the first (coarsest) such cell supplies the masters.
        lev_node = np.full(N, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(
            lev_node,
            inv,
            np.repeat(mesh.levels, P3),
        )

        own_cell = np.full(N, -1, dtype=np.int64)
        Xrel = coords_arr - lower
        for lv in sorted(tables):
            rem = np.flatnonzero((own_cell < 0) & (lev_node > lv))
            if rem.size == 0:
                continue
            hl = base_h / 2.0**lv
            t = Xrel[rem] / hl
            rt = _TOL / hl + 1e-12  # per-axis tolerance in lattice units
            a = np.floor(t + rt).astype(np.int64)
            b = np.floor(t - rt).astype(np.int64)  # b == a or a-1
            for c in range(8):
                ii = np.stack(
                    [(a if (c >> d) & 1 else b)[:, d] for d in range(3)],
                    axis=1,
                )
                found = mesh._lookup(tables[lv], ii)
                upd = (own_cell[rem] < 0) & (found >= 0)
                own_cell[rem[upd]] = found[upd]
        hanging = own_cell >= 0
        hsel = np.flatnonzero(hanging)
        t_loc_h = (coords_arr[hsel] - o[own_cell[hsel]]) / h[own_cell[hsel]]
        if hsel.size:
            th = np.clip(t_loc_h, 0.0, 1.0)
            Sx, _ = lagrange_eval(gll, th[:, 0])  # [n_h, p1]
            Sy, _ = lagrange_eval(gll, th[:, 1])
            Sz, _ = lagrange_eval(gll, th[:, 2])
            W = np.einsum("nk,nj,ni->nkji", Sz, Sy, Sx).reshape(hsel.size, P3)
            masters = dof_map[own_cell[hsel]]  # [n_h, P3]
            ri, ci = np.nonzero(np.abs(W) > 1e-12)
            raw_rows = hsel[ri]
            raw_cols = masters[ri, ci]
            raw_w = W[ri, ci]

            # Chain resolution: a raw master can itself be hanging (one
            # level coarser); levels strictly decrease along chains, so
            # C = sum_j H^j I_conf terminates after max_level sparse
            # matmuls (deal.II resolves the same chains inside
            # make_hanging_node_constraints).
            import scipy.sparse as sp

            H = sp.coo_matrix(
                (raw_w, (raw_rows, raw_cols)), shape=(N, N)
            ).tocsr()
            Ic = sp.diags((~hanging).astype(np.float64)).tocsr()
            C = Ic
            for _ in range(int(mesh.levels.max()) + 1):
                C = Ic + H @ C
            Ch = C[hsel].tocoo()
            keep = np.abs(Ch.data) > 1e-12
            hang_rows = hsel[Ch.row[keep]]
            hang_cols = Ch.col[keep]
            hang_w = Ch.data[keep]
            assert not hanging[hang_cols].any(), "unresolved constraint chain"
        else:
            hang_rows = np.zeros(0, dtype=np.int64)
            hang_cols = np.zeros(0, dtype=np.int64)
            hang_w = np.zeros(0)
        self.hanging_mask_np = hanging
        # the constraint triplets sorted by ROW (distribute sums into rows);
        # condense sums the transpose into the master columns, in the
        # row-sorted order within a column (a stable sort, as JAX's)
        order_r = np.argsort(hang_rows, kind="stable")
        hang_rows = hang_rows[order_r].astype(np.int64)
        hang_cols = hang_cols[order_r].astype(np.int64)
        hang_w = hang_w[order_r]
        self._hang_np = (hang_rows, hang_cols, hang_w)
        self.hang_rows = torch.as_tensor(hang_rows, device=self.device)
        self.hang_cols = torch.as_tensor(hang_cols, device=self.device)
        self.hang_w = torch.as_tensor(hang_w, dtype=dtype, device=self.device)
        self._distribute_plan = self._condense_plan = None
        if hang_rows.size:
            # distribute: one row per hanging DoF, its masters' weights
            self._distribute_plan = lg.make_sum_plan(
                hang_rows, N, weights=hang_w, rows=hsel, src=hang_cols, n_in=N, dtype=dtype, device=self.device
            )
            # condense: one row per master, the hanging residuals it receives
            self._condense_plan = lg.make_sum_plan(
                hang_cols, N, weights=hang_w, rows=np.unique(hang_cols), src=hang_rows, n_in=N, dtype=dtype,
                device=self.device,
            )

        # ---- Dirichlet boundary (whole domain boundary) ----
        lo = np.asarray(mesh.lower)
        up = np.asarray(mesh.upper)
        on_b = np.zeros(self.n_dofs, dtype=bool)
        for d in range(3):
            on_b |= np.abs(self.node_coords[:, d] - lo[d]) < _TOL
            on_b |= np.abs(self.node_coords[:, d] - up[d]) < _TOL
        self.boundary_mask_np = on_b
        # all constrained rows act as identity in vmult
        self.constrained_mask_np = on_b | hanging
        self.constrained_mask = torch.as_tensor(self.constrained_mask_np, device=self.device)
        self.hanging_mask = torch.as_tensor(hanging, device=self.device)

    def tensor(self, a) -> torch.Tensor:
        """Host array -> tensor in this space's dtype on its device."""
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    # ------------------- constraint application ---------------------- #
    def distribute(self, u: torch.Tensor) -> torch.Tensor:
        """Fill hanging DoFs from their masters (deal.II
        ``constraints.distribute`` / the forward ``resolve_hanging_nodes``)."""
        plan = self._distribute_plan
        if plan is None:
            return u
        out = u.clone()
        out[plan.rows] = plan.sums(u)
        return out

    def condense(self, v: torch.Tensor) -> torch.Tensor:
        """Accumulate hanging residuals onto masters and zero the hanging
        rows (the transpose application on the scatter side,
        ``bp5/fe_evaluation_gl.h:167-168``; the transpose of
        :meth:`distribute`)."""
        plan = self._condense_plan
        if plan is None:
            return v
        out = v.clone()
        out[plan.rows] = v[plan.rows] + plan.sums(v)
        return out.masked_fill_(self.hanging_mask, 0)

    def constraint_matrix(self):
        """scipy C with u_full = C u (identity on real DoFs, interpolation
        rows on hanging DoFs) — oracle/test use."""
        import scipy.sparse as sp

        n = self.n_dofs
        hang_rows, hang_cols, hang_w = self._hang_np
        eye_rows = np.flatnonzero(~self.hanging_mask_np)
        rows = np.concatenate([eye_rows, hang_rows])
        cols = np.concatenate([eye_rows, hang_cols])
        vals = np.concatenate([np.ones(eye_rows.size), hang_w])
        return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


_BACKENDS = ("auto", "general", "gather")
_JAX_NAMES = {"xla": "gather", "pallas": "general", "pallas_general": "general"}


class AdaptivePoissonOperator:
    """Matrix-free Poisson vmult on an adaptive space:

        zero constrained -> distribute (hanging interpolation) -> gather
        -> per-cell apply (per-cell diagonal Jacobians)
        -> scatter-add -> condense (transpose) -> identity on constrained

    ``backend``: ``general`` (K4, the active cells through
    :meth:`~.ops.general.GeneralCellKernel.apply_local` with per-cell
    ``diag3`` coefficients; the JAX ``pallas``), ``gather`` (the plain torch
    sum-factorized cell loop; the JAX ``xla``) or ``auto`` (``general`` on a
    CUDA device in every dtype, ``gather`` on the CPU). A CUDA space whose
    cells K4 refuses raises; nothing drops to the plain loop unless the
    caller names it.
    """

    def __init__(self, space: AdaptiveSpace, backend: str = "auto"):
        if backend in _JAX_NAMES:
            raise ValueError(f"adaptive backend {backend!r} is the JAX package's name; the port's is "
                             f"{_JAX_NAMES[backend]!r}")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown adaptive backend {backend!r}: expected one of {_BACKENDS}")
        self.space = space
        b = space.basis
        self.S = space.tensor(b.S)
        self.D = space.tensor(b.D)
        h = space.mesh.sizes  # [E, 3]
        det = h.prod(axis=1)
        md = np.stack([det / h[:, 0] ** 2, det / h[:, 1] ** 2, det / h[:, 2] ** 2], -1)
        w = b.q_weights
        w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :])[None]
        self._jxw_np = det[:, None, None, None] * w3
        self._jxw = space.tensor(self._jxw_np)
        self._md = md
        self._w3_np = w3
        self._cw_cache = None
        if backend == "auto":
            backend = "general" if space.device.type == "cuda" else "gather"
        self.backend = backend
        self._kernel = None

    @property
    def _cw(self):
        """The plain loop's gradient coefficient tables (three ``[E, q, q,
        q]`` tensors), built on first use: K4 streams its own ``[3, E, Q]``
        copy and never reads these."""
        if self._cw_cache is None:
            self._cw_cache = tuple(
                self.space.tensor(self._md[:, d, None, None, None] * self._w3_np) for d in range(3)
            )
        return self._cw_cache

    def _val_table(self):
        """``("table", a_jxw[E, Q])`` for the kernel's value term, or
        ``None`` (pure Poisson). Subclasses with a mass/value term
        override."""
        return None

    def _get_kernel(self):
        if self._kernel is None:
            from .ops.general import GeneralCellKernel

            s = self.space
            w = np.asarray(s.basis.q_weights)
            w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :])
            C = self._md[:, None, :] * w3.reshape(1, -1, 1)  # [E, Q, 3]
            self._kernel = GeneralCellKernel(
                s.basis, s.mesh.n_cells, s.dtype,
                grad=("diag3", C), val=self._val_table(), device=s.device,
            )
        return self._kernel

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """Global -> element-local ``[E, p+1, p+1, p+1]``."""
        s = self.space
        return lg.gather_indexed(u, s.elem_dof_map, s.degree)

    def scatter(self, vl: torch.Tensor) -> torch.Tensor:
        """Element-local -> global, the deterministic sorted scatter-add."""
        s = self.space
        return lg.scatter_indexed_sorted(vl, s.scatter_plan, s.n_dofs)

    def cell_apply(self, ul: torch.Tensor) -> torch.Tensor:
        """The per-cell apply on local vectors ``[E, p+1, p+1, p+1]``."""
        if self.backend == "general":
            k = self._get_kernel()
            return k.apply_local(ul.reshape(k.n_cells, k.n_local)).reshape(ul.shape)
        _, grads = sf.evaluate(ul, self.S, self.D, (1, 2, 3), False, True, True)
        gx, gy, gz = grads
        cx, cy, cz = self._cw
        return sf.integrate(None, (gx * cx, gy * cy, gz * cz), self.S, self.D, (1, 2, 3), True)

    def apply_cell_loop(self, u: torch.Tensor) -> torch.Tensor:
        return self.scatter(self.cell_apply(self.gather(u)))

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        s = self.space
        u = src.masked_fill(s.constrained_mask, 0)
        u = s.distribute(u)
        dst = self.apply_cell_loop(u)
        dst = s.condense(dst)
        return torch.where(s.constrained_mask, src, dst)

    def __call__(self, src):
        return self.vmult(src)

    def diagonal(self) -> torch.Tensor:
        s = self.space
        return torch.ones((s.n_dofs,), dtype=s.dtype, device=s.device)


class AdaptiveHelmholtzOperator(AdaptivePoissonOperator):
    """-div(grad u) + a(x) u on an adaptive (hanging-node) space — the
    step-64 workload (`step-64/step-64.cu:153-160`) on AMR meshes. ``a`` is
    evaluated at the physical (nodal, GLL-collocation) quadrature points of
    every active cell; with S == I the value term is one pointwise product
    at the quadrature stage."""

    def __init__(self, space: AdaptiveSpace, a=None, backend: str = "auto"):
        super().__init__(space, backend=backend)
        if a is None:
            from .models.helmholtz import default_coefficient

            a = default_coefficient
        aq = np.asarray(a(_cell_qpoints(space)), dtype=np.float64)
        # rounded to the space dtype first, as the JAX package stores a(x_q)
        aq_jxw = self.space.tensor(aq) * self._jxw
        self._aq_jxw = aq_jxw
        self._aq_jxw_np = aq_jxw.double().cpu().numpy()

    def _val_table(self):
        E = self.space.mesh.n_cells
        return ("table", self._aq_jxw_np.reshape(E, -1))

    def cell_apply(self, ul: torch.Tensor) -> torch.Tensor:
        if self.backend == "general":
            return super().cell_apply(ul)
        vals, grads = sf.evaluate(ul, self.S, self.D, (1, 2, 3), True, True, True)
        gx, gy, gz = grads
        cx, cy, cz = self._cw
        return sf.integrate(vals * self._aq_jxw, (gx * cx, gy * cy, gz * cz), self.S, self.D, (1, 2, 3), True)


def _cell_qpoints(space: AdaptiveSpace) -> np.ndarray:
    """Physical quadrature (= nodal, GLL collocation) points per active
    cell: ``[n_cells, q, q, q, 3]`` in local (z, y, x) order."""
    gll = space.basis.nodes
    o, h = space.mesh.origins, space.mesh.sizes
    q1 = gll.shape[0]
    X = np.zeros((space.mesh.n_cells, q1, q1, q1, 3))
    for d in range(3):
        axis_pts = o[:, d, None] + h[:, d, None] * gll[None, :]  # [E, q1]
        shape = [1, 1, 1]
        shape[2 - d] = q1  # local (k, j, i) = (z, y, x)
        X[..., d] = axis_pts.reshape((-1,) + tuple(shape))
    return X


def assemble_rhs_adaptive(space: AdaptiveSpace, f=1.0) -> torch.Tensor:
    """b_i = integral(f phi_i) over the adaptive mesh, condensed onto the
    conforming subspace and zeroed on constrained rows. ``f`` may be a
    constant or a callable of physical coordinates ``f(x[..., 3])``."""
    op = AdaptivePoissonOperator(space, backend="gather")
    q1 = space.basis.n_q
    if callable(f):
        fq = np.asarray(f(_cell_qpoints(space)), dtype=np.float64)
        integrand = space.tensor(fq) * op._jxw
    else:
        integrand = (float(f) * op._jxw).expand(space.mesh.n_cells, q1, q1, q1)
    vl = sf.integrate(integrand, None, op.S, op.D, (1, 2, 3), True)
    b = op.scatter(vl)
    b = space.condense(b)
    return b.masked_fill(space.constrained_mask, 0)


# --------------------------------------------------------------------- #
# error estimation + marking: the AMR workflow (the deal.II step-6-style
# solve -> estimate -> mark -> refine loop)
# --------------------------------------------------------------------- #
def estimate_gradient_recovery(
    space: AdaptiveSpace, op: AdaptivePoissonOperator, u: torch.Tensor
) -> np.ndarray:
    """Per-active-cell error indicators ``eta_K`` by Zienkiewicz-Zhu
    gradient recovery:

        eta_K^2 = int_K | grad u_h - R(grad u_h) |^2

    with ``R`` the node-averaged (multiplicity-weighted) recovery of the
    elementwise-discontinuous gradient field. One gather + D sweeps, one
    scatter-mean, one gather, one weighted reduction, each sum in the fixed
    order of the space's plans. Returns host ``[n_cells]``."""
    s = space
    uf = s.distribute(u.masked_fill(s.hanging_mask, 0))
    ul = lg.gather_indexed(uf, s.elem_dof_map, s.degree)
    _, grads = sf.evaluate(ul, op.S, op.D, (1, 2, 3), False, True, True)
    h = s.tensor(s.mesh.sizes)  # [E, 3]
    phys = [grads[d] / h[:, d, None, None, None] for d in range(3)]  # d/dx, d/dy, d/dz at the nodal points

    counts = lg.scatter_indexed_sorted(torch.ones_like(ul), s.scatter_plan, s.n_dofs)
    eta2 = torch.zeros((s.mesh.n_cells,), dtype=s.dtype, device=s.device)
    for g in phys:
        Rg = lg.scatter_indexed_sorted(g, s.scatter_plan, s.n_dofs) / counts
        diff = g - lg.gather_indexed(Rg, s.elem_dof_map, s.degree)
        eta2 = eta2 + torch.sum(diff * diff * op._jxw, dim=(1, 2, 3))
    return np.sqrt(eta2.cpu().numpy())


def mark_doerfler(eta: np.ndarray, theta: float = 0.5) -> np.ndarray:
    """Doerfler (bulk-chasing) marking: the smallest set of cells whose
    squared indicators sum to ``theta`` of the total.

    Determinism: symmetric meshes produce exactly-tied indicators, and a
    raw ``argsort`` makes the marked SET depend on last-bit FP noise in
    the solution (K4 and the plain loop, or the card and the CPU, agree to
    ~1e-16 relative, which is enough to reorder exact ties and refine
    different — if statistically equivalent — cells). The fix sorts by
    EXACT value and then merges adjacent sorted values within ``1e-12 *
    max`` into tie classes reordered by cell index — grouping is
    boundary-free, so a value sitting within last-bit noise of a quantum
    edge cannot flip classes the way round-to-bucket quantization could.

    Non-finite indicators (diverged solves) sort FIRST and are marked
    alone: the diverged cell refines, nothing else cascades off the
    meaningless ``inf`` cumulative sum."""
    eta2 = np.asarray(eta, dtype=np.float64) ** 2
    eta2 = np.where(np.isnan(eta2), np.inf, eta2)
    finite = eta2[np.isfinite(eta2)]
    scale = float(finite.max()) if finite.size else 0.0
    # exact descending sort, ascending cell index on exact ties (inf
    # entries land first: -inf is the smallest ascending key)
    order = np.lexsort((np.arange(eta2.size), -eta2))
    v = eta2[order]
    if scale > 0.0 and np.isfinite(v[0]):
        new_group = np.empty(v.size, dtype=bool)
        new_group[0] = True
        new_group[1:] = (v[:-1] - v[1:]) > 1e-12 * scale
        gid = np.cumsum(new_group) - 1
        order = order[np.lexsort((order, gid))]
    csum = np.cumsum(eta2[order])
    k = int(np.searchsorted(csum, theta * csum[-1])) + 1
    return order[:k]


def evaluate_at_points(
    space: AdaptiveSpace, u: torch.Tensor, pts: np.ndarray
) -> np.ndarray:
    """Point evaluation of the FE function on the adaptive mesh (host):
    locate the active cell containing each point, tensor Lagrange eval."""
    s = space
    uf = s.distribute(torch.as_tensor(u, device=s.device)).double().cpu().numpy()
    gll = s.basis.nodes
    lo, sz = s.mesh.origins, s.mesh.sizes
    out = np.zeros(len(pts))
    dof_map = s._dof_map_np
    p1 = s.degree + 1
    for i, x in enumerate(np.asarray(pts, dtype=np.float64)):
        t = (x[None, :] - lo) / sz
        inside = np.all((t > -_TOL) & (t < 1 + _TOL), axis=1)
        hits = np.flatnonzero(inside)
        if hits.size == 0:
            raise ValueError(
                f"evaluate_at_points: point {x.tolist()} lies outside "
                "every active cell (outside the domain?)"
            )
        e = int(hits[0])
        w = np.ones((p1, p1, p1))
        for d in range(3):
            S, _ = lagrange_eval(gll, np.array([np.clip(t[e, d], 0.0, 1.0)]))
            shape = [1, 1, 1]
            shape[2 - d] = p1
            w = w * S[0].reshape(shape)
        out[i] = float(uf[dof_map[e]].reshape(-1) @ w.reshape(-1))
    return out


def amr_loop(
    base: BrickMesh,
    degree: int,
    f=1.0,
    n_steps: int = 3,
    theta: float = 0.5,
    reduction: float = 1e-10,
    max_iterations: int = 800,
    precond: str = "none",
    dtype=torch.float64,
    make_op=None,
    device="cuda",
):
    """The solve -> estimate -> mark -> refine loop. Returns the per-step
    history: dicts with ``space``, ``x``, ``n_dofs``, ``n_cells``,
    ``eta`` (global estimate), ``eta_cells``, ``n_iterations``.
    ``precond="mg"`` solves each step with
    :class:`~.solvers.AdaptiveMultigrid`-preconditioned CG instead of plain
    merged CG; ``precond="mg-ir"`` runs mixed-precision iterative refinement
    (f32 adaptive-MG inner CG, f64 true residuals; ``dtype=float64`` only).
    ``make_op(space) -> operator`` selects the PDE (default Poisson on
    ``auto``: K4 on the card; pass :class:`AdaptiveHelmholtzOperator` for
    the step-64 problem). ``device``: ``cuda`` (default) or ``cpu``."""
    from .solvers import ReductionControl, solve_cg, solve_cg_merged

    if precond not in ("none", "mg", "mg-ir"):
        raise ValueError(f"precond {precond!r}: expected none, mg or mg-ir")
    make_op = make_op or AdaptivePoissonOperator
    mesh = AdaptiveMesh.from_brick(base)
    history = []
    # the MG coarsest level is always the conforming base brick, so one
    # dense coarse inverse serves every refinement step (per dtype)
    coarse_inv_cache: dict = {}
    for step in range(n_steps + 1):
        space = AdaptiveSpace(mesh, degree, dtype=dtype, device=device)
        op = make_op(space)
        b = assemble_rhs_adaptive(space, f)
        control = ReductionControl(
            max_iterations, tolerance=0.0, reduction=reduction
        )
        deep = int(mesh.levels.max()) > 0
        if precond == "mg-ir" and deep:
            from .solvers import AdaptiveMultigrid, solve_cg_ir

            if dtype != torch.float64:
                raise ValueError("mg-ir needs dtype=float64 (the outer residuals)")
            s32 = AdaptiveSpace(mesh, degree, dtype=torch.float32, device=device)
            op32 = make_op(s32)
            mg32 = AdaptiveMultigrid(
                s32, fine_op=op32, make_op=make_op,
                coarse_inv=coarse_inv_cache.get("f32"),
            )
            coarse_inv_cache["f32"] = mg32.coarse_inv_np
            x, ir_info = solve_cg_ir(
                op32, op, b, rtol=reduction, diag32=mg32.vcycle
            )
            info = {"n_iterations": ir_info["n_inner"]}
        elif precond == "mg" and deep:
            from .solvers import AdaptiveMultigrid

            mg = AdaptiveMultigrid(
                space, fine_op=op, make_op=make_op,
                coarse_inv=coarse_inv_cache.get("main"),
            )
            coarse_inv_cache["main"] = mg.coarse_inv_np
            x, info = solve_cg(op.vmult, b, control, diag=mg.vcycle)
        else:
            x, info = solve_cg_merged(op.vmult, b, control)
        eta = estimate_gradient_recovery(space, op, x)
        history.append(
            {
                "space": space,
                "x": x,
                "n_dofs": space.n_dofs,
                "n_cells": mesh.n_cells,
                "eta": float(np.sqrt((eta**2).sum())),
                "eta_cells": eta,
                "n_iterations": int(info["n_iterations"]),
            }
        )
        if step < n_steps:
            mesh = mesh.refine_active(mark_doerfler(eta, theta))
    return history
