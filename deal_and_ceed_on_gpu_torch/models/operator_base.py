"""Matrix-free operator base: the cell-loop pipeline.

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/operator_base.py`` and of
the reference's operator wrappers (``PoissonOperator::vmult``,
``bp5/step-64.cu:263-276``): the apply is

    mask constrained src -> gather -> evaluate -> quad-point op
        -> integrate -> scatter-add -> Dirichlet identity rows

Subclasses provide the quad-point operation (the
``apply_quad_point_operations`` hook, ``bp5/fe_evaluation_gl.h:373-393``).

Backends:
- ``structured``: index-free axis-separable gather/scatter, interleaved
  local layout ``[mz, p1, my, p1, mx, p1]``.
- ``gather``: the explicit ``local_to_global`` table (``FESpace.elem_dof_map``):
  an indexed gather, the same torch cell loop on the batched layout ``[E, p1,
  p1, p1]``, and the deterministic sorted scatter (``FESpace.scatter_plan``,
  ``ops/local_global.py``); the path of adaptive meshes, on a brick.
- ``separable``: the Kronecker form of ``ops/separable.py`` (subclasses fill
  ``_sep_terms``).
- ``stencil``: K1 (``ops/stencil.py``), set up by ``PoissonOperator`` and
  ``HelmholtzOperator`` (with K1's value term); one ``vmult`` is one K1
  launch, and ``fused_cg_step`` gives K5 (``ops/cg.py``) on its tables.
- ``qgrid``: K3 (``ops/qgrid.py``), set up by ``PoissonOperator``,
  ``HelmholtzOperator`` and ``MassOperator``; one ``vmult`` is one
  constrained K3 apply.
- ``banded``: K2 (``ops/banded.py``), set up by ``PoissonOperator`` and
  ``MassOperator`` on uniform or graded bricks; its tables carry the
  Dirichlet mask, and one ``vmult`` is one K2 launch (identity faces
  written in the kernel).
- ``general``: K4 (``ops/general.py``) between the element-major gather
  and the overlap-add scatter, set up by ``PoissonOperator``,
  ``HelmholtzOperator`` and ``MassOperator``: any rule, any geometry
  (uniform, graded, mapped); the JAX ``pallas_general`` backend.

``stream_dtype``: the dtype of the vectors ``vmult`` takes and returns
(bfloat16 halves their bytes); the apply computes at the space's dtype.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..basis import Basis1D, basis_tables_3d
from ..fe_space import FESpace
from ..geometry import Geometry
from ..ops import local_global as lg
from ..ops import sum_factorization as sf
from ..utils.profiling import span

__all__ = ["MatrixFreeOperator", "assemble_dense", "assemble_rhs", "l2_norm_function", "tensor_product_diagonal"]

_LAYOUT_AXES = {
    "structured": (1, 3, 5),
    "gather": (1, 2, 3),
    "separable": None,
    "stencil": None,
    "qgrid": None,
    "banded": None,
    "general": None,
}


class MatrixFreeOperator:
    needs_values: bool = False
    needs_gradients: bool = False
    # why the distributed layer (parallel/dist_operator.py) cannot take this
    # operator and backend, or None
    _dist_unsupported: str | None = None

    def __init__(
        self,
        space: FESpace,
        backend: str = "structured",
        stream_dtype: torch.dtype | None = None,
    ):
        if backend == "pallas_general":
            raise ValueError("backend 'pallas_general' is the JAX package's name for K4; the port's is 'general'")
        if backend not in _LAYOUT_AXES:
            raise ValueError(f"unknown backend {backend!r}")
        self.space = space
        self.backend = backend
        self.axes = _LAYOUT_AXES[backend]
        self.stream_dtype = space.dtype if stream_dtype is None else stream_dtype
        # separable backend: subclasses that support it fill _sep_terms
        self._sep_terms = None
        self.sep_mode = "matmul"
        # accumulated fold_scale factor; compute_diagonal applies it so a
        # Jacobi preconditioner built after fold_scale matches the operator
        self._fold_factor = 1.0
        # qgrid backend: subclasses that support it fill _qgrid (K3 tables)
        self._qgrid = None
        # stencil backend: subclasses that support it fill _stencil (K1
        # tables); the fused CG step built on them is cached
        self._stencil = None
        self._fused_cg_step = None
        # banded backend: subclasses that support it fill _banded (K2 tables)
        self._banded = None
        # general backend: subclasses that support it fill _general (K4 and
        # its gather/scatter, ops/general.build_general_operator)
        self._general = None

    # -------------------------- subclass hook ------------------------- #
    def quad_point_op(self, vals, grads):
        """Map (values, reference-cell gradients) at quadrature points to the
        integrands to be tested against (phi_i, grad phi_i)."""
        raise NotImplementedError

    # ------------------------- layout helpers ------------------------- #
    def w3d_layout(self) -> np.ndarray:
        """Tensorized quadrature weights, broadcastable in the local layout."""
        w = self.space.geometry.w3d  # [qz,qy,qx]
        q = w.shape[0]
        if self.backend == "gather":
            return w.reshape(1, q, q, q)
        return w.reshape(1, q, 1, q, 1, q)

    def jxw_layout(self) -> np.ndarray:
        """JxW in the structured local layout: a tiny broadcastable array on
        uniform meshes, per-element tensor factors on graded ones, the full
        per-q-point table on mapped ones."""
        geo = self.space.geometry
        w3 = self.w3d_layout()
        if geo.uniform:
            return geo.det_j * w3
        if geo.mapped:
            return self.to_layout(geo.jxw_full())
        if self.backend == "gather":
            return geo.det_per_cell().reshape(-1, 1, 1, 1) * w3
        hx, hy, hz = self.space.mesh.h_axes()
        mx, my, mz = self.space.mesh.n_elements
        det = (
            hz.reshape(mz, 1, 1, 1, 1, 1)
            * hy.reshape(1, 1, my, 1, 1, 1)
            * hx.reshape(1, 1, 1, 1, mx, 1)
        )
        return det * w3

    def to_layout(self, per_cell_q: np.ndarray) -> np.ndarray:
        """Reshape a host array ``[n_cells, n_q(, c)]`` (cell order (ez,ey,ex),
        qpoint order (qz,qy,qx)) into the backend's local layout."""
        mx, my, mz = self.space.mesh.n_elements
        q = self.space.basis.n_q
        trailing = per_cell_q.shape[2:]
        if self.backend == "gather":
            return per_cell_q.reshape((mx * my * mz, q, q, q) + trailing)
        a = per_cell_q.reshape((mz, my, mx, q, q, q) + trailing)
        return np.moveaxis(a, (3, 4, 5), (1, 3, 5))  # [mz,q,my,q,mx,q,...]

    # ----------------------------- apply ------------------------------ #
    def gather(self, u_flat: torch.Tensor) -> torch.Tensor:
        s = self.space
        if self.backend == "gather":
            return lg.gather_indexed(u_flat, s.elem_dof_map, s.degree)
        return lg.gather_structured(u_flat.reshape(s.grid_shape), s.mesh.n_elements, s.degree)

    def scatter(self, v_local: torch.Tensor) -> torch.Tensor:
        s = self.space
        if self.backend == "gather":
            return lg.scatter_indexed_sorted(v_local, s.scatter_plan, s.n_dofs)
        return lg.scatter_structured(v_local, s.degree).reshape(-1)

    def apply_cell_loop(self, u_flat: torch.Tensor) -> torch.Tensor:
        """The raw cell loop (no constraint handling): reference L-2. K2
        has no raw mode (its tables carry the Dirichlet mask): on the
        ``banded`` backend this is its constrained apply."""
        s = self.space
        if self.backend == "banded":
            return self.kernel_apply(u_flat.reshape(s.grid_shape)).reshape(-1)
        if self.backend == "general":
            return self._general(u_flat)
        if self.backend == "qgrid":
            from ..ops.qgrid import qgrid_apply

            return qgrid_apply(u_flat.reshape(s.grid_shape), self._qgrid).reshape(-1)
        if self.backend == "separable":
            from ..ops.separable import apply_separable

            if self._sep_terms is None:
                raise NotImplementedError(f"{type(self).__name__} has no separable form")
            u = u_flat.reshape(s.grid_shape)
            return apply_separable(u, self._sep_terms, self.sep_mode).reshape(-1)
        ul = self.gather(u_flat)
        vals, grads = sf.evaluate(
            ul, s.S, s.D, self.axes, self.needs_values, self.needs_gradients,
            s.basis.collocation,
        )
        vals, grads = self.quad_point_op(vals, grads)
        vl = sf.integrate(vals, grads, s.S, s.D, self.axes, s.basis.collocation)
        return self.scatter(vl)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """dst = A src with Dirichlet rows acting as identity
        (``bp5/step-64.cu:263-276``); returns a fresh ``stream_dtype`` dst.
        The call is the span ``op.vmult`` (``utils/profiling``)."""
        s = self.space
        with span("op.vmult"):
            if self.backend in ("stencil", "banded"):
                # K1 / K2 mask the constrained rows and write the identity rows
                return self.kernel_apply(src.to(self.stream_dtype).reshape(s.grid_shape)).reshape(-1)
            src = src.to(s.dtype)
            if self.backend == "qgrid":
                from ..ops.qgrid import qgrid_apply

                # K3's constrained mode: M A M and the identity rows in one launch
                out = qgrid_apply(src.reshape(s.grid_shape), self._qgrid, constrained=True)
                return out.reshape(-1).to(self.stream_dtype)
            dst = self.apply_cell_loop(s.zero_constrained_values(src))
            return s.copy_constrained_values(src, dst).to(self.stream_dtype)

    def kernel_apply(self, u: torch.Tensor) -> torch.Tensor:
        """One launch of the ``stencil`` (K1) or ``banded`` (K2) kernel on a
        ``[nz, ny, nx]`` grid or a ``[nc, nz, ny, nx]`` stack of components
        at the stream dtype: the constrained apply, identity faces included."""
        if self.backend == "stencil":
            from ..ops.stencil import stencil_apply

            return stencil_apply(u, self._stencil)
        if self.backend == "banded":
            from ..ops.banded import banded_apply

            return banded_apply(u, self._banded)
        raise NotImplementedError(f"{type(self).__name__} ({self.backend}) has no stencil or banded kernel")

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        return self.vmult(src)

    def fold_scale(self, s: float) -> None:
        """Rescale the operator in place: ``A <- s * A`` on unconstrained
        rows (identity rows unaffected). The chained-vmult benchmark folds
        its ``1/lambda_est`` normalization into the coefficient tables so
        each step is one pure apply (``bp5/step-64.cu:519-548`` pays no
        rescaling pass either)."""
        self._apply_fold_scale(s)
        self._fold_factor *= s

    def _apply_fold_scale(self, s: float) -> None:
        """Subclass hook: rescale the coefficient tables by ``s``."""
        if self._stencil is not None:
            # scales the device tables K1 and K5 read, in place; the fused
            # step is rebuilt on next use, as the JAX operators do
            self._stencil.scale_(s)
            self._fused_cg_step = None
            return
        if self._qgrid is not None:
            self._qgrid.fold_scale(s)
            return
        if self._banded is not None:
            self._banded.scale_(s)  # the x tables K2 reads, in place
            return
        if self._general is not None:
            self._general.fold_scale(s)  # the coefficients K4 reads, in place
            return
        if self._sep_terms is not None:
            for t in self._sep_terms:
                t["coef"] = t["coef"] * s
            return
        raise NotImplementedError(f"{type(self).__name__} ({self.backend}) has no fold_scale")

    @property
    def fused_cg_step(self):
        """K5, the fused CG iteration (``ops/cg.py``) on this operator's K1
        tables, value term included; cached until the next ``fold_scale``.
        Stencil backend only."""
        if self._stencil is None:
            raise NotImplementedError(
                f"{type(self).__name__} ({self.backend}): the fused CG kernel "
                "requires the stencil backend"
            )
        if self._fused_cg_step is None:
            from ..ops.cg import CGFusedStep

            self._fused_cg_step = CGFusedStep(self._stencil)
        return self._fused_cg_step

    def diagonal(self) -> torch.Tensor:
        """Preconditioner diagonal slot (reference L-12 ``DiagonalMatrix``).
        Both reference drivers fill it with 1.0 (``bp5/step-64.cu:428-432``)."""
        s = self.space
        return torch.ones((s.n_dofs,), dtype=s.dtype, device=s.device)

    def compute_diagonal(self) -> torch.Tensor:
        """Exact diagonal of the constrained operator (1.0 on Dirichlet
        rows), consistent with any accumulated :meth:`fold_scale` factor.
        Subclasses implement :meth:`_compute_diagonal`."""
        d = self._compute_diagonal()
        if self._fold_factor != 1.0:
            # fold_scale rescales unconstrained rows only
            d = torch.where(self.space.dirichlet_mask, d, self._fold_factor * d)
        return d

    def _compute_diagonal(self) -> torch.Tensor:
        raise NotImplementedError

    def weak_form(self):
        """``(gradient, value_q, value_const)`` describing the bilinear form,
        the parametrization :func:`tensor_product_diagonal` takes; drives the
        host-side dense assembly (:func:`assemble_dense`, the multigrid
        coarse solve). Operators without one raise ``NotImplementedError``."""
        raise NotImplementedError(f"{type(self).__name__} has no weak_form")

    # --------------------- distributed-table hooks -------------------- #
    def shard_table_names(self) -> tuple[str, ...]:
        """Names of the coefficient-table attributes that depend on the
        element block's physical position (empty for position-invariant
        operators such as uniform-mesh Poisson and mass). The distributed
        layer builds them on the global mesh, pads them over the dead
        elements and slices each rank's block (``parallel/dist_operator``;
        JAX ``operator_base.py:298-306``)."""
        return ()

    def bind_shard_tables(self, tables: dict) -> "MatrixFreeOperator":
        """A shallow copy with the given table attributes replaced."""
        import copy

        new = copy.copy(self)
        for name, value in tables.items():
            setattr(new, name, value)
        return new

    def jacobi_preconditioner(self) -> torch.Tensor:
        """1/diag(A) with identity on constrained rows, for the ``diag``
        slot of the CG solvers."""
        return 1.0 / self.compute_diagonal()


def tensor_product_diagonal(
    space: FESpace,
    gradient: bool = False,
    value_q: np.ndarray | None = None,
    value_const: float | None = None,
) -> torch.Tensor:
    """diag(A) on a uniform or graded brick (copy of the JAX package's
    brick path): the per-element local diagonal separates into 1D
    quadrature sums ``m1_a = sum_q w_q S[q,a]^2``, ``k1_a = sum_q w_q
    D[q,a]^2`` weighted by the per-element merged coefficient; a constant
    value coefficient ``value_const`` (the mass operator: 1) adds ``c det_e
    m1 (x) m1 (x) m1``, a varying one ``value_q [n_cells, n_q]`` is
    contracted axis by axis. Host numpy, one scatter-add, Dirichlet rows
    pinned to 1. A mapped mesh takes the general path of
    :func:`_general_local_diagonal` (the dense basis tables and the six
    merged-coefficient planes)."""
    basis, geo = space.basis, space.geometry
    if geo.mapped:
        return _scatter_local_diagonal(space, _general_local_diagonal(space, gradient, value_q, value_const))
    S2, D2, w = basis.S**2, basis.D**2, basis.q_weights
    m1 = np.einsum("q,qa->a", w, S2)
    k1 = np.einsum("q,qa->a", w, D2)
    p1 = basis.n_dofs
    n_cells = space.mesh.n_cells
    local_e = np.zeros((n_cells, p1, p1, p1))
    if gradient:
        md = geo.merged_diag_per_cell()  # [E, 3] in (x, y, z) order
        local_e += md[:, 0, None, None, None] * np.einsum("k,j,i->kji", m1, m1, k1)
        local_e += md[:, 1, None, None, None] * np.einsum("k,j,i->kji", m1, k1, m1)
        local_e += md[:, 2, None, None, None] * np.einsum("k,j,i->kji", k1, m1, m1)
    det_e = geo.det_per_cell()[:, None, None, None]
    if value_const is not None:
        local_e += value_const * det_e * np.einsum("k,j,i->kji", m1, m1, m1)
    if value_q is not None:
        q = basis.n_q
        aq = value_q.reshape(n_cells, q, q, q)
        t = np.einsum("ezyx,xi->ezyi", aq, w[:, None] * S2, optimize=True)
        t = np.einsum("ezyi,yj->ezji", t, w[:, None] * S2, optimize=True)
        local_e = local_e + det_e * np.einsum("ezji,zk->ekji", t, w[:, None] * S2, optimize=True)
    return _scatter_local_diagonal(space, local_e)


def _scatter_local_diagonal(space: FESpace, local_e: np.ndarray) -> torch.Tensor:
    """Scatter-add per-element local diagonals and pin the Dirichlet rows."""
    diag = np.zeros(space.n_dofs)
    np.add.at(diag, space.mesh.element_dof_map(space.degree).reshape(-1), local_e.reshape(-1))
    diag[space.mesh.boundary_dof_mask(space.degree)] = 1.0
    return space.tensor(diag)


def _general_local_diagonal(
    space: FESpace,
    gradient: bool,
    value_q: np.ndarray | None,
    value_const: float | None,
) -> np.ndarray:
    """Per-element diagonal on general (mapped) geometry:
    ``diag_e[a] = sum_q grad phi_a(q)^T C_e(q) grad phi_a(q) + value terms``
    with the six merged-coefficient planes, as one product ``[E, 6 n_q] x
    [6 n_q, n_local]``."""
    geo = space.geometry
    V, G = basis_tables_3d(space.basis)
    n_cells = space.mesh.n_cells
    local_e = np.zeros((n_cells, V.shape[0]))
    if gradient:
        C = geo.merged_coef_full()  # [E, n_q, 6]
        n_q = C.shape[1]
        T = np.empty((n_q, 6, V.shape[0]))
        for plane, (r, s) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
            T[:, plane, :] = (1.0 if r == s else 2.0) * (G[r] * G[s]).T
        local_e += C.reshape(n_cells, n_q * 6) @ T.reshape(n_q * 6, -1)
    if value_const is not None or value_q is not None:
        jxw = geo.jxw_full()  # [E, n_q]
        if value_q is not None:
            jxw = jxw * value_q.reshape(n_cells, -1)
        elif value_const != 1.0:
            jxw = jxw * value_const
        local_e += np.einsum("aq,aq,eq->ea", V, V, jxw, optimize=True)
    return local_e


def assemble_dense(op: MatrixFreeOperator, max_dofs: int = 20000) -> np.ndarray:
    """Dense matrix of the constrained operator (``vmult`` semantics: zero
    constrained source columns, cell loop, Dirichlet identity rows),
    assembled on the host from the geometry tables and the operator's
    :meth:`~MatrixFreeOperator.weak_form`: one batched host product per
    coefficient plane, then one scatter-add (copy of the JAX package's
    ``assemble_dense``). Brick meshes only (no hanging-node constraints);
    guarded by ``max_dofs``, since it is meant for coarse solves."""
    space = op.space
    if space.n_dofs > max_dofs:
        raise ValueError(
            f"assemble_dense: {space.n_dofs} DoFs > max_dofs={max_dofs} "
            "(dense assembly is for coarse solves)"
        )
    gradient, value_q, value_const = op.weak_form()
    geo = space.geometry
    V, G = basis_tables_3d(space.basis)  # V [nl, n_q], G [3, nl, n_q]
    n_local = V.shape[0]
    n_cells = space.mesh.n_cells
    K = np.zeros((n_cells, n_local, n_local))
    if gradient:
        C = geo.merged_coef_full()  # [E, n_q, 6], JxW-weighted
        planes = [(0, 0, 0), (1, 0, 1), (2, 0, 2), (3, 1, 1), (4, 1, 2), (5, 2, 2)]
        for plane, r, s in planes:
            # K_e[a,b] += sum_q C[e,q] G_r[a,q] G_s[b,q]  (+ sym for r!=s)
            K += (C[:, None, :, plane] * G[r][None]) @ G[s].T
            if r != s:
                K += (C[:, None, :, plane] * G[s][None]) @ G[r].T
    if value_const is not None or value_q is not None:
        jxw = geo.jxw_full()  # [E, n_q]
        if value_q is not None:
            jxw = jxw * np.asarray(value_q, dtype=np.float64).reshape(n_cells, -1)
        elif value_const != 1.0:
            jxw = jxw * value_const
        K += (jxw[:, None, :] * V[None]) @ V.T

    dof_map = space.mesh.element_dof_map(space.degree)  # [E, nl]
    n = space.n_dofs
    A = np.zeros((n, n))
    rows = np.repeat(dof_map, n_local, axis=1).reshape(-1)
    cols = np.tile(dof_map, (1, n_local)).reshape(-1)
    np.add.at(A, (rows, cols), K.reshape(-1))
    mask = space.mesh.boundary_dof_mask(space.degree)
    if op._fold_factor != 1.0:
        A[~mask, :] *= op._fold_factor
    A[mask, :] = 0.0
    A[:, mask] = 0.0
    A[mask, mask] = 1.0
    return A


# --------------------------------------------------------------------- #
# RHS assembly and validation norms (reference L-17 / L-18)
# --------------------------------------------------------------------- #
def assemble_rhs(
    space: FESpace,
    f: float | Callable[[np.ndarray], np.ndarray] = 1.0,
    backend: str = "structured",
) -> torch.Tensor:
    """Assemble the load vector b_i = integral(f * phi_i), zeroing constrained
    rows, with the structured cell loop's integrate/scatter (the reference
    runs a host FEValues loop, ``bp5/step-64.cu:372-418``). ``backend`` is
    the operator's; the other backends are vmult-only, and assembly, a
    one-time set-up cost, always runs through the structured loop."""
    if backend not in _LAYOUT_AXES:
        raise ValueError(f"unknown backend {backend!r}")
    op = MatrixFreeOperator(space, "structured")
    geo = space.geometry
    if callable(f):
        xq = geo.q_points_phys()  # [n_cells, n_q, 3]
        f_q = np.asarray(f(xq), dtype=np.float64).reshape(space.mesh.n_cells, geo.n_q)
        integrand = space.tensor(op.to_layout(f_q * geo.jxw_full()))
    else:
        q = space.basis.n_q
        mx, my, mz = space.mesh.n_elements
        integrand = space.tensor(float(f) * op.jxw_layout()).expand(mz, q, my, q, mx, q)
    vl = sf.integrate(integrand, None, space.S, space.D, op.axes, space.basis.collocation)
    return space.zero_constrained_values(op.scatter(vl))


def l2_norm_function(space: FESpace, u_flat: torch.Tensor, n_q: int | None = None):
    """L2 norm of the FE function u_h, via quadrature with ``n_q`` (default
    p+2, matching the reference's ``QGauss(p+2)`` validation rule,
    ``bp5/step-64.cu:602-616``). Returns a 0-dim tensor."""
    p = space.degree
    vb = Basis1D.make(p, p + 2 if n_q is None else n_q, "gauss")
    op = MatrixFreeOperator(space, "structured")
    ul = op.gather(u_flat)
    vals, _ = sf.evaluate(ul, space.tensor(vb.S), space.tensor(vb.D), op.axes, True, False, False)
    w = vb.q_weights
    q = w.shape[0]
    w3d = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(1, q, 1, q, 1, q)
    mx, my, mz = space.mesh.n_elements
    if space.mesh.is_mapped:
        # per-q-point det(J) at the validation rule's points
        det_q = Geometry.from_mesh(space.mesh, vb).det_q_full()
        det = np.moveaxis(det_q.reshape(mz, my, mx, q, q, q), (3, 4, 5), (1, 3, 5))
    else:
        hx, hy, hz = space.mesh.h_axes()
        det = (
            hz.reshape(mz, 1, 1, 1, 1, 1)
            * hy.reshape(1, 1, my, 1, 1, 1)
            * hx.reshape(1, 1, 1, 1, mx, 1)
        )
    return torch.sqrt(torch.sum(vals * vals * space.tensor(det * w3d)))
