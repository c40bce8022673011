"""step-64 Helmholtz operator: dst = (-laplace + a(x)) src.

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/helmholtz.py`` and of the
reference's ``HelmholtzOperator`` + ``LocalHelmholtzOperator``
(``step-64/step-64.cu:131-311``): evaluate values and gradients, submit
``a(x) u JxW`` and ``JxW J^{-1} J^{-T} grad u``, integrate both. The
coefficient ``a(x) = 10 / (0.05 + 2|x|^2)`` (``step-64/step-64.cu:96-118``)
is evaluated once at set-up over the physical quadrature points. Backends:

- ``structured`` / ``gather``: the torch cell loop with values and
  gradients, any mesh (the six-plane merged coefficient on graded and mapped
  ones; the plain comparator on the card), on the structured or the indexed
  transfer;
- ``separable``: GLL collocation on a uniform or graded brick: the Poisson
  Kronecker terms plus the assembled ``a JxW`` diagonal;
- ``qgrid``: K3 (``ops/qgrid.py``) with the weightless grad ``const`` /
  ``diag3`` / ``full6`` of the mesh and the ``a(x_q) det`` value table, any
  Gauss-type rule: the reference's native step-64 configuration (Q3, Gauss
  q = 4) and its graded and mapped variants;
- ``general``: K4 (``ops/general.py``) with the JxW-weighted grad ``const``
  / ``diag3`` / ``full6`` and the ``a(x_q) JxW`` value table, any rule and
  geometry: the JAX ``pallas_general`` backend;
- ``stencil``: K1 with its value term (``ops/stencil.py``), GLL collocation
  on a uniform brick: the JAX ``pallas`` backend. Quadrature points are the
  nodes, so the assembled value diagonal is ``d3 a = S diag(a) S`` with the
  nodal ``a(x) hx hy hz`` (K1's ``S`` holds the unit-cell weights); its
  ``fused_cg_step`` is K5 with the value term.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator, tensor_product_diagonal
from .poisson import full_contraction, grad_spec

__all__ = ["HelmholtzOperator", "default_coefficient"]


def default_coefficient(x: np.ndarray) -> np.ndarray:
    """a(x) = 10 / (0.05 + 2 |x|^2)  (step-64/step-64.cu:96-118)."""
    return 10.0 / (0.05 + 2.0 * np.sum(x * x, axis=-1))


class HelmholtzOperator(MatrixFreeOperator):
    needs_values = True
    needs_gradients = True

    def __init__(
        self,
        space: FESpace,
        backend: str = "structured",
        coefficient_fn: Callable[[np.ndarray], np.ndarray] = default_coefficient,
        stream_dtype: torch.dtype | None = None,
    ):
        super().__init__(space, backend, stream_dtype)
        geo = space.geometry
        a_q = np.asarray(coefficient_fn(geo.q_points_phys()), dtype=np.float64)
        self._a_q_raw = a_q  # [n_cells, n_q], kept for compute_diagonal
        if backend == "stencil":
            from ..ops.stencil import StencilTables

            if not space.basis.collocation:
                raise ValueError(
                    "stencil Helmholtz requires GLL collocation (the value term is "
                    "pointwise only when the nodes are the quadrature points)"
                )
            hx, hy, hz = space.mesh.h
            x_nodes = space.node_coords().reshape(space.grid_shape + (3,))
            a_nodes = np.asarray(coefficient_fn(x_nodes), dtype=np.float64) * (hx * hy * hz)
            self._stencil = StencilTables.create(
                space.mesh, space.basis, space.dtype, space.device, value=a_nodes
            )
            return
        if backend == "separable":
            # the varying-coefficient mass term is a global diagonal when the
            # quadrature points are the nodes
            if not space.basis.collocation:
                raise ValueError(
                    "separable Helmholtz requires GLL collocation (the Gauss-rule "
                    "mass term with varying a(x) is not separable)"
                )
            from ..ops.separable import poisson_terms

            dvec = np.zeros(space.n_dofs)
            np.add.at(dvec, space.mesh.element_dof_map(space.degree).reshape(-1), (a_q * geo.jxw_full()).reshape(-1))
            self._sep_terms = poisson_terms(space.mesh, space.basis, space.dtype, space.device) + [
                {"coef": 1.0, "band": [], "diag": space.tensor(dvec.reshape(space.grid_shape))}
            ]
            return
        if backend == "qgrid":
            from ..ops.qgrid import QGridTables

            self._qgrid = QGridTables.create(
                space.mesh, space.basis, space.dtype,
                grad=grad_spec(geo, weighted=False), val=("table", a_q * geo.det_q_full()),
                device=space.device,
            )
            return
        if backend == "general":
            from ..ops.general import build_general_operator

            self._general = build_general_operator(
                space, grad=grad_spec(geo, weighted=True), val=("table", a_q * geo.jxw_full())
            )
            return
        # structured: fold JxW into the value coefficient, a(x_q) * JxW(e, q)
        self._coef_val = space.tensor(self.to_layout(a_q * geo.jxw_full()))
        if geo.uniform:
            self._cdiag = geo.const_merged_diag
            self._w3d = space.tensor(self.w3d_layout())
            self._coef_g = None
        else:
            self._coef_g = space.tensor(self.to_layout(geo.merged_coef_full()))  # [..., 6]

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend in ("structured", "gather"):
            self._coef_val = self._coef_val * s
            if self._coef_g is None:
                self._cdiag = tuple(c * s for c in self._cdiag)
            else:
                self._coef_g = self._coef_g * s
            return
        super()._apply_fold_scale(s)

    def _compute_diagonal(self):
        return tensor_product_diagonal(self.space, gradient=True, value_q=self._a_q_raw)

    def weak_form(self):
        """``(gradient, value_q, value_const)``, as
        :func:`tensor_product_diagonal` takes them."""
        return True, self._a_q_raw, None

    def quad_point_op(self, vals, grads):
        gx, gy, gz = grads
        if self._coef_g is None:
            cx, cy, cz = self._cdiag
            w = self._w3d
            flux = (gx * (cx * w), gy * (cy * w), gz * (cz * w))
        else:
            flux = full_contraction(self._coef_g, gx, gy, gz)
        return vals * self._coef_val, flux
