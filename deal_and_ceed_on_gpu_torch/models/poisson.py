"""BP5/BP3 Poisson operator: dst = stiffness(src) with merged coefficients.

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/poisson.py`` and of the
reference's ``LocalPoissonOperator`` + ``PoissonOperator``
(``bp5/step-64.cu:118-276``). Backends:

- ``structured``: the torch cell loop (``bp5/step-64.cu:160-188``), with
  the uniform brick's merged coefficient ``C(q) = w3d(q) * diag(c)`` (three
  scalars, ``coefficient = "merged_const"``) or, on graded and mapped
  meshes, the six-plane table ``merged_coef_full`` and the symmetric 3x3
  contraction (``"merged_full"``); the plain comparator on the card;
- ``gather``: the same cell loop on the indexed transfer
  (``FESpace.elem_dof_map`` and its sorted scatter plan): the JAX
  ``backend="gather"``;
- ``separable``: the Kronecker form (uniform or graded bricks);
- ``stencil``: K1, the hand-written CUDA kernel (``ops/stencil.py``) on a
  uniform brick with GLL collocation; the counterpart of the JAX
  ``backend="pallas"`` on a collocated basis;
- ``qgrid``: K3 (``ops/qgrid.py``), any Gauss-type rule (q = p+1, p+2), grad
  ``const`` on a uniform brick, ``diag3`` on a graded one, ``full6`` on a
  mapped one (weightless coefficients, ``merged_coef_full / w3d``); the JAX
  ``backend="pallas_qgrid"``;
- ``banded``: K2 (``ops/banded.py``, ``kind="stiffness"``), the seven-sweep
  banded Kronecker kernel on a uniform or graded brick, any rule (BP3/BP4:
  Gauss q = p+2); the JAX ``backend="pallas"`` on a non-collocated basis;
- ``general``: K4 (``ops/general.py``), any rule on any geometry, grad
  ``const`` / ``diag3`` / ``full6`` with JxW-weighted coefficients
  (``merged_coef_full``); the JAX ``backend="pallas_general"``.
"""

from __future__ import annotations

import torch

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator

__all__ = ["PoissonOperator", "grad_spec"]


def grad_spec(geo, weighted: bool):
    """The gradient term of a geometry as ``(mode, data)``: ``const`` on a
    uniform brick, ``diag3`` on a graded one, ``full6`` on a mapped one.
    ``weighted``: JxW-weighted tables (K4's convention) or weightless ones
    (divided by ``w3d``, K3's)."""
    if geo.uniform:
        return ("const", geo.const_merged_diag)
    coef = geo.merged_coef_full()
    if not weighted:
        coef = coef / geo.w3d.reshape(1, -1, 1)
    return ("full6", coef) if geo.mapped else ("diag3", coef[:, :, (0, 3, 5)])


class PoissonOperator(MatrixFreeOperator):
    needs_values = False
    needs_gradients = True

    def __init__(
        self,
        space: FESpace,
        backend: str = "structured",
        stream_dtype: torch.dtype | None = None,
    ):
        super().__init__(space, backend, stream_dtype)
        geo = space.geometry
        if backend == "qgrid":
            from ..ops.qgrid import QGridTables

            self._qgrid = QGridTables.create(
                space.mesh, space.basis, space.dtype, grad=grad_spec(geo, weighted=False), device=space.device
            )
            return
        if backend == "general":
            from ..ops.general import build_general_operator

            self._general = build_general_operator(space, grad=grad_spec(geo, weighted=True))
            return
        if backend == "banded":
            from ..ops.banded import BandedTables

            self._banded = BandedTables.create(space.mesh, space.basis, space.dtype, space.device)
            return
        if backend == "stencil":
            from ..ops.stencil import StencilTables

            self._stencil = StencilTables.create(
                space.mesh, space.basis, space.dtype, space.device
            )
            return
        if backend == "separable":
            from ..ops.separable import poisson_terms

            self._sep_terms = poisson_terms(
                space.mesh, space.basis, space.dtype, space.device
            )
            return
        if geo.uniform:
            self.coefficient = "merged_const"
            self._cdiag = geo.const_merged_diag
            self._w3d = space.tensor(self.w3d_layout())
        else:
            self.coefficient = "merged_full"
            self._coef = space.tensor(self.to_layout(geo.merged_coef_full()))  # [..., 6]

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend in ("structured", "gather"):
            if self.coefficient == "merged_const":
                self._cdiag = tuple(c * s for c in self._cdiag)
            else:
                self._coef = self._coef * s
            return
        super()._apply_fold_scale(s)

    def _compute_diagonal(self) -> torch.Tensor:
        from .operator_base import tensor_product_diagonal

        return tensor_product_diagonal(self.space, gradient=True)

    def weak_form(self):
        return True, None, None

    def quad_point_op(self, vals, grads):
        gx, gy, gz = grads
        if self.coefficient == "merged_const":
            cx, cy, cz = self._cdiag
            w = self._w3d
            return None, (gx * (cx * w), gy * (cy * w), gz * (cz * w))
        return None, full_contraction(self._coef, gx, gy, gz)


def full_contraction(c, gx, gy, gz):
    """The symmetric 3x3 contraction with six planes (xx, xy, xz, yy, yz, zz)
    in the last axis of ``c`` (``bp5/step-64.cu:164-188``)."""
    return (
        c[..., 0] * gx + c[..., 1] * gy + c[..., 2] * gz,
        c[..., 1] * gx + c[..., 3] * gy + c[..., 4] * gz,
        c[..., 2] * gx + c[..., 4] * gy + c[..., 5] * gz,
    )
