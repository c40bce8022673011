"""BP5/BP3 Poisson operator: dst = stiffness(src) with merged coefficients.

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/poisson.py`` and of the
reference's ``LocalPoissonOperator`` + ``PoissonOperator``
(``bp5/step-64.cu:118-276``). Backends:

- ``structured``: the cell loop with the uniform brick's merged coefficient
  ``C(q) = w3d(q) * diag(c)`` (three scalars), ``bp5/step-64.cu:160-188``;
- ``separable``: the Kronecker form (uniform or graded bricks);
- ``stencil``: K1, the hand-written CUDA kernel (``ops/stencil.py``) on a
  uniform brick with GLL collocation; the counterpart of the JAX
  ``backend="pallas"`` on a collocated basis;
- ``qgrid``: K3 (``ops/qgrid.py``), any Gauss-type rule (q = p+1, p+2) on
  a uniform brick, grad ``const``; the JAX ``backend="pallas_qgrid"``;
- ``banded``: K2 (``ops/banded.py``, ``kind="stiffness"``), the seven-sweep
  banded Kronecker kernel on a uniform or graded brick, any rule (BP3/BP4:
  Gauss q = p+2); the JAX ``backend="pallas"`` on a non-collocated basis.
"""

from __future__ import annotations

import torch

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator

__all__ = ["PoissonOperator"]


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
        if backend == "qgrid":
            from ..ops.qgrid import QGridTables

            geo = space.geometry
            if not geo.uniform:
                raise ValueError("qgrid Poisson: uniform bricks only (graded diag3 waits for mapped geometry)")
            self._qgrid = QGridTables.create(
                space.mesh, space.basis, space.dtype, grad=("const", geo.const_merged_diag), device=space.device
            )
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
        geo = space.geometry
        if not geo.uniform:
            raise ValueError(
                "structured backend: uniform bricks only (graded bricks: "
                "use the separable backend)"
            )
        self._cdiag = geo.const_merged_diag
        self._w3d = space.tensor(self.w3d_layout())

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend == "structured":
            self._cdiag = tuple(c * s for c in self._cdiag)
            return
        super()._apply_fold_scale(s)

    def _compute_diagonal(self) -> torch.Tensor:
        from .operator_base import tensor_product_diagonal

        return tensor_product_diagonal(self.space, gradient=True)

    def quad_point_op(self, vals, grads):
        gx, gy, gz = grads
        cx, cy, cz = self._cdiag
        w = self._w3d
        return None, (gx * (cx * w), gy * (cy * w), gz * (cz * w))
