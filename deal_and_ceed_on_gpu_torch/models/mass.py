"""BP1 mass operator: dst = M src (values-only quad-point op).

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/mass.py``. CEED BP1 is
full Gauss quadrature q = p+2, the rectangular-interpolation path the
reference's collocation evaluator skips. Backends:

- ``structured`` / ``gather``: the torch cell loop, ``values * JxW`` at the
  quadrature points (uniform or graded bricks), on the structured or the
  indexed transfer;
- ``separable``: the Kronecker form ``Mz (x) My (x) Mx`` (``mass_terms``;
  diagonal at GLL collocation);
- ``banded``: K2, the hand-written CUDA kernel (``ops/banded.py``,
  ``kind="mass"``) on uniform or graded bricks, any rule; the JAX
  ``backend="pallas"``;
- ``qgrid``: K3 (``ops/qgrid.py``) with the value term only, ``("const",
  det_j)`` on a uniform brick and the ``det`` table on a graded or mapped
  one; the JAX ``backend="pallas_qgrid"``;
- ``general``: K4 (``ops/general.py``) with the value term only, ``("const",
  det_j)`` on a uniform brick and the JxW table otherwise; the JAX
  ``backend="pallas_general"``.
"""

from __future__ import annotations

import torch

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator, tensor_product_diagonal

__all__ = ["MassOperator"]


class MassOperator(MatrixFreeOperator):
    needs_values = True
    needs_gradients = False

    def __init__(
        self,
        space: FESpace,
        backend: str = "structured",
        stream_dtype: torch.dtype | None = None,
    ):
        super().__init__(space, backend, stream_dtype)
        geo = space.geometry
        if backend == "banded":
            from ..ops.banded import BandedTables

            self._banded = BandedTables.create(space.mesh, space.basis, space.dtype, space.device, kind="mass")
            return
        if backend == "qgrid":
            from ..ops.qgrid import QGridTables

            val = ("const", geo.det_j) if geo.uniform else ("table", geo.det_q_full())
            self._qgrid = QGridTables.create(space.mesh, space.basis, space.dtype, val=val, device=space.device)
            return
        if backend == "general":
            from ..ops.general import build_general_operator

            val = ("const", geo.det_j) if geo.uniform else ("table", geo.jxw_full())
            self._general = build_general_operator(space, val=val)
            return
        if backend == "separable":
            from ..ops.separable import mass_terms

            self._sep_terms = mass_terms(space.mesh, space.basis, space.dtype, space.device)
            return
        if backend not in ("structured", "gather"):
            raise ValueError(f"mass backend {backend!r}: use structured, gather, separable, banded, qgrid or general")
        self._jxw = space.tensor(self.jxw_layout())

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend in ("structured", "gather"):
            self._jxw = self._jxw * s
            return
        super()._apply_fold_scale(s)

    def quad_point_op(self, vals, grads):
        return vals * self._jxw, None

    def _compute_diagonal(self) -> torch.Tensor:
        return tensor_product_diagonal(self.space, value_const=1.0)

    def weak_form(self):
        return False, None, 1.0
