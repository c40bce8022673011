"""FEEvaluation: the element-evaluator API.

Counterpart of ``deal_and_ceed_on_gpu_tpu/fe_evaluation.py``, of
``CUDAWrappers::FEEvaluation`` and of the in-repo ``FEEvaluationGL``
(``bp5/fe_evaluation_gl.h:26-393``, component C6): the seven-step per-cell
protocol

    read_dof_values -> evaluate -> get_value/get_gradient
        -> submit_value/submit_gradient (x JxW / J^{-1})
        -> integrate -> distribute_local_to_global

batched over all cells at once and functional: each step returns new
tensors instead of mutating shared memory. Plain torch on
``ops/sum_factorization.py`` and the ``structured`` or ``gather`` transfer
of ``ops/local_global.py``; a convenience/parity layer for writing custom
operators the way the reference's ``LocalPoissonOperator`` functors are
written (the production operators in ``models/`` fuse these steps, and no
solve runs this module).

Example (the step-64 Helmholtz cell kernel, cf. step-64/step-64.cu:200-219)::

    fe = FEEvaluation(space)
    vals, grads = fe.evaluate(fe.read_dof_values(src), values=True, gradients=True)
    vals = fe.submit_value(a_q * vals)           # x JxW
    grads = fe.submit_gradient(grads)            # x JxW J^{-1} J^{-T}
    dst = fe.distribute_local_to_global(fe.integrate(vals, grads))
"""

from __future__ import annotations

import torch

from .fe_space import FESpace
from .models.operator_base import MatrixFreeOperator
from .ops import sum_factorization as sf

__all__ = ["FEEvaluation"]


class FEEvaluation:
    """Batched element evaluator over all cells of a space.

    backend: ``structured`` (interleaved local layout) or ``gather``
    (``[n_cells, p+1, p+1, p+1]``), matching the reference's
    ``read_dof_values`` gather semantics (``bp5/fe_evaluation_gl.h:135-152``).
    """

    def __init__(self, space: FESpace, backend: str = "structured"):
        if backend not in ("structured", "gather"):
            raise ValueError(f"FEEvaluation backend {backend!r}: structured or gather")
        self.space = space
        self._h = MatrixFreeOperator(space, backend)
        geo = space.geometry
        self._jxw = space.tensor(self._h.jxw_layout())
        if geo.mapped:
            # full 6-plane merged coefficient (general geometry)
            self._coef6 = space.tensor(self._h.to_layout(geo.merged_coef_full()))
            self._cdiag = None
        else:
            md = geo.merged_diag_per_cell()  # [E, 3]
            w3 = self._h.w3d_layout()
            self._cdiag = tuple(
                space.tensor(self._h.to_layout(md[:, d : d + 1].repeat(geo.n_q, axis=1)) * w3) for d in range(3)
            )
            self._coef6 = None
        self._jinv_t = None  # lazy J^{-T} layout tables for get_gradient

    # ------------------------------------------------------------------ #
    def read_dof_values(self, src: torch.Tensor) -> torch.Tensor:
        """Gather global -> element-local (``bp5/fe_evaluation_gl.h:135``)."""
        return self._h.gather(src)

    def evaluate(self, u_local, values: bool = False, gradients: bool = False):
        """Sum-factorized interpolation to quadrature points
        (``bp5/fe_evaluation_gl.h:192-219``). Gradients are reference-cell."""
        s = self.space
        return sf.evaluate(u_local, s.S, s.D, self._h.axes, values, gradients, s.basis.collocation)

    def get_value(self, vals):
        return vals

    def get_gradient(self, grads):
        """Physical-space gradients: J^{-T} times the reference-cell
        gradients (``bp5/fe_evaluation_gl.h:328-344``). The production
        operators never materialize these (the J factors are folded into
        submit_gradient's merged coefficient); this is for user functors
        that need physical gradients, e.g. nonlinear coefficients."""
        gx, gy, gz = grads
        geo = self.space.geometry
        if geo.uniform:
            hx, hy, hz = geo.h
            return (gx / hx, gy / hy, gz / hz)
        if self._jinv_t is None:
            jinv = geo.inv_jacobian_full()  # [E, n_q, 3, 3]
            self._jinv_t = tuple(
                tuple(self.space.tensor(self._h.to_layout(jinv[:, :, e, d])) for e in range(3)) for d in range(3)
            )
        # phys_d = sum_e Jinv[e, d] * g_e  (J^{-T} contraction)
        return tuple(c[0] * gx + c[1] * gy + c[2] * gz for c in self._jinv_t)

    def submit_value(self, vals):
        """Multiply by JxW (``bp5/fe_evaluation_gl.h:347-352``)."""
        return vals * self._jxw

    def submit_gradient(self, grads):
        """Multiply by JxW * J^{-1} J^{-T} (merged coefficient; the
        reference's submit_gradient applies J^{-T} and JxW,
        ``bp5/fe_evaluation_gl.h:355-369``). Full symmetric contraction on
        mapped meshes (``bp5/step-64.cu:164-188``)."""
        gx, gy, gz = grads
        if self._coef6 is not None:
            c = self._coef6
            return (
                c[..., 0] * gx + c[..., 1] * gy + c[..., 2] * gz,
                c[..., 1] * gx + c[..., 3] * gy + c[..., 4] * gz,
                c[..., 2] * gx + c[..., 4] * gy + c[..., 5] * gz,
            )
        cx, cy, cz = self._cdiag
        return (gx * cx, gy * cy, gz * cz)

    def apply_quad_point_operations(self, fn, vals=None, grads=None):
        """Run a user quad-point functor (``bp5/fe_evaluation_gl.h:373-393``)."""
        return fn(vals, grads)

    def integrate(self, vals=None, grads=None) -> torch.Tensor:
        """Transpose interpolation back to nodal coefficients
        (``bp5/fe_evaluation_gl.h:222-250``)."""
        s = self.space
        return sf.integrate(vals, grads, s.S, s.D, self._h.axes, s.basis.collocation)

    def distribute_local_to_global(self, v_local: torch.Tensor) -> torch.Tensor:
        """Scatter-add element-local -> global, deterministic (the dense
        overlap-add or the sorted plan; no atomics), the port's answer to
        the reference's atomicAdd-vs-colouring choice
        (``bp5/fe_evaluation_gl.h:162-181``)."""
        return self._h.scatter(v_local)
