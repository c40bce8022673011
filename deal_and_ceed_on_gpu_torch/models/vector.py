"""Vector-valued operators: BP2/BP4/BP6 (3 components per node).

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/vector.py``. CEED's vector
bake-off problems apply the same scalar bilinear form to ``n_components``
independent solution components that share all metric terms. Unknowns are
``[n_components, n_dofs]`` tensors; the CG solvers take their dots over all
entries, so a ``[3, n]`` vector solves like a flat one.

On the kernel backends one ``vmult`` is one launch for all components, the
tables shared: K2 (``banded``, the counterpart of
``pallas_banded.StackedBandedOperator``) and K1 (``stencil``, of
``pallas_stencil.StackedStencilOperator``) take a leading component count.
On the other backends (``separable``, ``structured``, ``qgrid``) the
components are applied one after the other, a written-out loop where the
JAX package ``vmap``s.
"""

from __future__ import annotations

import torch

from .operator_base import MatrixFreeOperator

__all__ = ["VectorOperator"]


class VectorOperator:
    """Wrap a scalar ``MatrixFreeOperator`` into an ``n_components``
    operator on ``[n_components, n]`` tensors."""

    def __init__(self, scalar_op: MatrixFreeOperator, n_components: int = 3):
        self.scalar_op = scalar_op
        self.n_components = n_components
        self.space = scalar_op.space

    @property
    def backend(self) -> str:
        return self.scalar_op.backend

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """dst = A src per component, Dirichlet rows as identity; returns a
        fresh ``[n_components, n]`` tensor at the stream dtype."""
        nc, op, s = self.n_components, self.scalar_op, self.space
        if src.shape[0] != nc:
            raise ValueError(f"vector operator: src has {src.shape[0]} components, want {nc}")
        if op.backend in ("banded", "stencil"):
            return op.kernel_apply(src.to(op.stream_dtype).reshape(nc, *s.grid_shape)).reshape(nc, -1)
        return torch.stack([op.vmult(src[c]) for c in range(nc)])

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        return self.vmult(src)

    def fold_scale(self, s: float) -> None:
        """``A <- s A`` on every component: the tables are shared."""
        self.scalar_op.fold_scale(s)

    def diagonal(self) -> torch.Tensor:
        d = self.scalar_op.diagonal()
        return d.expand((self.n_components,) + d.shape)

    def jacobi_preconditioner(self) -> torch.Tensor:
        d = self.scalar_op.jacobi_preconditioner()
        return d.expand((self.n_components,) + d.shape)

    def initialize_dof_vector(self) -> torch.Tensor:
        s = self.space
        return torch.zeros((self.n_components, s.n_dofs), dtype=s.dtype, device=s.device)
