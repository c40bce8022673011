"""Sum-factorized tensor-product evaluation/integration sweeps.

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/sum_factorization.py`` and of
deal.II's ``internal::EvaluatorTensorProduct`` (``gradient_at_quad_pts`` /
``value_at_quad_pts`` / ``integrate_value`` / ``integrate_gradient``; used at
``bp5/fe_evaluation_gl.h:192-250``): each sweep contracts one local tensor
axis of a batch of elements with a tiny 1D basis matrix, as one batched
``torch.tensordot``.

All functions are shape-polymorphic over leading batch axes: the three local
(z, y, x) axes can sit anywhere, identified by an ``axes`` tuple (the
structured layout is ``[mz, p1, my, p1, mx, p1]``).

Matrices follow the convention ``S[q, a]``, ``D[q, a]``: rows = quadrature
points, columns = nodal coefficients. ``evaluate`` contracts with the node
axis (forward), ``integrate`` contracts with the quadrature axis (transpose).

A float32 matrix product may run in TF32 on the card (about three decimal
digits, the GPU form of the TPU's bf16 matmul default), which is far too
coarse for an FEM operator apply. The JAX package passes ``precision=`` to
each contraction; the port scopes full float32 to its own products with
:func:`full_f32`, which ``sweep`` enters, and leaves the caller's global
settings as it found them.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

__all__ = ["full_f32", "sweep", "evaluate", "integrate"]


@contextlib.contextmanager
def full_f32():
    """Full-precision float32 products and convolutions (no TF32) inside the
    block; the caller's ``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32`` and float32 matmul precision are
    restored on exit, also on an exception."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def sweep(t: torch.Tensor, mat: torch.Tensor, axis: int, transpose: bool = False):
    """Contract ``axis`` of ``t`` with ``mat`` (``[q, a]``) in full float32
    or float64; the contracted axis is replaced in place (size a -> q, or
    q -> a when transpose)."""
    axis = axis % t.dim()
    with full_f32():
        out = torch.tensordot(t, mat, dims=([axis], [0 if transpose else 1]))
    return torch.movedim(out, -1, axis)


def evaluate(
    u: torch.Tensor,
    S: torch.Tensor,
    D: torch.Tensor,
    axes: Sequence[int],
    values: bool,
    gradients: bool,
    collocation: bool,
):
    """Element evaluation: nodal coefficients -> (values, reference-cell
    gradients) at quadrature points. Mirrors ``FEEvaluation::evaluate``
    (``bp5/fe_evaluation_gl.h:192-219``).

    axes = (az, ay, ax) positions of the local z/y/x axes in ``u``.
    Returns (vals | None, (gx, gy, gz) | None); metric terms are applied by
    the caller's quad-point operation (merged-coefficient design,
    ``bp5/step-64.cu:47``).
    """
    az, ay, ax = axes
    if collocation:
        # S == I: values are nodal values; gradients are single D sweeps
        # (the FEEvaluationGL fast path, bp5/fe_evaluation_gl.h:26-44)
        vals = u if values else None
        grads = None
        if gradients:
            grads = (sweep(u, D, ax), sweep(u, D, ay), sweep(u, D, az))
        return vals, grads

    tx = sweep(u, S, ax)
    txy = sweep(tx, S, ay)
    vals = sweep(txy, S, az) if values else None
    grads = None
    if gradients:
        gz = sweep(txy, D, az)
        gy = sweep(sweep(tx, D, ay), S, az)
        gx = sweep(sweep(sweep(u, D, ax), S, ay), S, az)
        grads = (gx, gy, gz)
    return vals, grads


def integrate(
    vals: Optional[torch.Tensor],
    grads,
    S: torch.Tensor,
    D: torch.Tensor,
    axes: Sequence[int],
    collocation: bool,
) -> torch.Tensor:
    """Transpose of :func:`evaluate`: quadrature-point (values, gradients)
    -> nodal residual contributions. Mirrors ``FEEvaluation::integrate``
    (``bp5/fe_evaluation_gl.h:222-250``). Quadrature weights / JxW must
    already be folded into the inputs (merged-coefficient convention)."""
    az, ay, ax = axes
    if collocation:
        out = vals
        if grads is not None:
            gx, gy, gz = grads
            gsum = (
                sweep(gx, D, ax, transpose=True)
                + sweep(gy, D, ay, transpose=True)
                + sweep(gz, D, az, transpose=True)
            )
            out = gsum if out is None else out + gsum
        return out

    acc = None
    if grads is not None:
        gx, gy, gz = grads
        # pair the x/y gradient sweeps before the shared z sweep
        txy = sweep(sweep(gx, D, ax, transpose=True), S, ay, transpose=True) + sweep(
            sweep(gy, S, ax, transpose=True), D, ay, transpose=True
        )
        acc = sweep(txy, S, az, transpose=True) + sweep(
            sweep(sweep(gz, S, ax, transpose=True), S, ay, transpose=True),
            D,
            az,
            transpose=True,
        )
    if vals is not None:
        v = sweep(
            sweep(sweep(vals, S, ax, transpose=True), S, ay, transpose=True),
            S,
            az,
            transpose=True,
        )
        acc = v if acc is None else acc + v
    return acc
