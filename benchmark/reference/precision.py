"""Storage precisions: the cells' own and their controls'.

A precision is ``(compute dtype, store, dot)``: vectors are rounded by
``store`` after every operation that writes them, arithmetic runs at the
compute dtype, and ``dot`` is the CG's inner product. ``float8_e4m3``
stores with one scale a vector (its largest magnitude at the format's
largest value, 448), as fp8 data is kept in practice. ``bfloat16_compute``
stores and computes in bf16, the inner products too: torch's own bf16
products and sums accumulate in f32, so the sum is a pairwise tree rounded
to bf16 at every level (the most accurate a bf16 accumulator can be).
"""

from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "precision"]


def _exact(v: torch.Tensor) -> torch.Tensor:
    return v


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(v.dtype)


def _fp8(v: torch.Tensor) -> torch.Tensor:
    amax = v.abs().max()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (v / s).to(torch.float8_e4m3fn).to(v.dtype) * s


def _bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    v = (a.to(torch.bfloat16) * b.to(torch.bfloat16)).reshape(-1)
    while v.numel() > 1:
        if v.numel() % 2:
            v = torch.cat([v, v.new_zeros(1)])
        v = v[0::2] + v[1::2]
    return v[0]


PRECISIONS = {
    "float64": (torch.float64, _exact, torch.dot),
    "float32": (torch.float32, _exact, torch.dot),
    "bfloat16": (torch.float32, _bf16, torch.dot),  # stored bf16, computed in f32
    "float8_e4m3": (torch.float32, _fp8, torch.dot),  # stored fp8 with a scale, computed in f32
    "bfloat16_compute": (torch.bfloat16, _exact, _bf16_dot),  # stored and computed in bf16
}


def precision(name: str):
    """``(compute dtype, store, dot)`` of a precision's name."""
    return PRECISIONS[name]
