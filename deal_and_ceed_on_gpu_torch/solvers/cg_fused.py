"""Merged CG on the fused iteration kernel K5 — the "pcg-fused" solver.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/cg_fused.py``: the
algorithm of ``solve_cg_merged`` (``SolverCGFullMerge``,
``bp5/solver.h:343-542``) with the identity diagonal, where the vector
updates, the operator apply and the four dots of an iteration are one K5
launch (``ops/cg.py``), and a one-block finishing kernel reduces the dots
and computes the scalar recurrences on the device. Call i of the kernel
performs::

    g <- g + alpha_{i-1} h        # completes iteration i-1's update
    d <- beta_{i-1} d - g
    x <- x + alpha_{i-1} d_old    # via (alpha/beta)(d_new + g_new)
    h <- A d
    dots = (d.h, h.h, g.h, g.g)   # feeds alpha_i, beta_i, |g_i|

so after the loop ``x += alpha_K d_K`` applies the pending update (the
reference's ``update_c``, ``bp5/solver.h:509-526``). The residual norm is
the reduction-free ``sqrt(g.g + 2 a g.h + a^2 h.h)``
(``bp5/solver.h:504-505``), so iteration counts match ``solve_cg_merged``.

alpha, beta and ``xa = alpha/beta`` stay on the device: the finishing
kernel writes them, and the next K5 launch reads them through a pointer.
The loop reads the residual norm on the host once per iteration for the
stopping test, as ``solve_cg_merged`` does. The stacked
state ping-pongs between two buffers (the kernel cannot write the state it
reads). Vectors are flat real-DoF tensors at the storage dtype; the dots
and the scalars are at the operator's compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from .control import SolverControl

__all__ = ["solve_cg_fused"]


def solve_cg_fused(step, b: torch.Tensor, control: SolverControl, x0: Optional[torch.Tensor] = None):
    """Solve ``A x = b`` with the fused-kernel merged CG. ``step``: a
    ``CGFusedStep`` or an operator with ``fused_cg_step`` (stencil
    backend). Returns ``(x, info)`` like the other solvers."""
    from ..ops.cg import D, H, X

    step = getattr(step, "fused_cg_step", step)
    cd = step.dtype
    scal = torch.zeros(3, dtype=cd, device=b.device)  # the first call: alpha = beta = xa = 0

    # init (bp5/solver.h:373-383): g = A x0 - b; an x0 costs one throwaway
    # kernel call: with alpha = beta = 0 it sets d = -g, so g := -x0 gives
    # h = A x0
    zeros = torch.zeros_like(b)
    g0 = -b
    if x0 is not None:
        s_tmp = step.stack_state(zeros, -x0, zeros, zeros)
        s_tmp, _ = step(s_tmp, torch.empty_like(s_tmp), scal)
        g0 = step.unstack(s_tmp, H) - b
    res0 = torch.sqrt(torch.sum(g0.to(cd) * g0.to(cd)))

    s = step.stack_state(zeros, g0, zeros, zeros if x0 is None else x0)
    sw = torch.empty_like(s)  # every real point is written on every call
    summary = None
    it = 0
    res0_h = float(res0)
    res_h = res0_h
    while control.continue_pred(it, res_h, res0_h):
        s_new, summary = step.iterate(s, sw, scal)
        scal = summary[4:7]  # [alpha, beta, xa] of the next call, on the device
        s, sw = s_new, s  # ping-pong: the stale read side is the next write buffer
        it += 1
        res_h = float(summary[7])  # the one host read per iteration
    # the pending update_c: x += alpha_K d_K
    if summary is None:
        return s[X].reshape(-1).clone(), {"n_iterations": 0, "res_norm": res0, "res0": res0}
    x = step.unstack(s, X) + summary[4].to(b.dtype) * step.unstack(s, D)
    return x, {"n_iterations": it, "res_norm": summary[7], "res0": res0}
