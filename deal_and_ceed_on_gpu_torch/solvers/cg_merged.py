"""Merged preconditioned CG — the "pcg-merged" solver.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/cg_merged.py`` and of the
reference's ``SolverCGFullMerge`` (``bp5/solver.h:15-542``). Per iteration:

1. one operator apply ``h = A d``,
2. the **seven** dot products of ``update_b`` (``bp5/solver.h:142-311``):
   ``d.h, h.h, g.h, g.g, g.(diag h), h.(diag h), g.diag.g``,
3. scalar recurrences — alpha, the **reduction-free residual norm**
   ``|g_new| = sqrt(g.g + 2 a g.h + a^2 h.h)`` (``bp5/solver.h:504-505``)
   and ``beta = a (g.Mh + a h.Mh) / (g.Mg)`` (``bp5/solver.h:533``),
4. the vector updates (the ``update_a*`` kernels, ``bp5/solver.h:48-140``).

The updates and dots are torch ops here; their fused kernels are later
work. Every scalar stays on the device; the loop reads the residual norm on
the host once per iteration for the stopping test, so the iteration count
is exactly that of the JAX ``while_loop``.

``deferred_x_update=True`` is the Kronbichler data-locality scheme
(``OPTIMIZED_UPDATE``, ``bp5/solver.h:106-140,509-526``): x is touched only
every second iteration via the merged two-step formula

    x += (a_j + a_{j-1}/b_{j-1}) d_j + (a_{j-1}/b_{j-1}) * diag * g_{j-1}

which equals ``a_{j-1} d_{j-1} + a_j d_j`` by the direction recurrence. The
two-step update fires exactly on even iterations, and a stop at an odd
iteration finishes with ``x += a d`` (the ``update_c`` epilogue). The
reference's quirk of selecting ``update_a1`` on every iteration once
``alpha_old != 0`` (``bp5/solver.h:413-472``) is not reproduced.

Sign conventions follow the reference (``bp5/solver.h:375-381``):
``g = A x - b``, ``d = -diag g + beta d``, ``g += alpha h``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .cg import safe_div
from .control import SolverControl

__all__ = ["solve_cg_merged"]


def solve_cg_merged(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    control: SolverControl,
    diag: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    deferred_x_update: bool = False,
    dot_dtype: Optional[torch.dtype] = None,
    dot_weight: Optional[torch.Tensor] = None,
    comm=None,
):
    """Solve A x = b. Returns ``(x, info)``; see ``solve_cg`` for the
    ``diag`` convention (a vector or None, the identity) and ``dot_dtype``
    (the dots and recurrences accumulate at it: float32 for bfloat16
    vectors). The vectors may have any shape (``[3, n]`` for the vector
    BPs): the dots run over all entries.

    Distributed (``parallel/dist_solve.py``): ``dot_weight`` zeroes a
    rank's duplicated planes in the dots and ``comm`` (a ``ShardComm``)
    sums the seven dots of an iteration in one all-reduce of the stacked
    seven, at ``dot_dtype`` (JAX's ``dot_weight`` / ``psum_axis``,
    ``cg_merged.py:67-68,112``); the initial residual norm is one more."""
    dt = b.dtype
    dd = dot_dtype or dt
    w = None if dot_weight is None else dot_weight.to(dd)

    def dot(u, v):
        # over all entries: a [3, n] vector solves like a flat one
        return torch.dot(u.reshape(-1), v.reshape(-1))

    def wt(u):
        return u if w is None else u * w

    def reduce(*s):
        if comm is None:
            return s
        return comm.allreduce_sum_(torch.stack(s)).unbind()

    def dots7(d, g, h):
        """The update_b seven-way reduction at the accumulation dtype. With
        the identity diagonal the last three equal g.h, h.h and g.g."""
        dq, gq, hq = d.to(dd), g.to(dd), h.to(dd)
        hw = wt(hq)
        dh, hh, gh, gg = dot(dq, hw), dot(hq, hw), dot(gq, hw), dot(gq, wt(gq))
        if diag is None:
            dh, hh, gh, gg = reduce(dh, hh, gh, gg)
            return dh, hh, gh, gg, gh, hh, gg
        mq = diag.to(dd)
        mh = mq * hw
        return reduce(dh, hh, gh, gg, dot(gq, mh), dot(hq, mh), dot(gq, mq * wt(gq)))

    def mdiag(v):
        return v if diag is None else diag * v

    # init (bp5/solver.h:373-383): g = A x - b, short-circuit for x0 == None
    if x0 is None:
        x = torch.zeros_like(b)
        g = -b
    else:
        x = x0
        g = A(x0) - b
    gq = g.to(dd)
    (gg0,) = reduce(dot(gq, wt(gq)))
    res0 = torch.sqrt(gg0)
    d = -mdiag(g)  # update_a0 (bp5/solver.h:48-72)

    alpha = beta = torch.zeros((), dtype=dd, device=b.device)
    res = res0
    it = 0
    res0_h = float(res0)
    if not control.continue_pred(it, res0_h, res0_h):
        return x, {"n_iterations": it, "res_norm": res, "res0": res0}
    while True:
        it += 1
        alpha_prev, beta_prev = alpha, beta
        h = A(d)
        s0, s1, s2, s3, s4, s5, s6 = dots7(d, g, h)
        alpha = safe_div(s6, s0)
        # reduction-free |g + alpha h|; clamp tiny negative roundoff
        res = torch.sqrt(torch.clamp_min(s3 + 2.0 * alpha * s2 + alpha * alpha * s1, 0.0))
        beta = safe_div(alpha * (s4 + alpha * s5), s6)
        # the one host read per iteration: the stopping test
        will_stop = not control.continue_pred(it, float(res), res0_h)
        a = alpha.to(dt)

        if not deferred_x_update:
            x = x + a * d  # update_a<true> (bp5/solver.h:74-104)
        elif it % 2 == 0:
            ratio = safe_div(alpha_prev, beta_prev).to(dt)
            x = x + (a + ratio) * d + ratio * mdiag(g)
        elif will_stop:
            x = x + a * d  # complete through it on early exit (update_c)

        g = g + a * h
        d = beta.to(dt) * d - mdiag(g)
        if will_stop:
            return x, {"n_iterations": it, "res_norm": res, "res0": res0}
