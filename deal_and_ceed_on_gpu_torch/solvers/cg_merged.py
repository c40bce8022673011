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

Steps 4 and 2 are K7 and K8 (``ops/cg_merged.py``, ``csrc/cg_merged.cu``),
and K8's last block does step 3, so an iteration on the card is three
launches: K7, the apply and K8 (with a ``comm``, K8's one-thread finisher
follows the all-reduce). K8's scratch, the summaries and both kernels'
checked vectors live in one ``DotsWorkspace`` a solve, so each call in
the loop checks h alone. Every scalar stays on the device; the loop
reads the residual norm on the host once per iteration for the stopping
test, so the iteration count is exactly that of the JAX ``while_loop``. On the CPU the wrappers run their plain versions, this
solver's torch expressions before the kernels.

The solve is the span ``cg.solve``; inside it ``cg.init`` (everything
before the loop), and an iteration's ``cg.apply``, ``cg.dots`` (K8's
wrapper), ``cg.stop_test`` (the residual's host read and the choice of
mode) and ``cg.update`` (K7's wrapper); each host read of a device value
counts one ``host_syncs`` (``utils/profiling``: off unless a profiler or
``record()`` is recording).

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

from ..ops.cg_merged import S_RES, SUMMARY, DotsWorkspace, merged_dots, merged_update, overlaps
from ..utils.profiling import count, span
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
    with span("cg.solve"):
        with span("cg.init"):
            dd = dot_dtype or b.dtype
            # the kernels see flat contiguous vectors of b's shape: broadcast the
            # weight and the diagonal once a solve
            w = None if dot_weight is None else torch.broadcast_to(dot_weight.to(dd), b.shape).contiguous()
            if diag is not None:
                diag = torch.broadcast_to(diag, b.shape).contiguous()

            # init (bp5/solver.h:373-383): g = A x - b, short-circuit for x0 == None;
            # x, g and d are the solver's own: K7 updates them in place
            if x0 is None:
                x = torch.zeros_like(b, memory_format=torch.contiguous_format)
                g = -b
            else:
                x = x0.clone(memory_format=torch.contiguous_format)
                g = A(x0) - b
            g = g.contiguous()
            # K8's scratch, the two summaries the loop alternates as scal and prev,
            # and the vectors K7 and K8 checked
            ws = DotsWorkspace(dd, b.device)
            gg0 = merged_dots(g, g, g, weight=w, dot_dtype=dd, workspace=ws)[3]  # the rank's g.g
            if comm is not None:
                (gg0,) = comm.allreduce_sum_(torch.stack([gg0])).unbind()
            res0 = torch.sqrt(gg0)
            # update_a0 (bp5/solver.h:48-72): d = -diag g, at torch's promotion of diag * g
            d = torch.empty(b.shape, dtype=g.dtype if diag is None else torch.promote_types(g.dtype, diag.dtype),
                            device=b.device)
            merged_update(None, g, d, None, diag, None, None, "init")

            res = res0
            it = 0
            count("host_syncs")
            res0_h = float(res0)
            if not control.continue_pred(it, res0_h, res0_h):
                return x, {"n_iterations": it, "res_norm": res, "res0": res0}
            # x takes d's type: x + a d promotes it so in the first update
            x = x.to(torch.promote_types(x.dtype, d.dtype))
            prev = torch.zeros(SUMMARY, dtype=dd, device=b.device)  # alpha = beta = 0 before the first iteration
        while True:
            it += 1
            with span("cg.apply"):
                h = A(d)
                if not h.is_contiguous() or any(overlaps(h, v) for v in (x, g, d)):
                    h = h.clone(memory_format=torch.contiguous_format)  # K7 writes x, g and d while it reads h
            with span("cg.dots"):
                scal = merged_dots(d, g, h, diag, w, dd, comm, workspace=ws)
            with span("cg.stop_test"):
                res = scal[S_RES]
                # the one host read per iteration: the stopping test
                count("host_syncs")
                will_stop = not control.continue_pred(it, float(res), res0_h)
                if not deferred_x_update:
                    mode = "plain"  # update_a<true> (bp5/solver.h:74-104)
                elif it % 2 == 0:
                    mode = "two-step"
                elif will_stop:
                    mode = "odd-stop"  # complete through it on early exit (update_c)
                else:
                    mode = "no-x"
            with span("cg.update"):
                merged_update(x, g, d, h, diag, scal, prev, mode, workspace=ws)
            prev = scal
            if will_stop:
                return x, {"n_iterations": it, "res_norm": res, "res0": res0}
