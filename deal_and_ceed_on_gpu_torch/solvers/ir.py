"""Mixed-precision iterative refinement: f32 CG inner solves, f64 true
residuals.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/ir.py``. f32 CG stagnates
near a true relative residual of ~1e-4 (its recurrence residual falls below
the true one); classical iterative refinement reaches f64 accuracy with f32
inner solves:

    repeat:  r = b - A x          (f64 operator, true residual)
             solve A e ~= r       (f32 CG, loose reduction)
             x += e               (f64 accumulation)

The outer loop is a host loop of a few iterations. The JAX package caches
its jitted steps on the operator; eager torch does not retrace, so the port
has no such cache.
"""

from __future__ import annotations

import torch

from .cg import solve_cg
from .cg_merged import solve_cg_merged
from .control import NoConvergence, ReductionControl

__all__ = ["solve_cg_ir"]


def solve_cg_ir(
    op32,
    op64,
    b64: torch.Tensor,
    rtol: float = 1e-10,
    inner_reduction: float = 1e-4,
    inner_max: int = 1000,
    max_outer: int = 25,
    diag32=None,
):
    """Solve ``A x = b`` to a true f64 relative residual ``rtol``.

    ``op32`` / ``op64`` are the same operator built at the two precisions
    (same mesh, degree and rule). ``diag32`` may be a vector (Jacobi, the
    default ``op32.jacobi_preconditioner()``), routed through merged CG, or a
    callable preconditioner such as ``FDMSolver.apply`` or a multigrid
    V-cycle, routed through plain CG. The inner vectors are at
    ``op32.stream_dtype`` (bfloat16 streams accumulate their dots at
    float32). Returns ``(x64, info)`` with ``n_outer``, the total
    ``n_inner`` CG iterations and ``res_rel``, the final true relative
    residual; raises :class:`NoConvergence` after ``max_outer`` cycles."""
    if b64.dtype != torch.float64:
        raise TypeError("b must be float64 (the accumulation dtype)")
    inner_control = ReductionControl(
        inner_max, tolerance=0.0, reduction=inner_reduction, success_on_max_steps=True
    )
    if diag32 is None:
        diag32 = op32.jacobi_preconditioner()
    stream = getattr(op32, "stream_dtype", torch.float32)
    dot_dtype = torch.float32 if stream != torch.float32 else None
    solver = solve_cg if callable(diag32) else solve_cg_merged

    bnorm = float(torch.linalg.vector_norm(b64))
    if bnorm == 0.0:
        return torch.zeros_like(b64), {"n_outer": 0, "n_inner": 0, "res_rel": 0.0}
    x = torch.zeros_like(b64)
    r = b64
    n_inner = 0
    res_rel = 1.0
    for outer in range(1, max_outer + 1):
        e32, info = solver(op32.vmult, r.to(stream), inner_control, diag=diag32, dot_dtype=dot_dtype)
        n_inner += int(info["n_iterations"])
        x = x + e32.to(torch.float64)
        r = b64 - op64.vmult(x).to(torch.float64)
        res_rel = float(torch.linalg.vector_norm(r)) / bnorm
        if res_rel <= rtol:
            return x, {"n_outer": outer, "n_inner": n_inner, "res_rel": res_rel}
    raise NoConvergence(max_outer, res_rel)
