"""Traffic kind "cg": whole solves of the configuration's control with the
merged CG (``solve_cg_merged``: K7, the apply, K8 an iteration) on the
operator's ``vmult``, preconditioned by the diagonal that the
configuration's preconditioner (``preconditioners/<name>.py``) gives the
program, back to back, each fenced.

Inputs: ``POOL`` right-hand sides, the load vectors of a fixed set of smooth
fields (``LOAD_SEED``: ``f = 1 + sum_k c_k cos(2 pi n_k . xhat + phi_k)``),
each mode's amplitude c_k times ``1 + PERTURBATION u``, u uniform in
[-1, 1] and drawn from the run's seed. The fixed modes set the work: a
solve's iteration count to a tolerance depends on which modes its load
holds, by some %, and not on their amplitudes within a few %, so every seed
runs the same work in the same order while the answers differ from seed to
seed (a field of new modes drawn from the seed moved step-64's count at
refine 7 by up to 4 %).

The check's numbers: ``out_gap``, ``|x - x_ref|_inf / |x_ref|_inf`` against
the reference's own CG to the same control from the same right-hand side,
with the diagonal the preconditioner gives the reference;
``res``, the true residual ``|b - A_ref x|_2 / |b|_2`` with the reference's
operator. A cell compares what its limits name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.brick import field_params, load_vector
from benchmark.reference.cg import cg
from benchmark.reference.precision import precision
from benchmark.system import DTYPES, POOL, inf_gap, preconditioner, reference_operator, sync

SOLVER_KERNELS = ("K7", "K8")
LOAD_SEED = 20
PERTURBATION = 0.02
WARMUP_STEPS = 3  # iterations of the warm-up solve: every kernel and shape of a solve


def make_inputs(cell, seed: int, device) -> dict:
    """The pool of right-hand sides at the vectors' precision and each one's
    2-norm (float64, for the solver's control)."""
    vec = DTYPES[cell.traffic["vectors"]]
    ref = reference_operator(cell.config, torch.float64, device)
    pool, norms = [], []
    for j in range(POOL):
        rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, j]))
        params = [(n, c * (1 + PERTURBATION * rng.uniform(-1, 1)), phi) for n, c, phi in field_params(LOAD_SEED, j)]
        v = load_vector(ref, params).to(vec)
        pool.append(v)
        norms.append(float(torch.linalg.vector_norm(v.double())))
    return {"pool": pool, "norms": norms, "scale": 1.0}


def program_control(cfg: dict, norm_b: float, max_steps: int | None = None):
    """The configuration's solver control for a right-hand side of 2-norm ``norm_b``."""
    from deal_and_ceed_on_gpu_torch import solvers

    c = cfg["control"]
    kw = {"tolerance": c.get("tolerance_of_b", 0.0) * norm_b}
    if "reduction" in c:
        kw["reduction"] = c["reduction"]
    return getattr(solvers, c["kind"])(max_steps or c["max_steps"], **kw)


def make_unit(cell, op, inputs: dict, device):
    """``(unit, warm)``: ``unit(A, j)`` solves with right-hand side j on the
    apply A and returns ``(x, iterations, met the control)``; ``warm(A)``
    runs a short solve."""
    from deal_and_ceed_on_gpu_torch.solvers import cg_merged

    cfg, t = cell.config, cell.traffic
    diag = preconditioner(cfg["preconditioner"]).program(op)
    # kernel_ctx counts K7's and K8's reads of a diagonal at the compute type
    if diag is not None and diag.dtype != DTYPES[t["compute"]]:
        raise ValueError(f"preconditioner {cfg['preconditioner']!r} gives a {diag.dtype} diagonal, "
                         f"not the compute type {t['compute']}")
    dot = DTYPES[t["dot_dtype"]] if t.get("dot_dtype") else None
    pool, norms = inputs["pool"], inputs["norms"]
    controls = [program_control(cfg, nb) for nb in norms]

    def unit(A, j):
        x, info = cg_merged.solve_cg_merged(A, pool[j], controls[j], diag=diag, dot_dtype=dot)
        sync(device)
        try:
            controls[j].check(info)
            ok = True
        except RuntimeError:
            ok = False
        return x, int(info["n_iterations"]), ok

    def warm(A):
        cg_merged.solve_cg_merged(A, pool[0], program_control(cfg, norms[0], WARMUP_STEPS), diag=diag,
                                  dot_dtype=dot)

    return unit, warm


def reference_units(cell, inputs: dict, indices, device, prec: str = "float64") -> dict:
    """``{j: (x, iterations)}``: the reference's CG to the configuration's
    control from right-hand side j, at the precision ``prec`` names
    (float64: the reference; lower: a control in the program's place)."""
    cfg = cell.config
    c = cfg["control"]
    dt = precision(prec)[0]
    ref = reference_operator(cfg, dt, device)
    diag = preconditioner(cfg["preconditioner"]).reference(ref, dt)
    out = {}
    for j in sorted(set(indices)):
        x, its, _ = cg(ref.apply, inputs["pool"][j].to(torch.float64), c["max_steps"],
                       c.get("tolerance_of_b", 0.0) * inputs["norms"][j], c.get("reduction", 0.0), prec, diag)
        out[j] = (x, its)
    return out


def numbers(cell, samples, inputs: dict, device) -> dict:
    """The check's numbers of ``samples`` ``[(j, x, iterations)]`` that the
    cell's limits name, each the largest over the samples."""
    names = set(cell.limits)
    out = {}
    if "out_gap" in names:
        ref = reference_units(cell, inputs, [j for j, _, _ in samples], device)
        out["out_gap"] = max(inf_gap(x, ref[j][0]) for j, x, _ in samples)
    if "res" in names:
        A = reference_operator(cell.config, torch.float64, device)
        res = []
        for j, x, _ in samples:
            b = inputs["pool"][j].to(torch.float64)
            r = b - A.apply(x.to(torch.float64)).reshape(-1)
            res.append(float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)))
        out["res"] = max(v if math.isfinite(v) else math.inf for v in res)
    return out
