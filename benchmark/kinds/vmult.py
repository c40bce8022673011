"""Traffic kind "vmult": whole chains of ``CHAIN`` applies ``u <- op.vmult(u)``
(the BP5 driver's vmult mode), the operator scaled once in set-up by
``1 / lambda_max`` so that a chain neither grows nor dies, back to back,
each chain fenced.

Inputs: ``POOL`` normal start vectors drawn from the seed, zero on the
boundary, of norm 1. The check's number: ``out_gap``,
``|u - u_ref|_inf / |u_ref|_inf`` of a chain's last vector against the
reference's chain from the same start.
"""

from __future__ import annotations

import torch

from benchmark.reference.cg import chain
from benchmark.reference.precision import precision
from benchmark.system import DTYPES, POOL, geometry, inf_gap, reference_operator, seeded_normal, sync

SOLVER_KERNELS = ()
CHAIN = 200
WARMUP_APPLIES = 3


def chain_scale(cfg: dict, iterations: int = 60) -> float:
    """The chained vmult's factor 1 / lambda_max, with lambda_max from a
    power iteration of the reference on the geometry's cut of the
    configuration to a few elements of the same size (the largest
    eigenvalue is that of the finest local mode, so it barely depends on the
    mesh's extent); on the CPU, in float64, from fixed interior values: the
    same for every seed."""
    op = reference_operator(geometry(cfg["geometry"]).small(cfg, (6, 4, 4)), torch.float64, "cpu")
    u = op.mask.to(torch.float64)
    lam = 1.0
    for _ in range(iterations):
        v = op.apply(u)
        lam = float(torch.linalg.vector_norm(v))
        u = v / lam
    return 1.0 / lam


def make_inputs(cell, seed: int, device) -> dict:
    vec = DTYPES[cell.traffic["vectors"]]
    mask = reference_operator(cell.config, torch.float64, device).mask
    pool = []
    for j in range(POOL):
        r = seeded_normal(mask.shape, seed, j, device) * mask
        pool.append((r / torch.linalg.vector_norm(r)).reshape(-1).to(vec))
    # one rounding to the compute type, so that program and reference fold the same number
    scale = float(torch.tensor(chain_scale(cell.config), dtype=DTYPES[cell.traffic["compute"]]))
    return {"pool": pool, "norms": [1.0] * POOL, "scale": scale}


def make_unit(cell, op, inputs: dict, device):
    """``(unit, warm)``: ``unit(A, j)`` runs the chain from start vector j and
    returns ``(last vector, applies, True)``; ``warm(A)`` a short chain."""
    pool = inputs["pool"]

    def unit(A, j):
        u = pool[j]
        for _ in range(CHAIN):
            u = A(u)
        sync(device)
        return u, CHAIN, True

    def warm(A):
        u = pool[0]
        for _ in range(WARMUP_APPLIES):
            u = A(u)

    return unit, warm


def reference_units(cell, inputs: dict, indices, device, prec: str = "float64") -> dict:
    """``{j: (last vector, applies)}``: the reference's chain from start
    vector j at the precision ``prec`` names."""
    ref = reference_operator(cell.config, precision(prec)[0], device, inputs["scale"])
    return {j: (chain(ref.apply, inputs["pool"][j].to(torch.float64), CHAIN, prec), CHAIN)
            for j in sorted(set(indices))}


def numbers(cell, samples, inputs: dict, device) -> dict:
    ref = reference_units(cell, inputs, [j for j, _, _ in samples], device)
    return {"out_gap": max(inf_gap(u, ref[j][0]) for j, u, _ in samples)}
