"""The reference against the program's plain CPU paths at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference.brick import BrickOperator, field_params, load_vector
from benchmark.reference.cg import cg, chain

CASES = [  # n_elements, upper, degree, n_q, rule, operator, coefficient, backends
    ((6, 2, 2), (3.0, 1.0, 1.0), 5, 6, "gauss_lobatto", "PoissonOperator", None, ("structured", "stencil")),
    ((4, 4, 4), (1.0, 1.0, 1.0), 3, 4, "gauss", "HelmholtzOperator", "step64", ("structured", "qgrid")),
    ((3, 2, 2), (1.5, 1.0, 1.0), 2, 4, "gauss", "PoissonOperator", None, ("structured", "qgrid")),
]


def _program(m, up, p, nq, rule, operator, backend):
    from deal_and_ceed_on_gpu_torch import models
    from deal_and_ceed_on_gpu_torch.fe_space import FESpace
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    space = FESpace.create(BrickMesh(m, (0.0, 0.0, 0.0), up), p, n_q=nq, rule=rule, dtype=torch.float64,
                           device="cpu")
    return space, getattr(models, operator)(space, backend=backend)


def _ref(m, up, p, nq, rule, coef, **kw):
    return BrickOperator({"n_elements": m, "lower": [0, 0, 0], "upper": up}, p, nq, rule, coef, **kw)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[5]}-p{c[2]}-{c[4]}")
def test_apply_and_load_vector(case):
    m, up, p, nq, rule, operator, coef, backends = case
    ref = _ref(m, up, p, nq, rule, coef)
    u = torch.randn(ref.n_dofs, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    want = ref.apply(u).reshape(-1)
    for backend in backends:
        space, op = _program(m, up, p, nq, rule, operator, backend)
        got = op.vmult(u)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-14, backend
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs

    params = field_params(7, 1)

    def f(x):  # the same field on the program's host points
        out = np.ones(x.shape[:-1])
        for n, c, phi in params:
            out += c * np.cos(2 * math.pi * sum(n[d] * x[..., d] / up[d] for d in range(3)) + phi)
        return out

    b_prog = assemble_rhs(space, f)
    b_ref = load_vector(ref, params)
    assert float((b_prog - b_ref).abs().max() / b_ref.abs().max()) < 1e-14


def test_cg_against_the_programs_solver():
    from deal_and_ceed_on_gpu_torch.solvers import ReductionControl, solve_cg_merged

    m, up, p, nq, rule, operator, coef, _ = CASES[1]
    space, op = _program(m, up, p, nq, rule, operator, "structured")
    ref = _ref(m, up, p, nq, rule, coef)
    b = load_vector(ref, field_params(11, 0))
    x, info = solve_cg_merged(op.vmult, b, ReductionControl(2000, tolerance=0.0, reduction=1e-12))
    x_ref, its, res = cg(ref.apply, b, 2000, 0.0, 1e-12)
    assert abs(int(info["n_iterations"]) - its) <= 1
    assert float((x - x_ref).abs().max() / x_ref.abs().max()) < 1e-9
    assert res <= 1e-12 * float(torch.linalg.vector_norm(b))


def _textbook_cg(apply, b, max_steps, tolerance=0.0, reduction=0.0, prec="float64"):
    """Plain CG, operation for operation as ``cg`` runs it without a diagonal."""
    from benchmark.reference.precision import precision

    dt, store, dot = precision(prec)
    b = store(b.to(dt))
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = dot(r, r)
    res0 = math.sqrt(float(rr))
    tol = max(tolerance, reduction * res0)
    it = 0
    res = res0
    while it < max_steps and res > tol:
        it += 1
        q = store(apply(p).reshape(-1).to(dt))
        alpha = rr / dot(p, q)
        x = store(x + alpha * p)
        r = store(r - alpha * q)
        rr_new = dot(r, r)
        p = store(r + (rr_new / rr) * p)
        rr = rr_new
        res = math.sqrt(float(rr))
    return x, it, res


@pytest.mark.parametrize("prec, iterations", [("float64", 67), ("float32", 72), ("bfloat16", 76)])
def test_cg_without_a_diagonal_is_plain_cg(prec, iterations):
    # every cell without a preconditioner keeps its reference answers bit for bit
    m, up, p, nq, rule, _, coef, _ = CASES[1]
    ref = _ref(m, up, p, nq, rule, coef)
    b = load_vector(ref, field_params(11, 0))
    x, its, res = cg(ref.apply, b, 2000, 0.0, 1e-12, prec)
    x0, its0, res0 = _textbook_cg(ref.apply, b, 2000, 0.0, 1e-12, prec)
    assert its == its0 == iterations and res == res0 and torch.equal(x, x0)
    assert cg(ref.apply, b, 2000, 0.0, 1e-12, prec, None)[1] == iterations


def test_chain_scale_keeps_the_chain_in_range():
    from benchmark.system import kind, load_cell

    cfg = load_cell("bp5_c40_f32_vmult").config
    s = kind("vmult").chain_scale(cfg)
    big = {**cfg, "mesh": {**cfg["mesh"], "n_elements": [9, 6, 6], "upper": [9 / 64, 6 / 64, 6 / 64]}}
    op = BrickOperator(big["mesh"], 5, 6, "gauss_lobatto", None, scale=s)
    u = op.mask.double().reshape(-1)
    u = u / torch.linalg.vector_norm(u)
    v = chain(op.apply, u, 200)
    assert 1e-6 < float(torch.linalg.vector_norm(v)) < 1e6  # neither vanishes nor blows up in 200 applies
