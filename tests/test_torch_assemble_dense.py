"""The host-side dense assembly of the port (models/operator_base.assemble_dense)
and the operators' weak_form() against the JAX package's, on the cases of
tests/test_assemble_dense.py: Poisson on a uniform GLL brick and on a mapped
Gauss mesh, Helmholtz with its value coefficient, mass on a graded brick,
after fold_scale; the port's matrix also against its own vmult
materialised column by column (the multigrid's fallback), the max_dofs
guard, and bounds_from_dense on the port's matrix against the JAX package's
(1e-14)."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, MassOperator, PoissonOperator, assemble_dense
from deal_and_ceed_on_gpu_torch.models.operator_base import MatrixFreeOperator
from deal_and_ceed_on_gpu_torch.solvers.multigrid import _dense_from_vmult, bounds_from_dense

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
    from deal_and_ceed_on_gpu_tpu.models import MassOperator as MassJ
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
    from deal_and_ceed_on_gpu_tpu.models.operator_base import assemble_dense as assemble_dense_j
    from deal_and_ceed_on_gpu_tpu.solvers.multigrid import bounds_from_dense as bounds_j
except ImportError:  # the card's machine has no jax
    jnp = None

TOL = 1e-12  # relative to max|A|, port against JAX
BREAKS = (np.array([0.0, 0.15, 0.45, 1.0]), np.linspace(0, 1, 4), np.linspace(0, 1, 4))

# (name, mesh kind, p, rule, port operator class, JAX operator class, backend)
CASES = {
    "poisson-uniform-gll": ("uniform", 2, "gauss_lobatto", "poisson", "separable"),
    "poisson-mapped-gauss": ("mapped", 2, "gauss", "poisson", "structured"),
    "helmholtz-gauss": ("uniform", 3, "gauss", "helmholtz", "structured"),
    "mass-graded": ("graded", 2, "gauss", "mass", "structured"),
    "poisson-graded-gll-general": ("graded", 3, "gauss_lobatto", "poisson", "general"),
}


def _ops(kind, p, rule, model, backend):
    if kind == "uniform":
        mt, mj = pt.BrickMesh((3, 3, 3)), jx.BrickMesh((3, 3, 3))
    elif kind == "mapped":
        mt = pt.BrickMesh((3, 3, 3)).deform(*pt.sine_map(0.05))
        mj = jx.BrickMesh((3, 3, 3)).deform(*jx.sine_map(0.05))
    else:
        mt, mj = pt.BrickMesh.graded(*BREAKS), jx.BrickMesh.graded(*BREAKS)
    st = pt.FESpace.create(mt, p, rule=rule, dtype=torch.float64, device="cpu")
    sj = jx.FESpace.create(mj, p, rule=rule, dtype=jnp.float64)
    cls_t = {"poisson": PoissonOperator, "helmholtz": HelmholtzOperator, "mass": MassOperator}[model]
    cls_j = {"poisson": PoissonJ, "helmholtz": HelmholtzJ, "mass": MassJ}[model]
    return cls_t(st, backend=backend), cls_j(sj, backend="structured" if backend == "general" else backend)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_assemble_dense_matches_jax(case):
    op_t, op_j = _ops(*CASES[case])
    A = assemble_dense(op_t)
    _close(A, assemble_dense_j(op_j))
    # the port's own apply, column by column (the multigrid's fallback)
    _close(_dense_from_vmult(op_t, chunk=100), A, tol=1e-10)


@pytest.mark.parametrize("model", ["poisson", "helmholtz", "mass"])
def test_weak_form_matches_jax(model):
    op_t, op_j = _ops("uniform", 3, "gauss", model, "structured")
    (gt, vt, ct), (gj, vj, cj) = op_t.weak_form(), op_j.weak_form()
    assert (gt, ct) == (gj, cj)
    assert (vt is None) == (vj is None)
    if vt is not None:
        np.testing.assert_array_equal(vt, np.asarray(vj))


def test_fold_scale_consistent():
    """fold_scale rescales the unconstrained rows; identity rows stay."""
    op_t, op_j = _ops("uniform", 2, "gauss_lobatto", "poisson", "separable")
    op_t.fold_scale(0.37)
    op_j.fold_scale(0.37)
    A = assemble_dense(op_t)
    _close(A, assemble_dense_j(op_j))
    _close(_dense_from_vmult(op_t), A, tol=1e-10)


def test_max_dofs_guard():
    space = pt.FESpace.create(pt.BrickMesh((8, 8, 8)), 3, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="max_dofs"):
        assemble_dense(PoissonOperator(space, backend="separable"), max_dofs=1000)


def test_operator_without_weak_form_raises():
    space = pt.FESpace.create(pt.BrickMesh((2, 2, 2)), 2, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="weak_form"):
        assemble_dense(MatrixFreeOperator(space, "structured"))


@pytest.mark.parametrize("case", ["poisson-uniform-gll", "helmholtz-gauss"])
def test_bounds_from_dense_matches_jax(case):
    """The seeded host power iteration: the port's bounds equal the JAX
    package's to 1e-14 and cover the spectrum of D^-1 A."""
    op_t, op_j = _ops(*CASES[case])
    A = assemble_dense(op_t)
    lo, hi = bounds_from_dense(A, smoothing_range=20.0)
    lo_j, hi_j = bounds_j(assemble_dense_j(op_j), smoothing_range=20.0)
    np.testing.assert_allclose([lo, hi], [lo_j, hi_j], rtol=1e-14)
    d = np.diag(A)
    lam_true = np.max(np.linalg.eigvalsh(A / np.sqrt(np.outer(d, d))))
    assert lam_true <= hi <= 1.6 * lam_true
    np.testing.assert_allclose(lo, hi / 20.0)
