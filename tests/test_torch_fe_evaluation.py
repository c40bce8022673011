"""FEEvaluation of the port (fe_evaluation.py) on the structured and gather
transfers: the three cases of tests/test_fe_evaluation.py — a hand-written
Poisson cell kernel equals the built-in operator and the JAX package's
hand-written kernel, physical gradients of a linear field, a hand-written
mass kernel on a graded mesh."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.fe_evaluation import FEEvaluation
from deal_and_ceed_on_gpu_torch.models import MassOperator, PoissonOperator

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.fe_evaluation import FEEvaluation as FEEvaluationJ
except ImportError:  # the card's machine has no jax
    jnp = None

BACKENDS = ("structured", "gather")


def _poisson_by_hand(fe, space, src):
    src_i = space.zero_constrained_values(src)
    _, grads = fe.evaluate(fe.read_dof_values(src_i), values=False, gradients=True)
    dst = fe.distribute_local_to_global(fe.integrate(None, fe.submit_gradient(grads)))
    return space.copy_constrained_values(src, dst)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
def test_hand_written_poisson_kernel(backend, rule):
    ts = pt.FESpace.create(pt.BrickMesh((2, 3, 2), upper=(1.0, 1.2, 0.7)), 3, rule=rule, dtype=torch.float64,
                           device="cpu")
    js = jx.FESpace.create(jx.BrickMesh((2, 3, 2), upper=(1.0, 1.2, 0.7)), 3, rule=rule, dtype=jnp.float64)
    u = np.random.default_rng(0).standard_normal(ts.n_dofs)
    got = _poisson_by_hand(FEEvaluation(ts, backend), ts, torch.as_tensor(u))
    want = PoissonOperator(ts, backend=backend).vmult(torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    want_j = np.asarray(_poisson_by_hand(FEEvaluationJ(js, backend), js, jnp.asarray(u)))
    np.testing.assert_allclose(got.numpy(), want_j, rtol=0, atol=1e-14 * np.abs(want_j).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_get_gradient_physical(backend):
    """A field linear in physical x has its constant gradient at every
    quadrature point, on an anisotropic brick and a mapped mesh."""
    a = np.array([0.7, -1.3, 2.1])
    for mesh in (pt.BrickMesh((3, 2, 2), upper=(1.0, 1.3, 0.8)), pt.BrickMesh((3, 3, 3)).deform(*pt.sine_map(0.04))):
        space = pt.FESpace.create(mesh, 3, rule="gauss", dtype=torch.float64, device="cpu")
        fe = FEEvaluation(space, backend)
        _, grads = fe.evaluate(fe.read_dof_values(torch.as_tensor(space.node_coords() @ a)), gradients=True)
        for comp, want in zip(fe.get_gradient(grads), a):
            np.testing.assert_allclose(comp.numpy(), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hand_written_mass_kernel_graded(backend):
    mesh = pt.BrickMesh.graded(np.array([0.0, 0.1, 0.4, 1.0]), np.linspace(0, 1, 4), np.linspace(0, 1, 3))
    space = pt.FESpace.create(mesh, 2, rule="gauss", n_q=4, dtype=torch.float64, device="cpu")
    fe = FEEvaluation(space, backend)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(space.n_dofs))
    src_i = space.zero_constrained_values(u)
    vals, _ = fe.evaluate(fe.read_dof_values(src_i), values=True)
    got = space.copy_constrained_values(u, fe.distribute_local_to_global(fe.integrate(fe.submit_value(vals))))
    np.testing.assert_allclose(got.numpy(), MassOperator(space).vmult(u).numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="structured or gather"):
        FEEvaluation(space, "general")
