"""The indexed transfers of the port (ops/local_global.py: gather_indexed,
the deterministic SumPlan scatter, make_scatter_plan, scatter_indexed) and
the ``gather`` operator backend against the JAX package's, on the cases of
tests/test_local_global.py: indexed against structured, the plan against
the raw scatter, bitwise equal between two calls, parity with JAX to
1e-14; on a card, the plan's scatter bitwise repeatable."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, MassOperator, PoissonOperator
from deal_and_ceed_on_gpu_torch.ops import local_global as lg

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu import models as jmodels
    from deal_and_ceed_on_gpu_tpu.ops import local_global as lgj
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

PARITY_TOL = 1e-14


@pytest.mark.parametrize("shape,p", [((2, 2, 2), 1), ((2, 3, 1), 3), ((2, 2, 2), 5)])
def test_structured_matches_indexed(shape, p):
    """The indexed gather / scatter equal the structured ones (the JAX
    test's check), and the JAX package's indexed ones."""
    mesh = pt.BrickMesh(shape)
    n = mesh.n_dofs(p)
    dm = torch.as_tensor(mesh.element_dof_map(p))
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.standard_normal(n))
    g_idx = lg.gather_indexed(u, dm, p)
    g_str = lg.gather_structured(u.reshape(mesh.n_nodes(p)[::-1]), mesh.n_elements, p)
    mx, my, mz = mesh.n_elements
    g_str_b = g_str.reshape(mz, p + 1, my, p + 1, mx, p + 1).permute(0, 2, 4, 1, 3, 5).reshape(g_idx.shape)
    assert torch.equal(g_idx, g_str_b)
    assert np.array_equal(g_idx.numpy(), np.asarray(lgj.gather_indexed(jnp.asarray(u.numpy()), jnp.asarray(dm.numpy()), p)))

    v = rng.standard_normal(tuple(g_idx.shape))
    s_idx = lg.scatter_indexed(torch.as_tensor(v), dm, n)
    v_il = torch.as_tensor(v).reshape(mz, my, mx, p + 1, p + 1, p + 1).permute(0, 3, 1, 4, 2, 5)
    s_str = lg.scatter_structured(v_il, p).reshape(-1)
    np.testing.assert_allclose(s_idx.numpy(), s_str.numpy(), atol=1e-13)
    want = np.asarray(lgj.scatter_indexed(jnp.asarray(v), jnp.asarray(dm.numpy()), n))
    np.testing.assert_allclose(s_idx.numpy(), want, rtol=0, atol=PARITY_TOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scatter_plan_matches_raw_scatter(dtype):
    """The sorted plan against the JAX raw and sorted scatters (random map
    with duplicates and unused DoFs, as the JAX test), bitwise equal
    between two calls, and against a float64 numpy bincount."""
    rng = np.random.default_rng(8)
    n_dofs, E, p1 = 500, 64, 3
    emap = rng.integers(0, n_dofs, (E, p1**3)).astype(np.int32)
    v = rng.standard_normal((E, p1, p1, p1))
    plan = lg.make_scatter_plan(emap, n_dofs, device="cpu")
    vt = torch.as_tensor(v, dtype=dtype)
    got = lg.scatter_indexed_sorted(vt, plan, n_dofs)
    assert got.dtype == dtype and torch.equal(got, lg.scatter_indexed_sorted(vt, plan, n_dofs))
    exact = np.bincount(emap.reshape(-1), weights=vt.double().numpy().reshape(-1), minlength=n_dofs)
    tol = PARITY_TOL if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got.double().numpy(), exact, rtol=0, atol=tol * np.abs(exact).max())
    if dtype == torch.float64:
        jplan = lgj.make_scatter_plan(emap, n_dofs)
        for want in (lgj.scatter_indexed(jnp.asarray(v), jnp.asarray(emap), n_dofs),
                     lgj.scatter_indexed_sorted(jnp.asarray(v), jplan, n_dofs)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol * np.abs(exact).max())


def test_sum_plan_rows_weights_and_order():
    """A weighted plan on a subset of rows (the shape of distribute /
    condense): the row sums to rounding, bitwise the same on a second call,
    an empty row zero; the guards."""
    rng = np.random.default_rng(3)
    ids = rng.choice([2, 5, 9], size=40)
    src = rng.integers(0, 30, size=40)
    w = rng.standard_normal(40)
    plan = lg.make_sum_plan(ids, 12, weights=w, rows=[2, 5, 9, 11], src=src, n_in=30, device="cpu")
    x = rng.standard_normal(30)
    got = plan.sums(torch.as_tensor(x))
    assert torch.equal(got, plan.sums(torch.as_tensor(x)))
    want = np.zeros(12)
    for i, s, ww in zip(ids, src, w):
        want[i] += ww * x[s]
    np.testing.assert_allclose(got.numpy(), want[[2, 5, 9, 11]], rtol=0, atol=PARITY_TOL * np.abs(want).max())
    assert got[3] == 0 and plan.rows.tolist() == [2, 5, 9, 11]
    assert plan.slots.dtype == torch.int32 and tuple(plan.slots.shape) == (4, np.bincount(ids).max())
    with pytest.raises(ValueError, match="not among the rows"):
        lg.make_sum_plan(ids, 12, rows=[2, 5], src=src, n_in=30, device="cpu")
    with pytest.raises(ValueError, match="n_in"):
        lg.make_sum_plan(ids, 12, src=src, device="cpu")
    with pytest.raises(ValueError, match="30 entries"):
        plan.sums(torch.zeros(29, dtype=torch.float64))
    with pytest.raises(ValueError, match="not a scatter plan"):
        lg.scatter_indexed_sorted(torch.as_tensor(x), plan, 12)


@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
@pytest.mark.parametrize("kind", ["uniform", "mapped"])
def test_gather_backend_matches_jax(rule, kind):
    """PoissonOperator, HelmholtzOperator and MassOperator on ``gather``
    against the JAX ``gather`` backend (1e-14) and the port's
    ``structured``."""
    meshes = [mod.BrickMesh((2, 3, 2)) for mod in (pt, jx)]
    if kind == "mapped":
        meshes = [m.deform(*mod.sine_map(0.05)) for m, mod in zip(meshes, (pt, jx))]
    ts = pt.FESpace.create(meshes[0], 3, rule=rule, dtype=torch.float64, device="cpu")
    js = jx.FESpace.create(meshes[1], 3, rule=rule, dtype=jnp.float64)
    u = np.random.default_rng(0).standard_normal(ts.n_dofs)
    for cls, jcls in ((PoissonOperator, jmodels.PoissonOperator), (HelmholtzOperator, jmodels.HelmholtzOperator),
                      (MassOperator, jmodels.MassOperator)):
        want = np.asarray(jcls(js, backend="gather").vmult(jnp.asarray(u)))
        got = cls(ts, backend="gather").vmult(torch.as_tensor(u))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PARITY_TOL * np.abs(want).max(), err_msg=cls.__name__)
        ref = cls(ts, backend="structured").vmult(torch.as_tensor(u))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=PARITY_TOL * np.abs(want).max())
    assert ts.elem_dof_map.dtype == torch.int32 and ts.elem_dof_map.device == ts.device


def test_bp5_driver_gather_backend():
    """drivers/bp5 takes ``gather`` (the plain indexed cell loop): cycle 7's
    solve at the driver's 1e-6 matches the structured backend's to one
    iteration and its L2 norm to 5e-9 (the summation order moves the last
    iteration, as between the JAX package's backends)."""
    from deal_and_ceed_on_gpu_torch.drivers import bp5

    assert "gather" in bp5.BACKENDS
    kw = dict(modes=("pcg-merged",), device="cpu", dtype="float64", n_repetitions=1, n_iterations=50)
    got = bp5.run_cycle(7, backend="gather", **kw)
    want = bp5.run_cycle(7, backend="structured", **kw)
    assert abs(got["n_iterations"]["pcg-merged"] - want["n_iterations"]["pcg-merged"]) <= 1
    assert abs(got["l2_norm"] - want["l2_norm"]) <= 5e-9 * want["l2_norm"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scatter_plan_bitwise_repeatable_on_card(cuda_device):
    """On the card the plan's scatter has no atomics: two calls are bitwise
    equal, and agree with the CPU's plan to rounding."""
    rng = np.random.default_rng(8)
    emap = rng.integers(0, 20000, (4000, 27)).astype(np.int32)
    v = rng.standard_normal((4000, 27))
    for dtype in (torch.float64, torch.float32):
        plan = lg.make_scatter_plan(emap, 20000, device=cuda_device)
        vt = torch.as_tensor(v, dtype=dtype, device=cuda_device)
        a, b = (lg.scatter_indexed_sorted(vt, plan, 20000) for _ in range(2))
        assert torch.equal(a, b)
        cpu = lg.scatter_indexed_sorted(vt.cpu(), lg.make_scatter_plan(emap, 20000, device="cpu"), 20000)
        assert float((a.cpu() - cpu).abs().max()) <= (1e-14 if dtype == torch.float64 else 1e-5) * float(cpu.abs().max())
