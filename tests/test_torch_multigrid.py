"""The geometric multigrid of the port (solvers/multigrid.py) against the JAX
package's, on the cases of tests/test_multigrid.py: prolongation_1d and
coarsen_mesh (exact), chebyshev_smooth, bounds per level, one V-cycle
(1e-11) and MG-CG (iterations equal, solutions 1e-8) on uniform, graded and
mapped meshes and Helmholtz, the vector V-cycle, symmetry, the guards, the
levels on the kernel backends (their plain versions here) and the coarse
matrix of an operator without a weak form, the products in full f32 with
TF32 on; on a card, K1 and K4 at the levels' shapes of the full-size cases
against their plain versions and the f32 V-cycle with TF32 on. The entry
points (step-64 --precond mg, bp5's new modes, scripts/bench_solvers_r3)
are in tests/test_torch_solvers_r3.py."""

import functools

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, PoissonOperator, VectorOperator, assemble_rhs
from deal_and_ceed_on_gpu_torch.solvers import multigrid as mgt

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
    from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
    from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
    from deal_and_ceed_on_gpu_tpu.models.vector import VectorOperator as VectorJ
    from deal_and_ceed_on_gpu_tpu.solvers import multigrid as mgj
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

VCYCLE_TOL = 1e-11  # one V-cycle, relative to max|want|
SOLUTION_TOL = 1e-8  # MG-CG solutions, relative
GRADED_X = np.cumsum(np.r_[0, 0.6 ** np.arange(8)[::-1]]) / np.sum(0.6 ** np.arange(8))

# name: (mesh kind, p, rule, model, port backend, JAX backend, coarse_max_dofs)
CASES = {
    "uniform-gll": ("uniform4", 3, "gauss_lobatto", "poisson", "separable", "separable", 500),
    "graded-gll": ("graded", 2, "gauss_lobatto", "poisson", "separable", "separable", 1000),
    "mapped-gauss": ("mapped", 2, "gauss", "poisson", "structured", "structured", 500),
    "helmholtz-gauss": ("uniform8", 3, "gauss", "helmholtz", "structured", "structured", 2000),
}
# the same systems with every level on a kernel backend (plain versions on the CPU)
KERNEL_CASES = {
    "uniform-gll": "stencil",
    "graded-gll": "banded",
    "mapped-gauss": "general",
    "helmholtz-gauss": "qgrid",
}


def _meshes(kind):
    out = []
    for mod in (pt, jx):
        if kind == "uniform4":
            out.append(mod.BrickMesh((4, 4, 4)))
        elif kind == "uniform8":
            out.append(mod.BrickMesh((8, 8, 8)))
        elif kind == "graded":
            out.append(mod.BrickMesh.graded(GRADED_X, np.linspace(0, 1, 9), np.linspace(0, 1, 9)))
        else:
            out.append(mod.BrickMesh((4, 4, 4)).deform(*mod.sine_map(0.04)))
    return out


@functools.cache
def _port_case(case, backend):
    kind, p, rule, model, _, _, coarse = CASES[case]
    st = pt.FESpace.create(_meshes(kind)[0], p, rule=rule, dtype=torch.float64, device="cpu")
    cls = PoissonOperator if model == "poisson" else HelmholtzOperator
    op = cls(st, backend=backend)
    return st, op, pt.Multigrid(st, make_op=lambda s: cls(s, backend=backend), fine_op=op, coarse_max_dofs=coarse)


@functools.cache
def _jax_case(case):
    kind, p, rule, model, _, bj, coarse = CASES[case]
    sj = jx.FESpace.create(_meshes(kind)[1], p, rule=rule, dtype=jnp.float64)
    cls = PoissonJ if model == "poisson" else HelmholtzJ
    op = cls(sj, backend=bj)
    return sj, op, mgj.Multigrid(sj, make_op=lambda s: cls(s, backend=bj), fine_op=op, coarse_max_dofs=coarse)


def _setup(case, backend=None):
    """(space, op, mg) of the port and of the JAX package for one case; the
    port's levels on ``backend`` (default: the case's). Built once per case
    and backend: the tests only apply them."""
    return _port_case(case, backend or CASES[case][4]), _jax_case(case)


@functools.cache
def _jax_mg_cg(case):
    """(solution, iterations) of the JAX MG-CG of one case."""
    sj, op_j, mg_j = _jax_case(case)
    _, xj, itj = _mg_cg(sj, op_j, mg_j, jx, rhs_j)
    return np.asarray(xj), itj


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _mg_cg(space, op, mg, mod, rhs, reduction=1e-10, max_it=80):
    b = rhs(space, 1.0)
    control = mod.ReductionControl(max_it, tolerance=0.0, reduction=reduction)
    x, info = mod.solve_cg(op.vmult, b, control, diag=mg.vcycle)
    return b, x, int(info["n_iterations"])


# --------------------------- components --------------------------- #
@pytest.mark.parametrize("p,mc", [(1, 1), (3, 2), (5, 3)])
@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
@pytest.mark.parametrize("graded", [False, True])
def test_prolongation_1d_matches_jax_exactly(p, mc, rule, graded):
    nodes = pt.Basis1D.make(p, rule=rule).nodes
    widths = np.random.default_rng(p).random(2 * mc) + 0.1 if graded else None
    np.testing.assert_array_equal(mgt.prolongation_1d(mc, p, nodes, widths), mgj.prolongation_1d(mc, p, nodes, widths))


def test_prolongation_exact_on_polynomials():
    p, mc = 3, 2
    nodes = pt.Basis1D.make(p).nodes
    P = mgt.prolongation_1d(mc, p, nodes)
    xc = np.concatenate([nodes / mc, 1 / mc + nodes[1:] / mc])
    mf = 2 * mc
    xf = np.concatenate([nodes / mf] + [e / mf + nodes[1:] / mf for e in range(1, mf)])
    for k in range(p + 1):
        np.testing.assert_allclose(P @ xc**k, xf**k, atol=1e-13)


def test_coarsen_mesh_matches_jax():
    bks = (np.array([0, 0.1, 0.3, 0.4, 1.0]), np.array([0, 0.5, 1.0]), np.array([0, 0.2, 1.0]))
    ct, cj = mgt.coarsen_mesh(pt.BrickMesh.graded(*bks)), mgj.coarsen_mesh(jx.BrickMesh.graded(*bks))
    assert ct.n_elements == cj.n_elements == (2, 1, 1)
    for a, b in zip(ct.widths, cj.widths):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ct.widths[0], [0.3, 0.7])
    mt = pt.BrickMesh((4, 6, 8)).deform(*pt.sine_map(0.05))
    c = mgt.coarsen_mesh(mt)
    assert isinstance(c, pt.MappedMesh) and c.mapping is mt.mapping and c.n_elements == (2, 3, 4)
    with pytest.raises(AssertionError):
        mgt.coarsen_mesh(pt.BrickMesh((3, 2, 2)))


@pytest.mark.parametrize("z0", [False, True])
def test_chebyshev_smooth_matches_jax(z0):
    (st, op_t, mg_t), (sj, op_j, mg_j) = _setup("uniform-gll")
    rng = np.random.default_rng(1)
    r = st.zero_constrained_values(torch.as_tensor(rng.standard_normal(st.n_dofs)))
    z = torch.as_tensor(rng.standard_normal(st.n_dofs)) if z0 else None
    bounds = mg_t.bounds[0]
    got = mgt.chebyshev_smooth(op_t.vmult, mg_t.dinv[0], bounds, 4, r, z)
    want = mgj.chebyshev_smooth(op_j.vmult, mg_j.dinv[0], tuple(float(v) for v in bounds), 4, jnp.asarray(r.numpy()),
                                None if z is None else jnp.asarray(z.numpy()))
    _close(got.numpy(), want, 1e-12)


def test_per_level_and_explicit_bounds():
    """bounds="per-level" (a power iteration per level) against the JAX
    package's to 1e-10; an explicit pair on every level; bad bounds raise."""
    _, p, rule, _, bt, bj, coarse = CASES["uniform-gll"]
    st = pt.FESpace.create(pt.BrickMesh((4, 4, 4)), p, rule=rule, dtype=torch.float64, device="cpu")
    sj = jx.FESpace.create(jx.BrickMesh((4, 4, 4)), p, rule=rule, dtype=jnp.float64)
    got = pt.Multigrid(st, coarse_max_dofs=coarse, bounds="per-level").bounds
    want = mgj.Multigrid(sj, coarse_max_dofs=coarse, bounds="per-level").bounds
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10)
    assert pt.Multigrid(st, coarse_max_dofs=coarse, bounds=(0.1, 2.0)).bounds == [(0.1, 2.0)]
    with pytest.raises(ValueError, match="expected 'coarse'"):
        pt.Multigrid(st, coarse_max_dofs=coarse, bounds="power")
    with pytest.raises(ValueError, match="explicit bounds"):
        pt.Multigrid(st, coarse_max_dofs=coarse, bounds=(0.1, 1.0, 2.0))


# ----------------------------- V-cycle ----------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_vcycle_matches_jax(case):
    (st, _, mg_t), (sj, _, mg_j) = _setup(case)
    assert mg_t.n_levels == mg_j.n_levels >= 2
    assert [s.grid_shape for s in mg_t.spaces] == [tuple(s.grid_shape) for s in mg_j.spaces]
    assert all(s.device == st.device for s in mg_t.spaces)  # the levels live on the fine space's device
    np.testing.assert_allclose(np.asarray(mg_t.bounds), np.asarray(mg_j.bounds), rtol=1e-14)
    r = np.random.default_rng(2).standard_normal(st.n_dofs)
    _close(mg_t.vcycle(torch.as_tensor(r)).numpy(), mg_j.vcycle(jnp.asarray(r)), VCYCLE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_mg_cg_matches_jax(case):
    """MG-CG to 1e-10: iterations equal to JAX's, solutions to 1e-8, a true
    residual of 5e-10."""
    (st, op_t, mg_t), _ = _setup(case)
    b, x, it = _mg_cg(st, op_t, mg_t, pt, assemble_rhs)
    xj, itj = _jax_mg_cg(case)
    assert it == itj <= 14
    assert float(torch.linalg.vector_norm(b - op_t.vmult(x)) / torch.linalg.vector_norm(b)) < 5e-10
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=SOLUTION_TOL, atol=1e-12)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_levels_on_the_kernel_backends(case):
    """Every level on a kernel backend (K1 stencil, K2 banded, K4 general, K3
    qgrid; their plain versions on the CPU): the JAX V-cycle on its plain
    backend to 1e-10, and its MG-CG."""
    backend = KERNEL_CASES[case]
    (st, op_t, mg_t), (sj, op_j, mg_j) = _setup(case, backend)
    assert [o.backend for o in mg_t.ops] == [backend] * mg_t.n_levels
    r = np.random.default_rng(3).standard_normal(st.n_dofs)
    _close(mg_t.vcycle(torch.as_tensor(r)).numpy(), mg_j.vcycle(jnp.asarray(r)), 1e-10)
    _, x, it = _mg_cg(st, op_t, mg_t, pt, assemble_rhs)
    xj, itj = _jax_mg_cg(case)
    assert it == itj
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=SOLUTION_TOL, atol=1e-12)


def test_vcycle_is_symmetric():
    """<M r, s> == <r, M s> to 1e-11: plain CG needs it."""
    space = pt.FESpace.create(pt.BrickMesh((4, 4, 4)), 3, dtype=torch.float64, device="cpu")
    mg = pt.Multigrid(space, coarse_max_dofs=500)
    rng = np.random.default_rng(3)
    r = space.zero_constrained_values(torch.as_tensor(rng.standard_normal(space.n_dofs)))
    s = space.zero_constrained_values(torch.as_tensor(rng.standard_normal(space.n_dofs)))
    np.testing.assert_allclose(float(torch.dot(mg.vcycle(r), s)), float(torch.dot(r, mg.vcycle(s))), rtol=1e-11)


def test_vcycle_vector_matches_jax():
    """BP6-style 3-component stiffness with the per-component V-cycle: the
    JAX iterations and solution, and the scalar solve per component."""
    st = pt.FESpace.create(pt.BrickMesh((8, 8, 8)), 2, dtype=torch.float64, device="cpu")
    sj = jx.FESpace.create(jx.BrickMesh((8, 8, 8)), 2, dtype=jnp.float64)
    sop_t, sop_j = PoissonOperator(st, backend="separable"), PoissonJ(sj, backend="separable")
    mg_t, mg_j = pt.Multigrid(st, coarse_max_dofs=2000), mgj.Multigrid(sj, coarse_max_dofs=2000)
    b1 = assemble_rhs(st, 1.0)
    b = torch.stack([b1, 2.0 * b1, -b1])
    control = pt.ReductionControl(60, tolerance=0.0, reduction=1e-10)
    x, info = pt.solve_cg(VectorOperator(sop_t, 3).vmult, b, control, diag=mg_t.vcycle_vector)
    bj = jnp.asarray(b.numpy())
    xj, ij = jx.solve_cg(VectorJ(sop_j, 3).vmult, bj, jx.ReductionControl(60, tolerance=0.0, reduction=1e-10),
                         diag=mg_j.vcycle_vector)
    assert info["n_iterations"] == int(ij["n_iterations"]) <= 12
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=SOLUTION_TOL, atol=1e-13)
    x1, _ = pt.solve_cg(sop_t.vmult, b1, control, diag=mg_t.vcycle)
    np.testing.assert_allclose(x[1].numpy(), 2 * x1.numpy(), rtol=1e-9, atol=1e-13)


def test_operator_without_weak_form_uses_its_vmult():
    """An operator without weak_form(): the coarse matrix comes from its
    vmult over identity columns, and the V-cycle is the same to 1e-12."""

    class NoWeakForm(PoissonOperator):
        def weak_form(self):
            raise NotImplementedError

    space = pt.FESpace.create(pt.BrickMesh((4, 4, 4)), 2, dtype=torch.float64, device="cpu")
    mg_a = pt.Multigrid(space, make_op=lambda s: NoWeakForm(s, backend="separable"), coarse_max_dofs=400)
    mg_b = pt.Multigrid(space, make_op=lambda s: PoissonOperator(s, backend="separable"), coarse_max_dofs=400)
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(space.n_dofs))
    _close(mg_a.vcycle(r).numpy(), mg_b.vcycle(r).numpy(), 1e-12)


def test_guards():
    space = pt.FESpace.create(pt.BrickMesh((5, 5, 5)), 3, dtype=torch.float64, device="cpu")  # 4096 > 4000
    with pytest.raises(ValueError, match="cannot coarsen"):
        pt.Multigrid(space)
    space = pt.FESpace.create(pt.BrickMesh((10, 10, 10)), 5, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="stop halving too early"):
        pt.Multigrid(space)


def test_small_mesh_degenerates_to_dense_direct():
    space = pt.FESpace.create(pt.BrickMesh((3, 3, 3)), 2, dtype=torch.float64, device="cpu")
    op = PoissonOperator(space, backend="separable")
    mg = pt.Multigrid(space)
    assert mg.n_levels == 1
    b, x, it = _mg_cg(space, op, mg, pt, assemble_rhs)
    assert it <= 2
    assert float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b)) < 1e-10


def test_f32_products_run_in_full_f32(monkeypatch):
    """With TF32 turned on by the caller, every product of the f32 V-cycle
    (transfers, coarse solve, the levels' applies) and of FDM runs with it
    off, and the caller's settings hold again afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    seen = []
    tensordot, matmul = torch.tensordot, torch.Tensor.__matmul__

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()

    def spy_tensordot(*a, **kw):
        seen.append(flags())
        return tensordot(*a, **kw)

    def spy_matmul(self, other):
        seen.append(flags())
        return matmul(self, other)

    monkeypatch.setattr(torch, "tensordot", spy_tensordot)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy_matmul)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        space = pt.FESpace.create(pt.BrickMesh((4, 4, 4)), 3, dtype=torch.float32, device="cpu")
        r = torch.ones(space.n_dofs)
        pt.Multigrid(space, coarse_max_dofs=500).vcycle(r)
        pt.FDMSolver(space).apply(r)
        assert len(seen) > 10 and set(seen) == {(False, "highest")}
        assert flags() == (True, "high")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# ------------------------------ card ------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K4 are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _levels(mesh, p):
    meshes = [mesh]
    while all(m % 2 == 0 for m in meshes[-1].n_elements) and meshes[-1].n_dofs(p) > 4000:
        meshes.append(mgt.coarsen_mesh(meshes[-1]))
    return meshes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
def test_k1_at_the_level_grids_on_card(cuda_device, dtype, tol):
    """K1 on every level grid of the cycle-26 cube (81×81×161 down to
    11×11×21), from a NaN-filled output, against its twin."""
    from deal_and_ceed_on_gpu_torch.ops import stencil as st

    for mesh in _levels(pt.BrickMesh.bp5_cycle(26), 5):
        tables = st.StencilTables.create(mesh, pt.Basis1D.make(5), dtype, cuda_device)
        u = torch.as_tensor(np.random.default_rng(0).standard_normal(tables.shape), dtype=dtype, device=cuda_device)
        before = st.LAUNCHES
        got = st.stencil_apply(u, tables, out=torch.full_like(u, float("nan")))
        torch.cuda.synchronize()
        assert st.LAUNCHES == before + 1
        want = st.stencil_apply_reference(u, tables)
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max() / want.abs().max()) <= tol, tables.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k4_at_the_level_element_counts_on_card(cuda_device, dtype, tol):
    """K4 with each level's real geometry of the sine-mapped 32^3 mesh (E =
    32768, 4096, 512, 64; GLL full6) against its plain version."""
    from deal_and_ceed_on_gpu_torch.ops import general as gk

    for mesh in _levels(pt.BrickMesh((32, 32, 32)).deform(*pt.sine_map(0.05)), 3):
        space = pt.FESpace.create(mesh, 3, dtype=dtype, device=cuda_device)
        op = PoissonOperator(space, backend="general")
        u = torch.as_tensor(np.random.default_rng(0).standard_normal(space.n_dofs), dtype=dtype, device=cuda_device)
        before = gk.LAUNCHES
        got = op.vmult(u)
        torch.cuda.synchronize()
        assert gk.LAUNCHES == before + 1
        want = PoissonOperator(space, backend="structured").vmult(u)
        assert float((got - want).abs().max() / want.abs().max()) <= tol, mesh.n_cells


@pytest.mark.cuda
def test_f32_vcycle_with_tf32_on_on_card(cuda_device):
    """TF32 turned on by the caller: the f32 V-cycle on K1 (transfers and
    the coarse product in full f32) agrees with the f64 one to 1e-5."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        mesh = pt.BrickMesh.bp5_cycle(20)
        r = np.random.default_rng(0).standard_normal(mesh.n_dofs(5))
        out = {}
        for dtype in (torch.float64, torch.float32):
            space = pt.FESpace.create(mesh, 5, dtype=dtype, device=cuda_device)
            mg = pt.Multigrid(space, make_op=lambda s: PoissonOperator(s, backend="stencil"))
            assert mg.n_levels >= 3
            out[dtype] = mg.vcycle(torch.as_tensor(r, dtype=dtype, device=cuda_device)).double()
        want = out[torch.float64]
        assert float((out[torch.float32] - want).abs().max() / want.abs().max()) <= 1e-5
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
