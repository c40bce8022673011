"""Adaptive (hanging-node) meshes of the port (adaptive.py) against the JAX
package's, on the cases of tests/test_adaptive.py: AdaptiveMesh (origins,
sizes, levels, the 2:1 balance) and AdaptiveSpace (DoFs, masks, the hanging
triplets) exactly; the Poisson and Helmholtz vmults on both cell-apply
backends (``general``: K4's plain version here; ``gather``: the torch loop)
to 1e-12 relative in f64 and against the scipy C^T A C oracle; polynomial
exactness of distribute, symmetry, condense as distribute's transpose;
assemble_rhs_adaptive; the solve against a sparse direct one; the adaptive
checkpoint round trip; the oracle copy; the backend names; on a card, K4
against the plain loop and a bitwise repeated apply."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch import adaptive as ta
from deal_and_ceed_on_gpu_torch.utils.oracle import element_matrix

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
    from deal_and_ceed_on_gpu_tpu import adaptive as ja
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

VMULT_TOL = 1e-12  # relative to max|want|
BACKENDS = ("gather", "general")
# (base shape, marks, then refine these level-1 children): the JAX tests' meshes
MESHES = {
    "one-cell": ((2, 2, 2), (0,), ()),
    "two-cells": ((2, 2, 2), (0, 3), ()),
    "flat": ((2, 2, 1), (0, 1, 2), ()),
    "two-level": ((2, 2, 2), (0,), (0,)),
    "two-level-flat": ((2, 2, 1), (0,), (3,)),
}


def _meshes(name):
    """The same adaptive mesh in both packages."""
    shape, marks, children = MESHES[name]
    out = []
    for mod, amod in ((pt, ta), (jx, ja)):
        m = amod.AdaptiveMesh.refine(mod.BrickMesh(shape), marks)
        if children:
            lv1 = np.flatnonzero(m.levels == 1)
            m = m.refine_active(tuple(int(lv1[c]) for c in children))
        out.append(m)
    return out


def _spaces(name, p, dtype=torch.float64):
    tm, jm = _meshes(name)
    return ta.AdaptiveSpace(tm, p, dtype=dtype, device="cpu"), ja.AdaptiveSpace(jm, p)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_equals_jax(name):
    tm, jm = _meshes(name)
    for attr in ("origins", "sizes", "levels"):
        assert np.array_equal(getattr(tm, attr), getattr(jm, attr)), attr
    assert tm.lower == jm.lower and tm.upper == jm.upper
    assert tm.is_balanced() and jm.is_balanced()


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("name", ["one-cell", "flat", "two-level"])
def test_space_equals_jax(name, p):
    ts, js = _spaces(name, p)
    assert ts.n_dofs == js.n_dofs and ts.hanging_mask_np.sum() > 0
    np.testing.assert_array_equal(ts.node_coords, js.node_coords)
    np.testing.assert_array_equal(ts.elem_dof_map.numpy(), np.asarray(js.elem_dof_map))
    for attr in ("hanging_mask_np", "boundary_mask_np", "constrained_mask_np"):
        np.testing.assert_array_equal(getattr(ts, attr), getattr(js, attr))
    for attr in ("hang_rows", "hang_cols", "hang_w"):
        np.testing.assert_array_equal(getattr(ts, attr).numpy(), np.asarray(getattr(js, attr)))
    assert ts.elem_dof_map.dtype == torch.int32 and ts.constrained_mask.device == ts.device


def _assemble_full(space):
    """Sparse stiffness over all active cells (no constraints)."""
    rows, cols, vals = [], [], []
    base = pt.BrickMesh((1, 1, 1))
    for e in range(space.mesh.n_cells):
        Ae = element_matrix(base, space.basis, "stiffness", h_cell=tuple(space.mesh.sizes[e]))
        idx = space._dof_map_np[e]
        rows.append(np.repeat(idx, idx.size))
        cols.append(np.tile(idx, idx.size))
        vals.append(Ae.reshape(-1))
    n = space.n_dofs
    return sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)).tocsr()


def _oracle_vmult(space, A, u):
    C = space.constraint_matrix()
    mask = space.constrained_mask_np
    v = C.T @ (A @ (C @ np.where(mask, 0.0, u)))
    v = np.where(space.hanging_mask_np, 0.0, v)
    return np.where(mask, u, v)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("name", ["one-cell", "two-cells", "flat", "two-level"])
def test_vmult_matches_jax_and_oracle(name, p):
    """Poisson and Helmholtz on both backends against the JAX ``xla`` vmult
    (1e-12 relative), Poisson also against the scipy C^T A C oracle."""
    ts, js = _spaces(name, p)
    A = _assemble_full(ts)
    rng = np.random.default_rng(0)
    for _ in range(2):
        u = rng.standard_normal(ts.n_dofs)
        for tcls, jcls in ((ta.AdaptivePoissonOperator, ja.AdaptivePoissonOperator),
                           (ta.AdaptiveHelmholtzOperator, ja.AdaptiveHelmholtzOperator)):
            want = np.asarray(jcls(js, backend="xla").vmult(jnp.asarray(u)))
            for backend in BACKENDS:
                got = tcls(ts, backend=backend).vmult(torch.as_tensor(u)).numpy()
                np.testing.assert_allclose(got, want, rtol=0, atol=VMULT_TOL * np.abs(want).max(),
                                           err_msg=f"{tcls.__name__} {backend}")
        np.testing.assert_allclose(ta.AdaptivePoissonOperator(ts, backend="general").vmult(torch.as_tensor(u)).numpy(),
                                   _oracle_vmult(ts, A, u), rtol=1e-11, atol=1e-11)


def test_f32_vmult_matches_f64():
    ts, _ = _spaces("two-level", 2)
    s32, _ = _spaces("two-level", 2, torch.float32)
    u = np.random.default_rng(1).standard_normal(ts.n_dofs)
    want = ta.AdaptivePoissonOperator(ts, backend="gather").vmult(torch.as_tensor(u))
    for backend in BACKENDS:
        got = ta.AdaptivePoissonOperator(s32, backend=backend).vmult(torch.as_tensor(u, dtype=torch.float32))
        assert got.dtype == torch.float32
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name,p", [("two-cells", 3), ("two-level", 2)])
def test_distribute_exact_for_polynomials(name, p):
    """distribute() reproduces tensor polynomials of degree <= p at every
    hanging node, through chains (tests/test_adaptive.py's two cases); no
    master is hanging."""
    ts, _ = _spaces(name, p)
    x = ts.node_coords

    def f(x):
        if p == 3:
            return 1.0 + 2.0 * x[:, 0] ** 3 - x[:, 1] ** 2 * x[:, 0] + 0.5 * x[:, 2] ** 3 * x[:, 1] ** 3
        return 0.5 + x[:, 0] ** 2 - 2.0 * x[:, 1] * x[:, 2] + x[:, 2] ** 2 * x[:, 0]

    np.testing.assert_allclose(ts.distribute(torch.as_tensor(f(x))).numpy(), f(x), rtol=1e-12, atol=1e-12)
    assert not ts.hanging_mask_np[ts.hang_cols.numpy()].any()


def test_condense_is_the_transpose_of_distribute():
    ts, js = _spaces("two-level", 2)
    rng = np.random.default_rng(4)
    u, v = rng.standard_normal(ts.n_dofs), rng.standard_normal(ts.n_dofs)
    _, vjp = torch.func.vjp(ts.distribute, torch.as_tensor(u))
    np.testing.assert_allclose(vjp(torch.as_tensor(v))[0].numpy(), ts.condense(torch.as_tensor(v)).numpy(),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(ts.condense(torch.as_tensor(v)).numpy(), np.asarray(js.condense(jnp.asarray(v))),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(ts.distribute(torch.as_tensor(u)).numpy(), np.asarray(js.distribute(jnp.asarray(u))),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("backend", BACKENDS)
def test_operator_is_symmetric(backend):
    ts, _ = _spaces("flat", 2)
    op = ta.AdaptivePoissonOperator(ts, backend=backend)
    M = torch.stack([op.vmult(e) for e in torch.eye(ts.n_dofs, dtype=torch.float64)], dim=1).numpy()
    np.testing.assert_allclose(M, M.T, atol=1e-12)


@pytest.mark.parametrize("name", ["two-cells", "two-level-flat"])
def test_rhs_matches_jax_and_solve_matches_direct(name):
    """assemble_rhs_adaptive (constant and callable f) against JAX; merged
    CG on the adaptive operator against a sparse direct solve of the
    constrained system, and the hanging values interpolate."""
    import scipy.sparse.linalg as spla

    ts, js = _spaces(name, 2)

    def f(x):
        return 1.0 + x[..., 0] * x[..., 1] - x[..., 2]

    for rhs in (1.0, f):
        want = np.asarray(ja.assemble_rhs_adaptive(js, rhs))
        got = ta.assemble_rhs_adaptive(ts, rhs).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15 * np.abs(want).max())
    b = ta.assemble_rhs_adaptive(ts, 1.0)
    A = _assemble_full(ts)
    C = ts.constraint_matrix()
    mask = ts.constrained_mask_np
    A_eff = (sp.diags((~mask).astype(float)) @ C.T @ A @ C @ sp.diags((~mask).astype(float))
             + sp.diags(mask.astype(float))).tocsc()
    x_direct = spla.spsolve(A_eff, b.numpy())
    op = ta.AdaptivePoissonOperator(ts, backend="general")
    x, _ = pt.solve_cg_merged(op.vmult, b, pt.SolverControl(800, 1e-12 * float(torch.linalg.vector_norm(b))))
    np.testing.assert_allclose(x.numpy(), x_direct, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(ts.distribute(x).numpy(), C @ x.numpy(), rtol=1e-12, atol=1e-13)


def test_refined_everything_matches_uniform():
    """Refining every cell gives a conforming mesh: no hanging nodes, and
    the solve matches the uniformly refined brick's (structured backend)."""
    ts, _ = _spaces("one-cell", 2)
    space_a = ta.AdaptiveSpace(ta.AdaptiveMesh.refine(pt.BrickMesh((2, 2, 2)), tuple(range(8))), 2, device="cpu")
    assert space_a.hanging_mask_np.sum() == 0 and ts.hanging_mask_np.sum() > 0
    b_a = ta.assemble_rhs_adaptive(space_a, 1.0)
    space_u = pt.FESpace.create(pt.BrickMesh((4, 4, 4)), 2, dtype=torch.float64, device="cpu")
    op_u = pt.PoissonOperator(space_u, backend="structured")
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs

    b_u = assemble_rhs(space_u, 1.0)
    control = pt.SolverControl(500, 1e-12 * float(torch.linalg.vector_norm(b_u)))
    x_a, _ = pt.solve_cg_merged(ta.AdaptivePoissonOperator(space_a, backend="general").vmult, b_a, control)
    x_u, _ = pt.solve_cg_merged(op_u.vmult, b_u, control)
    key = {tuple(c): i for i, c in enumerate(np.round(space_a.node_coords / 1e-9).astype(np.int64))}
    perm = np.array([key[tuple(c)] for c in np.round(space_u.node_coords() / 1e-9).astype(np.int64)])
    np.testing.assert_allclose(x_a.numpy()[perm], x_u.numpy(), rtol=1e-9, atol=1e-11)


def test_adaptive_checkpoint_roundtrip(tmp_path):
    """An AMR state survives save / load (JAX tests/test_aux_subsystems.py):
    the same DoF numbering, the same solution, a resumed solve is a no-op;
    the port's file loads in the JAX package and back."""
    from deal_and_ceed_on_gpu_torch.utils.checkpoint import load_adaptive_state, save_adaptive_state
    from deal_and_ceed_on_gpu_tpu.utils.checkpoint import load_adaptive_state as load_j

    ts, _ = _spaces("two-cells", 2)
    op = ta.AdaptivePoissonOperator(ts)
    b = ta.assemble_rhs_adaptive(ts, 1.0)
    x, _ = pt.solve_cg(op.vmult, b, pt.ReductionControl(400, tolerance=0.0, reduction=1e-11))
    path = save_adaptive_state(tmp_path / "amr.npz", ts, x, meta={"step": 3})
    space2, x2, meta = load_adaptive_state(path, device="cpu")
    assert meta["step"] == 3 and space2.n_dofs == ts.n_dofs and space2.dtype == torch.float64
    assert torch.equal(space2.elem_dof_map, ts.elem_dof_map) and torch.equal(x2, x)
    b2 = ta.assemble_rhs_adaptive(space2, 1.0)
    abs_control = pt.SolverControl(400, 1e-10 * float(torch.linalg.vector_norm(b2)))
    _, info = pt.solve_cg(ta.AdaptivePoissonOperator(space2).vmult, b2, abs_control, x0=x2)
    assert int(info["n_iterations"]) <= 1
    js, xj, _ = load_j(path)
    assert js.n_dofs == ts.n_dofs and np.array_equal(np.asarray(xj), x.numpy())


def test_oracle_copy_matches_jax():
    """utils/oracle.py is the JAX package's: element matrices, the sparse
    assemblies (tensor-product and from the geometry tables, graded and
    mapped meshes) and the constrained forms, to 1e-14."""
    from deal_and_ceed_on_gpu_torch.utils import oracle as ot
    from deal_and_ceed_on_gpu_tpu.utils import oracle as oj

    graded = (np.array([0.0, 0.3, 1.0]), np.linspace(0, 1, 3), np.array([0.0, 0.6, 1.0]))
    for kind in ("stiffness", "mass", "helmholtz"):
        meshes = [pt.BrickMesh.graded(*graded), jx.BrickMesh.graded(*graded)]
        bt, bj = pt.Basis1D.make(2, 4, "gauss"), jx.Basis1D.make(2, 4, "gauss")
        fn = pt.models.default_coefficient if kind == "helmholtz" else None
        a = ot.assemble_sparse(meshes[0], bt, kind, fn).toarray()
        np.testing.assert_allclose(a, oj.assemble_sparse(meshes[1], bj, kind, fn).toarray(), rtol=0, atol=1e-14)
        mapped = [m.deform(*mod.sine_map(0.05)) for m, mod in zip(meshes, (pt, jx))]
        g = ot.assemble_sparse_general(mapped[0], bt, kind, fn)
        np.testing.assert_allclose(g.toarray(), oj.assemble_sparse_general(mapped[1], bj, kind, fn).toarray(),
                                   rtol=0, atol=1e-14 * np.abs(g.toarray()).max())
    mask = meshes[0].boundary_dof_mask(2)
    u = np.random.default_rng(0).standard_normal(mask.size)
    np.testing.assert_array_equal(ot.apply_constrained(g, mask, u), oj.apply_constrained(g, mask, u))
    np.testing.assert_array_equal(ot.constrained_matrix(g, mask).toarray(), oj.constrained_matrix(g, mask).toarray())


def test_backend_names():
    """``auto`` is the plain loop on the CPU (K4 on a CUDA device); the JAX
    package's names are refused with the port's."""
    ts, _ = _spaces("one-cell", 2)
    assert ta.AdaptivePoissonOperator(ts).backend == "gather"
    for jax_name, port_name in (("xla", "gather"), ("pallas", "general"), ("pallas_general", "general")):
        with pytest.raises(ValueError, match=port_name):
            ta.AdaptivePoissonOperator(ts, backend=jax_name)
    with pytest.raises(ValueError, match="unknown"):
        ta.AdaptiveHelmholtzOperator(ts, backend="structured")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k4_matches_plain_loop_on_card(cuda_device, dtype, tol):
    """On the card ``auto`` is K4 in both precisions; Poisson and Helmholtz
    agree with the plain loop, and a second apply is bitwise the first."""
    from deal_and_ceed_on_gpu_torch.ops import general

    mesh = ta.AdaptiveMesh.refine(pt.BrickMesh((4, 4, 4)), (0, 5, 21, 42))
    space = ta.AdaptiveSpace(mesh, 2, dtype=dtype, device=cuda_device)
    u = space.tensor(np.random.default_rng(0).standard_normal(space.n_dofs))
    for cls in (ta.AdaptivePoissonOperator, ta.AdaptiveHelmholtzOperator):
        op = cls(space)
        assert op.backend == "general"
        n0 = general.LAUNCHES
        a, b = op.vmult(u), op.vmult(u)
        assert general.LAUNCHES == n0 + 2 and torch.equal(a, b)
        want = cls(space, backend="gather").vmult(u)
        assert float((a - want).abs().max()) <= tol * float(want.abs().max())
