"""The BP1-BP6 slice of the port (models/mass.py, models/vector.py,
models/bp.py, drivers/bp.py) against the JAX package in f64 on the CPU:
operator applies (1e-12 relative), converged pcg-merged solves (iterations
+-1, L2 norms 1e-10), the mass backends, graded bricks, and the sweep
driver's lines."""

import functools
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
import deal_and_ceed_on_gpu_tpu as jx
from deal_and_ceed_on_gpu_torch.drivers import bp as bp_t
from deal_and_ceed_on_gpu_torch.models import MassOperator, VectorOperator, make_bp_operator
from deal_and_ceed_on_gpu_torch.models import assemble_rhs as rhs_t
from deal_and_ceed_on_gpu_torch.models import l2_norm_function as l2_t
from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
from deal_and_ceed_on_gpu_tpu.models import l2_norm_function as l2_j
from deal_and_ceed_on_gpu_tpu.models import make_bp_operator as make_j
from deal_and_ceed_on_gpu_tpu.models.mass import MassOperator as MassJ

BPS = ["bp1", "bp2", "bp3", "bp4", "bp5", "bp6"]
ELEMENTS, DEGREE = (4, 4, 4), 3  # 2,197 DoFs a component
BREAKS = ([0, 0.2, 0.7, 1.0], [0, 0.4, 1.0, 1.3], [0, 0.3, 0.5, 1.2])


def _ncomp(bp):
    return 3 if bp in ("bp2", "bp4", "bp6") else 1


def _rhs(space, rhs, nc):
    b = rhs(space, 1.0)
    if nc == 1:
        return b
    return jnp.broadcast_to(b, (nc, b.shape[0])) if isinstance(b, jnp.ndarray) else b.expand(nc, -1).contiguous()


@functools.cache
def _jax_bp(bp):
    """The JAX operator's apply of a seeded vector and its converged
    pcg-merged solve (iterations, L2 norm of component 0)."""
    space, op = make_j(bp, jx.BrickMesh(ELEMENTS), DEGREE, dtype=jnp.float64)
    nc = _ncomp(bp)
    u = np.random.default_rng(3).standard_normal((nc, space.n_dofs) if nc > 1 else space.n_dofs)
    v = np.asarray(op.vmult(jnp.asarray(u)))
    b = _rhs(space, rhs_j, nc)
    x, info = jx.solve_cg_merged(op.vmult, b, jx.SolverControl(2000, 1e-12 * float(jnp.linalg.norm(b))))
    return u, v, int(info["n_iterations"]), float(l2_j(space, x if nc == 1 else x[0]))


def _port_bp(bp, **kw):
    return make_bp_operator(bp, pt.BrickMesh(ELEMENTS), DEGREE, dtype=torch.float64, device="cpu", **kw)


@pytest.mark.parametrize("bp", BPS)
def test_vmult_matches_jax(bp):
    u, want, _, _ = _jax_bp(bp)
    _, op = _port_bp(bp)
    assert op.backend == ("stencil" if bp in ("bp5", "bp6") else "banded")
    got = op.vmult(torch.as_tensor(u)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("bp", BPS)
def test_converged_solve_matches_jax(bp):
    """pcg-merged to 1e-12 |b| on the kernel backends (their plain versions
    here): the JAX iteration count +-1 and L2 norm to 1e-10."""
    _, _, it_j, l2j = _jax_bp(bp)
    space, op = _port_bp(bp)
    b = _rhs(space, rhs_t, _ncomp(bp))
    x, info = pt.solve_cg_merged(op.vmult, b, pt.SolverControl(2000, 1e-12 * float(torch.linalg.vector_norm(b))))
    assert x.shape == b.shape
    assert abs(info["n_iterations"] - it_j) <= 1
    l2 = float(l2_t(space, x if x.dim() == 1 else x[0]))
    assert abs(l2 - l2j) <= 1e-10 * l2j


@pytest.mark.parametrize("backend", ["separable", "structured"])
@pytest.mark.parametrize("bp", BPS)
def test_comparator_backends_match_the_kernel(bp, backend):
    u, want, _, _ = _jax_bp(bp)
    _, op = _port_bp(bp, backend=backend)
    got = op.vmult(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("graded", [False, True])
def test_mass_backends_agree(graded):
    """MassOperator on structured, separable, banded (K2) and qgrid (K3)
    against the JAX separable mass, Gauss q = p+2."""
    mt = pt.BrickMesh.graded(*BREAKS) if graded else pt.BrickMesh((3, 2, 4), upper=(1.0, 0.8, 1.3))
    mj = jx.BrickMesh.graded(*BREAKS) if graded else jx.BrickMesh((3, 2, 4), upper=(1.0, 0.8, 1.3))
    ts = pt.FESpace.create(mt, 3, n_q=5, rule="gauss", dtype=torch.float64, device="cpu")
    js = jx.FESpace.create(mj, 3, n_q=5, rule="gauss", dtype=jnp.float64)
    u = np.random.default_rng(8).standard_normal(ts.n_dofs)
    want = np.asarray(MassJ(js, backend="separable").vmult(jnp.asarray(u)))
    for backend in ("structured", "separable", "banded", "qgrid"):
        got = MassOperator(ts, backend=backend).vmult(torch.as_tensor(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max(), err_msg=backend)


def test_mass_diagonal_and_fold_scale_match_jax():
    ts = pt.FESpace.create(pt.BrickMesh.graded(*BREAKS), 2, n_q=4, rule="gauss", dtype=torch.float64, device="cpu")
    js = jx.FESpace.create(jx.BrickMesh.graded(*BREAKS), 2, n_q=4, rule="gauss", dtype=jnp.float64)
    jop = MassJ(js, backend="separable")
    jop.fold_scale(0.5)
    for backend in ("banded", "separable", "structured"):
        op = MassOperator(ts, backend=backend)
        op.fold_scale(0.5)
        np.testing.assert_allclose(op.compute_diagonal().numpy(), np.asarray(jop.compute_diagonal()),
                                   rtol=1e-13, atol=1e-15, err_msg=backend)
        u = np.random.default_rng(9).standard_normal(ts.n_dofs)
        np.testing.assert_allclose(op.vmult(torch.as_tensor(u)).numpy(), np.asarray(jop.vmult(jnp.asarray(u))),
                                   rtol=1e-12, atol=1e-14, err_msg=backend)


def test_pallas_general_mass_points_to_the_roadmap():
    ts = pt.FESpace.create(pt.BrickMesh((2, 2, 2)), 2, n_q=4, rule="gauss", dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="K4"):
        MassOperator(ts, backend="pallas_general")
    with pytest.raises(ValueError):
        MassOperator(ts, backend="stencil")


def test_bp3_graded_banded_matches_separable_and_jax():
    """BP3 on a graded brick: the per-element widths enter K2's tables
    axis by axis."""
    mt, mj = pt.BrickMesh.graded(*BREAKS), jx.BrickMesh.graded(*BREAKS)
    ts, op = make_bp_operator("bp3", mt, 3, dtype=torch.float64, device="cpu")
    _, sep = make_bp_operator("bp3", mt, 3, dtype=torch.float64, backend="separable", device="cpu")
    js, jop = make_j("bp3", mj, 3, dtype=jnp.float64)
    assert op.backend == "banded"
    u = np.random.default_rng(4).standard_normal(ts.n_dofs)
    got = op.vmult(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, sep.vmult(torch.as_tensor(u)).numpy(), rtol=0, atol=1e-12 * np.abs(got).max())
    np.testing.assert_allclose(got, np.asarray(jop.vmult(jnp.asarray(u))), rtol=0, atol=1e-12 * np.abs(got).max())
    # a collocated BP5 on a graded brick takes K2 too (K1 needs a uniform brick)
    _, op5 = make_bp_operator("bp5", mt, 3, dtype=torch.float64, device="cpu")
    _, sep5 = make_bp_operator("bp5", mt, 3, dtype=torch.float64, backend="separable", device="cpu")
    assert op5.backend == "banded"
    np.testing.assert_allclose(op5.vmult(torch.as_tensor(u)).numpy(), sep5.vmult(torch.as_tensor(u)).numpy(),
                               rtol=0, atol=1e-12 * np.abs(got).max())


@pytest.mark.parametrize("bp", ["bp2", "bp6"])
def test_vector_operator_helpers(bp):
    space, op = _port_bp(bp)
    assert isinstance(op, VectorOperator) and op.n_components == 3
    assert tuple(op.initialize_dof_vector().shape) == (3, space.n_dofs)
    d = op.jacobi_preconditioner()
    assert tuple(d.shape) == (3, space.n_dofs)
    assert torch.equal(d[2], op.scalar_op.jacobi_preconditioner())
    assert torch.equal(op.diagonal()[1], torch.ones(space.n_dofs, dtype=torch.float64))
    u = torch.as_tensor(np.random.default_rng(5).standard_normal((3, space.n_dofs)))
    before = op.vmult(u)
    op.fold_scale(0.5)
    after = op.vmult(u)
    mask = space.dirichlet_mask
    assert torch.equal(after[:, mask], u[:, mask])
    np.testing.assert_allclose(after[:, ~mask].numpy(), 0.5 * before[:, ~mask].numpy(), rtol=1e-13, atol=1e-15)
    with pytest.raises(ValueError):
        op.vmult(u[:2])


def test_bf16_vectors_on_the_kernel_backends():
    """bf16 vectors, f32 apply: BP3 (K2) and BP6 (K1, 3 components) return
    bf16 within bf16 rounding of the f32 apply."""
    for bp in ("bp3", "bp6"):
        space, op = make_bp_operator(bp, pt.BrickMesh((3, 3, 3)), 3, dtype=torch.float32, device="cpu")
        _, opb = make_bp_operator(bp, pt.BrickMesh((3, 3, 3)), 3, dtype=torch.float32, stream_dtype=torch.bfloat16,
                                  device="cpu")
        nc = _ncomp(bp)
        shape = (nc, space.n_dofs) if nc > 1 else (space.n_dofs,)
        u = torch.as_tensor(np.random.default_rng(6).standard_normal(shape), dtype=torch.float32)
        got = opb.vmult(u.to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        want = op.vmult(u)
        assert float((got.float() - want).abs().max() / want.abs().max()) < 3e-2


LINE = re.compile(r"^(pcg-merged|vmult) (\d+) ([0-9.e+]+)$")


@pytest.mark.parametrize("bp", ["bp2", "bp3"])
def test_run_sweep_prints_reference_lines(bp, capsys):
    res = bp_t.run_sweep(bp, (2,), 600, n_iterations=4, n_repetitions=1, dtype="float64", device="cpu")
    out = capsys.readouterr().out
    lines = [m.groups() for m in map(LINE.match, out.splitlines()) if m]
    mesh = bp_t.target_mesh(2, 600)
    rows = mesh.n_dofs(2) * _ncomp(bp)
    assert [(mode, int(n)) for mode, n, _ in lines] == [("pcg-merged", rows), ("vmult", rows)]
    r = res[2]
    assert r["backend"] == "banded" and r["n_iterations"]["pcg-merged"] == 4
    assert all(r["finite"].values()) and np.isfinite(r["l2_norm"])
    assert float(lines[0][2]) == pytest.approx(r["pcg-merged"], rel=1e-5)


def test_cli_on_cpu_and_cuda_without_a_card(capsys, monkeypatch):
    bp_t.main(["--bp", "bp4", "--p-min", "2", "--p-max", "2", "--target-dofs", "500", "--iterations", "3",
               "--repetitions", "1", "--dtype", "float32", "--stream-dtype", "bfloat16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^pcg-merged \d+ ", out, re.M) and re.search(r"^vmult \d+ ", out, re.M)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bp_t.main(["--bp", "bp1", "--p-min", "2", "--p-max", "2", "--device", "cuda"])


def test_target_mesh_matches_jax():
    from deal_and_ceed_on_gpu_tpu.drivers.bp import _target_mesh

    for p, target in ((5, 4_000_000), (2, 600), (8, 2_000_000), (1, 10)):
        assert bp_t.target_mesh(p, target).n_elements == _target_mesh(p, target).n_elements
    assert bp_t.target_mesh(5, 4_000_000).n_dofs(5) == 4_173_281


def test_new_modules_leave_jax_and_triton_out():
    code = (
        "import sys, deal_and_ceed_on_gpu_torch.drivers.bp, deal_and_ceed_on_gpu_torch.ops.banded, "
        "deal_and_ceed_on_gpu_torch.models.mass, deal_and_ceed_on_gpu_torch.models.vector; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'deal_and_ceed_on_gpu_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("bp", ["bp2", "bp4", "bp6"])
def test_vector_kernels_match_jax_stacked_interpret(bp):
    """One launch for all components: the port's K2 / K1 with nc = 3 (their
    plain versions here) against the JAX stacked kernels
    (``StackedBandedOperator`` / ``StackedStencilOperator``) in interpret
    mode, on global [3, n] vectors."""
    mesh = (3, 4, 5)
    js, vop = make_j(bp, jx.BrickMesh(mesh), 3, dtype=jnp.float64, backend="pallas")
    vop._stacked.interpret = True
    u = np.random.default_rng(10).standard_normal((3, js.n_dofs))
    want = np.asarray(vop.unpad_flat(vop.vmult_padded(vop.pad_flat(jnp.asarray(u)))))
    _, op = make_bp_operator(bp, pt.BrickMesh(mesh), 3, dtype=torch.float64, device="cpu")
    got = op.vmult(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
