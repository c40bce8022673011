"""The step-64 slice as a whole: HelmholtzOperator's backends and diagonal
against the JAX operator, Poisson on K3's plain version at p = 5, q = 7, the
port's step-64 driver against the golden fingerprint, and the device
defaults of the port's entry points."""

import functools
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
import deal_and_ceed_on_gpu_tpu as jx
from deal_and_ceed_on_gpu_torch.drivers import bp5 as bp5_t
from deal_and_ceed_on_gpu_torch.drivers import step64 as step64_t
from deal_and_ceed_on_gpu_torch.models import assemble_rhs as rhs_t
from deal_and_ceed_on_gpu_torch.ops import qgrid as qg
from deal_and_ceed_on_gpu_torch.ops import separable as sep_t
from deal_and_ceed_on_gpu_torch.ops import stencil as st
from deal_and_ceed_on_gpu_tpu.drivers import step64 as step64_j
from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j

TOL = 1e-12  # f64 operator applies, relative to max|want|
UPPER = (1.0, 0.8, 1.3)
# golden step-64 fingerprints of the JAX package (f64, CPU, backend
# structured, drivers.step64.run(n_refine, degree=3, dtype="float64"));
# plain and merged CG agree
GOLDEN = {2: (60, 0.020526851356887806), 3: (114, 0.020526101012361093)}


def _spaces(shape, p, n_q, rule):
    js = jx.FESpace.create(jx.BrickMesh(shape, upper=UPPER), p, n_q=n_q, rule=rule, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh(shape, upper=UPPER), p, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
    return js, ts


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


HELMHOLTZ = [
    # (backend, shape, p, n_q, rule)
    ("structured", (3, 2, 4), 3, 4, "gauss"),
    ("structured", (2, 3, 2), 2, 4, "gauss"),
    ("qgrid", (3, 2, 4), 3, 4, "gauss"),
    ("qgrid", (2, 3, 2), 2, 4, "gauss"),
    ("qgrid", (2, 2, 3), 4, 5, "gauss"),
    ("separable", (3, 2, 4), 3, None, "gauss_lobatto"),
    ("separable", (2, 2, 2), 5, None, "gauss_lobatto"),
]


@pytest.mark.parametrize("backend,shape,p,n_q,rule", HELMHOLTZ)
def test_helmholtz_vmult_matches_jax(backend, shape, p, n_q, rule):
    js, ts = _spaces(shape, p, n_q, rule)
    u = np.random.default_rng(p).standard_normal(ts.n_dofs)
    want = np.asarray(HelmholtzJ(js, backend="structured").vmult(jnp.asarray(u)))
    op = pt.HelmholtzOperator(ts, backend=backend)
    _close(op.vmult(torch.as_tensor(u)), want)
    # the raw cell loop too (no constraint handling)
    want_raw = np.asarray(HelmholtzJ(js, backend="structured").apply_cell_loop(jnp.asarray(u)))
    _close(op.apply_cell_loop(torch.as_tensor(u)), want_raw)
    # fold_scale: interior rows scale, identity rows stay
    op.fold_scale(0.5)
    got = op.vmult(torch.as_tensor(u)).numpy()
    mask = ts.mesh.boundary_dof_mask(p)
    _close(got[~mask], 0.5 * want[~mask])
    np.testing.assert_array_equal(got[mask], u[mask])


@pytest.mark.parametrize("backend,shape,p,n_q,rule", [HELMHOLTZ[0], HELMHOLTZ[2], HELMHOLTZ[5]])
def test_helmholtz_diagonal_matches_jax(backend, shape, p, n_q, rule):
    js, ts = _spaces(shape, p, n_q, rule)
    jop, op = HelmholtzJ(js, backend="structured"), pt.HelmholtzOperator(ts, backend=backend)
    want = np.asarray(jop.compute_diagonal())
    np.testing.assert_allclose(op.compute_diagonal().numpy(), want, rtol=1e-13, atol=0)
    np.testing.assert_allclose(op.jacobi_preconditioner().numpy(), np.asarray(jop.jacobi_preconditioner()), rtol=1e-13)
    # the diagonal is the operator's: e_i^T A e_i on a few interior rows
    rows = np.flatnonzero(~ts.mesh.boundary_dof_mask(p))[:: max(1, ts.n_dofs // 7)]
    for i in rows:
        e = torch.zeros(ts.n_dofs, dtype=torch.float64)
        e[i] = 1.0
        assert abs(float(op.vmult(e)[i]) - want[i]) <= 1e-12 * abs(want[i])
    jop.fold_scale(3.0)
    op.fold_scale(3.0)
    np.testing.assert_allclose(op.compute_diagonal().numpy(), np.asarray(jop.compute_diagonal()), rtol=1e-13)
    assert op.weak_form()[0] and op.weak_form()[2] is None
    np.testing.assert_array_equal(op.weak_form()[1], jop.weak_form()[1])


def test_helmholtz_custom_coefficient_matches_jax():
    js, ts = _spaces((2, 3, 2), 3, 4, "gauss")

    def a_fn(x):
        return 3.0 + x[..., 0] + 0.5 * x[..., 1] * x[..., 2]

    u = np.random.default_rng(5).standard_normal(ts.n_dofs)
    want = np.asarray(HelmholtzJ(js, backend="structured", coefficient_fn=a_fn).vmult(jnp.asarray(u)))
    for backend in ("structured", "qgrid"):
        _close(pt.HelmholtzOperator(ts, backend=backend, coefficient_fn=a_fn).vmult(torch.as_tensor(u)), want)


def test_helmholtz_rejects_unported_backends():
    _, ts = _spaces((2, 2, 2), 3, 4, "gauss")
    with pytest.raises(ValueError, match="general"):
        pt.HelmholtzOperator(ts, backend="pallas_general")  # the port's name for it is "general"
    with pytest.raises(ValueError, match="unknown backend"):
        pt.HelmholtzOperator(ts, backend="pallas")  # the port's name for it is "stencil"
    for backend in ("separable", "stencil"):
        with pytest.raises(ValueError, match="collocation"):
            pt.HelmholtzOperator(ts, backend=backend)  # Gauss rule: not pointwise
    # graded and mapped bricks run on structured, qgrid and general; the
    # Kronecker and stencil forms stay on the bricks they are exact on
    mapped = pt.FESpace.create(pt.BrickMesh((2, 2, 2)).deform(*pt.sine_map(0.05)), 3, rule="gauss_lobatto",
                               dtype=torch.float64, device="cpu")
    for backend in ("separable", "stencil"):
        with pytest.raises(ValueError):
            pt.HelmholtzOperator(mapped, backend=backend)


@pytest.mark.parametrize("shape,p", [((3, 2, 4), 3), ((2, 2, 2), 5)])
def test_helmholtz_stencil_matches_jax(shape, p):
    """The stencil backend (K1's value term, plain version on the CPU):
    f32 against the JAX pallas backend in interpret mode (1e-5), f64 against
    the JAX separable backend (1e-12), with fold_scale and the diagonal."""
    js32 = jx.FESpace.create(jx.BrickMesh(shape, upper=UPPER), p, dtype=jnp.float32)
    ts32 = pt.FESpace.create(pt.BrickMesh(shape, upper=UPPER), p, dtype=torch.float32, device="cpu")
    u = np.random.default_rng(p).standard_normal(ts32.n_dofs)
    want = np.asarray(HelmholtzJ(js32, backend="pallas", pallas_opts=dict(interpret=True)).vmult(
        jnp.asarray(u, jnp.float32)), dtype=np.float64)
    got = pt.HelmholtzOperator(ts32, backend="stencil").vmult(torch.as_tensor(u, dtype=torch.float32))
    _close(got.double(), want, 1e-5)

    js, ts = _spaces(shape, p, None, "gauss_lobatto")
    jop = HelmholtzJ(js, backend="separable")
    want = np.asarray(jop.vmult(jnp.asarray(u)))
    op = pt.HelmholtzOperator(ts, backend="stencil")
    _close(op.vmult(torch.as_tensor(u)), want)
    np.testing.assert_allclose(op.compute_diagonal().numpy(), np.asarray(jop.compute_diagonal()), rtol=1e-13)
    op.fold_scale(0.5)
    got = op.vmult(torch.as_tensor(u)).numpy()
    mask = ts.mesh.boundary_dof_mask(p)
    _close(got[~mask], 0.5 * want[~mask])
    np.testing.assert_array_equal(got[mask], u[mask])


@pytest.mark.parametrize("shape", [(2, 2, 3), (3, 1, 2)])
def test_poisson_qgrid_p5_q7_matches_jax_structured(shape):
    """Poisson on K3 at BP3's rule (p = 5, Gauss q = 7)."""
    js, ts = _spaces(shape, 5, 7, "gauss")
    u = np.random.default_rng(3).standard_normal(ts.n_dofs)
    want = np.asarray(jx.PoissonOperator(js, backend="structured").vmult(jnp.asarray(u)))
    op = pt.PoissonOperator(ts, backend="qgrid")
    _close(op.vmult(torch.as_tensor(u)), want)
    np.testing.assert_allclose(op.compute_diagonal().numpy(), np.asarray(jx.PoissonOperator(js).compute_diagonal()),
                               rtol=1e-13)
    op.fold_scale(2.0)
    mask = ts.mesh.boundary_dof_mask(5)
    got = op.vmult(torch.as_tensor(u)).numpy()
    _close(got[~mask], 2.0 * want[~mask])
    np.testing.assert_array_equal(got[mask], u[mask])


@pytest.mark.parametrize("rule,n_q", [("gauss_lobatto", None), ("gauss", 5)])
def test_poisson_diagonal_on_graded_brick_matches_jax(rule, n_q):
    breaks = ([0, 0.2, 0.7, 1.0], [0, 0.4, 1.0], [0, 0.3, 0.5, 1.2])
    js = jx.FESpace.create(jx.BrickMesh.graded(*breaks), 3, n_q=n_q, rule=rule, dtype=jnp.float64)
    ts = pt.FESpace.create(pt.BrickMesh.graded(*breaks), 3, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
    want = np.asarray(jx.PoissonOperator(js, backend="separable").compute_diagonal())
    op = pt.PoissonOperator(ts, backend="separable")
    np.testing.assert_allclose(op.compute_diagonal().numpy(), want, rtol=1e-13)
    np.testing.assert_allclose(op.jacobi_preconditioner().numpy(), 1.0 / want, rtol=1e-13)


def test_geometry_tables_match_jax():
    for mesh_j, mesh_t in (
        (jx.BrickMesh((3, 2, 2), upper=UPPER), pt.BrickMesh((3, 2, 2), upper=UPPER)),
        (jx.BrickMesh.graded([0, 0.2, 1.0], [0, 0.5, 1.0], [0, 1.0]), pt.BrickMesh.graded([0, 0.2, 1.0], [0, 0.5, 1.0], [0, 1.0])),
    ):
        a = jx.Geometry.from_mesh(mesh_j, jx.Basis1D.make(3, 4, "gauss"))
        b = pt.Geometry.from_mesh(mesh_t, pt.Basis1D.make(3, 4, "gauss"))
        np.testing.assert_array_equal(b.det_q_full(), a.det_q_full())
        np.testing.assert_array_equal(b.merged_diag_per_cell(), a.merged_diag_per_cell())
        np.testing.assert_array_equal(b.jxw_full(), a.jxw_full())


def test_assemble_rhs_takes_the_backend():
    js, ts = _spaces((2, 3, 2), 3, 4, "gauss")
    want = np.asarray(rhs_j(js, 1.0, backend="pallas_qgrid"))
    for backend in ("structured", "qgrid", "separable"):
        np.testing.assert_allclose(rhs_t(ts, 1.0, backend=backend).numpy(), want, rtol=1e-13, atol=1e-16)
    with pytest.raises(ValueError):
        rhs_t(ts, 1.0, backend="bogus")


@pytest.mark.parametrize("n_refine", [2, 3])
@pytest.mark.parametrize("backend", ["qgrid", "structured"])
@pytest.mark.parametrize("use_merged", [False, True])
def test_step64_driver_golden(n_refine, backend, use_merged):
    it_g, l2_g = GOLDEN[n_refine]
    r = step64_t.run(n_refine, backend=backend, use_merged=use_merged, device="cpu")
    assert r["n_iterations"] == it_g
    assert abs(r["l2_norm"] - l2_g) <= 1e-10 * l2_g
    assert r["space"].device.type == "cpu" and r["x"].dtype == torch.float64 and r["seconds"] > 0


@functools.cache
def _jax_jacobi(n_refine):
    r = step64_j.run(n_refine=n_refine, degree=3, dtype="float64", precond="jacobi")
    return r["n_iterations"], r["l2_norm"]


@pytest.mark.parametrize("use_merged", [False, True])
def test_step64_jacobi_matches_jax(use_merged):
    it_j, l2_j = _jax_jacobi(2)
    r = step64_t.run(2, precond="jacobi", use_merged=use_merged, device="cpu")
    assert abs(r["n_iterations"] - it_j) <= 1 and r["n_iterations"] < GOLDEN[2][0]
    assert abs(r["l2_norm"] - l2_j) <= 1e-10 * l2_j


def test_step64_cli_on_cpu_prints_reference_lines(capsys):
    step64_t.main(["--refine", "1", "--device", "cpu", "--backend", "qgrid"])
    out = capsys.readouterr().out
    assert out.count("Number of degrees of freedom: 343") == 2
    assert len(re.findall(r"Solved in \d+ iterations\.", out)) == 2
    assert len(re.findall(r"solution norm: \S+", out)) == 2
    with pytest.raises(ValueError, match="requires the plain solver"):
        step64_t.run(1, precond="fdm", use_merged=True, device="cpu")
    with pytest.raises(ValueError, match="expected one of"):
        step64_t.run(1, precond="ilu", device="cpu")


def test_step64_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step64_t.run(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step64_t.main(["--refine", "1"])


def test_entry_points_default_to_the_card():
    """Running on the CPU takes an explicit device="cpu"."""
    assert pt.FESpace.create(pt.BrickMesh((2, 2, 2)), 3).device.type == "cuda"
    assert pt.FESpace(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(3)).device.type == "cuda"
    for fn in (st.StencilTables.create, st.StencilTables.from_numpy, sep_t.poisson_terms,
               qg.QGridTables.create, qg.QGridTables.from_numpy, step64_t.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert bp5_t.BP5Config().device == "cuda"
