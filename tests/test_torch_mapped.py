"""The general-geometry slice as a whole: the port's MappedMesh, sine_map,
shear_map and every mapped geometry table against the JAX package's,
node_coords, the Poisson, Helmholtz and Mass operators on mapped (and
graded) meshes on ``structured``, ``qgrid`` and ``general`` against the JAX
operators, K3's tables from real geometry, the mapped Jacobi diagonal,
assemble_rhs and l2_norm_function, the mapped Jacobi solves against live
JAX solves, and chip_smoke.py's baked mapped goldens recomputed."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
import deal_and_ceed_on_gpu_tpu as jx
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, MassOperator, PoissonOperator
from deal_and_ceed_on_gpu_torch.models import assemble_rhs as rhs_t
from deal_and_ceed_on_gpu_torch.models import l2_norm_function as l2_t
from deal_and_ceed_on_gpu_torch.ops import qgrid as qg
from deal_and_ceed_on_gpu_torch.utils.convert import qgrid_tables_from_jax
from deal_and_ceed_on_gpu_tpu.mesh import shear_map as shear_j
from deal_and_ceed_on_gpu_tpu.mesh import sine_map as sine_j
from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator as HelmholtzJ
from deal_and_ceed_on_gpu_tpu.models import MassOperator as MassJ
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator as PoissonJ
from deal_and_ceed_on_gpu_tpu.models import assemble_rhs as rhs_j
from deal_and_ceed_on_gpu_tpu.models import l2_norm_function as l2_j
from deal_and_ceed_on_gpu_tpu.ops.pallas_qgrid import build_qgrid_operator

TOL = 1e-12  # f64 operator applies, relative to max|want|
SHEAR = (0.2, -0.1, 0.15)
BREAKS = ([0.0, 0.2, 0.7, 1.0], [0.0, 0.5, 1.0], [0.0, 0.3, 0.45, 1.0])


def _meshes(kind, shape=(3, 4, 3)):
    """(port mesh, JAX mesh) of one kind: sine-mapped, sheared, graded."""
    if kind == "sine":
        return pt.BrickMesh(shape).deform(*pt.sine_map(0.05)), jx.BrickMesh(shape).deform(*sine_j(0.05))
    if kind == "shear":
        return pt.BrickMesh(shape).deform(*pt.shear_map(*SHEAR)), jx.BrickMesh(shape).deform(*shear_j(*SHEAR))
    return pt.BrickMesh.graded(*BREAKS), jx.BrickMesh.graded(*BREAKS)


def _spaces(kind, p, n_q, rule, shape=(3, 4, 3)):
    mt, mj = _meshes(kind, shape)
    ts = pt.FESpace.create(mt, p, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
    js = jx.FESpace.create(mj, p, n_q=n_q, rule=rule, dtype=jnp.float64)
    return ts, js


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


def _a_fn(x):
    return 3.0 + x[..., 0] + 0.5 * x[..., 1] * x[..., 2]


def test_mapped_mesh_matches_jax():
    mt, mj = _meshes("sine")
    assert mt.is_mapped and not mt.is_uniform
    assert not pt.BrickMesh((2, 2, 2)).is_mapped and pt.BrickMesh((2, 2, 2)).is_uniform
    X = np.random.default_rng(0).random((5, 7, 3))
    for (phi_t, jac_t), (phi_j, jac_j) in ((pt.sine_map(0.07, 2), sine_j(0.07, 2)),
                                           (pt.shear_map(*SHEAR), shear_j(*SHEAR))):
        np.testing.assert_array_equal(phi_t(X), phi_j(X))
        np.testing.assert_array_equal(jac_t(X), jac_j(X))
    np.testing.assert_array_equal(mt.map_points(X), mj.map_points(X))
    # refine_global keeps the mapping (dataclasses.replace keeps the class)
    r = mt.refine_global(1)
    assert isinstance(r, pt.MappedMesh) and r.n_elements == (6, 8, 6) and r.mapping is mt.mapping
    with pytest.raises(ValueError):
        mt.h


@pytest.mark.parametrize("kind", ["sine", "shear", "graded"])
@pytest.mark.parametrize("p,n_q,rule", [(2, 3, "gauss"), (3, 5, "gauss"), (2, 3, "gauss_lobatto")])
def test_geometry_tables_match_jax(kind, p, n_q, rule):
    ts, js = _spaces(kind, p, n_q, rule)
    gt, gj = ts.geometry, js.geometry
    assert gt.mapped == gj.mapped == (kind != "graded")
    for name in ("jacobian_full", "inv_jacobian_full", "det_q_full", "jxw_full", "merged_coef_full",
                 "q_points_phys"):
        np.testing.assert_allclose(getattr(gt, name)(), getattr(gj, name)(), rtol=1e-14, atol=1e-14, err_msg=name)
    np.testing.assert_allclose(ts.node_coords(), js.node_coords(), rtol=0, atol=1e-15)
    if kind == "shear":
        # the affine shear's interpolated Jacobian is exact: the mesh's
        # analytic mapping_jacobian times the brick's diag(h)
        J = gt.jacobian_full()
        Xq = pt.Geometry.from_mesh(pt.BrickMesh((3, 4, 3)), ts.basis).q_points_phys()
        h = np.diag([ts.mesh.h_axes()[d][0] for d in range(3)])  # uniform brick under the shear
        want = ts.mesh.mapping_jacobian(Xq) @ h
        assert np.abs(want[..., 0, 1]).min() > 0  # a full Jacobian, not diag(h)
        np.testing.assert_allclose(J, want, rtol=0, atol=1e-14)


def test_interpolated_jacobian_converges_to_mapping_jacobian():
    """On the sine map the isoparametric Jacobian approaches the mesh's
    analytic ``mapping_jacobian`` (at the brick preimages of the q points,
    times diag(h)) at high order in the mapping degree."""
    mesh = pt.BrickMesh((2, 2, 2)).deform(*pt.sine_map(0.05))
    errs = []
    for p in (2, 4):
        basis = pt.Basis1D.make(p, rule="gauss")
        Xq = pt.Geometry.from_mesh(pt.BrickMesh((2, 2, 2)), basis).q_points_phys()
        J = pt.Geometry.from_mesh(mesh, basis).jacobian_full()
        errs.append(np.abs(J - mesh.mapping_jacobian(Xq) * 0.5).max())
    assert errs[1] < 0.05 * errs[0], errs  # 0.0109 -> 0.00037


def test_folded_mapping_raises():
    mesh = pt.BrickMesh((2, 2, 2)).deform(lambda X: -X)
    with pytest.raises(ValueError, match="folds"):
        pt.Geometry.from_mesh(mesh, pt.Basis1D.make(2, 3, "gauss")).det_q_full()


_BACKENDS = {"gauss": ("structured", "general", "qgrid"), "gauss_lobatto": ("structured", "general")}


@pytest.mark.parametrize("kind", ["sine", "shear", "graded"])
@pytest.mark.parametrize("p,n_q,rule", [(2, 4, "gauss"), (3, 4, "gauss"), (3, 4, "gauss_lobatto")])
def test_operators_match_jax(kind, p, n_q, rule):
    """Poisson, Helmholtz and Mass vmult on every backend that takes the mesh
    against the JAX structured operator; the diagonals against JAX."""
    ts, js = _spaces(kind, p, n_q, rule)
    u = np.random.default_rng(p).standard_normal(ts.n_dofs)
    cases = ((PoissonOperator, PoissonJ, {}), (HelmholtzOperator, HelmholtzJ, {"coefficient_fn": _a_fn}),
             (MassOperator, MassJ, {}))
    for cls_t, cls_j, kw in cases:
        jop = cls_j(js, backend="structured", **kw)
        want = np.asarray(jop.vmult(jnp.asarray(u)))
        dwant = np.asarray(jop.compute_diagonal())
        for backend in _BACKENDS[rule]:
            op = cls_t(ts, backend=backend, **kw)
            _close(op.vmult(torch.as_tensor(u)).numpy(), want)
            np.testing.assert_allclose(op.compute_diagonal().numpy(), dwant, rtol=1e-13, atol=1e-15,
                                       err_msg=f"{cls_t.__name__} {backend}")


@pytest.mark.parametrize("kind", ["sine", "graded"])
def test_helmholtz_general_matches_jax_pallas_general(kind):
    """The port's general backend against the JAX pallas_general backend in
    interpret mode: the same K4 function end to end, gather and scatter
    included."""
    ts, js = _spaces(kind, 3, 4, "gauss", shape=(2, 3, 2))
    u = np.random.default_rng(1).standard_normal(ts.n_dofs)
    jop = HelmholtzJ(js, backend="pallas_general", pallas_opts={"interpret": True, "block_e": 8})
    want = np.asarray(jop.vmult(jnp.asarray(u)))
    _close(HelmholtzOperator(ts, backend="general").vmult(torch.as_tensor(u)).numpy(), want)


@pytest.mark.parametrize("kind,shape,p,qoff", [("sine", (3, 9, 5), 3, 1), ("sine", (2, 9, 4), 2, 1),
                                               ("graded", (3, 4, 3), 3, 1)])
def test_qgrid_tables_from_real_geometry_equal_jax(kind, shape, p, qoff):
    """K3 fed real geometry: the weightless full6 / diag3 tables the port's
    Poisson builds and the det value table of its Mass equal the JAX
    QGridLayout's, cut to the real q grid."""
    ts, js = _spaces(kind, p, p + 1 + qoff, "gauss", shape=shape)
    gj = js.geometry
    w3 = np.asarray(gj.w3d).reshape(-1)
    coef = gj.merged_coef_full() / w3[None, :, None]
    grad = ("full6", coef) if gj.mapped else ("diag3", coef[:, :, (0, 3, 5)])
    qop = build_qgrid_operator(js.mesh, js.basis, jnp.float64, grad=grad, val=("table", gj.det_q_full()),
                               interpret=True)
    want = qgrid_tables_from_jax(qop.layout)
    poisson = PoissonOperator(ts, backend="qgrid")._qgrid
    mass = MassOperator(ts, backend="qgrid")._qgrid
    assert poisson.grad_kind == want["grad_kind"] == (3 if gj.mapped else 2)
    np.testing.assert_allclose(poisson.C.numpy(), want["C"], rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(mass.a_q.numpy(), want["a_q"], rtol=1e-14, atol=1e-14)


def test_rhs_and_l2_norm_match_jax():
    ts, js = _spaces("sine", 3, 4, "gauss")
    for f in (1.0, _a_fn):
        _close(rhs_t(ts, f).numpy(), np.asarray(rhs_j(js, f)), 1e-14)
    u = np.random.default_rng(4).standard_normal(ts.n_dofs)
    for n_q in (None, 6):
        want = float(l2_j(js, jnp.asarray(u), n_q))
        assert abs(float(l2_t(ts, torch.as_tensor(u), n_q)) - want) <= 1e-14 * want


def test_kernel_backends_reject_mapped_meshes():
    ts, _ = _spaces("sine", 3, 4, "gauss_lobatto")
    tg, _ = _spaces("sine", 3, 5, "gauss")
    for backend in ("separable", "stencil"):
        with pytest.raises(ValueError):
            PoissonOperator(ts, backend=backend)
        with pytest.raises(ValueError):
            HelmholtzOperator(ts, backend=backend)
    with pytest.raises(ValueError, match="mapped"):
        PoissonOperator(tg, backend="banded")
    with pytest.raises(ValueError, match="mapped"):
        MassOperator(tg, backend="banded")


def test_bp_default_backend_on_mapped_mesh_is_general():
    from deal_and_ceed_on_gpu_torch.models import make_bp_operator

    mesh = pt.BrickMesh((2, 2, 2)).deform(*pt.sine_map(0.05))
    for bp in ("bp1", "bp3", "bp5", "bp6"):
        _, op = make_bp_operator(bp, mesh, 2, dtype=torch.float64, device="cpu")
        assert op.backend == "general", bp


@functools.cache
def _jax_solve(m, rule):
    """The JAX golden of a mapped Jacobi solve (structured, f64, 1e-10)."""
    mesh = jx.BrickMesh((m, m, m)).deform(*sine_j(0.05))
    space = jx.FESpace.create(mesh, 3, n_q=4, rule=rule, dtype=jnp.float64)
    op = PoissonJ(space, backend="structured")
    b = rhs_j(space, 1.0)
    x, info = jx.solve_cg_merged(op.vmult, b, jx.ReductionControl(2000, tolerance=0.0, reduction=1e-10),
                                 diag=op.jacobi_preconditioner())
    return space.n_dofs, int(info["n_iterations"]), float(l2_j(space, x))


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
def test_mapped_jacobi_solves_match_jax(m, rule):
    from deal_and_ceed_on_gpu_torch.scripts.bench_solvers_r3 import run_case

    n, it, l2 = _jax_solve(m, rule)
    for backend in _BACKENDS[rule]:
        r = run_case(m, backend, rule, device="cpu")
        assert r["space"].n_dofs == n
        assert r["n_iterations"] == it, backend
        assert abs(r["l2_norm"] - l2) <= 1e-10 * l2, backend
        assert r["true_rel_res"] <= 1.2e-10


def test_chip_smoke_mapped_goldens_are_the_jax_package_values():
    """chip_smoke.py's baked mapped goldens, recomputed live."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    for (m, rule), (n, it, l2) in chip_smoke.MAPPED_GOLDEN.items():
        got = _jax_solve(m, rule)
        assert got[:2] == (n, it), (m, rule)
        assert abs(got[2] - l2) <= 1e-12 * l2, (m, rule)


if __name__ == "__main__":
    # print a mapped golden: PYTHONPATH=. python tests/test_torch_mapped.py M [RULE]
    import sys

    import jax

    jax.config.update("jax_enable_x64", True)
    print(_jax_solve(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "gauss_lobatto"))
