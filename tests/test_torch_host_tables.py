"""The port's numpy host copies build the same tables as the JAX package:
basis, brick mesh, uniform geometry and the separable band tables."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import separable as sep_t
from deal_and_ceed_on_gpu_tpu import Basis1D, BrickMesh, Geometry
from deal_and_ceed_on_gpu_tpu.ops import separable as sep_j

RULES = [(None, "gauss_lobatto"), (None, "gauss"), (2, "gauss")]  # n_q offset from p+1


def _nq(p, extra):
    return None if extra is None else p + extra


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("extra,rule", RULES)
def test_basis_equal(p, extra, rule):
    a = Basis1D.make(p, _nq(p, extra), rule)
    b = pt.Basis1D.make(p, _nq(p, extra), rule)
    assert a.collocation == b.collocation
    for name in ("nodes", "q_points", "q_weights", "S", "D"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    from deal_and_ceed_on_gpu_torch.basis import basis_tables_3d as bt_t
    from deal_and_ceed_on_gpu_tpu.basis import basis_tables_3d as bt_j

    for x, y in zip(bt_t(b), bt_j(a)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cycle", range(7, 13))
def test_bp5_cycle_mesh_equal(cycle):
    a, b = BrickMesh.bp5_cycle(cycle), pt.BrickMesh.bp5_cycle(cycle)
    assert (b.n_elements, b.lower, b.upper) == (a.n_elements, a.lower, a.upper)
    assert b.h == a.h and b.n_cells == a.n_cells
    for p in (1, 3, 5):
        assert b.n_nodes(p) == a.n_nodes(p) and b.n_dofs(p) == a.n_dofs(p)
        np.testing.assert_array_equal(b.element_dof_map(p), a.element_dof_map(p))
        np.testing.assert_array_equal(b.boundary_dof_mask(p), a.boundary_dof_mask(p))
        nodes = Basis1D.make(p).nodes
        for x, y in zip(b.node_coords_1d(p, nodes), a.node_coords_1d(p, nodes)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(b.h_axes(), a.h_axes()):
        np.testing.assert_array_equal(x, y)


def test_mesh_constructors_equal():
    pairs = [
        (BrickMesh.hyper_cube(0.0, 2.0).refine_global(2), pt.BrickMesh.hyper_cube(0.0, 2.0).refine_global(2)),
        (
            BrickMesh.subdivided_hyper_rectangle((3, 1, 2), upper=(1.0, 0.5, 2.0)),
            pt.BrickMesh.subdivided_hyper_rectangle((3, 1, 2), upper=(1.0, 0.5, 2.0)),
        ),
        (
            BrickMesh.graded([0, 0.2, 1.0], [0, 0.5, 0.7, 1.0], [0, 1.0]).refine_global(1),
            pt.BrickMesh.graded([0, 0.2, 1.0], [0, 0.5, 0.7, 1.0], [0, 1.0]).refine_global(1),
        ),
    ]
    for a, b in pairs:
        assert b.n_elements == a.n_elements and b.is_uniform == a.is_uniform
        for x, y in zip(b.h_axes(), a.h_axes()):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(b.edges_1d(), a.edges_1d()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(b.element_dof_map(2), a.element_dof_map(2))


@pytest.mark.parametrize("p", [2, 5])
@pytest.mark.parametrize("extra,rule", RULES)
def test_uniform_geometry_equal(p, extra, rule):
    mesh_a = BrickMesh((3, 2, 2), upper=(1.0, 0.8, 1.3))
    mesh_b = pt.BrickMesh((3, 2, 2), upper=(1.0, 0.8, 1.3))
    a = Geometry.from_mesh(mesh_a, Basis1D.make(p, _nq(p, extra), rule))
    b = pt.Geometry.from_mesh(mesh_b, pt.Basis1D.make(p, _nq(p, extra), rule))
    assert b.uniform and b.n_q == a.n_q
    assert b.h == a.h and b.det_j == a.det_j and b.const_merged_diag == a.const_merged_diag
    np.testing.assert_array_equal(b.w3d, a.w3d)
    np.testing.assert_array_equal(b.det_per_cell(), a.det_per_cell())
    np.testing.assert_array_equal(b.jxw_full(), a.jxw_full())
    np.testing.assert_array_equal(b.q_points_phys(), a.q_points_phys())


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("extra,rule", RULES)
def test_separable_tables_equal(p, extra, rule):
    shape, upper = (3, 2, 4), (1.0, 0.8, 1.3)
    ba, bb = Basis1D.make(p, _nq(p, extra), rule), pt.Basis1D.make(p, _nq(p, extra), rule)
    ma, mb = BrickMesh(shape, upper=upper), pt.BrickMesh(shape, upper=upper)
    ta, tb = sep_j._axis_tables(ma, ba), sep_t._axis_tables(mb, bb)
    for ax in (0, 1, 2):
        for key in ("A1", "B", "d"):
            if ta[ax][key] is None:
                assert tb[ax][key] is None
            else:
                np.testing.assert_array_equal(tb[ax][key], ta[ax][key])
        np.testing.assert_array_equal(
            sep_t._bands_from_dense(tb[ax]["A1"], p), sep_j._bands_from_dense(ta[ax]["A1"], p)
        )
    terms_a = sep_j.poisson_terms(ma, ba, np.float64)
    terms_b = sep_t.poisson_terms(mb, bb, torch.float64, device="cpu")
    assert len(terms_a) == len(terms_b)
    for x, y in zip(terms_b, terms_a):
        assert x["coef"] == y["coef"]
        assert (x["diag"] is None) == (y["diag"] is None)
        if x["diag"] is not None:
            np.testing.assert_array_equal(x["diag"].numpy(), np.asarray(y["diag"]))
        for (axb, matb, bandsb, pb), (axa, mata, bandsa, pa) in zip(x["band"], y["band"]):
            assert (axb, pb) == (axa, pa)
            np.testing.assert_array_equal(matb.numpy(), np.asarray(mata))
            np.testing.assert_array_equal(bandsb.numpy(), np.asarray(bandsa))
