"""The port's native set-up library (utils/native.py, its own copy of
csrc/fem_setup.cpp built with the host compiler) against numpy, and its VTK
writers (utils/vtk.py) against the JAX package's: the .vtr, .vts (shear
mapped), .vtu (adaptive) and .pvtr (BlockPartition.to_blocks) files are
byte-identical for the same mesh, space and values, at the sizes of
tests/test_native_and_vtk.py."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
import deal_and_ceed_on_gpu_tpu as jx
from deal_and_ceed_on_gpu_torch.parallel import BlockPartition
from deal_and_ceed_on_gpu_torch.utils import native, vtk
from deal_and_ceed_on_gpu_tpu.utils import vtk as jvtk


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no host C++ compiler: the native library falls back to numpy")
    return native.get_lib()


def _multiplicity(mesh, p):
    def shared(n):  # 2 on the nodes two elements of an axis share
        c = np.ones(n)
        c[p:n - 1:p] = 2.0
        return c

    nx, ny, nz = mesh.n_nodes(p)
    return np.einsum("k,j,i->kji", shared(nz), shared(ny), shared(nx)).reshape(-1).astype(np.float32)


@pytest.mark.parametrize("shape,p", [((2, 3, 4), 2), ((3, 2, 2), 5)])
def test_native_tables_match_numpy(lib, shape, p):
    mesh = pt.BrickMesh(shape)
    nx, ny, nz = mesh.n_nodes(p)
    np.testing.assert_array_equal(native.element_dof_map(*mesh.n_elements, p), mesh.element_dof_map(p))
    np.testing.assert_array_equal(native.boundary_mask(nx, ny, nz), mesh.boundary_dof_mask(p))
    np.testing.assert_array_equal(native.dof_multiplicity(*mesh.n_elements, p), _multiplicity(mesh, p))


def test_large_mesh_dof_map_takes_the_native_branch(lib):
    """Above 2^22 entries ``element_dof_map`` comes from the native library, equal
    to the numpy path (JAX mesh.py:211-218)."""
    mesh, p = pt.BrickMesh((21, 20, 20)), 7  # 8,400 cells x 512 > 2^22
    with mock.patch.object(native, "element_dof_map", wraps=native.element_dof_map) as spy:
        got = mesh.element_dof_map(p)
    spy.assert_called_once_with(21, 20, 20, p)
    with mock.patch.object(native, "element_dof_map", return_value=None):
        want = mesh.element_dof_map(p)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (8400, 512)


def test_native_write_vtr_is_byte_identical_to_python(lib, tmp_path):
    mesh = pt.BrickMesh((2, 2, 2))
    basis = pt.Basis1D.make(2)
    u = np.random.default_rng(0).standard_normal(mesh.n_dofs(2)).reshape(5, 5, 5)
    xs, ys, zs = mesh.node_coords_1d(2, basis.nodes)
    assert native.write_vtr(tmp_path / "c.vtr", xs, ys, zs, u)
    vtk._write_vtr_py(tmp_path / "py.vtr", xs, ys, zs, u)
    jvtk._write_vtr_py(tmp_path / "jax.vtr", xs, ys, zs, u)
    data = (tmp_path / "py.vtr").read_bytes()
    assert data.startswith(b"<?xml") and b"RectilinearGrid" in data
    assert (tmp_path / "c.vtr").read_bytes() == data == (tmp_path / "jax.vtr").read_bytes()


@pytest.mark.parametrize("graded", [False, True])
def test_vtr_matches_jax(tmp_path, graded):
    """A brick's .vtr (native writer, and the Python one where the library
    is unavailable) against the JAX package's file."""
    edges = [0.0, 0.3, 1.0]
    pmesh = pt.BrickMesh.graded(edges, edges, edges) if graded else pt.BrickMesh((2, 2, 2))
    jmesh = jx.BrickMesh.graded(edges, edges, edges) if graded else jx.BrickMesh((2, 2, 2))
    space = pt.FESpace.create(pmesh, 2, dtype=torch.float64, device="cpu")
    u = np.random.default_rng(1).standard_normal(space.n_dofs)
    vtk.write_solution_vtr(tmp_path / "port.vtr", space, torch.as_tensor(u))
    with mock.patch.object(native, "write_vtr", return_value=False):
        vtk.write_solution_vtr(tmp_path / "port_py.vtr", space, torch.as_tensor(u))
    jvtk.write_solution_vtr(tmp_path / "jax.vtr", jx.FESpace.create(jmesh, 2, dtype=jnp.float64), jnp.asarray(u))
    want = (tmp_path / "jax.vtr").read_bytes()
    assert (tmp_path / "port.vtr").read_bytes() == want
    assert (tmp_path / "port_py.vtr").read_bytes() == want


def test_vts_shear_mapped_matches_jax(tmp_path):
    pspace = pt.FESpace.create(pt.BrickMesh((2, 2, 2)).deform(*pt.shear_map(0.3)), 2, dtype=torch.float64,
                               device="cpu")
    jspace = jx.FESpace.create(jx.BrickMesh((2, 2, 2)).deform(*jx.shear_map(0.3)), 2, dtype=jnp.float64)
    u = np.arange(pspace.n_dofs, dtype=np.float64)
    got = vtk.write_solution_vtr(tmp_path / "port.vts", pspace, torch.as_tensor(u, dtype=torch.float32))
    assert str(got).endswith(".vts")
    jvtk.write_solution_vtr(tmp_path / "jax.vts", jspace, jnp.asarray(u))
    data = (tmp_path / "port.vts").read_bytes()
    assert b"StructuredGrid" in data and data == (tmp_path / "jax.vts").read_bytes()


def test_vtu_adaptive_matches_jax(tmp_path):
    from deal_and_ceed_on_gpu_tpu.adaptive import AdaptiveMesh as JMesh
    from deal_and_ceed_on_gpu_tpu.adaptive import AdaptiveSpace as JSpace

    p = 2
    pspace = pt.AdaptiveSpace(pt.AdaptiveMesh.refine(pt.BrickMesh((2, 2, 2)), (0, 5)), p, device="cpu")
    jspace = JSpace(JMesh.refine(jx.BrickMesh((2, 2, 2)), (0, 5)), p)
    u = np.random.default_rng(3).standard_normal(pspace.n_dofs)
    vtk.write_solution_vtu(tmp_path / "port.vtu", pspace, torch.as_tensor(u))
    jvtk.write_solution_vtu(tmp_path / "jax.vtu", jspace, jnp.asarray(u))
    data = (tmp_path / "port.vtu").read_bytes()
    assert f'NumberOfCells="{pspace.mesh.n_cells * p**3}"'.encode() in data
    assert data == (tmp_path / "jax.vtu").read_bytes()


def test_pvtr_blocks_match_jax(tmp_path):
    """One piece a block plus the master, from ``to_blocks`` of the same
    field (a tensor for the port, uneven in z with pz = 2)."""
    from deal_and_ceed_on_gpu_tpu.parallel import BlockPartition as JPartition

    p = 2
    part = BlockPartition(pt.BrickMesh((3, 4, 5)), p, 2, 2)
    jpart = JPartition(jx.BrickMesh((3, 4, 5)), p, pz=2, py=2)
    u = np.random.default_rng(0).standard_normal(part.global_grid_shape)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    vtk.write_solution_pvtr(str(tmp_path / "port" / "sol.pvtr"), part, torch.as_tensor(part.to_blocks(u)))
    jvtk.write_solution_pvtr(str(tmp_path / "jax" / "sol.pvtr"), jpart, jpart.to_blocks(u))
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == ["sol.pvtr"] + [f"sol_{k}.vtr" for k in range(4)]
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
