"""parallel/partition.py: block partitions against the JAX BlockPartition
(sizes, local meshes, to_blocks / from_blocks, slice_table, the per-rank
Dirichlet masks and dot weights), z slabs, ragged 3x1 and the 3-D 2x2x2
form, and the rank coordinates and identity rows of the port."""

import numpy as np
import pytest
import torch

from deal_and_ceed_on_gpu_torch.mesh import BrickMesh as TMesh
from deal_and_ceed_on_gpu_torch.ops.stencil import identity_mask
from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, SlabPartition

try:
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu.mesh import BrickMesh as JMesh
    from deal_and_ceed_on_gpu_tpu.parallel.partition import BlockPartition as JPartition
except ImportError:  # the card's machine has no jax
    jnp = None

pytestmark = pytest.mark.skipif(jnp is None, reason="needs the JAX package")

# (elements (mx, my, mz), p, (pz, py, px)): divisible, ragged, 2-D, 3-D, one rank
CASES = [
    ((2, 3, 4), 2, (2, 1, 1)),
    ((2, 4, 5), 2, (3, 1, 1)),
    ((3, 5, 7), 2, (2, 2, 1)),
    ((2, 5, 9), 2, (4, 2, 1)),
    ((3, 3, 3), 2, (2, 2, 2)),
    ((4, 3, 5), 3, (2, 1, 2)),
    ((2, 2, 2), 1, (1, 1, 1)),
    ((2, 3, 5), 1, (4, 3, 1)),
]


def _parts(n_el, p, shards):
    pz, py, px = shards
    return (BlockPartition(TMesh(n_el, upper=(1.0, 0.8, 1.3)), p, pz, py, px),
            JPartition(JMesh(n_el, upper=(1.0, 0.8, 1.3)), p, pz=pz, py=py, px=px))


@pytest.mark.parametrize("n_el,p,shards", CASES)
def test_sizes_and_local_mesh(n_el, p, shards):
    t, j = _parts(n_el, p, shards)
    for name in ("n_shards", "mz_local", "my_local", "mx_local", "local_grid_shape", "global_grid_shape",
                 "flat_grid_shape"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.local_mesh.n_elements == j.local_mesh.n_elements
    np.testing.assert_allclose(t.local_mesh.upper, j.local_mesh.upper, rtol=0, atol=1e-15)


@pytest.mark.parametrize("n_el,p,shards", CASES)
def test_blocks_round_trip_against_jax(n_el, p, shards):
    t, j = _parts(n_el, p, shards)
    u = np.random.default_rng(1).standard_normal(t.global_grid_shape)
    blocks = t.to_blocks(u)
    np.testing.assert_array_equal(blocks, j.to_blocks(u))
    np.testing.assert_array_equal(t.from_blocks(blocks), u)
    np.testing.assert_array_equal(t.from_blocks(blocks), j.from_blocks(blocks))
    # a rank's own block, and the blocks of every rank assembled
    np.testing.assert_array_equal(t.assemble([t.block(u, r) for r in range(t.n_shards)]), u)
    uc = np.stack([u, 2 * u])  # a leading component axis passes through
    np.testing.assert_array_equal(t.from_blocks(t.to_blocks(uc)), uc)


@pytest.mark.parametrize("n_el,p,shards", CASES)
def test_masks_and_dot_weights_against_jax(n_el, p, shards):
    t, j = _parts(n_el, p, shards)
    for r in range(t.n_shards):
        iz, iy, ix = t.coords(r)
        assert t.rank(iz, iy, ix) == r
        want = np.asarray(j.local_dirichlet_mask(iz, iy, ix))
        np.testing.assert_array_equal(t.local_dirichlet_mask(iz, iy, ix).numpy(), want)
        w = t.local_dot_weight(iz, iy, ix, dtype=torch.float64).numpy()
        np.testing.assert_array_equal(w, np.asarray(j.local_dot_weight(iz, iy, jnp.float64, ix)))
        # K1's and K2's identity rows of the block are that mask
        np.testing.assert_array_equal(identity_mask(t.local_grid_shape, t.ident(iz, iy, ix), "cpu").numpy(), want)


@pytest.mark.parametrize("n_el,p,shards", CASES[:5])
def test_slice_table_against_jax(n_el, p, shards):
    t, j = _parts(n_el, p, shards)
    q = p + 1
    mx, my, mz = (t.mx_local * t.px, t.my_local * t.py, t.mz_local * t.pz)
    table = np.random.default_rng(2).standard_normal((mz, q, my, q, mx, q, 2))
    np.testing.assert_array_equal(t.slice_table(table), j.slice_table(table))


@pytest.mark.parametrize("n_el,p,shards", CASES)
def test_phys_elems_and_faces(n_el, p, shards):
    """The blocks' physical elements add up to the mesh; an upper face is a
    wall exactly where the block reaches the global extent."""
    t, _ = _parts(n_el, p, shards)
    mx, my, mz = n_el
    for iz in range(t.pz):
        for iy in range(t.py):
            phys = t.phys_elems(iz, iy)
            assert phys[0] == mx if t.px == 1 else phys[0] <= t.mx_local
            z_lo, z_hi, y_lo, y_hi = t.faces(iz, iy)
            assert z_lo == (iz == 0) and y_lo == (iy == 0)
            assert z_hi == ((iz + 1) * t.mz_local >= mz) and y_hi == ((iy + 1) * t.my_local >= my)
            # dead elements only behind an upper wall
            assert (phys[2] == t.mz_local or z_hi) and (phys[1] == t.my_local or y_hi)
    assert sum(t.phys_elems(iz, 0)[2] for iz in range(t.pz)) == mz
    assert sum(t.phys_elems(0, iy)[1] for iy in range(t.py)) == my


def test_slab_partition():
    mesh = TMesh((2, 3, 5))
    s = SlabPartition(mesh, 2, 3)
    assert (s.pz, s.py, s.px) == (3, 1, 1)
    u = np.random.default_rng(3).standard_normal(s.global_grid_shape)
    slabs = s.to_slabs(u)
    assert slabs.shape == (3, *s.local_grid_shape)
    np.testing.assert_array_equal(s.from_slabs(slabs), u)


def test_bad_partitions_raise():
    with pytest.raises(ValueError):
        BlockPartition(TMesh((2, 2, 2)), 2, 0)
    with pytest.raises(ValueError):
        BlockPartition(TMesh((2, 2, 2)), 2, 2).coords(2)


def test_parallel_import_leaves_jax_and_triton_out():
    """The distributed port imports torch only: no jax, no JAX package, no
    triton, and importing builds nothing."""
    import subprocess
    import sys

    code = (
        "import sys, deal_and_ceed_on_gpu_torch.parallel, deal_and_ceed_on_gpu_torch.parallel.comm, "
        "deal_and_ceed_on_gpu_torch.parallel.dist_stencil, deal_and_ceed_on_gpu_torch.parallel.dist_banded, "
        "deal_and_ceed_on_gpu_torch.parallel.dist_solve, deal_and_ceed_on_gpu_torch.drivers.bp5; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', "
        "'deal_and_ceed_on_gpu_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "nvcc" not in proc.stdout + proc.stderr
