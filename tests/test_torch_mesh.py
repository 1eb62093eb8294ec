"""The port's mesh (``frankensearch_tpu_torch.parallel.mesh``) against the
JAX reference's on the CPU.

Oracle: tests/test_parallel.py's TestHybridMesh. The reference's meshes are
built over tests/conftest.py's 8 virtual CPU devices; the port's are tuples
of ``torch.device``s, here that many shards of the CPU. Shapes and axis
names are equal, and a scan sharded over a hybrid mesh's document axis
returns the reference's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.parallel import sharded_scan as jss
from frankensearch_tpu_torch.parallel import mesh as tmesh
from frankensearch_tpu_torch.parallel import sharded_scan as tss
from tests.conftest import make_unit_rows

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_equals_reference(n):
    got = tmesh.make_mesh(n, device="cpu")
    want = jmesh.make_mesh(n, axes=("d",))
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    assert got.shard_devices("d") == (CPU,) * n


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_two_axis_default_shape_equals_reference(n):
    got = tmesh.make_mesh(n, axes=("dp", "tp"), device="cpu")
    want = jmesh.make_mesh(n, axes=("dp", "tp"))
    assert got.shape == dict(want.shape)
    assert len(got.shard_devices("dp")) == want.shape["dp"]


def test_hybrid_mesh_single_slice_shape():
    got = tmesh.make_hybrid_mesh(slice_axes=("d",), n_devices=len(jax.devices()), device="cpu")
    want = jmesh.make_hybrid_mesh(slice_axes=("d",))
    assert got.axis_names == tuple(want.axis_names) == ("slice", "d")
    assert got.shape == dict(want.shape) == {"slice": 1, "d": len(jax.devices())}


def test_hybrid_mesh_usable_for_sharded_scan():
    """A scan sharded over the hybrid mesh's document axis: the reference's
    rows, scores within 1e-6 (f32 sums of bf16 products in another order)."""
    rng = np.random.default_rng(42)
    slab = make_unit_rows(rng, 128, 32)
    q = make_unit_rows(rng, 2, 32)
    got_mesh = tmesh.make_hybrid_mesh(n_devices=len(jax.devices()), device="cpu")
    s, m = tss.shard_slab(slab, got_mesh.shard_devices("d"), dtype=torch.float32)
    got = tss.sharded_scan_topk(s, m, torch.from_numpy(q), 5)
    want_mesh = jmesh.make_hybrid_mesh(slice_axes=("d",))
    js, jm = jss.shard_slab(slab, want_mesh, axis="d", dtype=jnp.float32)
    want = jss.sharded_scan_topk(js, jm, jnp.asarray(q), 5, mesh=want_mesh)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    assert (got.indices.numpy() < 128).all()


def test_mesh_of_one_card_repeated():
    """Several shards may share one device: a mesh is a tuple of devices."""
    mesh = tmesh.Mesh([CPU] * 4, ("d",))
    assert mesh.shape == {"d": 4} and mesh.shard_devices() == (CPU,) * 4


def test_mesh_rejects_mismatched_axes():
    with pytest.raises(ValueError, match="for axes"):
        tmesh.Mesh([CPU] * 4, ("dp", "tp"))
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh(0, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_cuda_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no card"):
        tmesh.make_mesh(2, device="cuda")
