"""The port's sharded scan (``parallel/sharded_scan.py``) against the JAX
reference's on the CPU.

Oracles: tests/test_parallel.py (the plain and int8 sharded scans, padding,
k past a shard's rows, a planted neighbour in every shard) and
tests/test_sharded_hier.py (the hierarchical body per shard, its int8
form, masked rows). The same seeded numpy slab and queries go through the
reference over meshes of 1, 2, 4 and 8 of tests/conftest.py's virtual CPU
devices and through the port over that many CPU shards. The reference's
hierarchical bodies run their Pallas kernels in interpret mode (B = 8, so
its rescore rounds the query to the slab dtype as K2 does). Rows are
equal; scores, f32 sums of the same products in another order, within
1e-6 (relative, absolute below 1). The port's hierarchical scan over shards equals its
single-device scan over the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankensearch_tpu.ops.quantize import calibrate_int8
from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.parallel import sharded_scan as jss
from frankensearch_tpu_torch.ops import topk_scan as ts
from frankensearch_tpu_torch.parallel import mesh as tmesh
from frankensearch_tpu_torch.parallel import sharded_scan as tss
from tests.conftest import make_unit_rows

REL = 1e-6
MESHES = pytest.mark.parametrize("n", [1, 2, 4, 8])
TILE = 256  # the reference's hierarchical tile in its parity tests


def devices(n):
    return tmesh.make_mesh(n, device="cpu").shard_devices()


def jm(n):
    return jmesh.make_mesh(n, axes=("d",))


def same(got, want, rel=REL):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=rel, atol=rel)


@MESHES
def test_plain_scan_equals_reference(n):
    rng = np.random.default_rng(n)
    slab, q = make_unit_rows(rng, 1000, 64), make_unit_rows(rng, 6, 64)  # 1000 rows: padded
    s, m = tss.shard_slab(slab, devices(n))
    got = tss.sharded_scan_topk(s, m, torch.from_numpy(q), 10)
    js, jmask = jss.shard_slab(slab, jm(n))
    same(got, jss.sharded_scan_topk(js, jmask, jnp.asarray(q), 10, mesh=jm(n)))
    assert got.indices.dtype == torch.int32 and got.scores.dtype == torch.float32


@MESHES
def test_padding_rows_never_win(n):
    rng = np.random.default_rng(7)
    slab = make_unit_rows(rng, 33, 32)  # forces padding on every mesh
    q = make_unit_rows(rng, 3, 32)
    got = tss.ShardedVectorScan(slab, [f"d{i}" for i in range(33)], tmesh.make_mesh(n, device="cpu"),
                                dtype=torch.float32).search_batch(q, 40)
    want = jss.ShardedVectorScan(slab, [f"d{i}" for i in range(33)], jm(n), dtype=jnp.float32).search_batch(q, 40)
    same(got, want)
    idx = got.indices.numpy()
    assert all(sorted(row[row >= 0].tolist()) == list(range(33)) for row in idx)
    assert (idx[:, 33:] == -1).all() and np.isneginf(got.scores.numpy()[:, 33:]).all()


@MESHES
def test_k_exceeding_shard_rows(n):
    rng = np.random.default_rng(9)
    slab = make_unit_rows(rng, n * 8, 32)
    q = make_unit_rows(rng, 2, 32)
    got = tss.ShardedVectorScan(slab, [f"d{i}" for i in range(len(slab))], tmesh.make_mesh(n, device="cpu"),
                                dtype=torch.float32).search_batch(q, len(slab))
    want = jss.ShardedVectorScan(slab, [f"d{i}" for i in range(len(slab))], jm(n),
                                 dtype=jnp.float32).search_batch(q, len(slab))
    same(got, want)
    assert len(set(got.indices.numpy()[0].tolist())) == len(slab)  # every live row returned


@MESHES
def test_int8_two_pass_equals_reference(n):
    rng = np.random.default_rng(11)
    slab, q = make_unit_rows(rng, 512, 64), make_unit_rows(rng, 6, 64)
    cal = calibrate_int8(slab)
    s, m = tss.shard_slab_int8(cal.values, devices(n))
    scale = tss.replicate(torch.from_numpy(cal.scale), devices(n))
    got = tss.sharded_scan_topk_int8(s, scale, m, torch.from_numpy(q), 10)
    js, jmask = jss.shard_slab_int8(cal.values, jm(n))
    same(got, jss.sharded_scan_topk_int8(js, jnp.asarray(cal.scale), jmask, jnp.asarray(q), 10, mesh=jm(n)))
    assert (got.indices.numpy() < 512).all()


@MESHES
def test_planted_neighbour_in_every_shard(n):
    """A query's exact neighbour planted in each shard's row range is found
    wherever it lies, by both int8 bodies."""
    rng = np.random.default_rng(13)
    slab = make_unit_rows(rng, n * 256, 128) * 0.3
    q = make_unit_rows(rng, 8, 128)
    planted = [(j % n) * 256 + 3 + j for j in range(8)]
    slab[planted] = q
    cal = calibrate_int8(slab)
    s, m = tss.shard_slab_int8(cal.values, devices(n), local_multiple=256)
    scale = tss.replicate(torch.from_numpy(cal.scale), devices(n))
    two_pass = tss.sharded_scan_topk_int8(s, scale, m, torch.from_numpy(q), 3)
    hier = tss.sharded_scan_topk_hier_int8(s, scale, m, torch.from_numpy(q), 3, group_overfetch=2)
    assert two_pass.indices[:, 0].tolist() == planted == hier.indices[:, 0].tolist()
    js, jmask = jss.shard_slab_int8(cal.values, jm(n), local_multiple=256)
    want = jss.sharded_scan_topk_int8(js, jnp.asarray(cal.scale), jmask, jnp.asarray(q), 3, mesh=jm(n))
    same(two_pass, want)


@MESHES
def test_hier_equals_reference_and_single_device(n):
    rng = np.random.default_rng(15)
    slab, q = make_unit_rows(rng, n * TILE * 2, 128), make_unit_rows(rng, 8, 128)
    s, m = tss.shard_slab(slab, devices(n), local_multiple=TILE)
    got = tss.sharded_scan_topk_hier(s, m, torch.from_numpy(q), 10)
    single = ts.scan_topk_hierarchical(torch.cat(s), torch.from_numpy(q), 10, torch.cat(m))
    np.testing.assert_array_equal(got.indices.numpy(), single.indices.numpy())
    np.testing.assert_allclose(got.scores.numpy(), single.scores.numpy(), rtol=REL, atol=REL)
    js, jmask = jss.shard_slab(slab, jm(n), local_multiple=TILE)
    same(got, jss.sharded_scan_topk_hier(js, jmask, jnp.asarray(q), 10, mesh=jm(n), tile_n=TILE,
                                         interpret=True))


@pytest.mark.parametrize("n", [2, 8])
def test_hier_k_exceeding_local_rows(n):
    rng = np.random.default_rng(17)
    slab, q = make_unit_rows(rng, n * TILE, 128), make_unit_rows(rng, 8, 128)
    s, m = tss.shard_slab(slab, devices(n), local_multiple=TILE)
    k = TILE + 64
    got = tss.sharded_scan_topk_hier(s, m, torch.from_numpy(q), k)
    assert got.scores.shape == (8, k)
    for row in got.indices.numpy():
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid) == k
    js, jmask = jss.shard_slab(slab, jm(n), local_multiple=TILE)
    same(got, jss.sharded_scan_topk_hier(js, jmask, jnp.asarray(q), k, mesh=jm(n), tile_n=TILE, interpret=True))


@pytest.mark.parametrize("n", [2, 4])
def test_hier_masked_rows_never_win(n):
    rng = np.random.default_rng(19)
    slab = make_unit_rows(rng, n * TILE, 128)
    q = slab[:8].copy()  # the queries are docs 0..7
    s, m = tss.shard_slab(slab, devices(n), local_multiple=TILE)
    full = torch.cat(m).clone()
    full[:3] = float("-inf")  # kill three perfect matches
    got = tss.sharded_scan_topk_hier(s, tss.shard_rows(full, devices(n)), torch.from_numpy(q), 5)
    assert not set(got.indices.numpy().reshape(-1).tolist()) & {0, 1, 2}
    assert got.indices.numpy()[3:, 0].tolist() == [3, 4, 5, 6, 7]


@MESHES
def test_hier_int8_equals_reference(n):
    rng = np.random.default_rng(21)
    slab, q = make_unit_rows(rng, n * TILE, 128), make_unit_rows(rng, 8, 128)
    cal = calibrate_int8(slab)
    s, m = tss.shard_slab_int8(cal.values, devices(n), local_multiple=TILE)
    scale = tss.replicate(torch.from_numpy(cal.scale), devices(n))
    got = tss.sharded_scan_topk_hier_int8(s, scale, m, torch.from_numpy(q), 10, group_overfetch=2)
    js, jmask = jss.shard_slab_int8(cal.values, jm(n), local_multiple=TILE)
    want = jss.sharded_scan_topk_hier_int8(js, jnp.asarray(cal.scale), jmask, jnp.asarray(q), 10, mesh=jm(n),
                                           tile_n=TILE, group_overfetch=2, interpret=True)
    same(got, want)


@MESHES
def test_merge_breaks_ties_toward_the_lower_global_row(n):
    """Equal scores in every shard (and both signed zeros): the merge keeps
    the reference's (score desc, row asc, +0.0 above -0.0) order."""
    d = 32
    slab = np.zeros((n * 16, d), np.float32)
    slab[:, 0] = 1.0
    slab[1::4, 0] = -0.0
    slab[2::4] = 0.0
    slab[3::4, 0] = -1.0
    q = np.zeros((2, d), np.float32)
    q[0, 0], q[1, 0] = 1.0, -1.0
    s, m = tss.shard_slab(slab, devices(n), dtype=torch.float32)
    got = tss.sharded_scan_topk(s, m, torch.from_numpy(q), n * 16)
    js, jmask = jss.shard_slab(slab, jm(n), dtype=jnp.float32)
    want = jss.sharded_scan_topk(js, jmask, jnp.asarray(q), n * 16, mesh=jm(n))
    same(got, want, rel=0)
    np.testing.assert_array_equal(got.scores.numpy().view(np.uint32), np.asarray(want.scores).view(np.uint32))


def test_shards_on_the_slab_device_are_views():
    x = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    parts = tss.shard_rows(x, devices(4))
    assert all(p.data_ptr() == x[4 * i :].data_ptr() for i, p in enumerate(parts))
    with pytest.raises(ValueError, match="equal shards"):
        tss.shard_rows(x, devices(3))
