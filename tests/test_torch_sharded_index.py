"""The port's mesh-sharded fast tier (``parallel/sharded_index.py``) and its
product surface (``TwoTierIndex.open/create(mesh_shards=...)``,
``open_hybrid``, the searcher's sharded fused lane) against the JAX
reference on the CPU.

Oracles: tests/test_sharded_index.py (TestShardedIndex,
TestShardedProductSurface, TestShardedFusedPhase1) and
tests/test_sharded_hier.py's TestShardedIndexHierMode. The same seeded
vectors (the port's HashEmbedder, whose rows equal the reference's) go into
both packages' sharded index over meshes of 2, 4 and 8 shards (the
reference's over tests/conftest.py's virtual CPU devices, the port's over
CPU shards). Rows are equal to the reference's and to the port's
single-device index; scores within 1e-6. On the CPU ``auto`` is the plain
exact sharded scan; with ``hier_align=True`` the hierarchical lanes run
the kernels' twins per shard.
"""

import numpy as np
import pytest
import torch

import frankensearch_tpu as fs
import frankensearch_tpu_torch as fst
from frankensearch_tpu.core.filter import BitsetFilter as RefBitset
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHash
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulk
from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index as RefShardedBm25
from frankensearch_tpu.parallel.sharded_index import ShardedDeviceVectorIndex as RefSharded
from frankensearch_tpu_torch.core.errors import InvalidConfig
from frankensearch_tpu_torch.core.filter import BitsetFilter as PortBitset
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.parallel.mesh import make_mesh
from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

CPU = torch.device("cpu")
REL = 1e-6
SHARDS = pytest.mark.parametrize("n", [2, 4, 8])
CORPUS = [(f"d{i}", f"document number {i} about topic {i % 5} words content") for i in range(40)]
QUERIES = ["topic 3 words", "document number", "topic 1 words content", "number 17"]


@pytest.fixture(scope="module")
def emb():
    return fst.HashEmbedder(dim=64)


@pytest.fixture(scope="module")
def vecs(emb):
    return emb.embed_batch([b for _, b in CORPUS])


def ids():
    return [d for d, _ in CORPUS]


def port_index(vecs, emb, n, **kw):
    return ShardedDeviceVectorIndex(vecs, ids(), emb.identity(), mesh=make_mesh(n, device="cpu"), **kw)


def ref_index(vecs, n, **kw):
    return RefSharded(vecs, ids(), RefHash(dim=64).identity(), mesh=jmesh.make_mesh(n, axes=("d",)),
                      use_pallas=False, **kw)


def same(got, want, rel=REL):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=rel, atol=rel)


@SHARDS
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matches_reference_and_single_device(emb, vecs, n, dtype):
    q = emb.embed_batch(QUERIES)
    got = port_index(vecs, emb, n, slab_dtype=dtype).search_batch(q, 8)
    same(got, ref_index(vecs, n, slab_dtype=dtype).search_batch(q, 8))
    single = DeviceVectorIndex(vecs, ids(), emb.identity(), device=CPU, slab_dtype=dtype).search_batch(q, 8, mode="xla")
    same(got, single)


@SHARDS
def test_tombstones_and_filters_respected(emb, vecs, n):
    tomb = np.array([i in (7, 12) for i in range(40)])
    idx = port_index(vecs, emb, n, slab_dtype="f32", tombstoned=tomb)
    q = emb.embed_batch([CORPUS[7][1], CORPUS[12][1]])
    got = idx.search_batch(q, 5)
    assert not {7, 12} & set(got.indices.numpy().reshape(-1).tolist())
    same(got, ref_index(vecs, n, slab_dtype="f32", tombstoned=tomb).search_batch(q, 5))
    allowed = frozenset(f"d{i}" for i in range(0, 40, 3))
    got = idx.search_batch(q, 6, search_filter=PortBitset(allowed))
    want = ref_index(vecs, n, slab_dtype="f32", tombstoned=tomb).search_batch(q, 6, search_filter=RefBitset(allowed))
    same(got, want)
    assert all(idx.doc_ids[r] in allowed for r in got.indices.numpy().reshape(-1) if r >= 0)


@SHARDS
def test_append_and_tombstone_stay_sharded(emb, vecs, n):
    idx = port_index(vecs, emb, n, slab_dtype="f32")
    new = emb.embed_batch(["fresh appended document", "another fresh one"])
    grown = idx.with_appended(["fresh", "fresh2"], new)
    assert isinstance(grown, ShardedDeviceVectorIndex) and grown.mesh is idx.mesh
    res = grown.search_batch(new, 3)
    assert [grown.doc_ids[int(r)] for r in res.indices[:, 0]] == ["fresh", "fresh2"]
    # in-batch duplicates are upserts, as on one device: the last one wins
    upsert = idx.with_appended(["fresh", "fresh2", "fresh"], np.concatenate([vecs[:1], new[1:], new[:1]]))
    assert upsert.n_rows == 42 and upsert._vectors_f32[upsert.row_for("fresh")].tolist() == \
        grown._vectors_f32[grown.row_for("fresh")].tolist()
    shrunk = grown.with_tombstones(["fresh"])
    assert isinstance(shrunk, ShardedDeviceVectorIndex) and shrunk.live_count == 41
    assert grown.row_for("fresh") not in shrunk.search_batch(new, 3).indices.numpy()[0].tolist()
    ref = ref_index(vecs, n, slab_dtype="f32").with_appended(["fresh", "fresh2"], new).with_tombstones(["fresh"])
    same(shrunk.search_batch(new, 3), ref.search_batch(new, 3))


@SHARDS
def test_int8_lane_equals_reference(emb, vecs, n):
    q = emb.embed_batch(QUERIES)
    got = port_index(vecs, emb, n).search_batch(q, 8, mode="int8")
    same(got, ref_index(vecs, n).search_batch(q, 8, mode="int8"))
    exact = port_index(vecs, emb, n).search_batch(q, 8, mode="xla")
    for g, w in zip(got.indices.numpy(), exact.indices.numpy()):
        assert len(set(g.tolist()) & set(w.tolist())) >= 6


@pytest.mark.parametrize("n", [2, 4])
def test_hier_aligned_lanes_equal_reference(emb, n):
    """``hier_align=True`` pads every shard to 8192 rows: ``hier`` (the K1 +
    K2 twins per shard) returns the exact scan's rows, ``int8_hier`` the
    reference's."""
    texts = [f"document number {i} about topic {i % 7}" for i in range(300)]
    v = emb.embed_batch(texts)
    doc_ids = [f"d{i}" for i in range(300)]
    idx = ShardedDeviceVectorIndex(v, doc_ids, emb.identity(), mesh=make_mesh(n, device="cpu"), hier_align=True)
    assert idx.local_rows == 8192 and idx.stats().padded_rows == n * 8192 - 300
    q = emb.embed_batch(["topic 3 document", "topic 5 number"] * 4)
    hier = idx.search_batch(q, 8, mode="hier")
    same(hier, idx.search_batch(q, 8, mode="xla"))
    ref = RefSharded(v, doc_ids, RefHash(dim=64).identity(), mesh=jmesh.make_mesh(n, axes=("d",)), hier_align=True)
    same(idx.search_batch(q, 8, mode="int8_hier"), ref.search_batch(q, 8, mode="int8_hier"))


def test_modes_off_the_mesh_are_refused(emb, vecs):
    idx = port_index(vecs, emb, 2)
    q = emb.embed_batch(QUERIES[:1])
    for mode in ("mrl", "ivf", "pallas"):
        with pytest.raises(InvalidConfig, match="single-device lane"):
            idx.search_batch(q, 5, mode=mode)
    with pytest.raises(InvalidConfig, match="8192-row shards"):
        idx.search_batch(q, 5, mode="hier")
    stats = idx.stats()
    assert (stats.shards, stats.devices, stats.total_rows, stats.padded_rows) == (2, ("cpu", "cpu"), 40, 8)


# -- the product surface ---------------------------------------------------------------------------


def build_root(pkg, root, *, config=None):
    api, kw = (fst, {"device": "cpu"}) if pkg == "port" else (fs, {})
    b = api.IndexBuilder(root, **kw).with_documents(
        api.IndexableDocument(doc_id=d, content=c) for d, c in CORPUS
    ).with_embedder_stack(api.EmbedderStack(fast=api.HashEmbedder(dim=64)))
    if config is not None:
        b = b.with_config(config)
    assert b.build().doc_count == len(CORPUS)
    return root


@SHARDS
def test_open_with_mesh_shards_equals_single_device(emb, tmp_path, n):
    root = build_root("port", str(tmp_path / "ix"), config=fst.TwoTierConfig(mesh_shards=n))
    plain = fst.TwoTierIndex.open(root, device=CPU)
    sharded = fst.TwoTierIndex.open(root, device=CPU, mesh_shards=n)
    assert isinstance(sharded.fast, ShardedDeviceVectorIndex) and sharded.mesh_shards == n
    assert len(sharded.fast.shard_devices) == n
    for query in QUERIES:
        q = emb.embed_batch([query])[0]
        hp = plain.search_fast_classified(q, 8).hits
        hs = sharded.search_fast_classified(q, 8).hits
        assert [h.doc_id for h in hp] == [h.doc_id for h in hs]
        np.testing.assert_allclose([h.score for h in hp], [h.score for h in hs], rtol=REL, atol=REL)


@pytest.mark.parametrize("n", [2, 8])
def test_append_delete_compact_keep_the_mesh(emb, tmp_path, n):
    root = build_root("port", str(tmp_path / "ix"))
    idx = fst.TwoTierIndex.open(root, device=CPU, mesh_shards=n)
    idx.append_fast(["new-doc"], emb.embed_batch(["completely new content here"]))
    idx.delete(["d3"])
    assert isinstance(idx.fast, ShardedDeviceVectorIndex)
    compacted = idx.compact()
    assert isinstance(compacted.fast, ShardedDeviceVectorIndex) and compacted.mesh_shards == n
    assert compacted.fast.row_for("d3") is None and compacted.fast.row_for("new-doc") is not None
    top = compacted.search_fast_classified(emb.embed_batch(["completely new content here"])[0], 1).hits
    assert top[0].doc_id == "new-doc"


def test_create_with_mesh_shards(emb, vecs, tmp_path):
    idx = fst.TwoTierIndex.create(str(tmp_path / "c"), vecs, ids(), emb.identity(), device=CPU, mesh_shards=4,
                                  slab_dtype="int8")
    assert isinstance(idx.fast, ShardedDeviceVectorIndex) and idx.fast._int8 is not None
    q = emb.embed_batch(QUERIES)
    ref = fs.TwoTierIndex.create(str(tmp_path / "r"), vecs, ids(), RefHash(dim=64).identity(), use_pallas=False,
                                 mesh_shards=4, slab_dtype="int8")
    same(idx.fast.search_batch(q, 8, mode="int8"), ref.fast.search_batch(q, 8, mode="int8"))


@pytest.mark.parametrize("n", [2, 4])
def test_open_hybrid_serves_sharded_arms_like_reference(tmp_path, n):
    roots = {p: build_root(p, str(tmp_path / p)) for p in ("port", "ref")}
    got = fst.open_hybrid(roots["port"], fast_embedder=fst.HashEmbedder(dim=64), device="cpu",
                          config=fst.TwoTierConfig(mesh_shards=n, fast_only=True))
    want = fs.open_hybrid(roots["ref"], fast_embedder=fs.HashEmbedder(dim=64),
                          config=fs.TwoTierConfig(mesh_shards=n, fast_only=True, use_pallas=False))
    assert isinstance(got.index.fast, ShardedDeviceVectorIndex)
    assert isinstance(got.delta.sealed, ShardedBulkDeviceBm25Index)
    assert isinstance(want.delta.sealed, RefShardedBm25)
    for q in QUERIES:
        g = got.searcher.search(q, k=5).results
        w = want.searcher.search(q, k=5).results
        assert [r.doc_id for r in g] == [r.doc_id for r in w], q
        np.testing.assert_allclose([r.score for r in g], [r.score for r in w], rtol=REL)
    g = got.searcher.search_batch(QUERIES, k=5)
    assert got.searcher.last_phase1_lex_lane == "sharded"
    w = want.searcher.search_batch(QUERIES, k=5)
    assert [[r.doc_id for r in o.results] for o in g] == [[r.doc_id for r in o.results] for o in w]
    got.close()
    want.close()


def fused_docs(api):
    rng = np.random.default_rng(6)
    words = ["alpha", "beta", "gamma", "delta"]
    return [api.IndexableDocument(doc_id=f"d{i:03d}", content=" ".join(rng.choice(words, size=7)) + f" tag{i % 10}")
            for i in range(96)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_fused_lane_engages_with_parity(tmp_path, n):
    """Both arms sharded: ``search_batch`` takes the sharded fused lane with
    the device RRF tail, bitwise equal to the host RRF oracle on the same
    arm outputs, to the port's single-device searcher and to the
    reference's sharded searcher (doc ids and fused scores)."""
    import frankensearch_tpu_torch.ops.hybrid_phase1 as hp

    docs = fused_docs(fst)
    emb = fst.HashEmbedder(dim=64)
    cfg = fst.TwoTierConfig(fast_only=True)
    idx = fst.TwoTierIndex.create(str(tmp_path / "p"), emb.embed_batch([d.content for d in docs]),
                                  [d.doc_id for d in docs], emb.identity(), device=CPU, mesh_shards=n)
    lex = ShardedBulkDeviceBm25Index(fst.BulkDeviceBm25Index(docs, device=CPU), make_mesh(n, device="cpu"))
    fused = fst.TwoTierSearcher(idx, emb, lexical=lex, config=cfg)
    plain = fst.TwoTierSearcher(fst.TwoTierIndex.open(str(tmp_path / "p"), device=CPU), emb,
                                lexical=fst.BulkDeviceBm25Index(docs, device=CPU), config=cfg)
    calls = []
    orig = hp.fused_phase1_sharded
    hp.fused_phase1_sharded = lambda *a, **k: calls.append(k["scan_mode"]) or orig(*a, **k)
    try:
        queries = ["alpha beta", "gamma tag3", "delta tag7", "beta beta alpha"]
        outs = fused.search_batch(queries, k=6)
    finally:
        hp.fused_phase1_sharded = orig
    assert calls == ["xla"] and fused.last_phase1_lex_lane == "sharded" and fused.last_fusion_path == "device"
    assert all(o.metrics.phase1_fused for o in outs)
    for q, o in zip(queries, outs):
        assert [(r.doc_id, r.score) for r in o.results] == [(r.doc_id, r.score) for r in plain.search(q, k=6).results]
    fused._device_rrf_tail = lambda *a: (None, None)
    oracle = fused.search_batch(queries, k=6)
    assert fused.last_fusion_path == "host"
    assert [[(r.doc_id, r.score) for r in o.results] for o in oracle] == \
        [[(r.doc_id, r.score) for r in o.results] for o in outs]
    ref_docs = fused_docs(fs)
    remb = fs.HashEmbedder(dim=64)
    ref_idx = fs.TwoTierIndex.create(str(tmp_path / "r"), remb.embed_batch([d.content for d in ref_docs]),
                                     [d.doc_id for d in ref_docs], remb.identity(), use_pallas=False, mesh_shards=n)
    ref_lex = RefShardedBm25(RefBulk(ref_docs), jmesh.make_mesh(n, axes=("d",)))
    ref = fs.TwoTierSearcher(ref_idx, remb, lexical=ref_lex, config=fs.TwoTierConfig(fast_only=True))
    for o, w in zip(outs, ref.search_batch(queries, k=6)):
        assert [r.doc_id for r in o.results] == [r.doc_id for r in w.results]
        np.testing.assert_allclose([r.score for r in o.results], [r.score for r in w.results], rtol=REL)


def test_one_sharded_arm_takes_the_unfused_path(tmp_path):
    """A sharded fast tier beside a single-device lexical arm is not the
    sharded lane: phase 1 runs unfused, with the same results."""
    docs = fused_docs(fst)
    emb = fst.HashEmbedder(dim=64)
    idx = fst.TwoTierIndex.create(str(tmp_path / "p"), emb.embed_batch([d.content for d in docs]),
                                  [d.doc_id for d in docs], emb.identity(), device=CPU, mesh_shards=2)
    s = fst.TwoTierSearcher(idx, emb, lexical=fst.BulkDeviceBm25Index(docs, device=CPU),
                            config=fst.TwoTierConfig(fast_only=True))
    outs = s.search_batch(["alpha beta", "gamma tag3"], k=6)
    assert not any(o.metrics.phase1_fused for o in outs) and all(o.results for o in outs)
