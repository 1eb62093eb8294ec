"""The live index's write path (``TwoTierIndex.append_fast``,
``append_quality``, ``delete``, ``sync_wal``, ``compact``) against the JAX
reference on the CPU.

The same operations on the same vectors go through both packages, each on
its own copy of one artifact: the WAL sidecars and the compacted FTVI
artifacts must be byte-identical, the vacuum stats equal, and the searches
before and after compaction and reopening equal (doc ids; scores within
1e-6, the two CPU backends' f32 sum order). Oracles: tests/test_index.py,
tests/test_wal_group_commit.py, tests/test_generation.py and
tests/test_recall_cert_persist.py, whose cases are repeated here on the
port. An append drops the IVF arm (``mode="ivf"`` raises ``InvalidConfig``
until ``enable_ivf()`` runs again); IVF and MRL certificates persist and
rebind like the int8 lane's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from frankensearch_tpu.index.fsvi import EmbeddingIdentity as RefIdentity
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig
from frankensearch_tpu_torch.core.errors import InvalidConfig, UncertifiedScanMode
from frankensearch_tpu_torch.core.generation import build_manifest, read_manifest, sha256_file, write_manifest
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.index.two_tier import FAST_FILE, QUALITY_FILE, TwoTierIndex, VacuumStats
from frankensearch_tpu_torch.index.wal import WriteAheadLog
from tests.conftest import make_unit_rows

CPU = torch.device("cpu")
IDENT = EmbeddingIdentity(embedder_id="test-emb", embedder_revision="1", dim=32)
REF_IDENT = RefIdentity(embedder_id="test-emb", embedder_revision="1", dim=32)
QIDENT = EmbeddingIdentity(embedder_id="quality-emb", dim=48)
REF_QIDENT = RefIdentity(embedder_id="quality-emb", dim=48)
EMB = HashEmbedder(dim=32)
SIDECARS = (FAST_FILE, FAST_FILE + ".wal", QUALITY_FILE, QUALITY_FILE + ".wal")


def _bytes(root, name):
    path = os.path.join(root, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _hits(index, q, k=8):
    return [(h.doc_id, h.score) for h in index.search_fast_classified(q, k).hits]


def _same_hits(got, want):
    assert [d for d, _ in got] == [d for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6, atol=1e-6)


@pytest.fixture
def pair(tmp_path):
    """One artifact (fast + quality tier) written by the reference, copied
    so that each package mutates its own root."""
    rng = np.random.default_rng(0)
    fast, quality = make_unit_rows(rng, 40, 32), make_unit_rows(rng, 40, 48)
    ids = [f"doc-{i}" for i in range(40)]
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    RefIndex.create(ref_root, fast, ids, REF_IDENT, quality_vectors=quality, quality_identity=REF_QIDENT,
                    use_pallas=True)
    shutil.copytree(ref_root, port_root)
    return {"ref": RefIndex.open(ref_root, use_pallas=True), "port": TwoTierIndex.open(port_root, device=CPU),
            "ref_root": ref_root, "port_root": port_root, "fast": fast, "quality": quality, "rng": rng}


@pytest.mark.parametrize("wal_sync", ["always", "deferred"])
def test_write_path_matches_reference_byte_for_byte(pair, wal_sync):
    ref, port, rng = pair["ref"], pair["port"], pair["rng"]
    ref.wal_sync = port.wal_sync = wal_sync
    new = make_unit_rows(rng, 5, 32)
    upsert = make_unit_rows(rng, 1, 32)
    new_q = make_unit_rows(rng, 3, 48)
    steps = [
        ("append_fast", ([f"new-{i}" for i in range(5)], new)),
        ("append_fast", (["doc-7"], upsert)),  # supersedes a base row
        ("append_quality", (["new-0", "new-1", "doc-3"], new_q)),
        ("delete", (["doc-0", "doc-1", "new-4", "missing"],)),
        ("sync_wal", ()),
    ]
    probes = np.concatenate([new, upsert, pair["fast"][:3]])
    for name, args in steps:
        getattr(ref, name)(*args)
        getattr(port, name)(*args)
        for name_ in SIDECARS:
            assert _bytes(pair["port_root"], name_) == _bytes(pair["ref_root"], name_), (name, name_)
        for q in probes:
            _same_hits(_hits(port, q), _hits(ref, q))
        assert port.doc_count() == ref.doc_count()
        np.testing.assert_array_equal(port._fast_to_quality, ref._fast_to_quality)
    got, want = port.compact(), ref.compact()
    for name_ in SIDECARS:
        assert _bytes(pair["port_root"], name_) == _bytes(pair["ref_root"], name_), name_
    assert {k: v.__dict__ for k, v in got.last_vacuum_stats.items()} == {
        k: v.__dict__ for k, v in want.last_vacuum_stats.items()}
    assert isinstance(got.last_vacuum_stats[FAST_FILE], VacuumStats)
    assert got.fast.slab_dtype == "bf16" and got.fast.device == CPU
    for q in probes:
        _same_hits(_hits(got, q), _hits(want, q))
    # each package reopens the other's compacted root to the same state
    for q in probes:
        _same_hits(_hits(TwoTierIndex.open(pair["ref_root"], device=CPU), q),
                   _hits(RefIndex.open(pair["port_root"], use_pallas=True), q))


def test_quality_rescore_follows_the_appends(pair):
    ref, port, rng = pair["ref"], pair["port"], pair["rng"]
    for index in (ref, port):
        index.append_fast(["late"], pair["fast"][5:6] * 0.5 + 0.1)
        index.append_quality(["late", "doc-9"], pair["quality"][[2, 4]])
    q = pair["quality"][2]
    hits = port.search_fast_classified(pair["fast"][5], 10).hits
    ref_hits = ref.search_fast_classified(pair["fast"][5], 10).hits
    got, want = port.quality_scores_for_hits(q, hits), ref.quality_scores_for_hits(q, ref_hits)
    assert got.keys() == want.keys() and "late" in got
    for d in got:
        assert abs(got[d] - want[d]) <= 1e-6
    with pytest.raises(ValueError):
        TwoTierIndex(port.fast).append_quality(["x"], q[None, :])


# --------------------------------------------------------------------------
# tests/test_index.py and tests/test_wal_group_commit.py, on the port
# --------------------------------------------------------------------------


def _create(root, n, rng):
    """An index whose identity is the HashEmbedder's, so a searcher over it
    admits the semantic arm."""
    fast = make_unit_rows(rng, n, 32)
    return TwoTierIndex.create(root, fast, [f"doc-{i}" for i in range(n)], EMB.identity(), device=CPU), fast


def test_wal_append_survives_reopen(rng, tmp_path):
    idx, _ = _create(str(tmp_path / "ix"), 10, rng)
    new = make_unit_rows(rng, 1, 32)
    idx.append_fast(["doc-extra"], new)
    reopened = TwoTierIndex.open(str(tmp_path / "ix"), device=CPU)
    assert reopened.doc_count() == 11
    assert reopened.search_fast_classified(new[0], 1).hits[0].doc_id == "doc-extra"


def test_delete_and_compact(rng, tmp_path):
    root = str(tmp_path / "ix")
    idx, _ = _create(root, 10, rng)
    idx.delete(["doc-0", "doc-1"])
    assert idx.doc_count() == 8
    compacted = idx.compact()
    assert compacted.doc_count() == 8 and compacted.fast.n_rows == 8  # physically removed
    # compact truncates to its open snapshot: this handle's tombstones stay
    # in the tail until a fresh open folds them
    TwoTierIndex.open(root, device=CPU).compact()
    st = WriteAheadLog(os.path.join(root, FAST_FILE + ".wal")).replay()
    assert st.batches_read == 0 and not st.live and not st.tombstones


def test_two_tier_policy_plumbs(rng, tmp_path):
    idx, _ = _create(str(tmp_path / "ix"), 10, rng)
    idx.wal_sync = "deferred"
    new = make_unit_rows(rng, 2, 32)
    idx.append_fast(["x1", "x2"], new)
    idx.delete(["doc-0"])
    idx.sync_wal()
    reopened = TwoTierIndex.open(str(tmp_path / "ix"), device=CPU)
    assert reopened.doc_count() == 11
    assert reopened.search_fast_classified(new[0], 1).hits[0].doc_id == "x1"


def test_compact_racing_writer_loses_nothing(rng, tmp_path):
    root = str(tmp_path / "ix")
    _create(root, 10, rng)
    compactor, writer = TwoTierIndex.open(root, device=CPU), TwoTierIndex.open(root, device=CPU)
    v = make_unit_rows(rng, 1, 32)
    writer.append_fast(["raced"], v)  # after the compactor's snapshot
    compactor.compact()
    reopened = TwoTierIndex.open(root, device=CPU)
    assert reopened.search_fast_classified(v[0], 1).hits[0].doc_id == "raced"


def test_second_compact_on_same_instance_loses_nothing(rng, tmp_path):
    root = str(tmp_path / "ix")
    _create(root, 10, rng)
    compactor, writer = TwoTierIndex.open(root, device=CPU), TwoTierIndex.open(root, device=CPU)
    writer.append_fast(["pre"], make_unit_rows(rng, 1, 32))
    compactor.compact()
    writer.append_fast(["raced2"], make_unit_rows(rng, 1, 32))  # into the rewritten WAL
    compactor.compact()
    assert {"pre", "raced2"} <= set(TwoTierIndex.open(root, device=CPU).fast.doc_ids)


def test_own_postopen_appends_survive_compact(rng, tmp_path):
    root = str(tmp_path / "ix")
    idx, _ = _create(root, 6, rng)
    idx.append_fast(["own"], make_unit_rows(rng, 1, 32))
    assert idx.compact().doc_count() == 7
    reopened = TwoTierIndex.open(root, device=CPU)
    assert reopened.doc_count() == 7 and sorted(reopened.fast.doc_ids).count("own") == 1


def test_an_unrooted_index_writes_memory_only(rng):
    from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex

    fast = make_unit_rows(rng, 4, 32)
    idx = TwoTierIndex(DeviceVectorIndex(fast, list("abcd"), IDENT, device=CPU))
    idx.append_fast(["e"], fast[:1])  # no root: memory only
    idx.delete(["a"])
    idx.sync_wal()
    assert idx.doc_count() == 4
    with pytest.raises(ValueError):
        idx.compact()


# --------------------------------------------------------------------------
# tests/test_generation.py: compaction keeps the manifest truthful
# --------------------------------------------------------------------------


def test_compact_keeps_manifest_truthful(rng, tmp_path):
    root = str(tmp_path / "ix")
    idx, _ = _create(root, 12, rng)
    manifest = build_manifest(root, "gen-1", 3, doc_count=12)
    manifest.extra = {"conformance": {"probe": 1}}
    write_manifest(root, manifest)
    idx.delete(["doc-3"])
    idx.compact()
    m = read_manifest(root)
    assert m.commit_seq == 4 and m.generation_id == "gen-1"  # the anti-rollback floor rises
    for a in m.artifacts:
        assert sha256_file(os.path.join(root, a.name)) == a.sha256, a.name  # census truthful
    assert m.extra["conformance"] == {"probe": 1}  # carried over


# --------------------------------------------------------------------------
# the IVF arm and the approximate lanes' certificates on the write path
# --------------------------------------------------------------------------


def test_append_invalidates_the_ivf_arm(rng, tmp_path):
    idx, fast = _create(str(tmp_path / "ix"), 300, rng)
    idx.fast.enable_ivf(n_clusters=4, dtype=torch.float32)
    idx.fast.search_batch(fast[:2], 3, mode="ivf")  # serves
    idx.delete(["doc-0"])  # a new index over the same rows: the arm is rebuilt by hand too
    with pytest.raises(InvalidConfig):
        idx.fast.search_batch(fast[:2], 3, mode="ivf")
    idx.fast.enable_ivf(n_clusters=4, dtype=torch.float32)
    new = make_unit_rows(rng, 1, 32)
    idx.append_fast(["fresh"], new)
    with pytest.raises(InvalidConfig, match="enable_ivf"):
        idx.fast.search_batch(new, 3, mode="ivf")
    searcher = TwoTierSearcher(idx, EMB, config=TwoTierConfig(fast_only=True, scan_mode="ivf"))
    with pytest.raises(InvalidConfig):
        searcher.search_batch(["w1 w2"], k=3)
    idx.fast.enable_ivf(n_clusters=4, dtype=torch.float32)
    hits = idx.fast.hydrate(idx.fast.search_batch(new, 3, mode="ivf", nprobe=4))[0]
    assert hits[0].doc_id == "fresh" and "doc-0" not in {h.doc_id for h in hits}
    assert searcher.search_batch(["w1 w2"], k=3)[0].results


@pytest.mark.parametrize("mode,kw", [("ivf", {"nprobe": 4}), ("mrl", {"mrl_search_dims": 16})])
def test_ivf_and_mrl_certificates_persist_and_rebind(rng, tmp_path, mode, kw):
    """As the int8 lane's (tests/test_recall_cert_persist.py): certify ->
    the manifest entry; an unchanged reopen rebinds it and the fail-closed
    gate serves; a WAL append voids it."""
    root = str(tmp_path / "ix")
    idx, fast = _create(root, 256, rng)
    write_manifest(root, build_manifest(root, "gen-1", 1, doc_count=256))
    idx.fast.enable_ivf(n_clusters=8, dtype=torch.float32)
    cert = idx.certify_fast_scan_mode(mode, 10, fast[:32] + 0.01, **kw)
    reopened = TwoTierIndex.open(root, device=CPU)
    assert reopened.fast.recall_certificate(mode) == cert
    reopened.fast.enable_ivf(n_clusters=8, dtype=torch.float32)
    cfg = {"ivf_nprobe": 4} if mode == "ivf" else {"mrl_search_dims": 16}
    searcher = TwoTierSearcher(reopened, EMB, config=TwoTierConfig(
        fast_only=True, scan_mode=mode, require_recall_certificate=True,
        min_certified_recall=min(cert.certified_recall, 0.5), **cfg))
    assert searcher.search("w1 w2", k=5).results
    assert searcher.search_batch(["w1 w2", "w3"], k=5)[0].results
    reopened.append_fast(["extra"], fast[:1] * 0.9)
    again = TwoTierIndex.open(root, device=CPU)
    assert again.fast.recall_certificate(mode) is None
    again.fast.enable_ivf(n_clusters=8, dtype=torch.float32)
    gated = TwoTierSearcher(again, EMB, config=searcher.config)
    with pytest.raises(UncertifiedScanMode, match="no recall certificate"):
        gated.search_batch(["w1"], k=5)
