"""The port's own copies of the reference's host modules, held to the
originals on the same inputs (both on the CPU).

The port imports nothing of ``frankensearch_tpu``; it carries copies of
the jax-free host modules it needs. Each check here feeds the same
seeded inputs to the reference's module and to the port's copy, each
built from its own package's types, and compares outputs: embedder
vectors bitwise, fused lists field by field, lexical results exactly,
and the on-disk FTVI and WAL bytes byte for byte (each package reads what
the other writes).
"""

import dataclasses
import os

import numpy as np
import pytest

from frankensearch_tpu.core import canonicalize as r_canon
from frankensearch_tpu.core import parsed_query as r_parsed
from frankensearch_tpu.core import query_class as r_qc
from frankensearch_tpu.core import types as r_types
from frankensearch_tpu.core.config import FusionStrategy as RFusion
from frankensearch_tpu.core.config import TiebreakStrategy as RTie
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RHash
from frankensearch_tpu.fusion import rrf as r_rrf
from frankensearch_tpu.fusion import rrf_batch as r_rrf_batch
from frankensearch_tpu.index import fsvi as r_fsvi
from frankensearch_tpu.index import wal as r_wal
from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex as RMem
from frankensearch_tpu_torch.core import canonicalize as p_canon
from frankensearch_tpu_torch.core import parsed_query as p_parsed
from frankensearch_tpu_torch.core import query_class as p_qc
from frankensearch_tpu_torch.core import types as p_types
from frankensearch_tpu_torch.core.config import FusionStrategy as PFusion
from frankensearch_tpu_torch.core.config import TiebreakStrategy as PTie
from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder as PHash
from frankensearch_tpu_torch.fusion import rrf as p_rrf
from frankensearch_tpu_torch.fusion import rrf_batch as p_rrf_batch
from frankensearch_tpu_torch.index import fsvi as p_fsvi
from frankensearch_tpu_torch.index import wal as p_wal
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex as PMem
from tests import test_torch_hot_arm as th

TEXTS = [
    "rust async futures", "", "  Ünïcödé   text\twith spaces ", "fn main() { println!(\"hi\"); }",
    "w1 w2 w3 w1", "the quick brown fox jumps over the lazy dog " * 20,
]
QUERIES = ["w0 w1", "w250", "w40 -w41", "\"w3 w4\"", "Foo::bar_baz", "", "  ", "w7 OR w199"]


def _fields(x):
    """A dataclass (or enum) of either package as plain values."""
    if dataclasses.is_dataclass(x):
        return tuple(_fields(getattr(x, f.name)) for f in dataclasses.fields(x))
    if hasattr(x, "value") and hasattr(x, "name"):
        return (type(x).__name__, x.value)
    if isinstance(x, (list, tuple)):
        return tuple(_fields(v) for v in x)
    return x


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("dim", [32, 256, 384])
def test_hash_embedder_is_the_reference_bitwise(dim):
    ref, port = RHash(dim=dim), PHash(dim=dim)
    np.testing.assert_array_equal(_bits(port.embed_batch(TEXTS)), _bits(ref.embed_batch(TEXTS)))
    assert _fields(port.identity()) == _fields(ref.identity())


def test_query_analysis_matches_reference():
    rc, pc = r_canon.DefaultCanonicalizer(), p_canon.DefaultCanonicalizer()
    for q in QUERIES + TEXTS:
        cq = pc.canonicalize_query(q)
        assert cq == rc.canonicalize_query(q)
        assert pc.canonicalize_document(q) == rc.canonicalize_document(q)
        assert _fields(p_parsed.ParsedQuery.parse(cq)) == _fields(r_parsed.ParsedQuery.parse(cq))
        assert p_qc.QueryClass.classify(cq).value == r_qc.QueryClass.classify(cq).value


def _pools(types, seed):
    rng = np.random.default_rng(seed)
    ids = [f"d{i:03d}" for i in range(60)]
    lex = [types.ScoredResult(doc_id=ids[i], score=float(s), lexical_score=float(s))
           for i, s in zip(rng.permutation(60)[:25], np.round(rng.random(25), 2))]
    vec = [types.VectorHit(doc_id=ids[i], score=float(s), row=int(i))
           for i, s in zip(rng.permutation(60)[:30], np.round(rng.random(30), 3))]
    return sorted(lex, key=lambda r: -r.score), sorted(vec, key=lambda h: -h.score)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy", ["rrf", "pool_minmax"])
@pytest.mark.parametrize("tiebreak", ["lexical_then_id", "neutral_hash"])
def test_fusion_matches_reference(seed, strategy, tiebreak):
    r_lex, r_vec = _pools(r_types, seed)
    p_lex, p_vec = _pools(p_types, seed)
    r_cfg = r_rrf.RrfConfig(k=60.0, lexical_weight=1.0, semantic_weight=0.7, tiebreak=RTie(tiebreak))
    p_cfg = p_rrf.RrfConfig(k=60.0, lexical_weight=1.0, semantic_weight=0.7, tiebreak=PTie(tiebreak))
    want = r_rrf.fuse_by_strategy(RFusion(strategy), r_lex, r_vec, 20, 0, r_cfg)
    got = p_rrf.fuse_by_strategy(PFusion(strategy), p_lex, p_vec, 20, 0, p_cfg)
    assert _fields(got) == _fields(want) and len(got) == 20


def test_batch_rrf_matches_reference():
    rng = np.random.default_rng(5)
    b, kl, kv, n = 6, 20, 30, 80
    lex_rows = np.stack([rng.permutation(n)[:kl] for _ in range(b)]).astype(np.int64)
    lex_rows[:, -3:] = -1
    lex_scores = np.sort(rng.random((b, kl)).astype(np.float32), axis=1)[:, ::-1].copy()
    vec_rows = np.stack([rng.permutation(n)[:kv] for _ in range(b)]).astype(np.int64)
    k_arr = rng.choice([30.0, 60.0], size=b)
    sem_w = rng.random(b)
    args = (lex_rows, lex_scores, vec_rows, 15, k_arr, 1.0, sem_w, n)
    want, got = r_rrf_batch.rrf_fuse_batch_rows(*args), p_rrf_batch.rrf_fuse_batch_rows(*args)
    assert got == want
    ids = [f"d{i}" for i in range(n)]
    for g, w in zip(got, want):
        assert _fields(p_rrf_batch.rows_to_fused_hits(g, ids)) == _fields(r_rrf_batch.rows_to_fused_hits(w, ids))


def test_memory_lexical_index_matches_reference():
    docs = th.corpus(n_docs=200)
    ref, port = th.memory_pair(docs)
    assert port.doc_count() == ref.doc_count()
    for q in th.QUERIES + ["w3 w4", "w12 -w1"]:
        for budget in (5, 50):
            got = [(c.doc_id, c.score) for c in port.search_candidates(q, budget)]
            assert got == [(c.doc_id, c.score) for c in ref.search_candidates(q, budget)], q
            assert _fields(port.search(q, budget)) == _fields(ref.search(q, budget))
    bulk_docs = th.port_docs(docs)
    bulk = PMem.bulk_build(bulk_docs)
    assert [(c.doc_id, c.score) for c in bulk.search_candidates("w0 w1", 20)] == [
        (c.doc_id, c.score) for c in RMem.bulk_build(docs).search_candidates("w0 w1", 20)
    ]


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32", "int8"])
def test_ftvi_bytes_round_trip_across_packages(tmp_path, dtype):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((50, 48)).astype(np.float32)
    ids = [f"doc-{i}" for i in range(50)]
    scale = None
    if dtype == "int8":
        scale = (np.abs(v).max(axis=0) / 127.0).astype(np.float32)
        v = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
    flags = np.zeros(50, np.uint8)
    flags[[3, 7]] = 1
    paths = {}
    for name, mod in (("ref", r_fsvi), ("port", p_fsvi)):
        paths[name] = str(tmp_path / f"{name}.idx")
        ident = mod.EmbeddingIdentity(embedder_id="hash-48", embedder_revision="r1", dim=48)
        mod.write_ftvi(paths[name], v, ids, ident, dtype=dtype, flags=flags, scale=scale)
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for reader, path in ((p_fsvi, paths["ref"]), (r_fsvi, paths["port"])):
        f = reader.FtviFile(path, verify_slab=True)
        assert list(f.doc_ids) == ids and f.header.dtype == dtype
        np.testing.assert_array_equal(f.tombstoned(), flags.astype(bool))
    np.testing.assert_array_equal(
        _bits(p_fsvi.FtviFile(paths["ref"]).vectors_f32()), _bits(r_fsvi.FtviFile(paths["port"]).vectors_f32())
    )


def test_wal_bytes_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    batches = [(["a", "b"], rng.standard_normal((2, 16)).astype(np.float32)),
               (["c", "a"], rng.standard_normal((2, 16)).astype(np.float32))]
    paths = {}
    for name, mod in (("ref", r_wal), ("port", p_wal)):
        paths[name] = str(tmp_path / f"{name}.wal")
        log = mod.WriteAheadLog(paths[name])
        for ids, vecs in batches:
            log.append(ids, vecs)
        log.tombstone(["b"])
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    want, got = r_wal.WriteAheadLog(paths["port"]).replay(), p_wal.WriteAheadLog(paths["ref"]).replay()
    assert sorted(got.live) == sorted(want.live) and set(got.tombstones) == set(want.tombstones)
    for doc_id in want.live:
        np.testing.assert_array_equal(_bits(got.live[doc_id]), _bits(want.live[doc_id]))
    assert os.path.getsize(paths["port"]) == got.bytes_consumed == want.bytes_consumed
