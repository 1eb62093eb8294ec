"""The port's block-sharded BM25 arm (``parallel/sharded_bm25.py``) against
the JAX reference's and against the port's own single-device pruned lane,
on the CPU.

Oracles: tests/test_sharded_index.py's TestShardedBm25 and
tests/test_fused_hot.py's TestShardedWithHot. Each shard runs the port's
pruned lane (its seq-T step, terms in chunks of 8 with a fused
multiply-add each), so over any mesh the arm equals the port's
single-device pruned lane on the same postings bit for bit. The
reference's sharded arm steps each block with a one-shot einsum: rows are
equal except where two scores lie within 1e-6 of the k-th, and scores
agree within 1e-6 relative. Meshes of 1, 2, 4 and 8 shards.
"""

import numpy as np
import pytest
import torch

from frankensearch_tpu.core.types import IndexableDocument as RefDoc
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulk
from frankensearch_tpu.lexical.query import parse_query as ref_parse
from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index as RefSharded
from frankensearch_tpu_torch.core.types import IndexableDocument as PortDoc
from frankensearch_tpu_torch.lexical import device_bm25 as tbm
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from frankensearch_tpu_torch.lexical.query import parse_query
from frankensearch_tpu_torch.parallel.mesh import make_mesh
from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")
MESHES = pytest.mark.parametrize("n", [1, 2, 4, 8])
QUERIES = ["alpha beta", "gamma tag3", "epsilon zeta omicron", "nosuchword", "tag5 tag6 alpha"]


def corpus(doc, n=200):
    rng = np.random.default_rng(4)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "omicron"]
    return [doc(doc_id=f"d{i:04d}", content=" ".join(rng.choice(words, size=12)) + f" tag{i % 17}")
            for i in range(n)]


def bits(cands):
    return [(c.doc_id, np.float32(c.score).view(np.uint32)) for c in cands]


def arrays(cands_rows, row_of, k):
    s = np.full((len(cands_rows), k), -np.inf, np.float32)
    i = np.full((len(cands_rows), k), -1, np.int64)
    for b, cands in enumerate(cands_rows):
        s[b, : len(cands)] = [c.score for c in cands]
        i[b, : len(cands)] = [row_of[c.doc_id] for c in cands]
    return s, i


def rank_tolerant(got, want, row_of, k):
    th.assert_rank_tolerant(*arrays(got, row_of, k), *arrays(want, row_of, k))


def own_pruned_lane(inner, queries, k):
    """The port's single-device pruned lane over the unsplit layout of the
    same postings, in one default-width block layout."""
    terms, docs, tfs = inner._post_host
    blocked = tbm._build_blocked(terms.astype(np.int64), docs.astype(np.int64), tfs, n_docs=inner.n_docs,
                                 vocab_size=inner.vocab_size, device=CPU)
    ids, w = inner._query_sparse_rows(queries)
    s, i, _ = tbm._graded_scan_pruned(blocked.classes, blocked.split_bounds(blocked.query_bounds(ids, w), CPU),
                                      torch.from_numpy(ids), torch.from_numpy(w), k=k)
    s, i = s.numpy(), i.numpy()
    return [[(inner.doc_ids[int(i[b, j])], s[b, j].view(np.uint32)) for j in range(k) if s[b, j] > 0.0]
            for b in range(len(queries))]


@MESHES
def test_parity_with_own_pruned_lane_and_reference(n):
    docs = corpus(PortDoc)
    inner = BulkDeviceBm25Index(docs, device=CPU)
    arm = ShardedBulkDeviceBm25Index(inner, make_mesh(n, device="cpu"))
    assert arm._blocked_host.n_blk >= n and arm.device == CPU
    got = arm.search_candidates_batch(QUERIES, 10)
    assert [bits(g) for g in got] == own_pruned_lane(inner, QUERIES, 10)
    ref = RefSharded(RefBulk(corpus(RefDoc)), jmesh.make_mesh(n, axes=("d",)))
    rank_tolerant(got, ref.search_candidates_batch(QUERIES, 10), {d: r for r, d in enumerate(inner.doc_ids)}, 10)
    # and within 1e-6 of the single-device dense lane
    rank_tolerant(got, inner.search_candidates_batch(QUERIES, 10), {d: r for r, d in enumerate(inner.doc_ids)}, 10)
    assert got[3] == [] and arm.search_candidates("alpha beta", 10) == got[0]


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("k", [1, 40, 300])
def test_budgets_past_a_shard_and_the_corpus(n, k):
    docs = corpus(PortDoc, 120)
    inner = BulkDeviceBm25Index(docs, device=CPU)
    arm = ShardedBulkDeviceBm25Index(inner, make_mesh(n, device="cpu"))
    got = arm.search_candidates_batch(QUERIES, k)
    assert [bits(g) for g in got] == own_pruned_lane(inner, QUERIES, min(k, 120))
    assert all(len({c.doc_id for c in g}) == len(g) for g in got)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pruning_engages_across_shards(n):
    """tf alternates per ~block-sized window, so every shard holds a block
    whose bound its local k-th score beats: blocks are skipped, and the
    skipped count equals the reference's (padding blocks included)."""
    def docs(doc):
        return [doc(doc_id=f"d{i:04d}", content=("alpha " * (12 if (i // 48) % 2 == 0 else 6)) + f"filler{i}")
                for i in range(768)]

    arm = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(docs(PortDoc), device=CPU), make_mesh(n, device="cpu"),
                                     block_postings=96)
    ref = RefSharded(RefBulk(docs(RefDoc)), jmesh.make_mesh(n, axes=("d",)), block_postings=96)
    hits = arm.search_candidates("alpha", 5)
    want = ref.search_candidates("alpha", 5)
    assert hits[0].doc_id == "d0000" and [c.doc_id for c in hits] == [c.doc_id for c in want]
    assert arm.last_blocks_skipped > 0 and arm.last_blocks_skipped == ref.last_blocks_skipped


@pytest.mark.parametrize("n", [2, 4])
def test_split_layout_rebuilds_the_unsplit_layout(n):
    """A split (hot-arm) index is wrapped over the unsplit graded layout
    rebuilt from its host postings: the port's own pruned lane's bits, the
    reference's rows within 1e-6."""
    mem, ref_idx, port_idx = th.build_pair()
    assert port_idx._hot is not None
    arm = ShardedBulkDeviceBm25Index(port_idx, make_mesh(n, device="cpu"))
    assert all(c.term is not None for c in arm._blocked_host.classes)
    got = arm.search_candidates_batch(th.QUERIES, 20)
    assert [bits(g) for g in got] == own_pruned_lane(port_idx, th.QUERIES, 20)
    want = RefSharded(ref_idx, jmesh.make_mesh(n, axes=("d",))).search_candidates_batch(th.QUERIES, 20)
    rank_tolerant(got, want, port_idx._row_of, 20)


@pytest.mark.parametrize("n", [1, 4])
def test_unsplit_blocked_index_is_sharded_as_it_stands(n):
    """An unsplit blocked index (hot arm off) keeps its own layout; the
    sharded arm equals its pruned lane bit for bit."""
    with th.lowered(hot=False, extra=[(tbm, "DEFAULT_BLOCK_POSTINGS", 512)]):
        port_idx = tbm.DeviceBm25Index(th.memory_pair(th.corpus())[1], device=CPU)
    assert port_idx._hot is None and port_idx._blocked.n_blk > 8
    port_idx.daat_mode = "blocked"
    arm = ShardedBulkDeviceBm25Index(port_idx, make_mesh(n, device="cpu"))
    assert arm._blocked_host is port_idx._blocked
    for k in (1, 25):
        assert [bits(g) for g in arm.search_candidates_batch(th.QUERIES, k)] == \
            [bits(g) for g in port_idx.search_candidates_batch(th.QUERIES, k)]


@pytest.mark.parametrize("raw", ["alpha AND beta", '"alpha beta"', "gamma NOT alpha"])
def test_boolean_parity_with_single_device(raw):
    single = BulkDeviceBm25Index(corpus(PortDoc), device=CPU)
    arm = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(corpus(PortDoc), device=CPU), make_mesh(4, device="cpu"))
    ref = RefSharded(RefBulk(corpus(RefDoc)), jmesh.make_mesh(4, axes=("d",)))
    got = [(r.doc_id, round(r.score, 5)) for r in arm.search_boolean(parse_query(raw), 10)]
    assert got == [(r.doc_id, round(r.score, 5)) for r in single.search_boolean(parse_query(raw), 10)]
    assert got == [(r.doc_id, round(r.score, 5)) for r in ref.search_boolean(ref_parse(raw), 10)]
