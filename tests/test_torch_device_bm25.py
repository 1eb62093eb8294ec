"""PyTorch port of device BM25 against the JAX reference: the dense lane,
and at blocked scale the split (flat + DAAT) and pruned lanes end to end.

The same corpus goes into the reference's ``DeviceBm25Index`` /
``BulkDeviceBm25Index`` and, through ``convert.bm25_from_arrays`` or the
port's own builders, into the port. The port's per-doc sum visits each
doc's postings in posting order, as the reference's segment sum does on the
CPU, so scores and rows are bitwise equal. The retired selectivity-grouped
dispatch of the pruned lane (``ops/ab_primitives.grouped_blocked_dispatch``)
is bitwise the single-batch lane and the reference's dispatch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu.lexical import device_bm25 as jbm
from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex
from frankensearch_tpu.lexical import daat as jdaat
from frankensearch_tpu_torch import convert
from frankensearch_tpu_torch.lexical import daat as tdaat
from frankensearch_tpu_torch.lexical import device_bm25 as tbm
from frankensearch_tpu_torch.lexical import hot_arm as thot
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")
QUERIES = [
    "w1 w2", "w5", "w100 w3 w7", "nonexistent", "w0 w0 w1 title",
    "w42 w43 w44 w45 w46 w47 w48 w49 w50 w51", "w199", "w7 w1",
]


def _corpus(n_docs=400, seed=1):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    return [
        IndexableDocument(
            doc_id=f"d{i:04d}",
            content=" ".join(rng.choice(words, size=int(rng.integers(3, 40)), p=p)),
            title=f"title {words[i % 50]}" if i % 4 == 0 else None,
        )
        for i in range(n_docs)
    ]


@pytest.fixture(scope="module")
def pair():
    mem, port_mem = th.memory_pair(_corpus())
    ref = jbm.DeviceBm25Index(mem)
    port = convert.bm25_from_arrays(
        np.asarray(ref._post_term), np.asarray(ref._post_doc), np.asarray(ref._post_tf),
        ref._arms, ref.doc_ids, ref.vocab_size, device=CPU,
    )
    return (mem, port_mem), ref, port


def _cands(lists):
    return [[(c.doc_id, c.score) for c in row] for row in lists]


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 10, 400])
def test_device_bm25_bitwise(pair, b, k):
    _, ref, port = pair
    q_idf = ref._query_idf_rows(QUERIES[:b])
    ws, wi = jbm._device_bm25(
        ref._post_term, ref._post_doc, ref._post_tf, jnp.asarray(q_idf),
        n_docs=ref.n_docs, k=k,
    )
    gs, gi = tbm._device_bm25(
        port._post_term, port._post_tf, port._doc_steps, torch.from_numpy(q_idf),
        n_docs=port.n_docs, k=k,
    )
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_converted_state_is_the_reference_state(pair):
    _, ref, port = pair
    np.testing.assert_array_equal(port._post_term.numpy(), np.asarray(ref._post_term))
    np.testing.assert_array_equal(port._post_tf.numpy(), np.asarray(ref._post_tf))
    # the doc column lives on as the doc-major plan: step j holds the j-th
    # posting of each running doc, in slot order
    post_doc, steps = np.asarray(ref._post_doc), port._doc_steps
    for j in range(len(steps.bounds) - 1):
        p = steps.posts[steps.bounds[j] : steps.bounds[j + 1]].numpy()
        np.testing.assert_array_equal(post_doc[p], steps.doc_of_slot[: len(p)].numpy())
    assert port.doc_ids == ref.doc_ids and port.vocab_size == ref.vocab_size
    np.testing.assert_array_equal(port._query_idf_rows(QUERIES), ref._query_idf_rows(QUERIES))


@pytest.mark.parametrize("builder", ["memory", "bulk"])
def test_port_builders_match_reference(pair, builder):
    (mem, port_mem), _, _ = pair
    docs = _corpus()
    if builder == "memory":
        ref, port = jbm.DeviceBm25Index(mem), tbm.DeviceBm25Index(port_mem, device=CPU)
    else:
        ref = jbm.BulkDeviceBm25Index(docs)
        port = tbm.BulkDeviceBm25Index(th.port_docs(docs), device=CPU)
    assert _cands(port.search_candidates_batch(QUERIES, 20)) == _cands(
        ref.search_candidates_batch(QUERIES, 20)
    )
    assert port.hydrate_candidates(["d0000"]) == ref.hydrate_candidates(["d0000"])


def test_solo_query_bits_equal_batched(pair):
    _, _, port = pair
    batch = _cands(port.search_candidates_batch(QUERIES, 15))
    for q, row in zip(QUERIES, batch):
        assert _cands(port.search_candidates_batch([q], 15))[0] == row


def test_doc_steps_visit_each_posting_once_in_order():
    post_doc = np.array([2, 0, 2, 1, 2, 0, 0, 0], np.int32)
    post_tf = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.0, 0.0], np.float32)  # tail = padding
    steps = tbm.build_doc_steps(post_doc, post_tf, 4, CPU)
    assert steps.doc_of_slot.tolist() == [2, 0, 1, 3]  # longest first, stable
    assert steps.bounds == (0, 3, 5, 6)
    # step j: the j-th posting of each doc still running, in slot order
    assert steps.posts.tolist() == [0, 1, 3, 2, 5, 4]


def test_blocked_scale_builds_split_layout(monkeypatch):
    """At the blocked threshold (lowered here, with the hot arm's minimum)
    the corpus builds the split layout and serves the dense lane's
    ranking."""
    docs = _corpus(n_docs=40)
    dense = tbm.BulkDeviceBm25Index(docs, device=CPU)
    monkeypatch.setattr(tbm, "BLOCKED_THRESHOLD_POSTINGS", 100)
    monkeypatch.setattr(thot, "HOT_MIN_POSTINGS", 100)
    split = tbm.BulkDeviceBm25Index(docs, device=CPU)
    assert dense._blocked is None and dense.posting_count >= 100
    assert split._blocked is not None and split._hot is not None and split._hot.n_hot > 0
    assert split._post_term is None and split.cold_posting_count < split.posting_count
    assert split._term_major().packed
    for got, want in zip(split.search_candidates_batch(QUERIES, 20),
                         dense.search_candidates_batch(QUERIES, 20)):
        assert [c.doc_id for c in got] == [c.doc_id for c in want]
        np.testing.assert_allclose([c.score for c in got], [c.score for c in want], rtol=1e-6)
    assert split.last_lane in ("blocked", "mixed", "daat")


# -- blocked scale against the reference ---------------------------------------


def _cand_bits(rows):
    return [[(c.doc_id, np.float32(c.score).view(np.uint32)) for c in row] for row in rows]


@pytest.fixture(scope="module")
def split_pair():
    return th.build_pair()


def _has_hot(port, queries):
    ids, w = port._query_sparse_rows(queries)
    return (thot.split_hot_rows(port._hot.hot_row_of, ids, w, port._hot.h_pad) > 0).any(axis=1)


@pytest.mark.parametrize("mode", ["auto", "blocked", "daat"])
def test_search_candidates_batch_split_matches_reference(split_pair, monkeypatch, mode):
    """End to end over the split layout: queries without hot terms are
    bitwise equal to the reference (its flat lane in K3's order); queries
    with hot terms equal in rows up to 1e-6 ties at the k-th score and in
    scores within 1e-6 relative (the hot partial's product order)."""
    _, ref, port = split_pair
    monkeypatch.setattr(ref, "daat_mode", mode)
    monkeypatch.setattr(port, "daat_mode", mode)
    with th.reference_flat_interpret():
        want = ref.search_candidates_batch(th.QUERIES, 30)
    got = port.search_candidates_batch(th.QUERIES, 30)
    assert port.last_lane == ref.last_lane
    assert port.last_hot_queries == ref.last_hot_queries > 0
    hot = _has_hot(port, th.QUERIES)
    assert hot.any() and (~hot).any()
    for q, h, g, w in zip(th.QUERIES, hot, got, want):
        if not h:
            assert _cand_bits([g]) == _cand_bits([w]), q
            continue
        gs = np.array([c.score for c in g] + [-np.inf] * (30 - len(g)), np.float32)
        ws = np.array([c.score for c in w] + [-np.inf] * (30 - len(w)), np.float32)
        gi = np.array([port._row_of[c.doc_id] for c in g] + [-1] * (30 - len(g)))
        wi = np.array([port._row_of[c.doc_id] for c in w] + [-1] * (30 - len(w)))
        th.assert_rank_tolerant(gs[None], gi[None], ws[None], wi[None])


def test_lanes_chosen_as_in_reference(split_pair, monkeypatch):
    """With the crossover lowered so that rare pure-tail queries are
    eligible, batches of eligible, hot and mixed queries take the daat,
    blocked and mixed lanes in both packages."""
    _, ref, port = split_pair
    monkeypatch.setattr(jdaat, "DAAT_CROSSOVER_DIVISOR", 8)
    monkeypatch.setattr(tdaat, "DAAT_CROSSOVER_DIVISOR", 8)
    ids, w = port._query_sparse_rows(th.QUERIES)
    ids, w = thot.compact_tail_rows(port._hot.hot_row_of, ids, w)
    elig = tdaat.daat_eligible(
        port._term_major().ptr, ids, w, total_postings=port.cold_posting_count
    ) & ~_has_hot(port, th.QUERIES)
    daat_qs = [q for q, e in zip(th.QUERIES, elig) if e]
    other_qs = [q for q, e in zip(th.QUERIES, elig) if not e]
    assert len(daat_qs) >= 2 and len(other_qs) >= 2
    for batch, lane in ((daat_qs, "daat"), (other_qs, "blocked"), (th.QUERIES, "mixed")):
        with th.reference_flat_interpret():
            want = ref.search_candidates_batch(batch, 20)
        got = port.search_candidates_batch(batch, 20)
        assert port.last_lane == ref.last_lane == lane
        if lane == "daat":
            assert _cand_bits(got) == _cand_bits(want)


@pytest.fixture(scope="module")
def pruned_pair():
    """The same corpus with the hot arm off: the pruned lane, in blocks of
    512 posting slots so that several blocks per class can be skipped."""
    with th.lowered(extra=[(jbm, "DEFAULT_BLOCK_POSTINGS", 512), (tbm, "DEFAULT_BLOCK_POSTINGS", 512)]):
        mem, ref, port = th.build_pair(hot=False)
    assert ref._hot is None and port._hot is None and port._blocked.n_blk > 8
    return mem, ref, port


@pytest.mark.parametrize("k", [1, 10, 40])
def test_pruned_lane_bitwise(pruned_pair, monkeypatch, k):
    """The pruned lane (hot arm off) equals the reference bit for bit: its
    8-term chunks are XLA's einsum on the CPU, a sequential fused
    multiply-add, which the port rounds exactly; it skips the same blocks."""
    _, ref, port = pruned_pair
    monkeypatch.setattr(ref, "daat_mode", "blocked")
    monkeypatch.setattr(port, "daat_mode", "blocked")
    skips = []
    for q in th.QUERIES:
        want = ref.search_candidates_batch([q], k)
        got = port.search_candidates_batch([q], k)
        assert _cand_bits(got) == _cand_bits(want), q
        assert port.last_blocks_skipped == ref.last_blocks_skipped, q
        skips.append(port.last_blocks_skipped)
    assert max(skips) > 0
    want = ref.search_candidates_batch(th.QUERIES, k)
    assert _cand_bits(port.search_candidates_batch(th.QUERIES, k)) == _cand_bits(want)
    assert port.last_lane == ref.last_lane == "blocked"


def test_pruned_lane_auto_matches_reference(pruned_pair):
    _, ref, port = pruned_pair
    assert _cand_bits(port.search_candidates_batch(th.QUERIES, 25)) == _cand_bits(
        ref.search_candidates_batch(th.QUERIES, 25)
    )
    assert port.last_lane == ref.last_lane


@pytest.mark.parametrize("k", [1, 10])
def test_selectivity_grouped_dispatch_bitwise(pruned_pair, monkeypatch, k):
    """Selective (one rare term) and broad queries, 11 selective so that the
    last sub-batch is short: every row bitwise the single-batch pruned lane
    and the reference's grouped dispatch, with the same blocks skipped."""
    from frankensearch_tpu.ops.ab_primitives import grouped_blocked_dispatch as ref_dispatch
    from frankensearch_tpu_torch.ops.ab_primitives import grouped_blocked_dispatch

    _, ref, port = pruned_pair
    monkeypatch.setattr(port, "daat_mode", "blocked")
    queries = [f"w{280 + i}" for i in range(11)] + ["w0 w1", "w1 w2 w3", "w0"]
    base = port.search_candidates_batch(queries, k)
    ids, w = port._query_sparse_rows(queries)
    bounds = port._blocked.query_bounds(ids, w)
    assert ((bounds <= 0.0).mean(axis=0) >= 0.5).sum() == 11
    s, i = grouped_blocked_dispatch(port, ids, w, bounds, k)
    assert s.shape == (len(queries), k) and i.dtype == np.int32
    grouped = [[(port.doc_ids[int(i[b, j])], s[b, j].view(np.uint32)) for j in range(k) if s[b, j] > 0.0]
               for b in range(len(queries))]
    assert grouped == _cand_bits(base)
    ws, wi = ref_dispatch(ref, ids, w, bounds, k)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_array_equal(s.view(np.uint32), np.asarray(ws).view(np.uint32))
    assert port.last_blocks_skipped == ref.last_blocks_skipped > 0


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 8, 4096).astype(np.float32)
    b = rng.uniform(0, 3, 4096).astype(np.float32)
    c = (rng.uniform(0, 50, 4096) * 10.0 ** rng.integers(-4, 3, 4096)).astype(np.float32)
    got = tbm._fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    from fractions import Fraction

    for i in range(0, 4096, 97):  # exact rational reference on a sample
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact), int(np.float32(x).view(np.uint32)) & 1))
        assert got[i] == best, i
