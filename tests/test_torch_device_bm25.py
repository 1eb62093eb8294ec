"""PyTorch port of the dense device BM25 lane against the JAX reference.

The same corpus goes into the reference's ``DeviceBm25Index`` /
``BulkDeviceBm25Index`` and, through ``convert.bm25_from_arrays`` or the
port's own builders, into the port. The port's per-doc sum visits each
doc's postings in posting order, as the reference's segment sum does on the
CPU, so scores and rows are bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu.lexical import device_bm25 as jbm
from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex
from frankensearch_tpu_torch import convert
from frankensearch_tpu_torch.lexical import device_bm25 as tbm

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
    mem = MemoryLexicalIndex()
    for d in _corpus():
        mem.add_document(d)
    mem.commit()
    ref = jbm.DeviceBm25Index(mem)
    port = convert.bm25_from_arrays(
        np.asarray(ref._post_term), np.asarray(ref._post_doc), np.asarray(ref._post_tf),
        ref._arms, ref.doc_ids, ref.vocab_size, device=CPU,
    )
    return mem, ref, port


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
    mem, _, _ = pair
    docs = _corpus()
    if builder == "memory":
        ref, port = jbm.DeviceBm25Index(mem), tbm.DeviceBm25Index(mem, device=CPU)
    else:
        ref, port = jbm.BulkDeviceBm25Index(docs), tbm.BulkDeviceBm25Index(docs, device=CPU)
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


def test_blocked_scale_raises(monkeypatch):
    monkeypatch.setattr(tbm, "BLOCKED_THRESHOLD_POSTINGS", 100)
    with pytest.raises(NotImplementedError, match="blocked"):
        tbm.BulkDeviceBm25Index(_corpus(n_docs=40), device=CPU)
