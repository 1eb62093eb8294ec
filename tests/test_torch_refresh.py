"""The port's background refresh path against the JAX reference, on the CPU.

``fusion/queue.EmbeddingQueue``, ``core/fingerprint`` and
``fusion/refresh.RefreshWorker`` run beside the reference's copies on the
same inputs (seeded with numpy); the reference's tests are the oracles
(tests/test_fusion_extras.py ``TestQueue`` / ``TestFingerprint``,
tests/test_concurrency_stress.py:25-103). Host outputs (enqueue results,
drained jobs, counters, fingerprints, decisions, doc ids, row maps,
stats) are equal; the fast tier's rows are a HashEmbedder's, bitwise
equal; the quality tier's rows come from the same 2-layer encoder weights
in both packages and agree within the encoder's stated 1e-5
(tests/test_torch_rerank.py).

The reference's two stress tests run against the port with a quality
tier added, and readers race ``search_batch`` with the Refined phase over
a two-tier index while a worker appends: before the port published its
tiers and their row map as one snapshot, a reader could meet the map
cleared to ``None`` (``TypeError``) or shorter than the fast tier.

The worker's loop diverges from the reference: a typed ``SearchError`` is
counted and the loop goes on, any other exception ends the loop and
``stop()`` raises it. Its fault order inside ``process_once`` is the
reference's: the fast tier is appended before the quality embed runs.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from chip_smoke import FailingOn
from frankensearch_tpu.core import fingerprint as rfp
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHashEmbedder
from frankensearch_tpu.fusion import queue as rqueue
from frankensearch_tpu.fusion.refresh import RefreshWorker as RefWorker
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.rerank.encoder import random_transformer_embedder as ref_random_embedder
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, TwoTierIndex, TwoTierSearcher
from frankensearch_tpu_torch.convert import bert_params_from_arrays
from frankensearch_tpu_torch.core import fingerprint as pfp
from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.fusion import queue as pqueue
from frankensearch_tpu_torch.fusion.refresh import RefreshWorker
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex
from frankensearch_tpu_torch.rerank.bert import BertConfig
from frankensearch_tpu_torch.rerank.encoder import TransformerEmbedder
from frankensearch_tpu_torch.rerank.tokenizer import WordPieceTokenizer

CPU = torch.device("cpu")
WORDS = [f"w{i}" for i in range(120)]
QUALITY_TOL = 1e-5  # the encoder, port vs reference on the same weights
SEEDS = 300


def texts_of(n, seed, prefix=""):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    return [prefix + " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12)), p=p)) for _ in range(n)]


def _port_encoder(ref):
    leaves, _ = tree_flatten_with_path(ref.params)
    cfg = BertConfig(**{f: getattr(ref.cfg, f) for f in ref.cfg.__dataclass_fields__})
    state = bert_params_from_arrays({keystr(p): np.asarray(v) for p, v in leaves}, cfg)
    return TransformerEmbedder(state, cfg, WordPieceTokenizer(ref.tokenizer.vocab, max_len=128), device=CPU,
                               embedder_id=ref.embedder_id, revision=ref.revision, max_tokens=ref.max_tokens)


@pytest.fixture(scope="module")
def encoders():
    """The same 2-layer H=32 encoder in both packages (the reference's seeded weights)."""
    ref = ref_random_embedder(WORDS, hidden=32, layers=2, heads=2, seed=3)
    return ref, _port_encoder(ref)


def port_index(root, texts, fe, qe=None, ids=None):
    ids = ids or [f"seed-{i}" for i in range(len(texts))]
    kw = {} if qe is None else {"quality_vectors": qe.embed_batch(texts), "quality_identity": qe.identity()}
    return TwoTierIndex.create(str(root), fe.embed_batch(texts), ids, fe.identity(), device=CPU, **kw)


# -- fusion/queue ---------------------------------------------------------------


def _queue_script(seed, n_ops=400):
    rng = np.random.default_rng(seed)
    pool = texts_of(120, seed + 1)
    ops = []
    for i in range(n_ops):
        if rng.random() < 0.2:
            ops.append(("drain", int(rng.integers(0, 6)) if rng.random() < 0.8 else None))
        else:
            ops.append(("push", f"d{i}", pool[int(rng.integers(len(pool)))], int(rng.integers(0, 3))))
    return ops


def _run_queue(mod, ops, capacity):
    q = mod.EmbeddingQueue(capacity=capacity)
    trace = []
    for op in ops:
        if op[0] == "push":
            trace.append(q.push(op[1], op[2], priority=op[3]).value)
        else:
            trace.append([(j.doc_id, j.content, j.content_hash, j.priority) for j in q.drain(op[1])])
        trace.append((len(q), q.pressure, q.enqueued, q.deduped, q.rejected))
    return trace


@pytest.mark.parametrize("seed,capacity", [(0, 4), (1, 8), (2, 32), (3, 0)])
def test_queue_equals_reference(seed, capacity):
    ops = _queue_script(seed)
    got, want = _run_queue(pqueue, ops, capacity), _run_queue(rqueue, ops, capacity)
    assert got == want
    if capacity:
        assert {"enqueued", "duplicate", "full"} <= {t for t in got if isinstance(t, str)}


def test_queue_dedup_backpressure_and_priority():
    """tests/test_fusion_extras.py::TestQueue on the port."""
    q = pqueue.EmbeddingQueue(capacity=2)
    assert q.push("a", "same text") is pqueue.EnqueueResult.ENQUEUED
    assert q.push("b", "same text") is pqueue.EnqueueResult.DUPLICATE
    assert q.push("c", "other") is pqueue.EnqueueResult.ENQUEUED
    assert q.push("d", "third") is pqueue.EnqueueResult.FULL
    assert q.pressure == 1.0
    assert [j.doc_id for j in q.drain(1)] == ["a"]
    assert q.push("a2", "same text") is pqueue.EnqueueResult.ENQUEUED
    q = pqueue.EmbeddingQueue()
    for doc_id, prio in (("low", 0), ("high", 5), ("mid", 2), ("high2", 5)):
        q.push(doc_id, f"text {doc_id}", priority=prio)
    assert [j.doc_id for j in q.drain()] == ["high", "high2", "mid", "low"]


@pytest.mark.parametrize("text", ["", "alpha", "naïve café ☕", "w1 " * 500])
def test_content_hash_equals_reference(text):
    assert pqueue.content_hash(text) == rqueue.content_hash(text)


# -- core/fingerprint ---------------------------------------------------------------


def _edits(seed):
    """(old, new) pairs: identical, tail edits, prepends, big growth,
    token drift, head rewrites beyond 256 characters."""
    rng = np.random.default_rng(seed)
    out = []
    for base in texts_of(30, seed, prefix="doc body ") + ["x" * 300 + " tail words here"]:
        extra = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 6))))
        out += [(base, base), (base, base + "!"), (base, extra + " " + base), (base, base + " " + base * 3),
                (base, base.replace(" ", "  ")), (base, base + " " + extra), (base, base[: len(base) // 2])]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", [(0.1, 0.15), (0.0, 0.0), (0.5, 0.5)])
def test_fingerprint_and_reembed_equal_reference(seed, policy):
    decisions = []
    for old, new in _edits(seed):
        fo, fn = pfp.DocumentFingerprint.of(old), pfp.DocumentFingerprint.of(new)
        ro, rn = rfp.DocumentFingerprint.of(old), rfp.DocumentFingerprint.of(new)
        assert fo.__dict__ == ro.__dict__ and fn.__dict__ == rn.__dict__
        got = pfp.ReembedPolicy(*policy).should_reembed(fo, fn)
        assert got == rfp.ReembedPolicy(*policy).should_reembed(ro, rn)
        decisions.append(got)
    assert True in decisions and (False in decisions or policy == (0.0, 0.0))


# -- fusion/refresh: the worker beside the reference's -------------------------------


def _pair(tmp_path, encoders, quality=True):
    ref_q, q = encoders
    seeds = texts_of(SEEDS, 5)
    ids = [f"seed-{i}" for i in range(SEEDS)]
    ref_fe, fe = RefHashEmbedder(dim=64), HashEmbedder(dim=64)
    kw = {"quality_vectors": ref_q.embed_batch(seeds), "quality_identity": ref_q.identity()} if quality else {}
    ref = RefIndex.create(str(tmp_path / "ref"), ref_fe.embed_batch(seeds), ids, ref_fe.identity(),
                          use_pallas=False, **kw)
    port = port_index(tmp_path / "port", seeds, fe, q if quality else None)
    return ref, port, ref_fe, fe


def _push_all(queue, seed, n=70):
    results = []
    for i, text in enumerate(texts_of(n, seed, prefix="fresh ")):
        results.append(queue.push(f"new-{i:03d}", text, priority=i % 3).value)
    # duplicates of queued content and re-pushes of seed ids (upserts)
    results.append(queue.push("dup", texts_of(n, seed, prefix="fresh ")[3]).value)
    results.append(queue.push("seed-7", "seed seven rewritten w1 w2").value)
    return results


@pytest.mark.parametrize("quality", [True, False], ids=["two-tier", "fast-only"])
def test_worker_equals_reference(tmp_path, encoders, quality):
    ref, port, ref_fe, fe = _pair(tmp_path, encoders, quality)
    ref_q, q = encoders
    rq, pq = rqueue.EmbeddingQueue(capacity=64), pqueue.EmbeddingQueue(capacity=64)
    assert _push_all(pq, 9) == _push_all(rq, 9)
    rw = RefWorker(rq, ref, ref_fe, ref_q if quality else None, max_batch=16)
    pw = RefreshWorker(pq, port, fe, q if quality else None, max_batch=16)
    counts = []
    while True:
        n_ref, n_port = rw.process_once(), pw.process_once()
        assert n_ref == n_port
        counts.append(n_port)
        if not n_port:
            break
    assert counts == [16, 16, 16, 16, 0] and len(pq) == len(rq) == 0
    assert (pw.stats.batches, pw.stats.docs_embedded, pw.stats.errors) == (
        rw.stats.batches, rw.stats.docs_embedded, rw.stats.errors) == (4, 64, 0)
    assert port.fast.doc_ids == ref.fast.doc_ids
    np.testing.assert_array_equal(port.fast.vectors_f32(), np.asarray(ref.fast.vectors_f32()))
    assert port.fast.live_count == ref.fast.live_count and port.doc_count() == ref.doc_count()
    with open(tmp_path / "port" / "vector.fast.idx.wal", "rb") as f, \
            open(tmp_path / "ref" / "vector.fast.idx.wal", "rb") as g:
        assert f.read() == g.read()
    if quality:
        assert port.quality.doc_ids == ref.quality.doc_ids
        np.testing.assert_array_equal(port._fast_to_quality, ref._fast_to_quality)
        np.testing.assert_allclose(port.quality.vectors_f32(), np.asarray(ref.quality.vectors_f32()),
                                   atol=QUALITY_TOL, rtol=0)
    # the reopened roots replay the same WAL state
    reopened = TwoTierIndex.open(str(tmp_path / "port"), device=CPU)
    assert reopened.fast.doc_ids == port.fast.doc_ids and reopened.doc_count() == port.doc_count()


def test_quality_embed_fault_leaves_the_fast_rows_appended(tmp_path, encoders):
    """The reference's fault order: append_fast runs before the quality
    embed, so a quality fault leaves the batch in the fast tier only."""
    ref, port, ref_fe, fe = _pair(tmp_path, encoders)
    ref_q, q = encoders
    rq, pq = rqueue.EmbeddingQueue(), pqueue.EmbeddingQueue()
    _push_all(rq, 4, n=24)
    _push_all(pq, 4, n=24)
    rw = RefWorker(rq, ref, ref_fe, FailingOn(ref_q, 2, RuntimeError("boom")), max_batch=8)
    pw = RefreshWorker(pq, port, fe, FailingOn(q, 2, RuntimeError("boom")), max_batch=8)
    for w in (rw, pw):
        assert w.process_once() == 8
        with pytest.raises(RuntimeError, match="boom"):
            w.process_once()
        assert w.process_once() == 8
    assert (pw.stats.batches, pw.stats.docs_embedded, pw.stats.errors) == (
        rw.stats.batches, rw.stats.docs_embedded, rw.stats.errors) == (2, 16, 1)
    assert port.fast.doc_ids == ref.fast.doc_ids and port.quality.doc_ids == ref.quality.doc_ids
    lost = [d for d in port.fast.doc_ids if port.quality.row_for(d) is None]
    assert len(lost) == 8 and lost == [d for d in ref.fast.doc_ids if ref.quality.row_for(d) is None]
    np.testing.assert_array_equal(port._fast_to_quality, ref._fast_to_quality)
    assert all(port._fast_to_quality[port.fast.row_for(d)] == -1 for d in lost)


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    return pred()


def test_loop_counts_a_search_error_and_goes_on(tmp_path):
    fe = HashEmbedder(dim=32)
    index = port_index(tmp_path / "ix", texts_of(20, 1), fe)
    queue = pqueue.EmbeddingQueue()
    worker = RefreshWorker(queue, index, FailingOn(fe, 1, EmbeddingFailed("rate limited after retries")),
                           max_batch=4, poll_interval_s=0.001)
    for i, text in enumerate(texts_of(12, 2, prefix="fresh ")):
        queue.push(f"new-{i}", text)
    worker.start()
    assert _wait(lambda: len(queue) == 0 and worker.stats.batches == 2)
    worker.stop()  # nothing kept: no raise
    assert (worker.stats.batches, worker.stats.docs_embedded, worker.stats.errors) == (2, 8, 1)
    assert index.doc_count() == 28


def test_loop_keeps_a_device_fault_and_stop_raises_it(tmp_path):
    fe = HashEmbedder(dim=32)
    qe = HashEmbedder(dim=48)
    texts = texts_of(20, 1)
    index = port_index(tmp_path / "ix", texts, fe, qe)
    queue = pqueue.EmbeddingQueue()
    fault = RuntimeError("CUDA error: an illegal memory access was encountered")
    worker = RefreshWorker(queue, index, fe, FailingOn(qe, 3, fault), max_batch=4, poll_interval_s=0.001)
    for i, text in enumerate(texts_of(24, 2, prefix="fresh ")):
        queue.push(f"new-{i:02d}", text)
    worker.start()
    assert _wait(lambda: not worker._thread.is_alive())
    with pytest.raises(RuntimeError, match="illegal memory access") as caught:
        worker.stop()
    assert caught.value is fault
    assert (worker.stats.batches, worker.stats.docs_embedded, worker.stats.errors) == (2, 8, 1)
    assert len(queue) == 12  # the loop ended: nothing drained after the fault
    fast_only = [d for d in index.fast.doc_ids if index.quality.row_for(d) is None]
    assert fast_only == [f"new-{i:02d}" for i in range(8, 12)]
    worker.stop()  # the fault was raised once; the worker is stopped


def test_stop_drains_one_batch_without_a_thread(tmp_path):
    fe = HashEmbedder(dim=32)
    index = port_index(tmp_path / "ix", texts_of(5, 1), fe)
    queue = pqueue.EmbeddingQueue()
    for i in range(6):
        queue.push(f"n{i}", f"fresh {i}")
    worker = RefreshWorker(queue, index, fe, max_batch=4)
    worker.stop()
    assert worker.stats.docs_embedded == 4 and len(queue) == 2


# -- the reference's stress tests, against the port, with a quality tier ----------------


def test_search_during_refresh_with_a_quality_tier(tmp_path, encoders):
    """tests/test_concurrency_stress.py::test_search_during_refresh on the port."""
    _, qe = encoders
    fe = HashEmbedder(dim=64)
    base_docs = [f"seed document number {i} words" for i in range(20)]
    index = port_index(tmp_path / "cx", base_docs, fe, qe)
    lexical = MemoryLexicalIndex()
    for i, text in enumerate(base_docs):
        lexical.add_document(IndexableDocument(doc_id=f"seed-{i}", content=text))
    lexical.commit()
    searcher = TwoTierSearcher(index, fe, lexical=lexical, quality_embedder=qe,
                               config=TwoTierConfig(quality_timeout_ms=0), cache_query_embeddings=False)
    queue = pqueue.EmbeddingQueue(capacity=512)
    worker = RefreshWorker(queue, index, fe, qe, max_batch=8, poll_interval_s=0.005)
    worker.start()
    errors, seen, stop = [], [], threading.Event()

    def reader():
        while not stop.is_set():
            try:
                out = searcher.search("document number words", k=5)
                for r in out.results:
                    assert r.doc_id.startswith(("seed-", "new-")), r.doc_id
                seen.append(len(out.results))
            except Exception as e:
                errors.append(e)
                break

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    for i in range(60):
        queue.push(f"new-{i:03d}", f"fresh appended doc {i} words content")
        time.sleep(0.002)
    _wait(lambda: worker.stats.docs_embedded >= 60)
    stop.set()
    for t in readers:
        t.join(timeout=30)
    worker.stop()
    assert not any(t.is_alive() for t in readers)
    assert not errors, errors[:2]
    assert (worker.stats.docs_embedded, worker.stats.errors) == (60, 0)
    assert len(seen) >= 3
    assert index.doc_count() == 80 and index.quality.n_rows == 80
    assert index.fast.doc_ids == index.quality.doc_ids


def test_concurrent_appends_serialized_by_writer_lock_with_a_quality_tier(tmp_path):
    """tests/test_concurrency_stress.py::test_concurrent_appends_serialized_by_writer_lock on the port."""
    fe, qe = HashEmbedder(dim=32), HashEmbedder(dim=48)
    index = port_index(tmp_path / "wx", ["base"], fe, qe, ids=["base"])
    queue = pqueue.EmbeddingQueue()
    worker = RefreshWorker(queue, index, fe, qe, max_batch=4)
    for i in range(40):
        queue.push(f"d{i:02d}", f"content {i}")
    threads = [threading.Thread(target=worker.process_once) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    while len(queue):
        worker.process_once()
    assert index.doc_count() == 41
    assert len(set(index.fast.doc_ids)) == 41 and sorted(index.quality.doc_ids) == sorted(index.fast.doc_ids)
    np.testing.assert_array_equal(
        index._fast_to_quality, [index.quality.row_for(d) for d in index.fast.doc_ids])


# -- readers racing the worker over a two-tier index --------------------------------


@pytest.fixture
def fast_switches():
    """Switch threads every 10 us, so a reader runs inside a writer's
    publication often."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("seed", [0, 1])
def test_refined_readers_race_the_worker(tmp_path, encoders, fast_switches, seed):
    _, qe = encoders
    fe = HashEmbedder(dim=64)
    seeds = texts_of(1000, seed)
    index = port_index(tmp_path / "race", seeds, fe, qe)
    searcher = TwoTierSearcher(index, fe, quality_embedder=qe, config=TwoTierConfig(quality_timeout_ms=0),
                               cache_query_embeddings=False)
    queries = texts_of(64, seed + 100)
    new = [f"fresh n{i} {text}" for i, text in enumerate(texts_of(240, seed + 200))]
    queue = pqueue.EmbeddingQueue(capacity=1024)
    worker = RefreshWorker(queue, index, fe, qe, max_batch=8, poll_interval_s=0.001)
    errors, batches, stop = [], [], threading.Event()
    known = {f"seed-{i}" for i in range(len(seeds))} | {f"new-{i}" for i in range(len(new))}

    def reader():
        try:
            while not stop.is_set():
                out = searcher.search_batch(queries, k=10)
                for o in out:
                    assert o.results and {r.doc_id for r in o.results} <= known
                    assert o.metrics.quality_candidates > 0
                batches.append(len(out))
        except Exception as e:
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    worker.start()
    for t in readers:
        t.start()
    for i, text in enumerate(new):
        assert queue.push(f"new-{i}", text) is pqueue.EnqueueResult.ENQUEUED
        if errors:
            break
        time.sleep(0.001)
    _wait(lambda: worker.stats.docs_embedded >= len(new) or bool(errors), timeout=120)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    worker.stop()
    assert not any(t.is_alive() for t in readers)
    assert not errors, [repr(e) for e in errors[:2]]
    assert worker.stats.docs_embedded == len(new) and worker.stats.errors == 0 and batches
    assert index.fast.doc_ids == index.quality.doc_ids


def test_worker_equals_direct_appends_bitwise(tmp_path, encoders):
    """A reader that races no writer: after the worker drained, the index
    serves ``search_batch`` (Refined) bitwise as one fed the same batches
    by direct ``append_fast`` / ``append_quality`` calls."""
    _, qe = encoders
    fe = HashEmbedder(dim=64)
    seeds = texts_of(SEEDS, 5)
    via_worker, direct = port_index(tmp_path / "a", seeds, fe, qe), port_index(tmp_path / "b", seeds, fe, qe)
    queue = pqueue.EmbeddingQueue()
    new = texts_of(50, 6, prefix="fresh ")
    for i, text in enumerate(new):
        queue.push(f"new-{i}", text)
    worker = RefreshWorker(queue, via_worker, fe, qe, max_batch=16)
    worker.start()
    assert _wait(lambda: worker.stats.docs_embedded == len(new))
    worker.stop()
    for start in range(0, len(new), 16):
        ids = [f"new-{i}" for i in range(start, min(start + 16, len(new)))]
        texts = new[start:start + 16]
        direct.append_fast(ids, fe.embed_batch(texts))
        direct.append_quality(ids, qe.embed_batch(texts))
    queries = texts_of(16, 7) + new[:8]
    rows = []
    for index in (via_worker, direct):
        s = TwoTierSearcher(index, fe, quality_embedder=qe, config=TwoTierConfig(quality_timeout_ms=0),
                            cache_query_embeddings=False)
        rows.append([[(r.doc_id, r.score, r.fast_score, r.quality_score) for r in o.results]
                     for o in s.search_batch(queries, k=10)])
    assert rows[0] == rows[1]
    for i, text in enumerate(new[:8]):
        assert rows[0][16 + i][0][0] == f"new-{i}", (text, rows[0][16 + i][:3])
