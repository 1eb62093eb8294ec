"""The background refresh path on an NVIDIA GPU, at a small size.

A ``RefreshWorker`` appends into a two-tier index on the card (HashEmbedder
fast tier, d = 256; a seeded 2-layer encoder's quality tier, d = 64, its
forward on the card) while four readers run ``search_batch`` with the
Refined phase and the quality rescan, so K1 and K2 launch over both tiers
under a concurrent writer. Checked: no reader raises, every returned id is
a seed or an appended id, K1 and K2 counted during the race, every
appended doc its own top fast-tier hit, the appended fast rows on the card
bitwise the CPU's HashEmbedder rows in the slab's dtype, the quality rows
within the encoder's card-vs-CPU 1e-5; and a quality embed that raises
``RuntimeError`` on its third batch ends the loop, ``stop()`` raises it,
and the fast tier keeps that batch's rows without quality rows.

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_refresh_cuda.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import FailingOn
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, TwoTierIndex, TwoTierSearcher
from frankensearch_tpu_torch.fusion.queue import EmbeddingQueue, EnqueueResult
from frankensearch_tpu_torch.fusion.refresh import RefreshWorker
from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder

pytestmark = pytest.mark.cuda

WORDS = [f"w{i}" for i in range(200)]
SEEDS = 12_000
NEW = 320
ENC_TOL = 1e-5  # the f32 encoder, card vs CPU (chip_smoke.ENC_F32_TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from frankensearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def texts_of(n, seed, prefix=""):
    rng = np.random.default_rng(seed)
    return [prefix + " ".join(rng.choice(WORDS, size=int(rng.integers(3, 10)))) for _ in range(n)]


def _world(dev, tmp_path):
    fe = HashEmbedder(dim=256)
    qe = random_transformer_embedder(WORDS, device=dev, hidden=64, layers=2, heads=4, seed=3)
    seeds = texts_of(SEEDS, 1)
    index = TwoTierIndex.create(
        str(tmp_path / "ix"), fe.embed_batch(seeds), [f"seed-{i}" for i in range(SEEDS)], fe.identity(),
        device=dev, quality_vectors=qe.embed_batch(seeds), quality_identity=qe.identity())
    return fe, qe, index


def test_refresh_races_refined_readers_on_the_card(cuda_device, tmp_path):
    fe, qe, index = _world(cuda_device, tmp_path)
    searcher = TwoTierSearcher(index, fe, quality_embedder=qe,
                               config=TwoTierConfig(quality_rescan=True, quality_timeout_ms=0),
                               cache_query_embeddings=False)
    queries = texts_of(64, 2)
    new = [f"fresh{i} " + t for i, t in enumerate(texts_of(NEW, 3))]
    known = {f"seed-{i}" for i in range(SEEDS)} | {f"new-{i}" for i in range(NEW)}
    queue = EmbeddingQueue(capacity=1024)
    worker = RefreshWorker(queue, index, fe, qe, max_batch=64, poll_interval_s=0.001)
    errors, batches, stop = [], [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                for o in searcher.search_batch(queries, k=10):
                    assert o.results and {r.doc_id for r in o.results} <= known
                    assert o.metrics.quality_candidates > 0
                batches.append(1)
        except Exception as e:
            errors.append(e)

    topk_scan.group_max.launches = topk_scan.gather_rescore.launches = 0
    readers = [threading.Thread(target=reader) for _ in range(4)]
    worker.start()
    for t in readers:
        t.start()
    for i, text in enumerate(new):
        assert queue.push(f"new-{i}", text) is EnqueueResult.ENQUEUED
    deadline = time.time() + 300
    while worker.stats.docs_embedded < NEW and time.time() < deadline and not errors:
        time.sleep(0.01)
    stop.set()
    for t in readers:
        t.join(timeout=120)
    worker.stop()
    assert not any(t.is_alive() for t in readers)
    launches = (topk_scan.group_max.launches, topk_scan.gather_rescore.launches)
    assert not errors, [repr(e) for e in errors[:2]]
    assert (worker.stats.docs_embedded, worker.stats.errors) == (NEW, 0) and batches
    assert min(launches) > 0, launches
    assert index.fast.doc_ids == index.quality.doc_ids and index.fast.n_rows == SEEDS + NEW

    rows = [index.fast.row_for(f"new-{i}") for i in range(NEW)]
    want_fast = HashEmbedder(dim=256).embed_batch(new)
    want_fast /= np.linalg.norm(want_fast, axis=1, keepdims=True)
    got_slab = index.fast.slab[rows, :256].cpu()
    assert torch.equal(got_slab, torch.from_numpy(want_fast).to(index.fast.slab.dtype))
    cpu_q = random_transformer_embedder(WORDS, device=torch.device("cpu"), hidden=64, layers=2, heads=4, seed=3)
    want_q = cpu_q.embed_batch(new)
    want_q /= np.linalg.norm(want_q, axis=1, keepdims=True)
    q_rows = [index.quality.row_for(f"new-{i}") for i in range(NEW)]
    np.testing.assert_allclose(index.quality.vectors_f32()[q_rows], want_q, atol=ENC_TOL, rtol=0)
    fast = TwoTierSearcher(index, fe, config=TwoTierConfig(fast_only=True))
    tops = [o.results[0].doc_id for o in fast.search_batch(new[:64], k=1)]
    assert tops == [f"new-{i}" for i in range(64)]


def test_a_device_fault_in_the_quality_embed_ends_the_loop(cuda_device, tmp_path):
    fe, qe, index = _world(cuda_device, tmp_path)
    fault = RuntimeError("CUDA error: an illegal memory access was encountered")
    queue = EmbeddingQueue()
    worker = RefreshWorker(queue, index, fe, FailingOn(qe, 3, fault), max_batch=16, poll_interval_s=0.001)
    for i, text in enumerate(texts_of(80, 4, prefix="fresh ")):
        queue.push(f"new-{i:02d}", text)
    worker.start()
    deadline = time.time() + 60
    while worker._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        worker.stop()
    assert (worker.stats.batches, worker.stats.errors) == (2, 1)
    assert [d for d in index.fast.doc_ids if index.quality.row_for(d) is None] == [
        f"new-{i:02d}" for i in range(32, 48)]
