"""The gauntlet on an NVIDIA GPU, at a small depth.

The differential campaign holds a ``BulkDeviceBm25Index`` on the card (the
split layout at 20,000 zipf docs: the hot arm, the flat lane on K3 and the
packed DAAT lane, the thresholds lowered) to ``chip_smoke.ExactBm25``, the
exact f64 host BM25 over the same postings, with the arm as it serves and
with every query on the flat lane (K3 counted); and a ``DeviceBm25Index``
on the card to the ``MemoryLexicalIndex`` oracle. The interaction matrix
runs every lane of ``LANE_CATALOG`` on a ``TwoTierSearcher`` over a
two-tier index on the card (HashEmbedder fast tier, d = 256; a seeded
2-layer encoder's quality tier, d = 64, its forward on the card) with the
bulk arm, with and without the quality rescan: every check holds, K1 and
K2 counted. The append-delete-compact law holds on a ``TwoTierIndex`` on
the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gauntlet_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import ExactBm25
from frankensearch_tpu_torch import (BulkDeviceBm25Index, DeviceBm25Index, HashEmbedder, IndexableDocument,
                                     MemoryLexicalIndex, TwoTierConfig, TwoTierIndex, TwoTierSearcher)
from frankensearch_tpu_torch.fusion.interaction_oracles import LANE_CATALOG, run_interaction_matrix
from frankensearch_tpu_torch.gauntlet.generator import CorpusSpec, QuerySpec, generate_corpus
from frankensearch_tpu_torch.gauntlet.runner import check_maintenance_laws, run_differential_campaign
from frankensearch_tpu_torch.lexical import device_bm25, hot_arm
from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder

pytestmark = pytest.mark.cuda

DOCS = 20_000
VOCAB = [f"w{i:05d}" for i in range(5_000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from frankensearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.fixture
def split_arm(cuda_device, monkeypatch):
    """20,000 docs of 14 zipf(1.35) words over 5,000 in the split layout
    on the card (the blocked and hot thresholds lowered to 50,000)."""
    monkeypatch.setattr(device_bm25, "BLOCKED_THRESHOLD_POSTINGS", 50_000)
    monkeypatch.setattr(hot_arm, "HOT_MIN_POSTINGS", 50_000)
    rng = np.random.default_rng(7)
    words = np.array(VOCAB)[(rng.zipf(1.35, size=(DOCS, 14)) - 1) % len(VOCAB)]
    docs = [IndexableDocument(doc_id=f"doc-{i:07d}", content=" ".join(row)) for i, row in enumerate(words)]
    arm = BulkDeviceBm25Index(docs, device=cuda_device)
    assert arm._hot is not None and arm._term_major() is not None
    return arm, docs


@pytest.mark.parametrize("mode", ["auto", "blocked"])
def test_campaign_of_the_split_arm_on_the_card(split_arm, mode):
    arm, docs = split_arm
    exact = ExactBm25(arm)
    arm.daat_mode = mode
    device_bm25.flat_class_fused.launches = 0
    report = run_differential_campaign(exact.search, arm.search_candidates, corpus=docs,
                                       query_spec=QuerySpec(n_queries=50, seed=3), k=10)
    assert report.ok and report.cases == 50, report.divergences[:3]
    assert mode == "auto" or device_bm25.flat_class_fused.launches > 0


def test_campaign_of_the_dense_arm_on_the_card(cuda_device):
    spec = CorpusSpec(n_docs=2_000, seed=7)
    corpus = generate_corpus(spec)
    mem = MemoryLexicalIndex()
    for d in corpus:
        mem.add_document(d)
    mem.commit()
    dev = DeviceBm25Index(mem, device=cuda_device)
    report = run_differential_campaign(mem.search_candidates, dev.search_candidates, corpus_spec=spec, corpus=corpus)
    assert report.ok and report.cases == 50 and report.agreement_rate > 0.8, report.divergences[:3]


@pytest.mark.parametrize("rescan", [False, True])
def test_interaction_matrix_on_the_card(cuda_device, split_arm, tmp_path, rescan):
    arm, docs = split_arm
    texts = [d.content for d in docs]
    fe = HashEmbedder(dim=256)
    qe = random_transformer_embedder(VOCAB, device=cuda_device, hidden=64, layers=2, heads=4, seed=3)
    index = TwoTierIndex.create(str(tmp_path / "ix"), fe.embed_batch(texts), [d.doc_id for d in docs], fe.identity(),
                                device=cuda_device, quality_vectors=qe.embed_batch(texts),
                                quality_identity=qe.identity())
    searchers = []

    def make_searcher(cfg):
        s = TwoTierSearcher(index, fe, lexical=arm, quality_embedder=qe,
                            config=dataclasses.replace(cfg, quality_rescan=rescan, quality_timeout_ms=0),
                            cache_query_embeddings=False)
        searchers.append(s)
        return s

    queries = [" ".join(d.content.split()[:n]) for n, d in zip((1, 2, 3, 4, 2), docs)]
    topk_scan.group_max.launches = topk_scan.gather_rescore.launches = 0
    report = run_interaction_matrix(make_searcher, queries, lanes=LANE_CATALOG)
    for s in searchers:
        s.close()
    assert report.checked == len(LANE_CATALOG) * len(queries) * 5 and report.ok, report.violations[:3]
    assert topk_scan.group_max.launches > 0 and topk_scan.gather_rescore.launches > 0


def test_maintenance_law_on_the_card(cuda_device, tmp_path):
    fe = HashEmbedder(dim=256)

    def build(corpus):
        return TwoTierIndex.create(str(tmp_path / "law"), fe.embed_batch([d.content for d in corpus]),
                                   [d.doc_id for d in corpus], fe.identity(), device=cuda_device)

    def search(index, q, k):
        return list(index.search_fast_classified(fe.embed(q), k).hits)

    def maintain(index):
        index.append_fast(["transient-doc"], fe.embed_batch(["transient maintenance doc"]))
        index.delete(["transient-doc"])
        return index.compact()

    assert check_maintenance_laws(build, search, maintain, law="append-delete-compact-invariance",
                                  corpus_spec=CorpusSpec(n_docs=2_000, seed=20261033)) == []
