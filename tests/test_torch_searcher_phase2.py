"""The port's Refined and Reranked phases against the JAX reference, on the CPU.

One on-disk two-tier index (a HashEmbedder fast tier, a quality tier of a
small random BERT's vectors) is opened by both packages; both searchers get
the same quality encoder and cross-encoder weights (the reference's,
carried across with ``convert.bert_params_from_arrays``) and the same
documents in their own lexical arms (``MemoryLexicalIndex``, or the device
BM25 arm that phase 1 fuses). Held to the reference:

* ``search()``'s phase stream: the same phase kinds, and in each phase the
  same doc ids; fused scores within 1e-9 relative (RRF sums of the same
  ranks), quality scores within 1e-5 (the encoders' f32 sums run in other
  orders) and rerank scores within 1e-5;
* ``search_batch`` Refined, with ``quality_rescan`` off and on: the
  reference's results, and each query alone the doc ids of ``search()``
  (in a batch, the candidate budgets are the largest of its queries');
* boolean and phrase queries through both entries;
* ``quality_scores_for_hits`` and ``search_quality``: 1e-6;
* the held-out lift world (tools/train_quality_lift.py, rebuilt by
  ``chip_smoke.lift_world``): per-query Initial and Refined nDCG@10 equal
  to the reference's, under the default config and with the rescan.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

import chip_smoke
from frankensearch_tpu.core.config import TwoTierConfig as RefConfig
from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHashEmbedder
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulkBm25
from frankensearch_tpu.rerank.cross_encoder import random_cross_encoder as ref_random_ce
from frankensearch_tpu.rerank.encoder import random_transformer_embedder as ref_random_embedder
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig
from frankensearch_tpu_torch.convert import bert_params_from_arrays
from frankensearch_tpu_torch.core.types import PhaseKind
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from frankensearch_tpu_torch.rerank.bert import BertConfig
from frankensearch_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
from frankensearch_tpu_torch.rerank.encoder import TransformerEmbedder
from frankensearch_tpu_torch.rerank.tokenizer import WordPieceTokenizer
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
WORDS = [f"w{i}" for i in range(120)]
QUERIES = ["w1 w2", "w5 w9 w30", "w100 w3 w7", "w0", "w12 w13 w14 w15", "nothing here", "w2 -w1"]
STRUCTURED = ['"w1 w2"', "w1 AND w3", "w2 NOT w5", '"w5 w9" OR w30']
SCORE_REL = 1e-9
QUALITY_TOL = 1e-5
RERANK_TOL = 1e-5


def _docs(n=200, seed=7):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    return [
        IndexableDocument(doc_id=f"d{i:04d}", content=" ".join(rng.choice(WORDS, size=int(rng.integers(3, 16)), p=p)))
        for i in range(n)
    ]


def _flat(params) -> dict:
    leaves, _ = tree_flatten_with_path(params)
    return {keystr(path): np.asarray(leaf) for path, leaf in leaves}


def _port_cfg(cfg) -> BertConfig:
    return BertConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    docs = _docs()
    texts = {d.doc_id: d.content for d in docs}
    ref_fast, fast = RefHashEmbedder(dim=64), HashEmbedder(dim=64)
    ref_q = ref_random_embedder(WORDS, seed=1)
    q = TransformerEmbedder(
        bert_params_from_arrays(_flat(ref_q.params), _port_cfg(ref_q.cfg)), _port_cfg(ref_q.cfg),
        WordPieceTokenizer(ref_q.tokenizer.vocab, max_len=128), device=CPU,
        embedder_id=ref_q.embedder_id, revision=ref_q.revision, max_tokens=ref_q.max_tokens,
    )
    ref_ce = ref_random_ce(WORDS, seed=2)
    ce = CrossEncoderReranker(
        bert_params_from_arrays(_flat(ref_ce.params), _port_cfg(ref_ce.cfg)), _port_cfg(ref_ce.cfg),
        WordPieceTokenizer(ref_ce.tokenizer.vocab, max_len=128), device=CPU, max_pair_tokens=128,
    )
    root = str(tmp_path_factory.mktemp("phase2"))
    contents = [d.content for d in docs]
    ref_index = RefIndex.create(
        root, ref_fast.embed_batch(contents), [d.doc_id for d in docs], ref_fast.identity(),
        quality_vectors=ref_q.embed_batch(contents), quality_identity=ref_q.identity(), use_pallas=True,
    )
    mem_ref, mem_port = th.memory_pair(docs)
    return {
        "docs": docs, "texts": texts, "ref_index": ref_index, "index": TwoTierIndex.open(root, device=CPU),
        "ref_fast": ref_fast, "fast": fast, "ref_q": ref_q, "q": q, "ref_ce": ref_ce, "ce": ce,
        "lex": {"memory": (mem_ref, mem_port),
                "device": (RefBulkBm25(docs), BulkDeviceBm25Index(th.port_docs(docs), device=CPU))},
    }


def _pair(world, lexical="memory", *, rerank=False, **cfg):
    ref_lex, port_lex = world["lex"][lexical]
    common = {"quality_timeout_ms": 0, "rerank_enabled": rerank, **cfg}  # no timeout in tests
    ref = RefSearcher(world["ref_index"], world["ref_fast"], lexical=ref_lex, quality_embedder=world["ref_q"],
                      reranker=world["ref_ce"] if rerank else None, config=RefConfig(**common),
                      cache_query_embeddings=False, text_fn=world["texts"].get)
    port = TwoTierSearcher(world["index"], world["fast"], lexical=port_lex, quality_embedder=world["q"],
                           reranker=world["ce"] if rerank else None, config=TwoTierConfig(**common),
                           cache_query_embeddings=False, text_fn=world["texts"].get)
    return ref, port


def _same_results(got, want, what):
    assert [r.doc_id for r in got] == [r.doc_id for r in want], what
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, rel=SCORE_REL, abs=1e-12), (what, g.doc_id)
        assert g.lexical_score == w.lexical_score and g.fast_score == pytest.approx(w.fast_score, rel=1e-6)
        for a, b, tol in ((g.quality_score, w.quality_score, QUALITY_TOL), (g.rerank_score, w.rerank_score, RERANK_TOL)):
            assert (a is None) == (b is None), (what, g.doc_id)
            if a is not None:
                assert abs(a - b) <= tol, (what, g.doc_id, a, b)


@pytest.mark.parametrize("rerank", [False, True], ids=["refined", "reranked"])
@pytest.mark.parametrize("lexical", ["memory", "device"])
def test_phase_stream_matches_reference(world, lexical, rerank):
    ref, port = _pair(world, lexical, rerank=rerank)
    for q in QUERIES + STRUCTURED:
        seen = []
        got = port.search(q, k=8, on_phase=seen.append)
        want = ref.search(q, k=8)
        assert [p.kind.value for p in seen] == [p.kind.value for p in got.phases] == [
            p.kind.value for p in want.phases], q
        for gp, wp in zip(got.phases, want.phases):
            _same_results(gp.results, wp.results, (q, gp.kind))
        _same_results(got.results, want.results, q)
        assert got.metrics.phase2_skip_reason == want.metrics.phase2_skip_reason, q
        assert got.metrics.phase3_skip_reason == want.metrics.phase3_skip_reason, q
        assert got.metrics.phase1_fused == want.metrics.phase1_fused, q
    kinds = {p.kind for p in got.phases}
    assert PhaseKind.REFINED in kinds and (PhaseKind.RERANKED in kinds) == rerank
    port.close()


@pytest.mark.parametrize("rescan", [False, True], ids=["aligned", "rescan"])
@pytest.mark.parametrize("lexical", ["memory", "device"])
def test_batch_refined_matches_search_and_reference(world, lexical, rescan):
    ref, port = _pair(world, lexical, quality_rescan=rescan)
    batch = port.search_batch(QUERIES + STRUCTURED, k=6)
    want = ref.search_batch(QUERIES + STRUCTURED, k=6)
    for q, b, w in zip(QUERIES + STRUCTURED, batch, want):
        _same_results(b.results, w.results, q)
        # alone, a query gets its own class's candidate budgets, as in search()
        alone = port.search_batch([q], k=6)[0]
        assert [r.doc_id for r in alone.results] == [r.doc_id for r in port.search(q, k=6).results], q
        assert b.metrics.quality_candidates == w.metrics.quality_candidates, q
    assert any(r.quality_score is not None for o in batch for r in o.results)
    port.close()


def test_prf_and_mmr_match_reference(world):
    """Rocchio PRF on the quality query (centroids from the quality tier's
    host rows) and MMR after the rerank (fast-tier rows)."""
    from frankensearch_tpu.fusion.mmr import MmrDiversifier as RefMmr
    from frankensearch_tpu.fusion.prf import RocchioPrf as RefPrf
    from frankensearch_tpu_torch.fusion.mmr import MmrDiversifier
    from frankensearch_tpu_torch.fusion.prf import RocchioPrf

    ref, port = _pair(world, rerank=True)
    ref.prf, ref.mmr, port.prf, port.mmr = RefPrf(), RefMmr(pool_size=6), RocchioPrf(), MmrDiversifier(pool_size=6)
    for q in QUERIES[:5]:
        got, want = port.search(q, k=8), ref.search(q, k=8)
        for gp, wp in zip(got.phases, want.phases):
            _same_results(gp.results, wp.results, (q, gp.kind))
        want_b = ref.search_batch([q], k=8)[0]
        _same_results(port.search_batch([q], k=8)[0].results, want_b.results, q)


def test_quality_scores_for_hits_and_search_quality(world):
    hits = world["index"].search_fast_classified(world["fast"].embed("w1 w2"), 20).hits
    ref_hits = world["ref_index"].search_fast_classified(world["ref_fast"].embed("w1 w2"), 20).hits
    assert [h.doc_id for h in hits] == [h.doc_id for h in ref_hits]
    qv = world["ref_q"].embed("w1 w2")
    got = world["index"].quality_scores_for_hits(qv, hits)
    want = world["ref_index"].quality_scores_for_hits(qv, ref_hits)
    assert got.keys() == want.keys() and len(got) == 20
    for d in got:
        assert abs(got[d] - want[d]) <= 1e-6
    g, w = world["index"].search_quality(qv, 10), world["ref_index"].search_quality(qv, 10)
    assert [h.doc_id for h in g.hits] == [h.doc_id for h in w.hits]
    np.testing.assert_allclose([h.score for h in g.hits], [h.score for h in w.hits], rtol=1e-6)


def test_quality_identity_mismatch_fails_closed(world):
    other = TransformerEmbedder(world["q"].params, world["q"].cfg, world["q"].tokenizer, device=CPU,
                                embedder_id="another-encoder")
    port = TwoTierSearcher(world["index"], world["fast"], quality_embedder=other,
                           config=TwoTierConfig(quality_timeout_ms=0))
    out = port.search("w1 w2", k=5)
    assert out.metrics.phase2_skip_reason == "quality_identity_mismatch"
    assert [p.kind for p in out.phases] == [PhaseKind.INITIAL]


def test_batch_phase2_failure_propagates(world, monkeypatch):
    """search_batch's quality rescore raises instead of serving phase 1."""
    _, port = _pair(world)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(world["q"], "forward_device", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        port.search_batch(["w1 w2"], k=5)
    # search() keeps the RefinementFailed protocol (the prefetch's failure
    # is raised inside phase 2)
    out = port.search("w1 w2", k=5)
    assert out.metrics.phase2_skip_reason == "error"
    assert [p.kind for p in out.phases] == [PhaseKind.INITIAL, PhaseKind.REFINEMENT_FAILED]


@pytest.mark.parametrize("rescan", [False, True], ids=["default", "rescan"])
def test_lift_world_ndcg_equals_reference(rescan, tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import train_quality_lift as tql
    finally:
        sys.path.pop(0)
    from frankensearch_tpu.rerank.encoder import load_artifact as ref_load
    from frankensearch_tpu_torch.rerank.encoder import load_artifact

    _, ref_docs, ref_queries, ref_qrels, ref_words = tql.build_paraphrase_world(seed=chip_smoke.LIFT_SEED)
    world = chip_smoke.lift_world()
    docs, queries, qrels, words = world
    assert docs == [(d.doc_id, d.content) for d in ref_docs]
    assert (queries, qrels, words) == (ref_queries, ref_qrels, ref_words)
    art = str(REPO / chip_smoke.QUALITY_ARTIFACT)
    want_i, want_r = tql.eval_phase_lift(
        ref_docs, ref_queries, ref_qrels, tql.term_identity_fast(ref_words), ref_load(art),
        cfg=RefConfig(quality_rescan=rescan, quality_timeout_ms=0),
    )
    got_i, got_r, skips = chip_smoke.lift_eval(
        CPU, world, load_artifact(art, device=CPU), str(tmp_path), rescan=rescan, timeout_ms=0
    )
    assert skips == [None] * len(queries)
    assert got_i == want_i and got_r == want_r
    assert np.mean(got_r) - np.mean(got_i) >= chip_smoke.LIFT_FLOOR
