"""The port's rerank layer against the JAX reference, on the CPU.

The same weights (the reference's ``init_params``, or an in-repo
``ftenc.v1`` artifact) go through both packages' encoders via
``convert.bert_params_from_arrays``. Tolerances, port vs reference on the
same inputs:

* f32 ``embed_forward`` / ``cross_encoder_forward``: 1e-5 absolute (both
  sum in f32, in different orders);
* ``compute="bf16"``: 5e-4 absolute on unit vectors (a bf16 rounding of
  an intermediate may land on the other side in either package), with
  equal nearest-neighbour rankings;
* int8 weights: 2e-3 absolute on unit vectors, 5e-3 on cross-encoder
  scores (the int32 sums are exact in both; an f32 activation one ulp
  apart can round to the neighbouring int8 value, which moves a product by
  1/127 of its row's largest activation), with equal neighbour rankings.

A query's vector alone and in a batch: the batch pads to the length
bucket of its longest text and the GEMMs see another row count, so the f32
sums may run in another order; the rows agree within 1e-5.

The WordPiece tokenizer, the rerank step and the token-budget chunking
are host code and must match exactly.
"""

import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from frankensearch_tpu.rerank import bert as rbert
from frankensearch_tpu.rerank import tokenizer as rtok
from frankensearch_tpu.rerank.encoder import load_artifact as ref_load_artifact
from frankensearch_tpu_torch.convert import bert_params_from_arrays
from frankensearch_tpu_torch.core.errors import IndexCorrupted, SubsystemError
from frankensearch_tpu_torch.core.types import ScoredResult
from frankensearch_tpu_torch.rerank import tokenizer as ptok
from frankensearch_tpu_torch.rerank.bert import Bert, BertConfig, int8_matmul, quantize_linear_weights
from frankensearch_tpu_torch.rerank.cross_encoder import CrossEncoderReranker, RerankScore, random_cross_encoder
from frankensearch_tpu_torch.rerank.encoder import (
    TransformerEmbedder,
    load_artifact,
    random_transformer_embedder,
    save_artifact,
)
from frankensearch_tpu_torch.rerank.pipeline import CombineStrategy, rerank_step

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ART_64 = REPO / "data" / "quality_encoder"
ART_384 = REPO / "data" / "quality_encoder_384"
WORDS = ["search", "vector", "lexical", "rust", "python", "tpu", "index", "query"]
TEXTS = [
    "search vector index", "vector search query", "rust python tpu",
    "lexical index rust", "tpu tpu tpu", "searches indexing", "query",
]
F32_TOL = 1e-5
BF16_TOL = 5e-4
INT8_TOL = 2e-3
INT8_SCORE_TOL = 5e-3
SOLO_BATCH_TOL = 1e-5


def _flat(params) -> dict:
    leaves, _ = tree_flatten_with_path(params)
    return {keystr(path): np.asarray(leaf) for path, leaf in leaves}


def _batch(tok, texts, pair_with=None):
    encs = [tok.encode_pair(pair_with, t) if pair_with else tok.encode(t) for t in texts]
    t = max(len(e.input_ids) for e in encs)
    ids = np.zeros((len(texts), t), np.int32)
    mask = np.zeros((len(texts), t), np.int32)
    types = np.zeros((len(texts), t), np.int32)
    for i, e in enumerate(encs):
        ids[i, : len(e.input_ids)] = e.input_ids
        mask[i, : len(e.input_ids)] = e.attention_mask
        types[i, : len(e.input_ids)] = e.token_type_ids
    return ids, mask, types


@pytest.fixture(scope="module")
def small():
    """A 2-layer H=64 model drawn by the reference, in both packages."""
    vocab = rtok.tiny_test_vocab(WORDS)
    cfg = rbert.BertConfig(vocab_size=len(vocab) + 8, hidden=64, layers=2, heads=4,
                           intermediate=256, max_position=128)
    params = rbert.init_params(cfg, seed=3)
    pcfg = BertConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    state = bert_params_from_arrays(_flat(params), pcfg)
    return {"vocab": vocab, "cfg": cfg, "pcfg": pcfg, "params": params, "state": state,
            "tok": rtok.WordPieceTokenizer(vocab)}


def _neighbours(v):
    s = v @ v.T
    return np.argsort(-s + np.eye(len(v)) * 10, axis=1)[:, 1]


class TestWordPiece:
    @pytest.mark.parametrize("text", TEXTS + ["Searches, vectors! 42", ""])
    def test_ids_equal_reference(self, text):
        ref = rtok.WordPieceTokenizer(rtok.tiny_test_vocab(WORDS), max_len=16)
        port = ptok.WordPieceTokenizer(ptok.tiny_test_vocab(WORDS), max_len=16)
        assert port.vocab == ref.vocab
        assert port.encode(text).__dict__ == ref.encode(text).__dict__
        assert port.encode_pair("vector query", text).__dict__ == ref.encode_pair("vector query", text).__dict__

    def test_artifact_vocab_ids_equal_reference(self):
        meta = json.loads((ART_384 / "encoder.json").read_text())
        vocab = {str(k): int(v) for k, v in meta["vocab"].items()}
        ref, port = rtok.WordPieceTokenizer(vocab, 128), ptok.WordPieceTokenizer(vocab, 128)
        for text in ("cw001 sy002 fil003", "unknown-words here", "CW010 sy099"):
            assert port.encode_text(text) == ref.encode_text(text)


class TestForwardParity:
    @pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
    def test_embed_forward(self, small, form):
        ids, mask, _ = _batch(small["tok"], TEXTS)
        cfg, params, pcfg, state = small["cfg"], small["params"], small["pcfg"], small["state"]
        if form == "int8":
            params, state = rbert.quantize_linear_weights(params), quantize_linear_weights(state)
        if form == "bf16":
            cfg, pcfg = (type(c)(**{**c.__dict__, "compute": "bf16"}) for c in (cfg, pcfg))
        want = np.asarray(rbert.embed_forward(params, ids, mask, cfg=cfg))
        got = Bert(pcfg, state, device=CPU).embed_forward(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        got = got.numpy()
        tol = {"f32": F32_TOL, "bf16": BF16_TOL, "int8": INT8_TOL}[form]
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
        assert (_neighbours(got) == _neighbours(want)).all()

    @pytest.mark.parametrize("form", ["f32", "int8"])
    def test_cross_encoder_forward(self, small, form):
        ids, mask, types = _batch(small["tok"], TEXTS, pair_with="vector search")
        params, state = small["params"], small["state"]
        if form == "int8":
            params, state = rbert.quantize_linear_weights(params), quantize_linear_weights(state)
        want = np.asarray(rbert.cross_encoder_forward(params, ids, mask, types, cfg=small["cfg"]))
        got = Bert(small["pcfg"], state, device=CPU).cross_encoder_forward(
            torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(types).long()
        ).numpy()
        np.testing.assert_allclose(got, want, atol=F32_TOL if form == "f32" else INT8_SCORE_TOL, rtol=0)
        assert ((got >= 0.0) & (got <= 1.0)).all()

    def test_quantized_weights_equal_reference(self, small):
        want = _flat(rbert.quantize_linear_weights(small["params"]))
        got = quantize_linear_weights(small["state"])
        from frankensearch_tpu_torch.rerank.bert import port_name

        assert {port_name(k) for k in want} == set(got)
        for k, v in want.items():
            np.testing.assert_array_equal(got[port_name(k)].numpy(), v)

    def test_int8_matmul_is_exact(self):
        g = torch.Generator().manual_seed(0)
        x = torch.randint(-127, 128, (5, 1536), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (1536, 1), generator=g, dtype=torch.int8)
        want = x.to(torch.int64) @ w.to(torch.int64)
        assert torch.equal(int8_matmul(x, w).to(torch.int64), want)

    @pytest.mark.parametrize("art", [ART_64, ART_384], ids=["h64", "h384"])
    def test_artifact_embeddings_match_reference(self, art):
        texts = ["cw001 cw002 sy003", "the quick brown fox", "fil010 fil011", "alpha"]
        want = ref_load_artifact(str(art)).embed_batch(texts)
        got = load_artifact(str(art), device=CPU).embed_batch(texts)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.fixture(scope="module")
def trained():
    return load_artifact(str(ART_384), device=CPU)  # verify=True: certificate fail-closed


class TestRealShapeArtifact:
    """tests/test_trained_quality_384.py's checks, on the port."""

    def test_loads_with_cert_at_real_shape(self, trained):
        assert (trained.cfg.hidden, trained.cfg.layers, trained.cfg.heads) == (384, 6, 12)
        assert trained.embedder_id == "random-bert-384-tuned"

    def test_learned_synonym_geometry(self, trained):
        canon = trained.embed_batch(["cw000 cw001", "cw002 cw003"])
        syn = trained.embed_batch(["sy000 sy001", "sy002 sy003"])
        filler = trained.embed_batch(["fil000 fil001", "fil002 fil003"])
        paired = float(np.mean(np.sum(canon * syn, axis=1)))
        unpaired = float(np.mean(np.sum(canon * filler, axis=1)))
        assert paired > unpaired + 0.1, (paired, unpaired)

    def test_tampered_weights_fail_closed_even_with_tolerance(self, tmp_path):
        dst = tmp_path / "artifact"
        shutil.copytree(ART_384, dst)
        blob = {k: v + np.float32(0.05) for k, v in dict(np.load(dst / "params.npz")).items()}
        np.savez(dst / "params.npz", **blob)
        with pytest.raises(IndexCorrupted, match="certificate mismatch"):
            load_artifact(str(dst), device=CPU)

    def test_platform_drift_within_tolerance_loads(self, tmp_path):
        dst = tmp_path / "artifact"
        shutil.copytree(ART_384, dst)
        meta = json.loads((dst / "encoder.json").read_text())
        gv = np.asarray(meta["golden_vectors"], dtype=np.float32)
        gv = gv + np.random.default_rng(0).uniform(-5e-4, 5e-4, gv.shape).astype(np.float32)
        meta["golden_vectors"] = [[float(x) for x in row] for row in gv]
        meta["golden"]["vectors_sha256"] = "0" * 64
        (dst / "encoder.json").write_text(json.dumps(meta))
        assert load_artifact(str(dst), device=CPU).cfg.hidden == 384

    def test_drift_beyond_tolerance_fails(self, tmp_path):
        dst = tmp_path / "artifact"
        shutil.copytree(ART_384, dst)
        meta = json.loads((dst / "encoder.json").read_text())
        gv = np.asarray(meta["golden_vectors"], dtype=np.float32) + 0.01
        meta["golden_vectors"] = [[float(x) for x in row] for row in gv]
        meta["golden"]["vectors_sha256"] = "0" * 64
        (dst / "encoder.json").write_text(json.dumps(meta))
        with pytest.raises(IndexCorrupted, match="certificate mismatch"):
            load_artifact(str(dst), device=CPU)

    def test_bf16_serving_after_the_f32_check(self, trained):
        bf16 = load_artifact(str(ART_384), device=CPU, compute="bf16")
        assert bf16.cfg.compute == "bf16" and trained.cfg.compute == "f32"
        texts = ["cw001 cw002", "sy001 sy002", "fil001 fil002", "cw005 sy006"]
        np.testing.assert_allclose(bf16.embed_batch(texts), trained.embed_batch(texts), atol=2e-2)


class TestArtifactRoundTrip:
    def test_save_then_load(self, tmp_path):
        emb = random_transformer_embedder(WORDS, device=CPU, seed=5)
        save_artifact(emb, str(tmp_path / "a"))
        back = load_artifact(str(tmp_path / "a"), device=CPU)  # the sha matches on the saving platform
        np.testing.assert_array_equal(back.embed_batch(TEXTS), emb.embed_batch(TEXTS))
        # the reference opens the port's artifact (its keys, its layout)
        np.testing.assert_allclose(
            ref_load_artifact(str(tmp_path / "a")).embed_batch(TEXTS), emb.embed_batch(TEXTS), atol=F32_TOL
        )

    def test_save_refuses_bf16_embedder(self, tmp_path):
        emb = random_transformer_embedder(WORDS, device=CPU)
        bf16 = TransformerEmbedder(emb.params, emb.cfg, emb.tokenizer, device=CPU, compute="bf16")
        with pytest.raises(ValueError):
            save_artifact(bf16, str(tmp_path / "x"))

    def test_solo_vs_batch_within_bound(self, trained):
        texts = ["cw001", "cw002 sy003 fil004", " ".join(f"cw{i:03d}" for i in range(20)), "sy010 sy011"]
        batch = trained.embed_batch(texts)
        for i, t in enumerate(texts):
            np.testing.assert_allclose(trained.embed_batch([t])[0], batch[i], atol=SOLO_BATCH_TOL, rtol=0)

    def test_prefetch_equals_embed(self):
        emb = random_transformer_embedder(WORDS, device=CPU)
        collect = emb.embed_prefetch("rust index")
        np.testing.assert_array_equal(collect(), emb.embed_batch(["rust index"])[0])


class TestCrossEncoder:
    def test_token_budget_chunking(self):
        ce = random_cross_encoder(WORDS, device=CPU)
        docs = [(f"d{i}", "search vector lexical " * (1 + i % 3)) for i in range(8)]
        whole = ce.score_pairs("query", docs)
        calls = []
        chunk = ce._score_chunk
        ce._score_chunk = lambda c: calls.append(len(c)) or chunk(c)
        ce.max_batch_tokens = 64  # force chunking
        scores = ce.score_pairs("query", docs)
        assert [s.doc_id for s in scores] == [f"d{i}" for i in range(8)]
        assert len(calls) > 1 and sum(calls) == 8
        np.testing.assert_allclose([s.score for s in scores], [s.score for s in whole], atol=1e-6)

    @pytest.mark.parametrize("int8", [False, True])
    def test_scores_in_unit_interval_and_deterministic(self, int8):
        ce = random_cross_encoder(WORDS, device=CPU, int8=int8)
        a = ce.score_pairs("vector search", [("d1", "vector search index"), ("d2", "rust python")])
        b = ce.score_pairs("vector search", [("d1", "vector search index"), ("d2", "rust python")])
        assert [s.score for s in a] == [s.score for s in b]
        assert all(0.0 <= s.score <= 1.0 for s in a)

    def test_reranker_matches_reference_model(self, small):
        """A CrossEncoderReranker over the reference's weights scores the
        pairs as the reference's reranker does."""
        from frankensearch_tpu.rerank.cross_encoder import CrossEncoderReranker as RefCE

        docs = [(f"d{i}", t) for i, t in enumerate(TEXTS)]
        ref = RefCE(small["params"], small["cfg"], small["tok"], max_pair_tokens=128)
        port = CrossEncoderReranker(small["state"], small["pcfg"], ptok.WordPieceTokenizer(small["vocab"]),
                                    device=CPU, max_pair_tokens=128)
        want = ref.score_pairs("vector query", docs)
        got = port.score_pairs("vector query", docs)
        assert [s.doc_id for s in got] == [s.doc_id for s in want]
        np.testing.assert_allclose([s.score for s in got], [s.score for s in want], atol=F32_TOL)


def _results(n=3):
    return [ScoredResult(doc_id=d, score=s) for d, s in zip("abc", (0.03, 0.02, 0.01))][:n]


class _Fixed:
    def __init__(self, scores):
        self.scores = scores

    def score_pairs(self, query, docs):
        return [RerankScore(d, self.scores[d]) for d, _ in docs]


class _Raising:
    """A reranker whose typed failure the pipeline skips."""

    def score_pairs(self, query, docs):
        raise SubsystemError("boom")


class _Faulting:
    """A reranker whose untyped failure (a device fault) must propagate."""

    def score_pairs(self, query, docs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


class TestRerankStep:
    """tests/test_rerank.py's pipeline cases, on the port."""

    def test_rank_only_reorders(self):
        out = rerank_step(_Fixed({"a": 0.1, "b": 0.9, "c": 0.5}), "q", _results(), lambda d: f"text {d}",
                          combine=CombineStrategy.RANK_ONLY)
        assert [r.doc_id for r in out.results] == ["b", "c", "a"]
        assert out.reranked_count == 3

    def test_missing_text_graceful_skip(self):
        out = rerank_step(_Raising(), "q", _results(), lambda d: None)
        assert out.skipped and out.skip_reason == "no_text"
        assert [r.doc_id for r in out.results] == ["a", "b", "c"]

    def test_reranker_error_graceful(self):
        out = rerank_step(_Raising(), "q", _results(), lambda d: "t")
        assert out.skipped and out.skip_reason == "rerank_error"
        assert [r.doc_id for r in out.results] == ["a", "b", "c"]

    def test_reranker_device_fault_propagates(self):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            rerank_step(_Faulting(), "q", _results(), lambda d: "t")

    def test_no_input(self):
        out = rerank_step(None, "q", _results(), lambda d: "t")
        assert out.skipped and out.skip_reason == "no_input"

    def test_tail_preserved(self):
        results = _results() + [ScoredResult(doc_id="tail", score=0.001)]
        out = rerank_step(_Fixed({"a": 0.5, "b": 0.5, "c": 0.5}), "q", results, lambda d: "t", top_n=3)
        assert out.results[-1].doc_id == "tail"

    def test_nonfinite_scores_dropped_doc_keeps_position(self):
        results = [ScoredResult(doc_id=f"d{i}", score=1.0 - i * 0.1) for i in range(6)]
        scores = {f"d{i}": float("nan") for i in range(6)} | {"d3": 9.0}
        out = rerank_step(_Fixed(scores), "q", results, lambda d: f"text {d}", top_n=6)
        assert not out.skipped
        assert all(math.isfinite(r.score) for r in out.results)
        assert out.results[0].doc_id == "d3"

    @pytest.mark.parametrize("combine", list(CombineStrategy))
    def test_matches_reference(self, combine):
        from frankensearch_tpu.core.types import ScoredResult as RefResult
        from frankensearch_tpu.rerank.cross_encoder import RerankScore as RefScore
        from frankensearch_tpu.rerank.pipeline import CombineStrategy as RefCombine
        from frankensearch_tpu.rerank.pipeline import rerank_step as ref_step

        scores = {"a": 0.2, "b": 0.9, "c": 0.2, "d": float("inf")}
        base = [("a", 0.05), ("b", 0.02), ("c", 0.02), ("d", 0.01), ("e", 0.005)]

        class RefFixed:
            def score_pairs(self, query, docs):
                return [RefScore(d, scores[d]) for d, _ in docs]

        want = ref_step(RefFixed(), "q", [RefResult(doc_id=d, score=s) for d, s in base],
                        lambda d: "t", top_n=4, combine=RefCombine(combine.value))
        got = rerank_step(_Fixed(scores), "q", [ScoredResult(doc_id=d, score=s) for d, s in base],
                          lambda d: "t", top_n=4, combine=combine)
        assert [(r.doc_id, r.score, r.rerank_score) for r in got.results] == [
            (r.doc_id, r.score, r.rerank_score) for r in want.results
        ]
