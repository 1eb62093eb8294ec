"""The Model2Vec fast tier of the port against the JAX reference, on the
CPU: the embedder (tokenizer, gather + mean-pool + normalize, loading), the
bulk corpus embed (bag-of-words lane), and the fully fused phase-1 lane of
``search_batch`` (embed + scan + BM25 + RRF in one pass) in the dense,
blocked, DAAT and mixed lexical lanes.

Both packages get the same table: the reference's seeded numpy draw, bf16
on each side.

Tolerances:
- token ids and masks are equal; tables are bitwise equal;
- embedded rows agree within 1e-6 absolute (unit rows): both pool in f32,
  but the reference's XLA reductions (the token sum, the sum of squares)
  take an order of their own where the port adds token by token and over a
  halving tree of the dimensions;
- the bag lane sums each doc's terms in posting order as the reference's
  CPU scatter does; its normalisation is the port's, so also 1e-6;
- fused results (doc ids and RRF scores, which depend only on ranks) are
  equal to the reference's; vector scores agree within 1e-6 relative;
- the port's rows do not depend on their batchmates or on the padded token
  length, so a query alone returns its batch row bit for bit where its
  class budgets are the batch's (``chip_smoke.check_singletons_by_budget``;
  elsewhere the batch's pools are deeper, and the lane scores both lists
  hold are bitwise equal).
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from frankensearch_tpu.core.config import TwoTierConfig as RefConfig
from frankensearch_tpu.embed import bulk as jbulk
from frankensearch_tpu.embed import model2vec as jm2v
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulkBm25
from frankensearch_tpu.ops import hybrid_phase1 as jhp
from frankensearch_tpu_torch import TwoTierConfig, convert
from frankensearch_tpu_torch.embed import bulk as tbulk
from frankensearch_tpu_torch.embed import model2vec as tm2v
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from frankensearch_tpu_torch.ops import hybrid_phase1 as thp
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")
VOCAB = [f"w{i}" for i in range(300)]
ATOL = 1e-6


def texts(n, seed, lo=0, hi=40):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(VOCAB, size=int(rng.integers(lo, hi)))) for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    """The same seeded table in both packages."""
    ref = jm2v.random_model2vec(VOCAB, dim=64, seed=2)
    port = tm2v.random_model2vec(VOCAB, dim=64, seed=2, device=CPU)
    return ref, port


def f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def test_tables_and_identity_equal(pair):
    ref, port = pair
    assert port._emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(port._emb.to(torch.float32).numpy(), f32(ref._emb))
    assert port.identity().embedder_id == ref.identity().embedder_id == "random-m2v-64"
    assert (port.dim, port.revision) == (ref.dim, ref.revision)


@pytest.mark.parametrize("case", [
    ["w1 w2", "", "W3 w4!", "zzz w5", "w1, w1. w1"],  # empty, case, punctuation, OOV, repeats
    texts(6, 0, 10, 30),  # the 32-token bucket
    texts(3, 1, 100, 200) + ["w7"],  # 256
    [" ".join(["w9"] * 700)],  # past max_tokens: cut at 512
])
def test_tokenize_batch_equal(pair, case):
    ref, port = pair
    for got, want in zip(port.tokenize_batch(case), ref.tokenize_batch(case)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 16), (10, 32), (30, 64), (0, 130)])
def test_gather_pool_normalize_matches_reference(pair, lo, hi):
    ref, port = pair
    batch = texts(24, lo + hi, lo, hi) + ["", "zzz"]
    ids, mask = ref.tokenize_batch(batch)
    want = np.asarray(jm2v._gather_pool_normalize(ref._emb, ids, mask))
    got = tm2v.gather_pool_normalize(port._emb, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[-2:].any()  # no token, no vector
    np.testing.assert_allclose(port.embed_batch(batch), ref.embed_batch(batch), rtol=0, atol=ATOL)


def test_rows_independent_of_batch_and_padding(pair):
    """A row's bits do not change with its batchmates or the token bucket."""
    _, port = pair
    short, long_ = texts(5, 3, 1, 10), texts(3, 4, 40, 60)
    alone = np.stack([port.embed_batch([t])[0] for t in short])
    mixed = port.embed_batch(short + long_)[: len(short)]
    assert port.tokenize_batch(short + long_)[0].shape[1] == 64 != port.tokenize_batch(short)[0].shape[1]
    np.testing.assert_array_equal(alone.view(np.uint32), mixed.view(np.uint32))


def test_normalize_rows_any_width():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 48)).astype(np.float32)
    x[3] = 0.0
    got = tm2v.normalize_rows(torch.from_numpy(x)).numpy()
    want = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("chunk", [16_384, 7])
def test_bag_lane_matches_reference(pair, chunk):
    ref, port = pair
    corpus = texts(200, 0, 0, 40) + ["", "zzz qqq", "!!!", "W1 w1 w1 w2"]
    want = jbulk.bag_embed_corpus(ref, corpus, chunk_docs=chunk)
    got = tbulk.bag_embed_corpus(port, corpus, chunk_docs=chunk)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # chunk boundaries do not change a doc's sum
    whole = tbulk.bag_embed_corpus(port, corpus)
    np.testing.assert_array_equal(got.view(np.uint32), whole.view(np.uint32))


def test_bag_lane_cases(pair):
    """The reference's tests/test_bulk_embed.py cases on the port."""
    _, port = pair
    corpus = texts(200, 0, 25, 26)
    bag = tbulk.bag_embed_corpus(port, corpus)
    assert np.sum(port.embed_batch(corpus) * bag, axis=1).min() > 0.99999
    np.testing.assert_allclose(np.linalg.norm(bag, axis=1), 1.0, atol=1e-5)
    out = tbulk.bag_embed_corpus(port, ["", "w5 w6 w7", "zzz qqq", "!!!"])
    norms = np.linalg.norm(out, axis=1)
    assert norms[1] == pytest.approx(1.0, abs=1e-5)
    assert norms[0] == norms[2] == norms[3] == 0.0  # empty / OOV-only
    a = tbulk.bag_embed_corpus(port, ["w1 w1 w1 w2"])  # tf weighting
    assert float(np.sum(a * port.embed_batch(["w1 w1 w1 w2"]))) > 0.99999
    np.testing.assert_array_equal(tbulk.bag_embed_corpus(port, ["W1 W2"]), tbulk.bag_embed_corpus(port, ["w1 w2"]))
    wire = tbulk.embed_corpus(port, corpus[:20], wire_dtype="bf16")
    np.testing.assert_array_equal(wire, torch.from_numpy(bag[:20]).to(torch.bfloat16).float().numpy())
    assert tbulk.embed_corpus(port, []).shape == (0, 64)
    assert tm2v.SimpleWordTokenizer({"a": 0, "b": 1}).encode_batch(["a b", "b zzz"]) == [[0, 1], [1]]


def test_embed_corpus_falls_back_for_other_tokenizers():
    class FakeBpe:
        def encode(self, text):
            return [1, 2]

    emb = tm2v.Model2VecEmbedder(np.eye(8, 4, dtype=np.float32), FakeBpe(), embedder_id="bpe-test", device=CPU)
    ref = jm2v.Model2VecEmbedder(np.eye(8, 4, dtype=np.float32), FakeBpe(), embedder_id="bpe-test")
    assert tbulk.bag_embed_corpus(emb, ["anything"]) is None
    out = tbulk.embed_corpus(emb, ["anything at all", "more"])
    np.testing.assert_allclose(out, jbulk.embed_corpus(ref, ["anything at all", "more"]), rtol=0, atol=ATOL)


def test_from_dir_loads_like_reference(tmp_path):
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[UNK]": 0, **{w: i + 1 for i, w in enumerate(VOCAB[:50])}}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    model = tmp_path / "potion-test"
    model.mkdir()
    tok.save(str(model / "tokenizer.json"))
    table = np.random.default_rng(9).standard_normal((len(vocab), 32)).astype(np.float32)
    save_file({"embeddings": table}, str(model / "model.safetensors"))
    (model / "config.json").write_text(json.dumps({"model_revision": "r7"}))
    ref = jm2v.Model2VecEmbedder.from_dir(str(model))
    port = tm2v.Model2VecEmbedder.from_dir(str(model), device=CPU)
    assert (port.embedder_id, port.revision, port.dim) == (ref.embedder_id, ref.revision, ref.dim)
    assert port.identity().embedder_id == "potion-test" and port.revision == "r7"
    batch = ["w1 w2 w3", "w4 nothing w49", ""]
    for got, want in zip(port.tokenize_batch(batch), ref.tokenize_batch(batch)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(port.embed_batch(batch), ref.embed_batch(batch), rtol=0, atol=ATOL)
    with pytest.raises(Exception, match="layout not found"):
        tm2v.Model2VecEmbedder.from_dir(str(tmp_path), device=CPU)


def test_model2vec_from_arrays(pair):
    ref, _ = pair
    tok = ref._tokenizer
    port = convert.model2vec_from_arrays(
        np.asarray(ref._emb), tok.vocab, device=CPU, unk_id=tok.unk_id, lowercase=tok.lowercase,
        embedder_id=ref.embedder_id, revision=ref.revision,
    )
    np.testing.assert_array_equal(port._emb.to(torch.float32).numpy(), f32(ref._emb))
    assert port.identity() == convert.EmbeddingIdentity(
        embedder_id=ref.embedder_id, embedder_revision=ref.revision, dim=ref.dim, is_semantic=True)
    batch = texts(8, 6)
    np.testing.assert_allclose(port.embed_batch(batch), ref.embed_batch(batch), rtol=0, atol=ATOL)


# --------------------------------------------------------------------------
# the fully fused phase-1 lane
# --------------------------------------------------------------------------


def _spy(monkeypatch, module, names):
    calls = {name: 0 for name in names}
    for name in names:
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, spy)
    return calls


EMBED_LANES = ("fused_phase1_embed_dense", "fused_phase1_embed_blocked",
               "fused_phase1_embed_daat", "fused_phase1_embed_daat_mixed")


def _stacks(root, docs, ref_lex, port_lex):
    ref_emb = jm2v.random_model2vec(th.WORDS, dim=64, seed=4)
    emb = tm2v.random_model2vec(th.WORDS, dim=64, seed=4, device=CPU)
    ref_index = RefIndex.create(
        root, ref_emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        ref_emb.identity(), use_pallas=True,  # pads to 8192 rows, like the port
    )
    ref = RefSearcher(ref_index, ref_emb, lexical=ref_lex, config=RefConfig(fast_only=True))
    port = TwoTierSearcher(TwoTierIndex.open(root, device=CPU), emb, lexical=port_lex,
                           config=TwoTierConfig(fast_only=True))
    return ref, port


@pytest.fixture(scope="module")
def dense_stacks(tmp_path_factory):
    docs = th.corpus()
    return _stacks(str(tmp_path_factory.mktemp("m2v_dense")), docs,
                   RefBulkBm25(docs), BulkDeviceBm25Index(th.port_docs(docs), device=CPU))


@pytest.fixture(scope="module")
def split_stacks(tmp_path_factory):
    docs = th.corpus()
    with th.lowered():
        ref_lex = RefBulkBm25(docs)
        port_lex = BulkDeviceBm25Index(th.port_docs(docs), device=CPU)
    assert ref_lex._hot is not None and port_lex._hot is not None
    return _stacks(str(tmp_path_factory.mktemp("m2v_split")), docs, ref_lex, port_lex)


def _check_fused(ref, port, monkeypatch, batch, k=10):
    """One batch through both packages' fully fused lanes: the port's
    results equal the reference's; returns the port's outcomes."""
    ref_calls = _spy(monkeypatch, jhp, EMBED_LANES)
    port_calls = _spy(monkeypatch, thp, EMBED_LANES)
    want = ref.search_batch(batch, k=k)
    got = port.search_batch(batch, k=k)
    assert sum(port_calls.values()) == 1 and port_calls == ref_calls, (port_calls, ref_calls)
    assert port.last_phase1_embed_fused and port.last_fusion_path == "device"
    assert port.last_phase1_lex_lane == ref.last_phase1_lex_lane
    assert all(o.metrics.phase1_fused for o in got)
    assert [[(r.doc_id, r.score) for r in o.results] for o in got] == [
        [(r.doc_id, r.score) for r in o.results] for o in want
    ]
    for g, w in zip(got, want):
        gs = [r.fast_score for r in g.results if r.fast_score is not None]
        ws = [r.fast_score for r in w.results if r.fast_score is not None]
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    return got


@pytest.mark.parametrize("k", [5, 10])
def test_fused_embed_dense_lane_matches_reference(dense_stacks, monkeypatch, k):
    ref, port = dense_stacks
    got = _check_fused(ref, port, monkeypatch, th.QUERIES, k=k)
    assert port.last_phase1_lex_lane == "dense"
    for q in th.QUERIES:
        (one,) = _check_fused(ref, port, monkeypatch, [q], k=k)
        if one.results:
            chip_smoke.check_singletons_by_budget("dense lane", th.QUERIES, got, [q], [one])


@pytest.mark.parametrize("divisor", [128, 8])
def test_fused_embed_blocked_lanes_match_reference(split_stacks, monkeypatch, divisor):
    """The split layout (thresholds lowered): the blocked lane for the
    batch, and with a lowered crossover the daat and mixed lanes."""
    from frankensearch_tpu.lexical import daat as jdaat
    from frankensearch_tpu_torch.lexical import daat as tdaat

    monkeypatch.setattr(jdaat, "DAAT_CROSSOVER_DIVISOR", divisor)
    monkeypatch.setattr(tdaat, "DAAT_CROSSOVER_DIVISOR", divisor)
    ref, port = split_stacks
    lanes = set()
    with th.reference_flat_interpret():
        got = _check_fused(ref, port, monkeypatch, th.QUERIES)
        lanes.add(port.last_phase1_lex_lane)
        for q in th.QUERIES:
            (one,) = _check_fused(ref, port, monkeypatch, [q])
            lanes.add(port.last_phase1_lex_lane)
            if one.results:
                chip_smoke.check_singletons_by_budget("blocked lanes", th.QUERIES, got, [q], [one])
    assert lanes == {"blocked", "daat", "mixed"}


def test_fused_embed_lane_needs_model2vec(dense_stacks, monkeypatch):
    """A hash embedder keeps the scan + BM25 lane; a filtered batch leaves
    the fused lanes altogether."""
    from frankensearch_tpu_torch import HashEmbedder
    from frankensearch_tpu_torch.core.filter import BitsetFilter

    _, port = dense_stacks
    calls = _spy(monkeypatch, thp, EMBED_LANES)
    hashed = TwoTierSearcher(port.index, HashEmbedder(dim=64), lexical=port.lexical,
                             config=TwoTierConfig(fast_only=True))
    hashed._semantic_admitted = True  # the index's identity is the Model2Vec one
    out = hashed.search_batch(th.QUERIES[:3], k=5)
    assert all(o.metrics.phase1_fused for o in out) and not hashed.last_phase1_embed_fused
    out = port.search_batch(th.QUERIES[:3], k=5, search_filter=BitsetFilter({"d0001", "d0002"}))
    assert not any(o.metrics.phase1_fused for o in out) and not port.last_phase1_embed_fused
    assert sum(calls.values()) == 0
