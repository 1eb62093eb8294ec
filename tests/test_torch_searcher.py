"""The whole ported slice against the JAX reference, on the CPU.

The same docs go through the reference ``TwoTierSearcher`` (fast-only,
``BulkDeviceBm25Index``, ``HashEmbedder``) and the port's, over one on-disk
index opened by both packages. Each package gets objects of its own types
(config, embedder, documents): the port shares no class with the reference. The fused results — doc ids and RRF scores —
must be equal, and the port must take the fused lane and the device fusion.
At blocked scale (thresholds lowered in both packages) the lexical lane of
each batch must be the reference's as well.
"""

import numpy as np
import pytest
import torch

from frankensearch_tpu.core.config import TwoTierConfig as RefConfig
from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHashEmbedder
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulkBm25
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, convert
from frankensearch_tpu_torch.device import resolve_device
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")
QUERIES = [
    "w1 w2", "w5 w9 w30", "w100 w3 w7", "w0", "", "w250 w251",
    "w12 w13 w14 w15 w16 w17", "nothing matches", "w2 -w1",
]


def _docs(n=500, seed=1):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    return [
        IndexableDocument(
            doc_id=f"d{i:04d}",
            content=" ".join(rng.choice(words, size=int(rng.integers(3, 40)), p=p)),
            title=f"note {words[i % 40]}" if i % 5 == 0 else None,
        )
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    docs = _docs()
    ref_emb, emb = RefHashEmbedder(dim=64), HashEmbedder(dim=64)
    root = str(tmp_path_factory.mktemp("slice"))
    ref_index = RefIndex.create(
        root, ref_emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        ref_emb.identity(), use_pallas=True,  # pads to 8192 rows, like the port
    )
    ref = RefSearcher(ref_index, ref_emb, lexical=RefBulkBm25(docs), config=RefConfig(fast_only=True))
    index = TwoTierIndex.open(root, device=CPU)
    port = TwoTierSearcher(
        index, emb, lexical=BulkDeviceBm25Index(th.port_docs(docs), device=CPU),
        config=TwoTierConfig(fast_only=True),
    )
    return {"docs": docs, "emb": emb, "ref_emb": ref_emb, "ref": ref, "port": port,
            "ref_index": ref_index, "index": index, "root": root}


def _results(outcomes):
    return [[(r.doc_id, r.score) for r in o.results] for o in outcomes]


@pytest.mark.parametrize("k", [1, 5, 10, 40])
def test_hybrid_batch_matches_reference(stacks, k):
    ref, port = stacks["ref"], stacks["port"]
    want = ref.search_batch(QUERIES, k=k)
    got = port.search_batch(QUERIES, k=k)
    assert _results(got) == _results(want)
    for g, w in zip(got, want):
        assert g.metrics.query_class == w.metrics.query_class
        assert g.metrics.phase1_fused == w.metrics.phase1_fused
    assert port.last_fusion_path == ref.last_fusion_path == "device"
    live = [o for q, o in zip(QUERIES, got) if q]
    assert all(o.metrics.phase1_fused for o in live)


@pytest.mark.parametrize("query", [q for q in QUERIES if q])
def test_singleton_requests_match_reference(stacks, query):
    """A solo request is padded to a batch of 8 by both packages."""
    got = stacks["port"].search_batch([query], k=10)
    assert _results(got) == _results(stacks["ref"].search_batch([query], k=10))


def test_semantic_only_matches_reference(stacks):
    ref = RefSearcher(stacks["ref_index"], stacks["ref_emb"], config=RefConfig(fast_only=True))
    port = TwoTierSearcher(stacks["index"], stacks["emb"], config=TwoTierConfig(fast_only=True))
    want, got = ref.search_batch(QUERIES, k=10), port.search_batch(QUERIES, k=10)
    assert [[r.doc_id for r in o.results] for o in got] == [
        [r.doc_id for r in o.results] for o in want
    ]
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            [r.fast_score for r in g.results], [r.fast_score for r in w.results], rtol=1e-6
        )


def test_converted_index_scans_like_the_reference(stacks):
    """The reference's own device state, carried across: the port's
    hierarchical lane (plain twins on the CPU) and its plain scan agree
    with the reference scan."""
    ref_fast = stacks["ref_index"].fast
    fast = convert.device_index_from_arrays(
        np.asarray(ref_fast.slab), np.asarray(ref_fast.base_mask),
        ref_fast.doc_ids, ref_fast.identity, device=CPU,
    )
    assert fast.n_pad % 8192 == 0 and fast.d_pad % 128 == 0
    np.testing.assert_array_equal(
        fast.slab.to(torch.float32).numpy(), np.asarray(ref_fast.slab).astype(np.float32)
    )
    qv = stacks["emb"].embed_batch([q for q in QUERIES if q])
    want = ref_fast.search_batch(qv, 10, mode="xla")
    for mode in ("hierarchical", "xla"):
        got = fast.search_batch(qv, 10, mode=mode)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-6)


def test_appends_and_tombstones(stacks):
    fast = stacks["index"].fast
    rng = np.random.default_rng(4)
    v = rng.standard_normal((2, 64)).astype(np.float32)
    grown = fast.with_appended(["new-a", "new-b"], v)
    assert grown.n_rows == fast.n_rows + 2 and grown.slab is not fast.slab
    hit = grown.search_classified(v[1], 1)
    assert hit.hits[0].doc_id == "new-b"
    gone = grown.with_tombstones(["new-b"])
    assert "new-b" in gone.tombstoned_ids()
    assert all(h.doc_id != "new-b" for h in gone.search_classified(v[1], 5).hits)


@pytest.fixture(scope="module")
def split_stacks(tmp_path_factory):
    """The hybrid slice over a lexical arm at blocked scale: the blocked
    threshold and the hot arm's minimum lowered in both packages, so the
    corpus builds the split layout (flat lane + DAAT)."""
    docs = th.corpus()
    ref_emb, emb = RefHashEmbedder(dim=64), HashEmbedder(dim=64)
    root = str(tmp_path_factory.mktemp("split"))
    ref_index = RefIndex.create(
        root, ref_emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        ref_emb.identity(), use_pallas=True,
    )
    with th.lowered():
        ref_lex = RefBulkBm25(docs)
        port_lex = BulkDeviceBm25Index(th.port_docs(docs), device=CPU)
    assert ref_lex._hot is not None and port_lex._hot is not None
    return {
        "ref": RefSearcher(ref_index, ref_emb, lexical=ref_lex, config=RefConfig(fast_only=True)),
        "port": TwoTierSearcher(TwoTierIndex.open(root, device=CPU), emb, lexical=port_lex,
                                config=TwoTierConfig(fast_only=True)),
    }


@pytest.mark.parametrize("divisor", [128, 8])
def test_split_corpus_batch_matches_reference(split_stacks, monkeypatch, divisor):
    """search_batch over the split layout: the same lexical lane per batch
    and the same fused results as the reference (its flat lane in K3's
    order), for the whole batch and for each query alone. A lowered
    crossover makes rare pure-tail queries daat-eligible."""
    from frankensearch_tpu.lexical import daat as jdaat
    from frankensearch_tpu_torch.lexical import daat as tdaat

    monkeypatch.setattr(jdaat, "DAAT_CROSSOVER_DIVISOR", divisor)
    monkeypatch.setattr(tdaat, "DAAT_CROSSOVER_DIVISOR", divisor)
    ref, port = split_stacks["ref"], split_stacks["port"]
    lanes = set()
    for batch in [th.QUERIES] + [[q] for q in th.QUERIES]:
        with th.reference_flat_interpret():
            want = ref.search_batch(batch, k=10)
        got = port.search_batch(batch, k=10)
        assert _results(got) == _results(want), batch
        assert port.last_phase1_lex_lane == ref.last_phase1_lex_lane, batch
        assert all(o.metrics.phase1_fused for o in got) and port.last_fusion_path == "device"
        lanes.add(port.last_phase1_lex_lane)
    assert lanes == {"blocked", "daat", "mixed"}


def test_unported_lanes_raise(stacks):
    """No lane raises NotImplementedError: ``mrl`` serves the reference's
    rows, and ``ivf`` refuses with the reference's ``InvalidConfig`` only
    while the index has no IVF arm (tests/test_torch_ivf.py and
    tests/test_torch_scan_lanes.py hold both lanes to the reference)."""
    from frankensearch_tpu_torch.core.errors import InvalidConfig

    q = np.ones((1, 64), np.float32)
    got = stacks["index"].fast.search_batch(q, 3, mode="mrl")
    want = stacks["ref_index"].fast.search_batch(q, 3, mode="mrl")
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    with pytest.raises(InvalidConfig, match="enable_ivf"):
        stacks["index"].fast.search_batch(q, 3, mode="ivf")


def test_resolve_device_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == CPU
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
