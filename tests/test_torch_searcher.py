"""The whole ported slice against the JAX reference, on the CPU.

The same docs go through the reference ``TwoTierSearcher`` (fast-only,
``BulkDeviceBm25Index``, ``HashEmbedder``) and the port's, over one on-disk
index opened by both packages. The fused results — doc ids and RRF scores —
must be equal, and the port must take the fused lane and the device fusion.
"""

import numpy as np
import pytest
import torch

from frankensearch_tpu.core.config import TwoTierConfig
from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu.embed.hash_embedder import HashEmbedder
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulkBm25
from frankensearch_tpu_torch import convert
from frankensearch_tpu_torch.device import resolve_device
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index

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
    emb = HashEmbedder(dim=64)
    root = str(tmp_path_factory.mktemp("slice"))
    ref_index = RefIndex.create(
        root, emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        emb.identity(), use_pallas=True,  # pads to 8192 rows, like the port
    )
    cfg = TwoTierConfig(fast_only=True)
    ref = RefSearcher(ref_index, emb, lexical=RefBulkBm25(docs), config=cfg)
    index = TwoTierIndex.open(root, device=CPU)
    port = TwoTierSearcher(
        index, emb, lexical=BulkDeviceBm25Index(docs, device=CPU), config=cfg
    )
    return {"docs": docs, "emb": emb, "ref": ref, "port": port, "ref_index": ref_index,
            "index": index}


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
    cfg = TwoTierConfig(fast_only=True)
    ref = RefSearcher(stacks["ref_index"], stacks["emb"], config=cfg)
    port = TwoTierSearcher(stacks["index"], stacks["emb"], config=cfg)
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


def test_unported_lanes_raise(stacks):
    with pytest.raises(NotImplementedError, match="boolean/phrase"):
        stacks["port"].search_batch(['"exact phrase" w1'], k=5)
    with pytest.raises(NotImplementedError, match="phase 2"):
        TwoTierSearcher(stacks["index"], stacks["emb"], quality_embedder=stacks["emb"])
    with pytest.raises(NotImplementedError, match="int8"):
        stacks["index"].fast.search_batch(np.ones((1, 64), np.float32), 3, mode="int8")


def test_resolve_device_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == CPU
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
