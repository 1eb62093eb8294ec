"""The port's package facade and the members it lacked, against the JAX
reference, and the three catch-alls of device paths narrowed to
``SearchError``, on the CPU.

* ``frankensearch_tpu_torch.__all__`` holds every name of the reference's,
  each importable from the package, ``SearchError``, ``SearchPhase`` and
  ``PhaseKind`` the port's own classes;
* ``DeviceVectorIndex.stats()``, ``TermMajorPostings.hbm_bytes`` (packed
  and f32 layouts) and ``HotArm.hbm_bytes`` equal the reference's on the
  same small index (integers: exactly);
* phase 3 (``rerank/pipeline.rerank_step`` and the searcher's step) and
  ``EmbedderStack.auto_detect`` keep the reference's skip for a typed
  ``SearchError`` (and, in auto_detect, for what a malformed model
  directory raises on the host), and let any other exception propagate.
"""

import os

import numpy as np
import pytest
import torch

import frankensearch_tpu as ref_pkg
import frankensearch_tpu_torch as port_pkg
from frankensearch_tpu.index.device_index import DeviceVectorIndex as RefVectorIndex
from frankensearch_tpu.lexical import daat as jdaat
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, TwoTierIndex, TwoTierSearcher
from frankensearch_tpu_torch.core import errors as perr
from frankensearch_tpu_torch.core import types as ptypes
from frankensearch_tpu_torch.embed import stack as pstack
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex, ScanStats
from frankensearch_tpu_torch.lexical import daat as tdaat
from tests import test_torch_hot_arm as th

CPU = torch.device("cpu")


def test_all_holds_every_reference_name():
    assert set(ref_pkg.__all__) <= set(port_pkg.__all__)
    for name in port_pkg.__all__:
        assert getattr(port_pkg, name) is not None, name


def test_typed_exports_are_the_ports_own():
    from frankensearch_tpu_torch import PhaseKind, SearchError, SearchPhase

    assert (SearchError, SearchPhase, PhaseKind) == (perr.SearchError, ptypes.SearchPhase, ptypes.PhaseKind)
    assert {k.name: k.value for k in PhaseKind} == {k.name: k.value for k in ref_pkg.PhaseKind}


@pytest.mark.parametrize("n,dead", [(1, ()), (300, (0, 7, 299)), (8192, (5,)), (8193, ())])
def test_scan_stats_equal_reference(n, dead):
    rng = np.random.default_rng(n)
    vecs = rng.standard_normal((n, 16)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    tomb = np.zeros(n, dtype=bool)
    tomb[list(dead)] = True
    emb = HashEmbedder(dim=16)
    port = DeviceVectorIndex(vecs, ids, emb.identity(), device=CPU, tombstoned=tomb)
    from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHash

    ref = RefVectorIndex(vecs, ids, RefHash(dim=16).identity(), tombstoned=tomb)
    got, want = port.stats(), ref.stats()
    assert isinstance(got, ScanStats)
    assert (got.total_rows, got.live_rows, got.padded_rows) == (want.total_rows, want.live_rows, want.padded_rows)
    appended = port.with_appended(["new"], vecs[:1]).stats()
    ref_appended = ref.with_appended(["new"], vecs[:1]).stats()
    assert appended.__dict__ == ref_appended.__dict__


@pytest.fixture(scope="module")
def split_pair():
    mem, ref, port = th.build_pair()
    assert ref._hot is not None and port._hot is not None
    return ref, port


def test_hot_arm_hbm_bytes_equal_reference(split_pair):
    ref, port = split_pair
    assert port._hot.hbm_bytes == ref._hot.hbm_bytes > 0


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "f32"])
def test_term_major_hbm_bytes_equal_reference(split_pair, packed):
    ref, port = split_pair
    want = jdaat.build_term_major(*ref._cold_host, vocab_size=ref.vocab_size,
                                  raw=ref._cold_raw if packed else None)
    got = tdaat.build_term_major(*port._cold_host, vocab_size=port.vocab_size, device=CPU,
                                 raw=port._cold_raw if packed else None)
    assert got.packed == want.packed == packed
    assert got.hbm_bytes == want.hbm_bytes > 0


# -- catch-alls narrowed to SearchError ----------------------------------------


class _Fixed:
    def score_pairs(self, query, docs):
        from frankensearch_tpu_torch.rerank.cross_encoder import RerankScore

        return [RerankScore(doc_id=d, score=0.5) for d, _ in docs]


def _searcher():
    emb = HashEmbedder(dim=32)
    texts = ["alpha beta", "beta gamma", "gamma delta"]
    index = TwoTierIndex(DeviceVectorIndex(emb.embed_batch(texts), ["a", "b", "c"], emb.identity(), device=CPU))
    return TwoTierSearcher(index, emb, reranker=_Fixed(), config=TwoTierConfig(rerank_enabled=True))


def test_phase3_step_search_error_is_rerank_failed():
    def text_fn(doc_id):
        raise perr.SubsystemError("document store unavailable")

    out = _searcher().search("beta", k=3, text_fn=text_fn)
    assert out.metrics.phase3_skip_reason == "rerank_failed"
    assert [p.kind for p in out.phases] == [ptypes.PhaseKind.INITIAL]
    assert out.results


def test_phase3_step_device_fault_propagates():
    def text_fn(doc_id):
        raise RuntimeError("CUDA error: device-side assert triggered")

    with pytest.raises(RuntimeError, match="device-side assert"):
        _searcher().search("beta", k=3, text_fn=text_fn)


def test_phase3_reranked_when_the_step_succeeds():
    out = _searcher().search("beta", k=3, text_fn=lambda d: "text " + d)
    assert out.metrics.phase3_skip_reason is None
    assert [p.kind for p in out.phases][-1] is ptypes.PhaseKind.RERANKED


def _models_dir(tmp_path, name):
    d = tmp_path / "models" / name
    d.mkdir(parents=True)
    return d


@pytest.mark.parametrize("fault", [
    OSError("unreadable weights"), ValueError("bad config.json"), KeyError("embeddings"),
    ImportError("no safetensors"), perr.EmbeddingFailed("model2vec layout not found"),
], ids=["oserror", "valueerror", "keyerror", "importerror", "searcherror"])
def test_auto_detect_skips_a_malformed_model_dir(tmp_path, monkeypatch, fault):
    _models_dir(tmp_path, "potion-test")

    def from_dir(cls, d, **kw):
        raise fault

    monkeypatch.setattr(pstack.Model2VecEmbedder, "from_dir", classmethod(from_dir))
    stack = pstack.EmbedderStack.auto_detect(str(tmp_path), device=CPU, fast_dim=32)
    assert stack.availability.fast_source == "hash" and stack.fast.dim == 32
    assert any(w.startswith("model dir potion-test: " + type(fault).__name__) for w in stack.availability.warnings)


def test_auto_detect_device_fault_propagates(tmp_path, monkeypatch):
    _models_dir(tmp_path, "potion-test")

    def from_dir(cls, d, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 GiB")

    monkeypatch.setattr(pstack.Model2VecEmbedder, "from_dir", classmethod(from_dir))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pstack.EmbedderStack.auto_detect(str(tmp_path), device=CPU, fast_dim=32)


def test_auto_detect_quality_device_fault_propagates(tmp_path, monkeypatch):
    _models_dir(tmp_path, "minilm-quality")
    from frankensearch_tpu_torch.rerank import encoder

    def load(d, **kw):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(encoder, "load_encoder_embedder", load)
    with pytest.raises(RuntimeError, match="out of memory"):
        pstack.EmbedderStack.auto_detect(str(tmp_path), device=CPU, fast_dim=32)
    assert os.path.isdir(tmp_path / "models" / "minilm-quality")
