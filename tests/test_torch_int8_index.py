"""The int8 capacity lane and the per-tile top-k lane through the port's
index and searcher, against the JAX reference on the CPU.

Both packages open the same artifacts: the int8 FTVI files that each
writes are byte-identical, and the int8 arm each preloads, calibrates or
appends to is the other's bit for bit. ``search_batch`` with ``scan_mode``
``"int8"`` and ``"pallas"`` serves the unfused path (vector scan,
``search_candidates_batch``, per-query host RRF) in both. On the CPU the
int8 lane is the plain two-pass scan in both packages, and the reference's
per-tile kernel runs in interpret mode.

Tolerances: doc ids and fused scores are equal. At the index, rows may
swap only where two scores lie within 1e-6 (the two-pass rescore sums in
another order than XLA's CPU dot), scores within 1e-6 relative.

The recall-certificate gate is held to the reference's own behaviour
(tests/test_recall_certificate_gate.py and test_recall_cert_persist.py):
the same scenarios refuse with the same message or serve the same
results, and certificates persisted by either package rebind in both.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from frankensearch_tpu.core.config import TwoTierConfig as RefConfig
from frankensearch_tpu.core.errors import UncertifiedScanMode as RefUncertified
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHashEmbedder
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulkBm25
from frankensearch_tpu.ops import topk_scan as jts
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, convert
from frankensearch_tpu_torch.core.errors import UncertifiedScanMode
from frankensearch_tpu_torch.core.generation import MANIFEST_FILE
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.index.recall_certificate import load_persisted_certificates
from frankensearch_tpu_torch.index.two_tier import FAST_FILE, TwoTierIndex
from frankensearch_tpu_torch.index.wal import WriteAheadLog
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from tests import test_torch_hot_arm as th
from tests.test_torch_int8_scan import assert_equal_up_to_near_ties, bits
from tests.test_torch_searcher import QUERIES, _docs, _results

CPU = torch.device("cpu")
DIM = 64


@pytest.fixture(autouse=True)
def reference_tile_kernel_interpreted(monkeypatch):
    """The reference's ``scan_mode="pallas"`` lane calls its K5 kernel,
    which runs on the CPU only in interpret mode."""
    monkeypatch.setattr(
        jts, "scan_topk_pallas", functools.partial(jts.scan_topk_pallas, interpret=True)
    )


def _vectors(emb, docs):
    return emb.embed_batch([d.content for d in docs])


@pytest.fixture(scope="module")
def int8_roots(tmp_path_factory):
    """One int8 artifact written by each package from the same vectors."""
    docs = _docs()
    ref_emb, emb = RefHashEmbedder(dim=DIM), HashEmbedder(dim=DIM)
    ids = [d.doc_id for d in docs]
    ref_root = str(tmp_path_factory.mktemp("int8_ref"))
    port_root = str(tmp_path_factory.mktemp("int8_port"))
    ref = RefIndex.create(ref_root, _vectors(ref_emb, docs), ids, ref_emb.identity(),
                          slab_dtype="int8", use_pallas=True)
    port = TwoTierIndex.create(port_root, _vectors(emb, docs), ids, emb.identity(),
                               device=CPU, slab_dtype="int8")
    return {"docs": docs, "ref": ref, "port": port, "ref_root": ref_root,
            "port_root": port_root, "ref_emb": ref_emb, "emb": emb}


def _arm(index):
    values, scale = index._int8
    return np.asarray(values), np.asarray(scale)


def _assert_same_arm(port_index, ref_index):
    (pv, ps), (rv, rs) = _arm(port_index.fast if hasattr(port_index, "fast") else port_index), _arm(
        ref_index.fast if hasattr(ref_index, "fast") else ref_index
    )
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(bits(ps), bits(rs))


def test_int8_artifacts_are_byte_identical_and_open_in_both(int8_roots):
    r = int8_roots
    with open(os.path.join(r["ref_root"], FAST_FILE), "rb") as a, \
            open(os.path.join(r["port_root"], FAST_FILE), "rb") as b:
        assert a.read() == b.read()
    # the port opens the reference's artifact, the reference the port's
    _assert_same_arm(TwoTierIndex.open(r["ref_root"], device=CPU), r["ref"])
    _assert_same_arm(r["port"], RefIndex.open(r["port_root"], use_pallas=True))
    port_fast = r["port"].fast
    assert port_fast.slab_dtype == "bf16" and port_fast._int8[0].shape == (port_fast.n_pad, port_fast.d_pad)
    np.testing.assert_array_equal(
        port_fast.slab.to(torch.float32).numpy(), np.asarray(r["ref"].fast.slab).astype(np.float32)
    )


def test_calibrated_and_appended_arms_match_reference(tmp_path):
    """A bf16 artifact calibrates its arm on first use; an append into the
    padding quantizes the new rows with the fixed scale."""
    docs = _docs(120)
    ref_emb, emb = RefHashEmbedder(dim=DIM), HashEmbedder(dim=DIM)
    ids = [d.doc_id for d in docs]
    RefIndex.create(str(tmp_path), _vectors(ref_emb, docs), ids, ref_emb.identity(), use_pallas=True)
    ref = RefIndex.open(str(tmp_path), use_pallas=True).fast
    port = TwoTierIndex.open(str(tmp_path), device=CPU).fast
    assert port._int8 is None
    ref._int8_arm(), port._int8_arm()
    _assert_same_arm(port, ref)
    new = 3.0 * np.random.default_rng(9).standard_normal((4, DIM)).astype(np.float32)
    ref_grown, port_grown = ref.with_appended(list("abcd"), new), port.with_appended(list("abcd"), new)
    _assert_same_arm(port_grown, ref_grown)
    assert port_grown.recall_certificate("int8") is None


def test_convert_carries_the_int8_arm(int8_roots):
    ref_fast = int8_roots["ref"].fast
    fast = convert.device_index_from_arrays(
        np.asarray(ref_fast.slab), np.asarray(ref_fast.base_mask), ref_fast.doc_ids,
        ref_fast.identity, device=CPU, int8=_arm(ref_fast),
    )
    assert isinstance(fast.identity, EmbeddingIdentity)
    _assert_same_arm(fast, ref_fast)
    qv = int8_roots["emb"].embed_batch([q for q in QUERIES if q])
    want, got = ref_fast.search_batch(qv, 10, mode="int8"), fast.search_batch(qv, 10, mode="int8")
    assert_equal_up_to_near_ties(got.scores.numpy(), got.indices.numpy(),
                                 np.asarray(want.scores), np.asarray(want.indices))


@pytest.mark.parametrize("mode", ["int8", "pallas"])
@pytest.mark.parametrize("k", [10, 40, 180])
def test_index_modes_match_reference(int8_roots, mode, k):
    qv = int8_roots["emb"].embed_batch([q for q in QUERIES if q])
    want = int8_roots["ref"].fast.search_batch(qv, k, mode=mode)
    got = int8_roots["port"].fast.search_batch(qv, k, mode=mode)
    assert_equal_up_to_near_ties(got.scores.numpy(), got.indices.numpy(),
                                 np.asarray(want.scores), np.asarray(want.indices))


def _searchers(r, mode, lexical, **cfg):
    docs = r["docs"]
    ref = RefSearcher(
        r["ref"], r["ref_emb"], lexical=RefBulkBm25(docs) if lexical else None,
        config=RefConfig(fast_only=True, scan_mode=mode, **cfg),
    )
    port = TwoTierSearcher(
        r["port"], r["emb"],
        lexical=BulkDeviceBm25Index(th.port_docs(docs), device=CPU) if lexical else None,
        config=TwoTierConfig(fast_only=True, scan_mode=mode, **cfg),
    )
    return ref, port


@pytest.mark.parametrize("mode,k", [("int8", 1), ("int8", 10), ("pallas", 1), ("pallas", 10), ("pallas", 40)])
@pytest.mark.parametrize("lexical", [False, True], ids=["fast_only", "hybrid"])
def test_searcher_lanes_match_reference(int8_roots, mode, k, lexical):
    """The unfused path: the same doc ids and fused scores as the
    reference, for the batch and for each query alone."""
    ref, port = _searchers(int8_roots, mode, lexical)
    for batch in [QUERIES] + [[q] for q in QUERIES if q]:
        got, want = port.search_batch(batch, k=k), ref.search_batch(batch, k=k)
        assert _results(got) == _results(want), batch
        assert not any(o.metrics.phase1_fused for o in got)
    assert port.last_fusion_path is None


# --------------------------------------------------------------------------
# the recall-certificate gate
# --------------------------------------------------------------------------


@pytest.fixture
def gate_roots(tmp_path):
    """One bf16 artifact opened by both packages (the reference's gate
    tests' corpus shape: 256 unit vectors of dim 64)."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((256, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ref_emb, emb = RefHashEmbedder(dim=DIM), HashEmbedder(dim=DIM)
    root = str(tmp_path)
    ids = [f"d{i:03d}" for i in range(256)]
    ref = RefIndex.create(root, vecs, ids, ref_emb.identity(), use_pallas=False)
    return {"root": root, "vecs": vecs, "ref": ref, "port": TwoTierIndex.open(root, device=CPU),
            "ref_emb": ref_emb, "emb": emb}


def _outcome(searcher, error, k):
    try:
        return ("served", _results(searcher.search_batch(["w1 w2", "w3"], k=k)))
    except error as e:
        return ("refused", str(e))


def _gate(g, k, **cfg):
    ref = RefSearcher(g["ref"], g["ref_emb"], config=RefConfig(fast_only=True, **cfg),
                      cache_query_embeddings=False)
    port = TwoTierSearcher(g["port"], g["emb"], config=TwoTierConfig(fast_only=True, **cfg),
                           cache_query_embeddings=False)
    want, got = _outcome(ref, RefUncertified, k), _outcome(port, UncertifiedScanMode, k)
    assert got == want
    return got


@pytest.mark.parametrize(
    "scenario,cfg,k,expect",
    [
        ("uncertified", {"scan_mode": "int8", "require_recall_certificate": True}, 5, "no recall certificate"),
        ("certified", {"scan_mode": "int8", "require_recall_certificate": True, "min_certified_recall": 0.5}, 5, None),
        ("low", {"scan_mode": "int8", "require_recall_certificate": True, "min_certified_recall": 1.01}, 5,
         "below the configured floor"),
        ("k_beyond", {"scan_mode": "int8", "require_recall_certificate": True, "min_certified_recall": 0.5}, 50,
         "exceeds the certified k"),
        ("exact_mode", {"require_recall_certificate": True}, 5, None),
        ("exact_pallas", {"scan_mode": "pallas", "require_recall_certificate": True}, 5, None),
        ("gate_off", {"scan_mode": "int8"}, 5, None),
    ],
)
def test_certificate_gate_matches_reference(gate_roots, scenario, cfg, k, expect):
    g = gate_roots
    if scenario != "uncertified":
        sample = g["vecs"][:32] + 0.01
        want = g["ref"].fast.certify_scan_mode("int8", 10, sample, int8_candidate_multiplier=4)
        got = g["port"].fast.certify_scan_mode("int8", 10, sample, int8_candidate_multiplier=4)
        assert got.to_record() == want.to_record() and got.n_calibration == 32
    kind, detail = _gate(g, k, **cfg)
    if expect is None:
        assert kind == "served" and all(detail)
    else:
        assert kind == "refused" and expect in detail


def test_certificate_persists_and_rebinds_across_packages(gate_roots):
    g = gate_roots
    sample = g["vecs"][:32] + 0.01
    cert = g["port"].certify_fast_scan_mode("int8", 10, sample, int8_candidate_multiplier=4)
    with open(os.path.join(g["root"], MANIFEST_FILE)) as f:
        entry = json.load(f)["extra"]["recall_certificates"]["int8"]
    assert entry["cert"]["k"] == 10
    assert entry["binding"] == g["port"].fast.scan_state_signature()
    assert entry["binding"] == g["ref"].fast.scan_state_signature()
    # a restart of either package rebinds it without re-certifying
    assert TwoTierIndex.open(g["root"], device=CPU).fast.recall_certificate("int8") == cert
    assert RefIndex.open(g["root"], use_pallas=False).fast.recall_certificate("int8").to_record() == cert.to_record()
    g["port"] = TwoTierIndex.open(g["root"], device=CPU)
    g["ref"] = RefIndex.open(g["root"], use_pallas=False)
    kind, _ = _gate(g, 5, scan_mode="int8", require_recall_certificate=True, min_certified_recall=0.5)
    assert kind == "served"
    # and one the reference persisted rebinds in the port
    ref_cert = g["ref"].certify_fast_scan_mode("int8", 20, sample, int8_candidate_multiplier=8)
    assert TwoTierIndex.open(g["root"], device=CPU).fast.recall_certificate("int8").to_record() == ref_cert.to_record()


@pytest.mark.parametrize("change", ["wal_append", "slab_rewrite"])
def test_state_change_voids_the_persisted_certificate(gate_roots, change):
    g = gate_roots
    g["port"].certify_fast_scan_mode("int8", 10, g["vecs"][:32] + 0.01, int8_candidate_multiplier=4)
    if change == "wal_append":
        path = os.path.join(g["root"], FAST_FILE)
        WriteAheadLog(path + ".wal").append(["extra-doc"], g["vecs"][:1] * 0.9)
    else:
        v2 = np.random.default_rng(7).standard_normal((256, DIM)).astype(np.float32)
        TwoTierIndex.create(g["root"], v2, [f"d{i:03d}" for i in range(256)], g["emb"].identity(), device=CPU)
    g["port"] = TwoTierIndex.open(g["root"], device=CPU)
    g["ref"] = RefIndex.open(g["root"], use_pallas=False)
    assert g["port"].fast.recall_certificate("int8") is None
    assert g["ref"].fast.recall_certificate("int8") is None
    kind, detail = _gate(g, 5, scan_mode="int8", require_recall_certificate=True, min_certified_recall=0.5)
    assert kind == "refused" and "no recall certificate" in detail


def test_binding_edges(gate_roots):
    g = gate_roots
    g["port"].certify_fast_scan_mode("int8", 10, g["vecs"][:32] + 0.01)
    clone = g["port"].fast.with_appended(["new-doc"], g["vecs"][:1] * 0.8)
    assert clone.recall_certificate("int8") is None
    assert load_persisted_certificates(g["root"], clone.scan_state_signature()) == {}
    memory = DeviceVectorIndex(g["vecs"][:16], [f"x{i}" for i in range(16)],
                               EmbeddingIdentity(embedder_id="mem", dim=DIM), device=CPU)
    assert memory.scan_state_signature() is None
