"""The port's API embedder, model registry and catalog against the JAX
reference, on the CPU.

The reference's tests are the oracles (tests/test_gated_features.py
``TestApiEmbedder``, tests/test_catalog_registry.py). Each scenario runs in
both packages on the same inputs (seeded with numpy) and compares:

* ``embed/api_embedder``: the vectors (the same transport's rows through
  the same f32 normalize: bitwise), the request and retry counts, the
  backoff sleeps, and the typed failures with their messages; nothing
  reaches a network (the transport is a fake, the default fails closed);
* ``embed/model_registry``: model lists, verification and receipt
  freshness, and the files each package writes (manifests and, with the
  clock fixed, receipts) byte for byte; a receipt written by one package
  is fresh for the other;
* ``runtime/catalog``: replay classifications, dirty sets and counts over
  the same changelog, and a catalog database written by one package read
  by the other.
"""

import json
import os

import numpy as np
import pytest

from frankensearch_tpu.core.errors import EmbeddingFailed as RefEmbeddingFailed
from frankensearch_tpu.embed import api_embedder as rapi
from frankensearch_tpu.embed import model_manifest as rmanifest
from frankensearch_tpu.embed import model_registry as rreg
from frankensearch_tpu.runtime import catalog as rcat
from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.embed import api_embedder as papi
from frankensearch_tpu_torch.embed import model_manifest as pmanifest
from frankensearch_tpu_torch.embed import model_registry as preg
from frankensearch_tpu_torch.runtime import catalog as pcat

PACKAGES = {"ref": (rapi, RefEmbeddingFailed), "port": (papi, EmbeddingFailed)}


# -- embed/api_embedder -------------------------------------------------------------


class _Transport:
    """A seeded fake provider: rows from numpy, and a script of faults by
    call number ("rate" = rate limited, "drop" = a transport failure,
    "short" = one row too few)."""

    def __init__(self, api, dim, seed, faults=None):
        self.api, self.dim, self.faults = api, dim, faults or {}
        self.rng = np.random.default_rng(seed)
        self.calls, self.sizes = 0, []

    def __call__(self, payload):
        self.calls += 1
        fault = self.faults.get(self.calls)
        if fault == "rate":
            raise self.api.RateLimited(retry_after_s=0.01 * self.calls)
        if fault == "drop":
            raise ConnectionError("connection reset by peer")
        n = len(payload["input"]) - (fault == "short")
        self.sizes.append(len(payload["input"]))
        rows = self.rng.standard_normal((n, self.dim)).astype(np.float32)
        return {"embeddings": rows.tolist()}


def _run_api(pkg, texts, *, dim=8, seed=0, faults=None, **cfg):
    api, failed = PACKAGES[pkg]
    transport = _Transport(api, dim, seed, faults)
    slept = []
    emb = api.ApiEmbedder(api.ApiEmbedderConfig(dim=dim, **cfg), transport, clock_sleep=slept.append)
    try:
        out = ("ok", emb.embed_batch(texts).tobytes())
    except failed as e:
        out = ("failed", str(e))
    return out, emb.requests, emb.retries, slept, transport.sizes, (emb.embedder_id, emb.dim, emb.revision)


SCENARIOS = {
    "roundtrip": dict(texts=["a", "b", "c"]),
    "empty": dict(texts=[]),
    "chunks": dict(texts=[f"t{i}" for i in range(11)], batch_limit=4),
    "rate_limited_then_ok": dict(texts=["x", "y"], faults={1: "rate", 2: "rate"}, max_retries=3),
    "transport_drop_then_ok": dict(texts=["x"], faults={1: "drop"}, base_backoff_s=0.5),
    "retries_exhausted": dict(texts=["x"], faults={1: "rate", 2: "drop", 3: "rate"}, max_retries=2),
    "wrong_count": dict(texts=["a", "b"], faults={1: "short"}),
    "chunk_fails_midway": dict(texts=[f"t{i}" for i in range(6)], batch_limit=2, faults={2: "short"}),
    "wide": dict(texts=["a"] * 5, dim=1536, seed=4, provider="gemini", model="text-embedding-004"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_api_embedder_equals_reference(name):
    kw = dict(SCENARIOS[name])
    texts = kw.pop("texts")
    got, want = _run_api("port", texts, **kw), _run_api("ref", texts, **kw)
    assert got == want


def test_api_embedder_default_transport_fails_closed():
    with pytest.raises(EmbeddingFailed, match="no transport configured") as got:
        papi.ApiEmbedder(papi.ApiEmbedderConfig(dim=4)).embed_batch(["x"])
    with pytest.raises(RefEmbeddingFailed) as want:
        rapi.ApiEmbedder(rapi.ApiEmbedderConfig(dim=4)).embed_batch(["x"])
    assert str(got.value) == str(want.value)


def test_api_embedder_provider_dim_mismatch_is_typed():
    emb = papi.ApiEmbedder(papi.ApiEmbedderConfig(dim=4), lambda p: {"embeddings": [[1.0, 0.0]]})
    with pytest.raises(EmbeddingFailed, match="provider dim 2 != configured 4"):
        emb.embed_batch(["x"])


def test_api_embedder_rows_are_unit():
    out = papi.ApiEmbedder(papi.ApiEmbedderConfig(dim=4),
                           lambda p: {"embeddings": [[1.0, 2.0, 2.0, 0.0]] * len(p["input"])}).embed_batch(["a", "b"])
    assert out.dtype == np.float32 and out.shape == (2, 4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)


# -- embed/model_registry ------------------------------------------------------------


def _stage(root, manifest_mod, name, payload):
    d = root / "models" / name
    d.mkdir(parents=True)
    (d / "model.safetensors").write_bytes(payload)
    (d / "tokenizer.json").write_text(json.dumps({"name": name}))
    manifest_mod.write_model_manifest(str(d), manifest_mod.build_model_manifest(str(d), name, "r1", 64, "model2vec"))
    return d


def _models(root, manifest_mod, seed=0):
    rng = np.random.default_rng(seed)
    for name in ("potion-base", "minilm-quality", "b-model"):
        _stage(root, manifest_mod, name, rng.bytes(int(rng.integers(64, 4096))))
    (root / "models" / "stray.txt").write_text("not a model")
    (root / "models" / "no-manifest").mkdir()


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_equals_reference_byte_for_byte(tmp_path, monkeypatch, seed):
    monkeypatch.setattr(rreg.time, "time", lambda: 1_790_000_000.25)
    monkeypatch.setattr(preg.time, "time", lambda: 1_790_000_000.25)
    trees = {}
    for pkg, manifest_mod, reg_mod in (("ref", rmanifest, rreg), ("port", pmanifest, preg)):
        root = tmp_path / pkg
        _models(root, manifest_mod, seed)
        reg = reg_mod.ModelRegistry(str(root / "models"))
        first = [(m.name, m.verified, m.receipt_fresh) for m in reg.verified_models()]
        second = [(m.name, m.verified, m.receipt_fresh) for m in reg.verified_models()]
        (root / "models" / "b-model" / "model.safetensors").write_bytes(b"tampered")
        forced = reg.verify("b-model", force=True)
        trees[pkg] = (reg.list_models(), first, second, (forced.verified, forced.receipt_fresh), _files(root))
    assert trees["port"] == trees["ref"]
    models, first, second, forced, _ = trees["port"]
    assert models == ["b-model", "minilm-quality", "no-manifest", "potion-base"]
    assert [f[1:] for f in first] == [(True, False), (True, False), (False, False), (True, False)]
    assert [s[1:] for s in second] == [(True, True), (True, True), (False, False), (True, True)]
    assert forced == (False, False)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_receipt_written_by_one_package_is_fresh_for_the_other(tmp_path, writer, reader):
    mods = {"ref": (rmanifest, rreg), "port": (pmanifest, preg)}
    _stage(tmp_path, mods[writer][0], "potion-x", b"weights")
    assert mods[writer][1].ModelRegistry(str(tmp_path / "models")).verify("potion-x").verified
    got = mods[reader][1].ModelRegistry(str(tmp_path / "models")).verify("potion-x")
    assert got.verified and got.receipt_fresh and got.manifest.model_id == "potion-x"


def test_registry_of_a_missing_root_is_empty(tmp_path):
    assert preg.ModelRegistry(str(tmp_path / "nowhere")).list_models() == []
    assert preg.ModelRegistry(str(tmp_path / "nowhere")).verified_models() == []


def test_unreadable_receipt_is_stale(tmp_path):
    _stage(tmp_path, pmanifest, "m1", b"w")
    reg = preg.ModelRegistry(str(tmp_path / "models"))
    reg.verify("m1")
    (tmp_path / "models" / "m1" / preg.RECEIPT_FILE).write_text("{not json")
    got = reg.verify("m1")
    assert got.verified and not got.receipt_fresh


# -- runtime/catalog ----------------------------------------------------------------


def _catalog_script(seed, n_ops=300):
    rng = np.random.default_rng(seed)
    paths = [f"/corpus/doc{i}.md" for i in range(25)]
    ops = []
    for _ in range(n_ops):
        path = paths[int(rng.integers(len(paths)))]
        kind = rng.choice(["dirty", "dirty", "tomb", "indexed", "remove", "replay"])
        mtime, size = float(rng.integers(1, 4)), int(rng.integers(1, 3))
        ops.append((str(kind), path, mtime, size))
    return ops


def _stat_fn(seed):
    rng = np.random.default_rng(seed + 1000)
    table = {f"/corpus/doc{i}.md": (float(rng.integers(1, 4)), int(rng.integers(1, 3))) for i in range(20)}
    return table.get  # doc20..doc24 have vanished


def _run_catalog(mod, ops, stat_fn, db):
    cat = mod.IndexCatalog(db)
    trace = []
    for kind, path, mtime, size in ops:
        if kind == "dirty":
            trace.append(cat.log_dirty(path, mtime, size))
        elif kind == "tomb":
            trace.append(cat.log_tombstone(path))
        elif kind == "indexed":
            cat.mark_indexed(path, mtime, size)
        elif kind == "remove":
            cat.remove(path)
        else:
            trace.append([(i.path, i.decision.value, i.seq) for i in cat.replay(stat_fn)])
    trace.append([(i.path, i.decision.value, i.seq) for i in cat.replay(stat_fn)])
    trace.append((cat.dirty_set(stat_fn), cat.known_count()))
    return cat, trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_catalog_equals_reference(seed):
    ops, stat_fn = _catalog_script(seed), _stat_fn(seed)
    _, got = _run_catalog(pcat, ops, stat_fn, ":memory:")
    _, want = _run_catalog(rcat, ops, stat_fn, ":memory:")
    assert got == want
    decisions = {d for step in got[:-1] if isinstance(step, list) for _, d, _ in step}
    assert decisions == {d.value for d in pcat.ReplayDecision}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_catalog_database_read_by_the_other_package(tmp_path, writer, reader):
    mods = {"ref": rcat, "port": pcat}
    ops, stat_fn = _catalog_script(5), _stat_fn(5)
    db = str(tmp_path / "catalog.db")
    _, trace = _run_catalog(mods[writer], ops, stat_fn, db)
    other = mods[reader].IndexCatalog(db)
    assert [(i.path, i.decision.value, i.seq) for i in other.replay(stat_fn)] == trace[-2]
    assert (other.dirty_set(stat_fn), other.known_count()) == trace[-1]


def test_catalog_replays_against_the_filesystem(tmp_path):
    """tests/test_catalog_registry.py::TestCatalog on the port (os.stat)."""
    f = tmp_path / "a.txt"
    f.write_text("hello")
    st = os.stat(f)
    db = str(tmp_path / "catalog.db")
    cat = pcat.IndexCatalog(db)
    cat.log_dirty(str(f), st.st_mtime, st.st_size)
    assert cat.replay()[0].decision is pcat.ReplayDecision.REINDEX
    assert pcat.IndexCatalog(db).dirty_set() == [str(f)]  # a crash before mark_indexed
    cat.mark_indexed(str(f), st.st_mtime, st.st_size)
    assert cat.replay() == []
    cat.log_dirty(str(f), st.st_mtime, st.st_size)
    assert cat.replay()[0].decision is pcat.ReplayDecision.CLEAN
    cat.log_dirty(str(tmp_path / "gone.txt"), 1.0, 10)
    assert cat.replay()[-1].decision is pcat.ReplayDecision.VANISHED
