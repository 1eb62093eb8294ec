"""The port's entry point (``builder.IndexBuilder`` / ``open_hybrid``) and the
modules ``open_hybrid`` builds from the config (``fusion/hubness``,
``fusion/graph_rank``, ``core/graph``) against the JAX reference on the CPU.

Oracles: tests/test_facade_e2e.py, tests/test_storage.py's builder facade,
tests/test_fts5_backend.py, tests/test_durability_repair.py's sealed roots
and tests/test_fusion_extras.py (hubness, smoothing, graph rank). The same
documents go through both packages' ``IndexBuilder``: the FTVI tiers, the
packed FLXB arm and the JSON oracle snapshot are byte-equal, the SQLite
store equal by rows, and each package's ``open_hybrid`` serves the other's
root with the same doc ids. The port's divergences are pinned here: it runs
on the device it is given (``"cuda"`` by default, so without a card the
default raises), a failure of the Model2Vec bag lane or of the packed arm's
build raises where the reference warns and falls back, and
``mesh_shards > 0`` raises ``NotImplementedError``.
"""

import os
import sqlite3

import numpy as np
import pytest
import torch

import frankensearch_tpu as fs
import frankensearch_tpu.core.graph as j_graph
import frankensearch_tpu.embed.bulk as j_bulk
import frankensearch_tpu.embed.model2vec as j_m2v
import frankensearch_tpu.fusion.graph_rank as j_grank
import frankensearch_tpu.fusion.hubness as j_hub
import frankensearch_tpu.native as j_native
import frankensearch_tpu_torch as fst
import frankensearch_tpu_torch.core.graph as t_graph
import frankensearch_tpu_torch.embed.bulk as t_bulk
import frankensearch_tpu_torch.embed.model2vec as t_m2v
import frankensearch_tpu_torch.fusion.graph_rank as t_grank
import frankensearch_tpu_torch.fusion.hubness as t_hub
import frankensearch_tpu_torch.native as t_native
from frankensearch_tpu.core.types import ScoredResult as RefScored
from frankensearch_tpu.core.types import VectorHit as RefHit
from frankensearch_tpu_torch.core.types import ScoredResult, VectorHit
from frankensearch_tpu_torch.lexical import delta as t_delta
from frankensearch_tpu_torch.lexical import device_bm25 as t_dbm
from tests.test_torch_persist import CPU, PORT, REF, read

for _pkg, _api in ((REF, fs), (PORT, fst)):
    _pkg.api = _api
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
CPU_KW = {"device": "cpu"}


def kw(pkg):
    return CPU_KW if pkg is PORT else {}


def make_book(pkg):
    """tests/test_facade_e2e.py's book: five themed chapters."""
    themes = {
        "ch01-voyage": "ship voyage harbor sailors compass storm rigging deck",
        "ch02-island": "island lagoon palm sand treasure map buried chest",
        "ch03-mutiny": "mutiny captain crew pistol quarrel loyalty brig",
        "ch04-cave": "cave torch shadows echo bats underground passage",
        "ch05-rescue": "rescue signal fire longboat tide homeward journey",
    }
    rng = np.random.default_rng(99)
    return [pkg.Doc(doc_id=d, content=" ".join(rng.choice(v.split(), size=400)), title=d)
            for d, v in themes.items()]


def corpus(pkg, n=300, seed=5):
    """Zipf words (some docs titled, some with links and a duplicate id)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:04d}" for i in range(400)]
    p = 1.0 / np.arange(1, 401) ** 1.1
    p /= p.sum()
    docs = [pkg.Doc(doc_id=f"doc-{i:05d}", content=" ".join(rng.choice(vocab, size=int(rng.integers(4, 30)), p=p)),
                    title=f"title w{i % 40:04d}" if i % 7 == 0 else None,
                    metadata={"links": [f"doc-{(i + 1) % n:05d}"]} if i % 5 == 0 else None)
            for i in range(n)]
    docs.append(pkg.Doc(doc_id="doc-00003", content="w0001 w0002 replaced version"))
    docs.append(pkg.Doc(doc_id="noise", content="!!! ###"))
    return docs


def build(pkg, root, docs, *, dim=32, stack=None, config=None):
    b = pkg.api.IndexBuilder(root, **kw(pkg)).with_documents(docs).with_embedder_stack(
        stack or pkg.api.EmbedderStack(fast=pkg.api.HashEmbedder(dim=dim)))
    if config is not None:
        b = b.with_config(config)
    return b.build()


def open_root(pkg, root, *, dim=32, **extra):
    return pkg.api.open_hybrid(root, fast_embedder=pkg.api.HashEmbedder(dim=dim), **kw(pkg), **extra)


def lexical_dir(root):
    with open(os.path.join(root, "lexical", "CURRENT")) as f:
        return os.path.join(root, "lexical", f.read().strip())


def db_rows(path):
    conn = sqlite3.connect(path)
    try:
        docs = conn.execute("SELECT doc_id, content_hash, preview, title, metadata_json, deleted "
                            "FROM documents ORDER BY doc_id").fetchall()
        status = conn.execute("SELECT doc_id, embedder_id, content_hash FROM embedding_status "
                              "ORDER BY doc_id").fetchall()
        builds = conn.execute("SELECT doc_count, error_count, detail_json FROM index_builds").fetchall()
    finally:
        conn.close()
    return docs, status, builds


def rows(outcomes):
    return [[(r.doc_id, r.score) for r in o.results] for o in outcomes]


QUERIES = ["w0001 w0002", "w0010", "title w0007", "w0100 w0200 w0300", "replaced version", "nothing"]


# -- IndexBuilder: artifacts equal the reference's ------------------------------------


@pytest.fixture(scope="module")
def built_pair(tmp_path_factory):
    roots, stats = {}, {}
    for pkg in (REF, PORT):
        roots[pkg.name] = str(tmp_path_factory.mktemp(f"built_{pkg.name}"))
        stats[pkg.name] = build(pkg, roots[pkg.name], corpus(pkg))
    return roots, stats


def test_build_stats_equal_reference(built_pair):
    _, stats = built_pair
    got, want = stats["port"], stats["ref"]
    for field in ("doc_count", "error_count", "skipped_low_signal", "superseded_duplicates", "warnings",
                  "per_doc_errors", "semantic"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.doc_count, got.skipped_low_signal, got.superseded_duplicates) == (300, 1, 1)
    assert vars(got.sizes) == vars(want.sizes) and got.sizes.total_bytes > 0


@pytest.mark.parametrize("artifact", ["vector.fast.idx", "index.flexb", "index.flex.json"])
def test_artifacts_byte_equal_reference(built_pair, artifact):
    roots, _ = built_pair
    if artifact == "vector.fast.idx":
        got, want = (os.path.join(roots[n], artifact) for n in ("port", "ref"))
    else:
        got, want = (os.path.join(lexical_dir(roots[n]), artifact) for n in ("port", "ref"))
    assert read(got) == read(want)
    assert os.path.exists(got + ".fsum") and os.path.exists(got + ".fspar") or artifact == "index.flex.json"


def test_storage_rows_and_manifest_equal_reference(built_pair):
    roots, _ = built_pair
    got, want = (db_rows(os.path.join(roots[n], "metadata.db")) for n in ("port", "ref"))
    assert got == want and len(got[0]) == 300
    manifests = {}
    for n in ("port", "ref"):
        import json

        with open(os.path.join(roots[n], "MANIFEST.json")) as f:
            manifests[n] = json.load(f)
    assert manifests["port"]["extra"]["conformance"] == manifests["ref"]["extra"]["conformance"]
    assert manifests["port"]["doc_count"] == manifests["ref"]["doc_count"] == 300


def test_each_package_serves_the_others_root(built_pair):
    """The port opens the reference's root (and the reference the port's)
    and serves the same doc ids as the reference over its own root."""
    roots, _ = built_pair
    cfg = {"config": fst.TwoTierConfig(fast_only=True)}
    ref_cfg = {"config": fs.TwoTierConfig(fast_only=True)}
    want = fs.open_hybrid(roots["ref"], fast_embedder=fs.HashEmbedder(dim=32), **ref_cfg)
    want_rows = rows(want.searcher.search_batch(QUERIES, k=10))
    for pkg, root, extra in ((PORT, roots["ref"], cfg), (PORT, roots["port"], cfg), (REF, roots["port"], ref_cfg)):
        h = open_root(pkg, root, **extra)
        got = rows(h.searcher.search_batch(QUERIES, k=10))
        assert [[d for d, _ in r] for r in got] == [[d for d, _ in r] for r in want_rows]
        if pkg is PORT:
            assert isinstance(h.searcher.lexical, t_delta.DeltaLexicalIndex)
            assert isinstance(h.delta.sealed, t_dbm.BulkDeviceBm25Index) and h.delta.sealed.device == CPU
            assert h.searcher.last_fusion_path == "device"
            lex_got = [[(c.doc_id, c.score) for c in r] for r in h.delta.sealed.search_candidates_batch(QUERIES, 10)]
            lex_want = [[(c.doc_id, c.score) for c in r]
                        for r in want.delta.sealed.search_candidates_batch(QUERIES, 10)]
            assert lex_got == lex_want
        h.close()
    want.close()


def test_model2vec_build_embeds_through_the_bag_lane(tmp_path):
    """A Model2Vec fast tier: both packages embed the corpus through the
    native bag lane, and the bf16 slabs (f32 sums in another order,
    rounded to bf16) hold the same rows up to one bf16 step."""
    docs = corpus(REF, n=120)
    words = sorted({w for d in docs for w in d.content.split()})
    ref_m2v = j_m2v.random_model2vec(words, dim=64, seed=3)
    port_m2v = t_m2v.random_model2vec(words, dim=64, seed=3, device=CPU)
    build(REF, str(tmp_path / "ref"), docs, stack=fs.EmbedderStack(fast=ref_m2v))
    stats = build(PORT, str(tmp_path / "port"), corpus(PORT, n=120), stack=fst.EmbedderStack(fast=port_m2v))
    assert stats.doc_count == 120 and not stats.warnings and stats.semantic
    ref = fs.TwoTierIndex.open(str(tmp_path / "port")).fast.vectors_f32()
    port = fst.TwoTierIndex.open(str(tmp_path / "ref"), device=CPU).fast.vectors_f32()
    np.testing.assert_allclose(port, ref, rtol=0, atol=2 ** -8)
    assert read(os.path.join(lexical_dir(str(tmp_path / "port")), "index.flexb")) == \
        read(os.path.join(lexical_dir(str(tmp_path / "ref")), "index.flexb"))


# -- the divergences: the device, and no fallback that hides it ---------------------------


def test_default_device_is_the_card(tmp_path):
    """``IndexBuilder`` and ``open_hybrid`` default to ``"cuda"``: without a
    usable card the default raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda-marked test covers the default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fst.IndexBuilder(str(tmp_path))
    root = str(tmp_path / "ix")
    build(PORT, root, make_book(PORT))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fst.open_hybrid(root, fast_embedder=fst.HashEmbedder(dim=32))


@pytest.mark.cuda
def test_default_device_lands_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    root = str(tmp_path / "ix")
    fst.IndexBuilder(root).with_documents(make_book(PORT)).with_embedder_stack(
        fst.EmbedderStack(fast=fst.HashEmbedder(dim=32))).build()
    h = fst.open_hybrid(root, fast_embedder=fst.HashEmbedder(dim=32))
    assert h.index.fast.slab.device.type == "cuda" and h.delta.sealed.device.type == "cuda"
    assert h.searcher.search_batch(["buried treasure map"], k=3)[0].results[0].doc_id == "ch02-island"


def test_bag_lane_failure_raises(tmp_path, monkeypatch):
    """The reference catches any bulk-embed failure and falls back to the
    per-batch loop; the port lets a failure of the device bag lane raise."""
    docs = make_book(PORT)
    words = sorted({w for d in docs for w in d.content.split()})

    def broken(*a, **k):
        raise RuntimeError("device fault (injected)")

    monkeypatch.setattr(t_bulk, "bag_embed_corpus", broken)
    stack = fst.EmbedderStack(fast=t_m2v.random_model2vec(words, dim=32, seed=0, device=CPU))
    with pytest.raises(RuntimeError, match="device fault"):
        build(PORT, str(tmp_path / "port"), docs, stack=stack)
    monkeypatch.setattr(j_bulk, "bag_embed_corpus", broken)
    stats = build(REF, str(tmp_path / "ref"), make_book(REF),
                  stack=fs.EmbedderStack(fast=j_m2v.random_model2vec(words, dim=32, seed=0)))
    assert stats.doc_count == 5 and any("bulk embed lane failed" in w for w in stats.warnings)


class _FlakyEmbedder:
    """A hash embedder whose ``embed_batch`` fails on any batch holding a
    text with "poison"."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def embed_batch(self, texts):
        if any("poison" in t for t in texts):
            raise ValueError("embedder fault")
        return self.inner.embed_batch(texts)


def test_embed_batch_failures_become_per_doc_errors(tmp_path):
    """An embedder's own ``embed_batch`` failure is isolated per batch and
    recorded per doc, in both packages alike."""
    out = {}
    for pkg in (REF, PORT):
        docs = corpus(pkg, n=150)
        docs[70] = pkg.Doc(doc_id=docs[70].doc_id, content="poison pill text here")
        stack = pkg.api.EmbedderStack(fast=_FlakyEmbedder(pkg.api.HashEmbedder(dim=32)))
        stats = pkg.api.IndexBuilder(str(tmp_path / pkg.name), **kw(pkg)).with_documents(docs) \
            .with_embedder_stack(stack).with_batch_size(32).build()
        out[pkg.name] = (stats.doc_count, stats.error_count, stats.per_doc_errors, stats.warnings[1:])
    assert out["port"] == out["ref"]
    assert out["port"][1] == 32 and out["port"][2]["doc-00070"] == "fast: ValueError"


def test_packed_arm_skipped_only_where_native_postings_do_not_apply(tmp_path, monkeypatch):
    """No native postings: both packages warn, write no FLXB and serve the
    oracle arm. Any other failure of the packed build raises in the port
    (the reference warns for every exception)."""
    monkeypatch.setattr(t_native, "build_postings_native", lambda texts: None)
    monkeypatch.setattr(j_native, "build_postings_native", lambda texts: None)
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name)
        stats = build(pkg, root, make_book(pkg))
        assert any(w.startswith("packed lexical arm skipped") for w in stats.warnings)
        assert not os.path.exists(os.path.join(lexical_dir(root), "index.flexb"))
        h = open_root(pkg, root)
        assert h.delta.sealed is None
        assert h.searcher.search("buried treasure map", k=3).results[0].doc_id == "ch02-island"
        h.close()
    monkeypatch.undo()

    def broken(self, docs, **k):
        raise ValueError("layout fault (injected)")

    monkeypatch.setattr(t_dbm.BulkDeviceBm25Index, "__init__", broken)
    with pytest.raises(ValueError, match="layout fault"):
        build(PORT, str(tmp_path / "port2"), make_book(PORT))


@pytest.mark.parametrize("entry", ["build", "open"])
def test_mesh_shards_raise_not_implemented(tmp_path, entry):
    cfg = fst.TwoTierConfig(mesh_shards=2)
    root = str(tmp_path / "ix")
    if entry == "build":
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            build(PORT, root, make_book(PORT), config=cfg)
        assert not os.path.exists(root)
    else:
        build(PORT, root, make_book(PORT))
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            open_root(PORT, root, config=cfg)


# -- open_hybrid: the facade's flows (tests/test_facade_e2e.py) -----------------------------


@PKGS
def test_book_roundtrip(pkg, tmp_path):
    root = str(tmp_path / "book")
    assert build(pkg, root, make_book(pkg), dim=128).doc_count == 5
    h = open_root(pkg, root, dim=128)
    for query, expected in {"buried treasure map": "ch02-island", "mutiny on the ship captain": "ch03-mutiny",
                            "torch in the underground cave": "ch04-cave"}.items():
        assert h.searcher.search(query, k=3).results[0].doc_id == expected
    h.close()


@PKGS
def test_duplicate_ids_and_appended_duplicates_are_upserts(pkg, tmp_path):
    root = str(tmp_path / "ix")
    stats = build(pkg, root, [pkg.Doc(doc_id="a", content="alpha bravo obsolete"),
                              pkg.Doc(doc_id="b", content="charlie delta"),
                              pkg.Doc(doc_id="a", content="alpha updated fresh")])
    assert (stats.doc_count, stats.superseded_duplicates) == (2, 1)
    with open_root(pkg, root) as h:
        assert "a" not in [r.doc_id for r in h.searcher.search("obsolete", k=5).results if r.lexical_score]
        docs = [pkg.Doc(doc_id="a", content="alpha again newer"), pkg.Doc(doc_id="c", content="echo foxtrot old"),
                pkg.Doc(doc_id="c", content="echo foxtrot new")]
        h.index.append_fast([d.doc_id for d in docs], h.searcher.fast_embedder.embed_batch([d.content for d in docs]))
        for d in docs:
            h.delta.add_document(d)
        h.delta.commit()
        h.delta.seal()
        assert h.index.doc_count() == 3
        for q, doc_id, want in [("fresh", "a", False), ("newer", "a", True), ("old", "c", False), ("new", "c", True)]:
            res = h.searcher.search(q, k=6).results
            assert any(r.doc_id == doc_id and r.lexical_score is not None for r in res) == want, q
            assert len({r.doc_id for r in res}) == len(res)


@PKGS
def test_negation_excludes_through_storage_text(pkg, tmp_path):
    root = str(tmp_path / "ix")
    build(pkg, root, [pkg.Doc(doc_id="a", content="alpha updated fresh"),
                      pkg.Doc(doc_id="b", content="alpha charlie delta")])
    with open_root(pkg, root) as h:
        assert [r.doc_id for r in h.searcher.search("alpha -fresh", k=5).results] == ["b"]
        outs = h.searcher.search_batch(["alpha -fresh", "alpha"], k=5)
        assert [r.doc_id for r in outs[0].results] == ["b"] and {r.doc_id for r in outs[1].results} == {"a", "b"}


@PKGS
def test_delete_reaches_every_arm_and_survives_a_reopen(pkg, tmp_path):
    root = str(tmp_path / "ix")
    docs = [pkg.Doc(doc_id=f"d{i}", content=f"alpha beta doc {i}") for i in range(10)]
    build(pkg, root, docs + [pkg.Doc(doc_id="target", content="zeppelin unique document")])
    h = open_root(pkg, root)
    assert h.searcher.search("zeppelin unique", k=3).results[0].doc_id == "target"
    h.delete(["target"])
    assert "target" not in [r.doc_id for r in h.searcher.search("zeppelin unique", k=3).results]
    assert h.storage.get_document("target").deleted
    assert "target" not in [r.doc_id for r in h.searcher.search_batch(["zeppelin unique"], k=3)[0].results]
    h.close()
    h2 = open_root(pkg, root)
    assert "target" not in [r.doc_id for r in h2.searcher.search("zeppelin unique", k=3).results]
    h2.index.delete(["d1"])  # the vector arm only: the searcher supersedes the lexical hit
    assert "d1" not in [r.doc_id for r in h2.searcher.search("alpha beta doc 1", k=5).results]
    h2.close()
    with pytest.raises(RuntimeError):
        h2.searcher._pool.submit(lambda: None)


@PKGS
def test_sealed_generations_are_protected_and_pruned(pkg, tmp_path):
    root = str(tmp_path / "idx")
    build(pkg, root, [pkg.Doc(doc_id=f"doc-{i:04d}", content=f"alpha beta topic {i}") for i in range(8)])
    for i in range(4):
        with open_root(pkg, root) as h:
            if i == 3:  # three incremental seals: a stack at MAX_SEGMENTS, each segment protected
                assert isinstance(h.delta.sealed, pkg.seg.SegmentedBm25) and len(h.delta.sealed.segments) == 4
                assert pkg.dur.ParityProtector.is_protected(os.path.join(lexical_dir(root), "seg-003.flexb"))
            doc = pkg.Doc(doc_id=f"extra-{i}", content=f"seal round {i}")
            h.index.append_fast([doc.doc_id], h.searcher.fast_embedder.embed_batch([doc.content]))
            h.delta.add_document(doc)
            h.delta.commit()
            h.delta.seal()
    gens = pkg.persist.list_generations(root)
    assert len(gens) == 2 and lexical_dir(root).endswith(gens[-1])
    # the fourth seal found the stack full and compacted it into one segment
    assert pkg.dur.ParityProtector.is_protected(os.path.join(lexical_dir(root), "index.flexb"))
    with open_root(pkg, root) as h:
        assert not isinstance(h.delta.sealed, pkg.seg.SegmentedBm25) and h.delta.sealed.n_docs == 12
        res = h.searcher.search("seal round", k=8).results
        assert any(r.doc_id == "extra-3" and r.lexical_score is not None for r in res)


# -- open_hybrid: the lexical backends -------------------------------------------------------


FTS_DOCS = [("a", "alpha beta write ahead log"), ("b", "delta epsilon log ahead write"),
            ("c", "gamma zeta unrelated text")]


@PKGS
def test_fts5_backend_builds_one_artifact_and_serves_as_its_own_delta(pkg, tmp_path):
    root = str(tmp_path / "ix")
    cfg = pkg.api.TwoTierConfig(lexical_backend="fts5")
    build(pkg, root, [pkg.Doc(doc_id=i, content=t) for i, t in FTS_DOCS], config=cfg)
    lex = os.listdir(os.path.join(root, "lexical"))
    assert "fts5.db" in lex and not any(f.endswith(".flexb") or f.startswith("gen-") for f in lex)
    h = open_root(pkg, root)  # auto: the FTS5 engine
    assert h.delta is h.searcher.lexical and type(h.delta).__name__ == "Fts5LexicalIndex"
    ids = [r.doc_id for r in h.searcher.search('"write ahead log"', k=3).results]
    assert "a" in ids and "b" not in ids
    new = pkg.Doc(doc_id="d", content="omega fresh appended")
    h.index.append_fast(["d"], h.searcher.fast_embedder.embed_batch([new.content]))
    h.delta.add_document(new)
    h.delta.commit()
    assert h.delta.seal() is None
    top = h.searcher.search("omega fresh", k=2).results[0]
    assert top.doc_id == "d" and top.lexical_score is not None
    h.delete(["a"])
    assert all(r.doc_id != "a" for r in h.searcher.search("alpha beta", k=3).results)
    h2 = open_root(pkg, root, config=cfg)
    assert [c.doc_id for c in h2.searcher.lexical.search_candidates("omega", 5)] == ["d"]
    with pytest.raises(pkg.errors.IndexNotFound):
        other = str(tmp_path / "plain")
        build(pkg, other, [pkg.Doc(doc_id="x", content="plain doc")])
        open_root(pkg, other, config=cfg)


@PKGS
def test_corrupt_oracle_snapshot_degrades_to_the_packed_arm(pkg, tmp_path):
    root = str(tmp_path / "ix")
    build(pkg, root, make_book(pkg))
    with open(os.path.join(lexical_dir(root), "index.flex.json"), "w") as f:
        f.write("{not json")
    h = open_root(pkg, root)
    assert h.lexical is None and h.delta is None
    assert type(h.searcher.lexical).__name__ == "BulkDeviceBm25Index"
    assert h.searcher.search("buried treasure map", k=3).results[0].doc_id == "ch02-island"


@PKGS
def test_truncated_oracle_snapshot_takes_the_ladder_at_open(pkg, tmp_path):
    """A snapshot cut short (a full disk, a copy stopped midway) is found
    at open, as in the reference, and the open degrades to the packed
    arm."""
    root = str(tmp_path / "ix")
    build(pkg, root, make_book(pkg))
    path = os.path.join(lexical_dir(root), "index.flex.json")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: len(data) * 2 // 3])
    h = open_root(pkg, root)
    assert h.lexical is None and h.delta is None
    assert type(h.searcher.lexical).__name__ == "BulkDeviceBm25Index"
    assert h.searcher.search("buried treasure map", k=3).results[0].doc_id == "ch02-island"


# -- open_hybrid: the quality kernels from the config -------------------------------------------


def linked_book(pkg):
    docs = make_book(pkg)
    return [pkg.Doc(doc_id=d.doc_id, content=d.content, title=d.title,
                    metadata={"links": [docs[(i + 1) % len(docs)].doc_id]}) for i, d in enumerate(docs)]


def test_config_builds_the_quality_kernels_like_the_reference(tmp_path):
    out = {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name)
        build(pkg, root, linked_book(pkg), dim=128)
        cfg = pkg.api.TwoTierConfig(prf_enabled=True, mmr_lambda=0.6, hubness_beta=0.2, graph_rank=True,
                                    neighbor_smoothing=True, smoothing_alpha=0.2, smoothing_neighbors=2)
        h = open_root(pkg, root, dim=128, config=cfg)
        s = h.searcher
        assert s.prf is not None and s.mmr.lambda_relevance == 0.6 and s.hubness.beta == 0.2
        assert s.graph_ranker.graph.edge_count() == 5 and s.smoother.alpha == 0.2
        out[pkg.name] = (s.hubness.scores_by_row, s.smoother.neighbors_by_row,
                         [r.doc_id for r in s.search("buried treasure map", k=3).results])
        plain = open_root(pkg, root, dim=128)
        assert plain.searcher.prf is None and plain.searcher.hubness is None and plain.searcher.graph_ranker is None
        capped = pkg.api.TwoTierConfig(hubness_beta=0.2, hubness_max_docs=2)
        with pytest.warns(UserWarning, match="hubness"):
            assert open_root(pkg, root, dim=128, config=capped).searcher.hubness is None
    assert out["port"] == out["ref"]


def test_hubness_and_smoothing_equal_reference():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((50, 16)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    hub = base.mean(axis=0)
    vecs = np.vstack([base, hub / np.linalg.norm(hub)])
    scores = t_hub.build_hubness_scores(vecs, k=5)
    assert scores == j_hub.build_hubness_scores(vecs, k=5) and 50 in scores
    out = t_hub.HubnessCorrector(beta=0.5, scores_by_row=scores).apply([VectorHit("hub", 0.9, 50), VectorHit("x", 0.89, 0)])
    want = j_hub.HubnessCorrector(beta=0.5, scores_by_row=scores).apply([RefHit("hub", 0.9, 50), RefHit("x", 0.89, 0)])
    assert [(h.doc_id, h.score) for h in out] == [(h.doc_id, h.score) for h in want] and out[0].doc_id == "x"
    nbrs = t_hub.build_neighbor_lists(vecs[:20], k=3)
    assert nbrs == j_hub.build_neighbor_lists(vecs[:20], k=3)
    hits = [(f"d{i}", float(20 - i) / 20, i) for i in range(10)]
    got = t_hub.ScoreSmoother(alpha=0.5, neighbors_by_row=nbrs).apply([VectorHit(*h) for h in hits])
    want = j_hub.ScoreSmoother(alpha=0.5, neighbors_by_row=nbrs).apply([RefHit(*h) for h in hits])
    assert [(h.doc_id, h.score) for h in got] == [(h.doc_id, h.score) for h in want]
    assert t_hub.HubnessCorrector(beta=0.0).apply(hits[:1]) == hits[:1]


def test_graph_rank_equals_reference():
    out = {}
    for graph_mod, rank_mod, Scored in ((t_graph, t_grank, ScoredResult), (j_graph, j_grank, RefScored)):
        g = graph_mod.DocumentGraph()
        g.add_edge("seed", "linked", 1.0)
        g.add_edge("linked", "deep", 1.0)
        g.add_edge("seed", "other", 0.5, graph_mod.EdgeType.SIMILAR)
        g.add_node("island")
        ranked = rank_mod.GraphRanker(g).rank([Scored(doc_id="seed", score=1.0), Scored(doc_id="x", score=0.5)])
        out[graph_mod] = ([(r.doc_id, r.score, r.graph_score) for r in ranked], g.node_count(), g.edge_count())
    got, want = out[t_graph], out[j_graph]
    assert got == want
    by = {d: s for d, s, _ in got[0]}
    assert by["seed"] > by["linked"] > by["deep"] and "island" not in by


def test_delete_of_an_appended_doc_survives_a_reopen(tmp_path):
    """A doc appended through the WAL, sealed into the lexical stack and
    then deleted holds no fast-tier row once the WAL replays, so the
    reference's supersession (tombstoned rows only) lets the sealed lexical
    generation serve it again after a reopen. The port counts the WAL's
    rowless tombstones too (``TwoTierIndex.tombstoned_ids``)."""
    served = {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name)
        build(pkg, root, [pkg.Doc(doc_id=f"d{i}", content=f"alpha beta doc {i}") for i in range(10)])
        with open_root(pkg, root) as h:
            new = pkg.Doc(doc_id="fresh", content="zeppelin unique arrival")
            h.index.append_fast(["fresh"], h.searcher.fast_embedder.embed_batch([new.content]))
            h.delta.add_document(new)
            h.delta.commit()
            h.delta.seal()
            h.delete(["fresh"])
            assert "fresh" not in [r.doc_id for r in h.searcher.search("zeppelin unique", k=3).results]
        with open_root(pkg, root) as h:
            served[pkg.name] = [r.doc_id for r in h.searcher.search_batch(["zeppelin unique"], k=3)[0].results]
            if pkg is PORT:
                assert h.index.tombstoned_ids() == {"fresh"} and not h.index.fast.tombstoned_ids()
    assert "fresh" in served["ref"] and "fresh" not in served["port"]
