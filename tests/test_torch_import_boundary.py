"""The port runs where neither jax nor the JAX package is importable.

A subprocess makes ``import jax`` and ``import frankensearch_tpu`` fail
(``sys.modules[...] = None``), imports ``frankensearch_tpu_torch``, builds
every object from the port's own types and serves a tiny hybrid
``search_batch`` on the CPU: over the dense lexical lane, over the blocked
(split, flat, DAAT) layout, through the ``int8`` (certified) and
``pallas`` scan modes, and with a Model2Vec fast tier (the fully fused
lane), then runs the A/B scan lane, and a phrase query through the
Refined and Reranked phases (a BERT quality tier and a cross-encoder), then
builds a root with ``IndexBuilder``, serves it through ``open_hybrid`` and
seals a write, then runs the CLI's ``index`` and ``search``, and ``watch``
of a corpus directory followed by the ``tui`` over the watched root, then
``repro``, ``footprint``, ``fleet`` (a registered node; the simulator),
``download --diagnose`` and ``uninstall --dry-run``. A static
check reads every import statement of the port's files, ``chip_smoke.py``
and ``profile_chip.py``: none may name ``frankensearch_tpu`` or ``jax``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import os, sys, tempfile
sys.modules["jax"] = None
sys.modules["frankensearch_tpu"] = None
import numpy as np
import frankensearch_tpu_torch as fst
from frankensearch_tpu_torch import IndexableDocument

dev = fst.resolve_device("cpu")
docs = [IndexableDocument(doc_id=f"d{i}", content=text) for i, text in enumerate(
    ["rust async futures", "jax tpu compile", "bm25 lexical ranking",
     "vector cosine search", "sqlite write ahead log"])]
emb = fst.HashEmbedder(dim=32)
mem = fst.MemoryLexicalIndex.bulk_build(docs)
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(
        root, emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        emb.identity(), device=dev)
    searcher = fst.TwoTierSearcher(
        index, emb, lexical=fst.DeviceBm25Index(mem, device=dev),
        config=fst.TwoTierConfig(fast_only=True))
    out = searcher.search_batch(["vector search", "write ahead log"], k=3)
assert out[0].results[0].doc_id == "d3", out[0].results
assert out[1].results[0].doc_id == "d4", out[1].results
assert all(o.metrics.phase1_fused for o in out) and searcher.last_fusion_path == "device"

# the blocked scale: split layout, flat lane, DAAT (thresholds lowered)
from frankensearch_tpu_torch.lexical import daat, device_bm25, hot_arm
from frankensearch_tpu_torch.ops import _build, hybrid_phase1
device_bm25.BLOCKED_THRESHOLD_POSTINGS = 1
hot_arm.HOT_MIN_POSTINGS = 1
hot_arm.HOT_MAX_TERMS = 2
lex = fst.BulkDeviceBm25Index(docs, device=dev)
assert lex._hot is not None and lex._term_major() is not None
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(
        root, emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        emb.identity(), device=dev)
    searcher = fst.TwoTierSearcher(
        index, emb, lexical=lex, config=fst.TwoTierConfig(fast_only=True))
    out = searcher.search_batch(["write ahead log", "bm25 ranking"], k=3)
assert out[0].results[0].doc_id == "d4" and out[1].results[0].doc_id == "d2", out
assert searcher.last_phase1_lex_lane in ("blocked", "mixed", "daat")

# the int8 capacity slab behind the certificate gate, and the tile scan
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(
        root, emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
        emb.identity(), device=dev, slab_dtype="int8")
    sample = np.repeat(emb.embed_batch([d.content for d in docs]), 5, axis=0)  # 25 queries
    cert = index.certify_fast_scan_mode("int8", 5, sample + 0.01)
    assert cert.certified_recall == 1.0, cert
    index = fst.TwoTierIndex.open(root, device=dev)
    assert index.fast.recall_certificate("int8") is not None
    for mode in ("int8", "pallas"):
        searcher = fst.TwoTierSearcher(index, emb, lexical=fst.DeviceBm25Index(mem, device=dev),
            config=fst.TwoTierConfig(fast_only=True, scan_mode=mode, require_recall_certificate=True))
        out = searcher.search_batch(["vector search", "write ahead log"], k=3)
        assert out[0].results[0].doc_id == "d3" and out[1].results[0].doc_id == "d4", (mode, out)
        assert not any(o.metrics.phase1_fused for o in out)

# a Model2Vec fast tier: the corpus through the bag lane, the queries
# embedded inside the fused pass; the A/B scan lane over its slab
import torch
from frankensearch_tpu_torch.ops import ab_primitives
words = sorted({w for d in docs for w in d.content.split()})
m2v = fst.random_model2vec(words, dim=32, seed=0, device=dev)
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(
        root, fst.embed_corpus(m2v, [d.content for d in docs]), [d.doc_id for d in docs],
        m2v.identity(), device=dev)
    searcher = fst.TwoTierSearcher(index, m2v, lexical=fst.DeviceBm25Index(mem, device=dev),
        config=fst.TwoTierConfig(fast_only=True))
    out = searcher.search_batch(["vector search", "write ahead log"], k=3)
assert searcher.last_phase1_embed_fused and all(o.metrics.phase1_fused for o in out)
assert out[0].results[0].doc_id == "d3" and out[1].results[0].doc_id == "d4", out
q = torch.zeros(2, index.fast.slab.shape[1])
q[:, :32] = torch.from_numpy(m2v.embed_batch(["vector search", "sqlite log"]))
hits = ab_primitives.scan_topk_hierarchical_ab(index.fast.slab, q, 2, emit="tile_topk", tile_n=1024)
assert hits.indices[0, 0] == 3 and hits.indices[1, 0] == 4, hits
# the Refined and Reranked phases: a quality tier, a BERT encoder and a
# cross-encoder, through search() and search_batch
from frankensearch_tpu_torch.core.types import PhaseKind
from frankensearch_tpu_torch.rerank.cross_encoder import random_cross_encoder
from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder
words = sorted({w for d in docs for w in d.content.split()})
quality = random_transformer_embedder(words, device=dev, hidden=32, layers=1, heads=2)
with tempfile.TemporaryDirectory() as root:
    texts = [d.content for d in docs]
    index = fst.TwoTierIndex.create(
        root, emb.embed_batch(texts), [d.doc_id for d in docs], emb.identity(), device=dev,
        quality_vectors=quality.embed_batch(texts), quality_identity=quality.identity())
    searcher = fst.TwoTierSearcher(index, emb, lexical=mem, quality_embedder=quality,
        reranker=random_cross_encoder(words, device=dev, hidden=32, layers=1, heads=2),
        config=fst.TwoTierConfig(quality_timeout_ms=0, rerank_enabled=True),
        text_fn={d.doc_id: d.content for d in docs}.get)
    out = searcher.search('"write ahead" log', k=3)
    assert [p.kind for p in out.phases] == [PhaseKind.INITIAL, PhaseKind.REFINED, PhaseKind.RERANKED]
    assert out.results[0].doc_id == "d4", out.results
    batch = searcher.search_batch(["vector search", '"write ahead"'], k=3)
    assert batch[1].results[0].doc_id == "d4" and batch[0].results[0].quality_score is not None
    searcher.close()
# the library's entry point: a built root, opened, served, written and sealed
with tempfile.TemporaryDirectory() as root:
    stats = fst.IndexBuilder(root, device="cpu").with_documents(docs).with_embedder_stack(
        fst.EmbedderStack(fast=emb)).build()
    assert stats.doc_count == 5 and os.path.exists(os.path.join(root, "metadata.db"))
    h = fst.open_hybrid(root, fast_embedder=emb, device="cpu", config=fst.TwoTierConfig(fast_only=True))
    out = h.searcher.search_batch(["vector search", "write ahead log"], k=3)
    assert out[0].results[0].doc_id == "d3" and out[1].results[0].doc_id == "d4", out
    assert h.searcher.last_fusion_path == "device"
    h.delta.add_document(IndexableDocument(doc_id="d5", content="zeppelin fresh arrival"))
    h.delta.commit()
    assert h.delta.search_candidates("zeppelin", 3)[0].doc_id == "d5"
    assert h.delta.seal().generation and type(h.delta.sealed).__name__ == "SegmentedBm25"
    h.close()
# the CLI: index a JSONL corpus, then search it
import contextlib, io, json
from frankensearch_tpu_torch.cli.main import main as cli
with tempfile.TemporaryDirectory() as tmp:
    corpus = os.path.join(tmp, "c.jsonl")
    with open(corpus, "w") as f:
        f.write("\n".join(json.dumps({"id": d.doc_id, "content": d.content}) for d in docs))
    for argv in (["index", corpus], ["search", "write ahead log"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli(["--format", "json", *argv, "--root", os.path.join(tmp, "ix"), "--device", "cpu"]) == 0
        env = json.loads(buf.getvalue())
    assert env["data"][0]["doc_id"] == "d4" and env["meta"]["device"] == "cpu", env
    # watch a corpus directory into a root, then the tui on the sync searcher
    ix, src = os.path.join(tmp, "ixw"), os.path.join(tmp, "src")
    os.makedirs(src)
    with open(os.path.join(src, "a.txt"), "w") as f:
        f.write("alpha beta")
    for argv, text in ((["index", src], None), (["watch", src, "--once", "--cycles", "1", "--debounce", "0"], "zeppelin"),
                       (["tui"], None)):
        if text:
            with open(os.path.join(src, "z.txt"), "w") as f:
                f.write(text + " fresh arrival")
        buf, stdin = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO("zeppelin\nzeppelin fresh\n:status\n:metrics\n:q\n")
        try:
            with contextlib.redirect_stdout(buf):
                fmt = [] if argv == ["tui"] else ["--format", "json"]
                assert cli([*fmt, *argv, "--root", ix, "--device", "cpu"]) == 0
        finally:
            sys.stdin = stdin
    frames = buf.getvalue()
    assert "z.txt" in frames.split("[search]")[2] and "search_ms" in frames, frames
    # the rest of the CLI: repro and footprint of the watched root, the
    # fleet console (a registered node, the simulator), the host transactions
    from frankensearch_tpu_torch.fleet.registry import NodeRegistrar
    with NodeRegistrar(os.path.join(tmp, "fleet"), "n1", status_fn=lambda: {"doc_count": 3}):
        for argv in (["repro", "zeppelin", "--out", os.path.join(tmp, "pack"), "--root", ix, "--device", "cpu"],
                     ["footprint", "--root", ix], ["fleet", "--live", os.path.join(tmp, "fleet"), "--slo"],
                     ["fleet", "--ticks", "3"], ["download", "m", "--root", ix, "--diagnose"],
                     ["uninstall", "--root", ix, "--dry-run"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli(["--format", "json", *argv]) == 0, argv
            env = json.loads(buf.getvalue())
            assert env["ok"], (argv, env)
    assert env["data"]["entries"][0]["path"] == "frankensearch_tpu_torch"
assert sys.modules["jax"] is None and sys.modules["frankensearch_tpu"] is None
assert not [m for m in sys.modules if m.startswith(("jax.", "frankensearch_tpu."))]
print("OK")
"""


def test_port_serves_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def _imported_roots(path: Path) -> set[str]:
    """The top-level package of every import statement in a file,
    including imports inside functions."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_the_reference_or_jax():
    files = sorted((REPO / "frankensearch_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "profile_chip.py"]
    assert len(files) > 40
    offenders = {
        str(f.relative_to(REPO)): sorted(bad)
        for f in files
        if (bad := _imported_roots(f) & {"frankensearch_tpu", "jax", "jaxlib"})
    }
    assert offenders == {}
