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
``download --diagnose`` and ``uninstall --dry-run``. A second
subprocess, with the same two blocked, drives the background refresh path
and the lifecycle modules ported beside it (``REFRESH_MODULES``): a
``RefreshWorker`` appending into a two-tier index while ``search_batch``
runs, an ``ApiEmbedder`` on a fake transport, the model registry, the
catalog, the lock order, redaction, the host adapter, and a generation
activated, travelled, replayed, repaired and planned. A static
check reads every import statement of the port's files, ``chip_smoke.py``
and ``profile_chip.py``: none may name ``frankensearch_tpu`` or ``jax``;
it also reads each of ``REFRESH_MODULES`` and ``EVALUATION_MODULES`` on
its own. A third subprocess imports each of ``EVALUATION_MODULES`` with
the two blocked and runs a campaign, the reload law, the lockstep, the
quality harness and the evidence lint. A fourth imports each of
``PARALLEL_MODULES`` with the two blocked and serves a root through
``open_hybrid(mesh_shards=4)`` (the sharded fused lane, a write, a
compaction) and the CLI's ``search --shards 2``. A fifth imports each of
``TRAIN_MODULES`` with ``jax``, ``optax``, ``orbax`` and the JAX package
blocked and runs a (2, 2) mesh training step, a checkpoint and its resume,
a fine-tune, the pipeline and ``graft_entry.dryrun_multichip(4)`` on CPU
shards. Every ``.py`` of the JAX package has a counterpart in the port (its
``__graft_entry__.py`` is the port's ``graft_entry.py``), and the entry
points that take a device run on the card unless the caller asks for the
CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

#: the background refresh path and the lifecycle modules (the port's
#: copies, at the reference's relative paths)
REFRESH_MODULES = (
    "fusion/queue.py", "fusion/refresh.py", "core/fingerprint.py", "embed/api_embedder.py",
    "embed/model_registry.py", "runtime/catalog.py", "runtime/concurrency.py", "runtime/redaction.py",
    "core/host_adapter.py", "core/activation.py", "core/time_travel.py", "core/commit_replay.py",
    "core/repair.py", "core/recovery_plan.py",
)

#: the evaluation, gauntlet and contract modules (the port's copies, at
#: the reference's relative paths)
EVALUATION_MODULES = (
    "core/metrics_eval.py", "utils/bench_regression.py", "utils/quality_harness.py", "gauntlet/__init__.py",
    "gauntlet/generator.py", "gauntlet/perf_ratchet.py", "gauntlet/runner.py", "core/e2e_artifact.py",
    "core/distributed_observability.py", "core/contract_sanity.py", "fusion/priors.py", "fusion/ope.py",
    "fusion/interaction_oracles.py",
)

#: the multi-device serving path (the port's copies, at the reference's
#: relative paths)
PARALLEL_MODULES = (
    "parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_scan.py", "parallel/sharded_index.py",
    "parallel/sharded_bm25.py",
)

#: the training path (the port's copies, at the reference's relative paths)
TRAIN_MODULES = ("parallel/train.py", "parallel/checkpoint.py", "parallel/pipeline.py")

#: the reference's entry points outside its package -> the port's module
ENTRY_COUNTERPARTS = {"__graft_entry__.py": "graft_entry.py"}

REFRESH_SCRIPT = r"""
import os, sys, tempfile, threading, time
sys.modules["jax"] = None
sys.modules["frankensearch_tpu"] = None
import numpy as np
import frankensearch_tpu_torch as fst
from frankensearch_tpu_torch import PhaseKind, SearchError, SearchPhase
from frankensearch_tpu_torch.core import activation, commit_replay, fingerprint, generation, host_adapter
from frankensearch_tpu_torch.core import recovery_plan, repair, time_travel
from frankensearch_tpu_torch.core.collectors import TelemetryEnvelope, TelemetryEvent
from frankensearch_tpu_torch.embed import api_embedder, model_manifest, model_registry
from frankensearch_tpu_torch.fusion.queue import EmbeddingQueue, EnqueueResult
from frankensearch_tpu_torch.fusion.refresh import RefreshWorker
from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder
from frankensearch_tpu_torch.runtime import catalog, concurrency, redaction

dev = fst.resolve_device("cpu")
words = [f"w{i}" for i in range(40)]
texts = [" ".join(words[(i * 7 + j) % 40] for j in range(5)) for i in range(60)]
fe = fst.HashEmbedder(dim=32)
qe = random_transformer_embedder(words, device=dev, hidden=32, layers=2, heads=2)
with tempfile.TemporaryDirectory() as root:
    index = fst.TwoTierIndex.create(root, fe.embed_batch(texts), [f"s{i}" for i in range(60)], fe.identity(),
        device=dev, quality_vectors=qe.embed_batch(texts), quality_identity=qe.identity())
    searcher = fst.TwoTierSearcher(index, fe, quality_embedder=qe, config=fst.TwoTierConfig(quality_timeout_ms=0))
    queue = EmbeddingQueue(capacity=64)
    worker = RefreshWorker(queue, index, fe, qe, max_batch=8, poll_interval_s=0.001)
    worker.start()
    errors, stop = [], threading.Event()
    def reader():
        try:
            while not stop.is_set():
                searcher.search_batch(texts[:8], k=5)
        except Exception as e:
            errors.append(e)
    t = threading.Thread(target=reader)
    t.start()
    for i in range(24):
        assert queue.push(f"n{i}", f"zeppelin{i} fresh") is EnqueueResult.ENQUEUED
    assert queue.push("dup", "zeppelin0 fresh") is EnqueueResult.DUPLICATE
    deadline = time.time() + 60
    while worker.stats.docs_embedded < 24 and time.time() < deadline:
        time.sleep(0.01)
    stop.set(); t.join(); worker.stop()
    assert not errors and worker.stats.docs_embedded == 24 and index.quality.n_rows == 84, (errors, worker.stats)
    out = searcher.search_batch(["zeppelin5 fresh"], k=3)[0]
    assert out.results[0].doc_id == "n5" and out.results[0].quality_score is not None, out.results
    assert index.fast.stats().live_rows == 84
old = fingerprint.DocumentFingerprint.of("a b c")
assert fingerprint.ReembedPolicy().should_reembed(old, fingerprint.DocumentFingerprint.of("z a b c d e"))
emb = api_embedder.ApiEmbedder(api_embedder.ApiEmbedderConfig(dim=4),
    lambda p: {"embeddings": [[1.0, 2.0, 2.0, 0.0]] * len(p["input"])})
assert emb.embed_batch(["a"]).shape == (1, 4)
try:
    api_embedder.ApiEmbedder(api_embedder.ApiEmbedderConfig(dim=4)).embed_batch(["x"])
    raise AssertionError("no transport must fail closed")
except SearchError:
    pass
with tempfile.TemporaryDirectory() as tmp:
    d = os.path.join(tmp, "models", "potion-x")
    os.makedirs(d)
    with open(os.path.join(d, "model.safetensors"), "wb") as f:
        f.write(b"w")
    model_manifest.write_model_manifest(d, model_manifest.build_model_manifest(d, "potion-x", "r1", 8, "model2vec"))
    assert model_registry.ModelRegistry(os.path.join(tmp, "models")).verify("potion-x").verified
    cat = catalog.IndexCatalog(os.path.join(tmp, "catalog.db"))
    cat.log_dirty(os.path.join(d, "model.safetensors"), 1.0, 1)
    assert cat.replay()[0].decision is catalog.ReplayDecision.REINDEX
    with concurrency.OrderedLock(concurrency.LockLevel.CATALOG), concurrency.OrderedLock(concurrency.LockLevel.PUBLICATION):
        concurrency.check_access("refresh_worker", "vector_write")
    assert redaction.STRICT_POLICY.redact({"query": "q"})["query"].startswith("redacted:")
    assert host_adapter.run_adapter_conformance(host_adapter.HostAdapter(name="t", sink=lambda d: None)).passed
    ctl = activation.GenerationController(tmp)
    gdir = ctl.generation_dir("gen-1")
    os.makedirs(gdir)
    with open(os.path.join(gdir, "vector.fast.idx"), "wb") as f:
        f.write(b"data")
    generation.write_manifest(gdir, generation.build_manifest(gdir, "gen-1", 7, embedders={"fast": {"embedder_id": "h"}}))
    assert ctl.activate("gen-1").activated and ctl.commit_floor() == 7
    assert time_travel.GenerationHistory(ctl).at_commit_seq(9).generation_id == "gen-1"
    log = commit_replay.CommitLog(os.path.join(tmp, "commits.jsonl"))
    log.append(commit_replay.OpKind.UPSERT, "a", "x")
    assert commit_replay.replay(log.read()).applied_seq == 1
orch = repair.RepairOrchestrator(repair_actions={"x": lambda: True})
orch.report_corruption("x")
assert orch.attempt_repair("x") and orch.state is repair.ServiceState.HEALTHY
plan = recovery_plan.plan_recovery(recovery_plan.SearchMode.FULL,
    fast_model=recovery_plan.ModelState.PRESENT_VERIFIED, quality_model=recovery_plan.ModelState.MISSING,
    index=recovery_plan.IndexState.READY_SEMANTIC)
assert plan.action is recovery_plan.NextAction.SERVE_DEGRADED
assert sys.modules["jax"] is None and sys.modules["frankensearch_tpu"] is None
assert not [m for m in sys.modules if m.startswith(("jax.", "frankensearch_tpu."))]
print("OK")
"""

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


def test_refresh_path_runs_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", REFRESH_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


EVALUATION_SCRIPT = r"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["frankensearch_tpu"] = None
import torch
for m in MODULES:
    importlib.import_module("frankensearch_tpu_torch." + m[:-3].replace("/", ".").removesuffix(".__init__"))
from frankensearch_tpu_torch.core.contract_sanity import check_schema_lockstep, lint_evidence_stream
from frankensearch_tpu_torch.core.e2e_artifact import E2eManifest, OracleReport, validate_artifact
from frankensearch_tpu_torch.gauntlet.generator import CorpusSpec, generate_corpus
from frankensearch_tpu_torch.gauntlet.runner import check_reload_law, run_differential_campaign
from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex
from frankensearch_tpu_torch.utils.quality_harness import EvalQuery, evaluate
spec = CorpusSpec(n_docs=60, seed=4)
corpus = generate_corpus(spec)
mem = MemoryLexicalIndex()
for d in corpus:
    mem.add_document(d)
mem.commit()
dev = DeviceBm25Index(mem, device=torch.device("cpu"))
report = run_differential_campaign(mem.search_candidates, dev.search_candidates, corpus_spec=spec, corpus=corpus)
assert report.ok and report.cases == 50, report.divergences[:3]
assert check_reload_law() == [] and check_schema_lockstep().ok
q = EvalQuery("q0", corpus[0].content.split()[0], {corpus[0].doc_id: 1.0})
assert evaluate(dev.search_candidates, [q], n_resamples=50).n_queries == 1
records = [E2eManifest("r", "gauntlet").to_dict(), OracleReport("r", "oracle", cases=50).to_dict()]
assert [validate_artifact(r) for r in records] == [[], []] and lint_evidence_stream(records) == []
assert not [m for m in sys.modules if m.startswith(("jax.", "frankensearch_tpu."))]
print("OK")
"""


def test_evaluation_modules_run_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = f"MODULES = {EVALUATION_MODULES!r}\n" + EVALUATION_SCRIPT
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


MESH_SCRIPT = r"""
import contextlib, importlib, io, json, sys, tempfile
sys.modules["jax"] = None
sys.modules["frankensearch_tpu"] = None
for m in MODULES:
    importlib.import_module("frankensearch_tpu_torch." + m[:-3].replace("/", ".").removesuffix(".__init__"))
import frankensearch_tpu_torch as fst
from frankensearch_tpu_torch.cli.main import main
from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex
words = [f"w{i}" for i in range(40)]
docs = [fst.IndexableDocument(doc_id=f"d{i}", content=" ".join(words[(i * 7 + j) % 40] for j in range(6)) + f" u{i}")
        for i in range(80)]
emb = fst.HashEmbedder(dim=32)
with tempfile.TemporaryDirectory() as root:
    fst.IndexBuilder(root, device="cpu").with_documents(docs).with_embedder_stack(fst.EmbedderStack(fast=emb)).build()
    h = fst.open_hybrid(root, fast_embedder=emb, device="cpu", config=fst.TwoTierConfig(mesh_shards=4, fast_only=True))
    assert isinstance(h.index.fast, ShardedDeviceVectorIndex) and isinstance(h.delta.sealed, ShardedBulkDeviceBm25Index)
    out = h.searcher.search_batch([docs[3].content, "w1 w2"], k=5)
    assert h.searcher.last_phase1_lex_lane == "sharded" and out[0].results[0].doc_id == "d3"
    h.index.append_fast(["z"], emb.embed_batch(["zeppelin"]))
    h.index.delete(["d5"])
    c = h.index.compact()
    assert isinstance(c.fast, ShardedDeviceVectorIndex) and c.fast.row_for("d5") is None
    h.close()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--format", "json", "search", docs[7].content, "--root", root, "--shards", "2", "--device", "cpu"])
    env = json.loads(buf.getvalue())
    assert rc == 0 and env["data"][0]["doc_id"] == "d7", env
assert not [m for m in sys.modules if m.startswith(("jax.", "frankensearch_tpu."))]
print("OK")
"""


def test_sharded_path_runs_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = f"MODULES = {PARALLEL_MODULES!r}\n" + MESH_SCRIPT
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
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


@pytest.mark.parametrize("module", REFRESH_MODULES + EVALUATION_MODULES + PARALLEL_MODULES)
def test_refresh_module_is_the_ports_own_copy(module):
    port, ref = REPO / "frankensearch_tpu_torch" / module, REPO / "frankensearch_tpu" / module
    assert port.is_file() and ref.is_file()
    assert not _imported_roots(port) & {"frankensearch_tpu", "jax", "jaxlib"}
    named = {
        node.module for node in ast.walk(ast.parse(port.read_text()))
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("frankensearch")
    }
    assert all(m.startswith("frankensearch_tpu_torch.") for m in named), named


TRAIN_SCRIPT = r"""
import importlib, sys, tempfile
for name in ("jax", "optax", "orbax", "frankensearch_tpu"):
    sys.modules[name] = None
for m in MODULES:
    importlib.import_module("frankensearch_tpu_torch." + m[:-3].replace("/", "."))
import numpy as np
import torch
torch.set_num_threads(1)  # tiny shapes: leave the cores to the suite's other workers
from frankensearch_tpu_torch.graft_entry import dryrun_multichip
from frankensearch_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from frankensearch_tpu_torch.parallel.mesh import make_mesh
from frankensearch_tpu_torch.parallel.pipeline import pipeline_embed_forward, shard_stacked_layers, stack_layer_params
from frankensearch_tpu_torch.parallel.train import finetune_quality_tier, make_train_state, make_train_step
from frankensearch_tpu_torch.rerank.bert import BertConfig
from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder
cfg = BertConfig(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64, max_position=16)
mesh = make_mesh(4, axes=("dp", "tp"), device="cpu")
params, opt_state, optimizer = make_train_state(cfg, mesh)
step = make_train_step(cfg, mesh, optimizer)
ids = np.random.default_rng(0).integers(0, 64, size=(4, 8))
mask = np.ones((4, 8), np.int64)
params, opt_state, loss = step(params, opt_state, ids, mask, ids, mask)
with tempfile.TemporaryDirectory() as ck:
    save_train_state(ck, params, opt_state, step=1, cfg=cfg, mesh=mesh)
    p2, o2, _ = make_train_state(cfg, mesh, seed=3)
    restore_train_state(ck, p2, o2, cfg=cfg, mesh=mesh)
assert all(torch.equal(p2[n], params[n]) for n in params) and np.isfinite(float(loss))
words = ["alpha", "beta", "gamma"] + [str(i) for i in range(8)]
emb = random_transformer_embedder(words, device=torch.device("cpu"), hidden=32, layers=2, heads=2)
tuned, losses = finetune_quality_tier(emb, [(f"alpha {i}", f"beta {i} gamma") for i in range(8)], steps=2, batch_size=4)
assert len(losses) == 2 and tuned.embedder_id.endswith("-tuned")
pp = make_mesh(2, axes=("pp",), device="cpu")
state = tuned.model.state_dict()
stacked = shard_stacked_layers(stack_layer_params(state), pp)
t = torch.from_numpy(ids % tuned.cfg.vocab_size)
with torch.inference_mode():
    got = pipeline_embed_forward(state, stacked, t, torch.ones_like(t), cfg=tuned.cfg, mesh=pp, microbatches=2)
    assert (got - tuned.model.embed_forward(t, torch.ones_like(t))).abs().max() <= 2e-5
dryrun_multichip(4, device="cpu")
assert not [m for m in sys.modules if m.startswith(("jax.", "optax.", "orbax.", "frankensearch_tpu."))]
print("OK")
"""


def test_training_path_runs_without_jax_optax_orbax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = f"MODULES = {TRAIN_MODULES!r}\n" + TRAIN_SCRIPT
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("module", TRAIN_MODULES + ("graft_entry.py",))
def test_training_module_imports_no_jax_optax_orbax_or_the_reference(module):
    port = REPO / "frankensearch_tpu_torch" / module
    assert port.is_file()
    assert not _imported_roots(port) & {"frankensearch_tpu", "jax", "jaxlib", "optax", "orbax"}


def test_every_reference_module_has_a_port_counterpart():
    ref_root, port_root = REPO / "frankensearch_tpu", REPO / "frankensearch_tpu_torch"
    missing = sorted(str(p.relative_to(ref_root)) for p in ref_root.rglob("*.py")
                     if not (port_root / p.relative_to(ref_root)).is_file())
    assert missing == []
    for ref, port in ENTRY_COUNTERPARTS.items():
        assert (REPO / ref).is_file() and (port_root / port).is_file()


def test_training_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """make_mesh, make_train_state (through its mesh), graft_entry's entry
    points: the default is the card, and without one they raise instead of
    falling back to the CPU. finetune_quality_tier trains on the embedder's
    own device."""
    import inspect

    import torch

    from frankensearch_tpu_torch import graft_entry
    from frankensearch_tpu_torch.parallel.mesh import make_mesh
    from frankensearch_tpu_torch.parallel.train import finetune_quality_tier, make_train_state
    from frankensearch_tpu_torch.rerank.bert import BertConfig
    from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder

    for fn in (make_mesh, graft_entry.entry, graft_entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    cfg = BertConfig(vocab_size=32, hidden=32, layers=1, heads=2, intermediate=64, max_position=16)
    if torch.cuda.is_available():
        params, _, _ = make_train_state(cfg, make_mesh(1, axes=("dp",)))
        assert all(p.device.type == "cuda" for p in params.values())
    else:
        with pytest.raises(RuntimeError, match="no card"):
            make_train_state(cfg, make_mesh(1, axes=("dp",)))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graft_entry.entry()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graft_entry.dryrun_multichip(2)
    emb = random_transformer_embedder(["a", "b"], device=torch.device("cpu"), hidden=32, layers=1, heads=2)
    tuned, _ = finetune_quality_tier(emb, [("a", "a b"), ("b", "b a")], steps=1, batch_size=2)
    assert tuned.device == emb.device == torch.device("cpu")
