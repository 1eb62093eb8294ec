"""The port's storage layer (``storage/store``, ``job_queue``, ``pipeline``),
the FTS5 lexical engine (``lexical/fts5_adapter``) and the WAL rebuild rung
(``index/rebuild``) against the JAX reference on the CPU.

Oracles: tests/test_storage.py, tests/test_fts5_adapter.py,
tests/test_fts5_backend.py and tests/test_durability_repair.py's rebuild
rung. Every scenario runs on both packages (``PKGS``) over the same inputs
and their outputs are compared: SQLite rows (clock columns aside), FTS5
candidates and scores, the rebuilt FTVI artifact's bytes and the report.
"""

import os

import numpy as np
import pytest

import frankensearch_tpu as fs
import frankensearch_tpu.embed.hash_embedder as j_hash
import frankensearch_tpu.index.rebuild as j_rebuild
import frankensearch_tpu.index.wal as j_wal
import frankensearch_tpu.lexical.fts5_adapter as j_fts5
import frankensearch_tpu.lexical.query as j_query
import frankensearch_tpu.storage.job_queue as j_jobs
import frankensearch_tpu.storage.pipeline as j_pipe
import frankensearch_tpu.storage.store as j_store
import frankensearch_tpu_torch as fst
import frankensearch_tpu_torch.embed.hash_embedder as t_hash
import frankensearch_tpu_torch.index.rebuild as t_rebuild
import frankensearch_tpu_torch.index.wal as t_wal
import frankensearch_tpu_torch.lexical.fts5_adapter as t_fts5
import frankensearch_tpu_torch.lexical.query as t_query
import frankensearch_tpu_torch.storage.job_queue as t_jobs
import frankensearch_tpu_torch.storage.pipeline as t_pipe
import frankensearch_tpu_torch.storage.store as t_store
from tests.test_torch_persist import PORT, REF, read

for _pkg, _mods in ((REF, (j_store, j_jobs, j_pipe, j_fts5, j_rebuild, j_wal, j_hash, j_query, fs)),
                    (PORT, (t_store, t_jobs, t_pipe, t_fts5, t_rebuild, t_wal, t_hash, t_query, fst))):
    (_pkg.store, _pkg.jobs, _pkg.pipe, _pkg.fts5, _pkg.rebuild, _pkg.wal, _pkg.hash, _pkg.query,
     _pkg.api) = _mods
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
pytestmark = pytest.mark.skipif(not t_fts5.fts5_available(), reason="sqlite without fts5")


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages; the port's result
    must equal the reference's. Returns it."""
    got, want = scenario(PORT, *args), scenario(REF, *args)
    assert got == want
    return got


# -- storage/store ----------------------------------------------------------------


def _dedup_and_staleness(pkg):
    s = pkg.store.Storage()
    out = [s.upsert_document("a", "hello world"), s.upsert_document("a", "hello world"),
           s.upsert_document("a", "hello there")]
    _, hb = s.upsert_document("b", "text b")
    out.append(s.staleness("emb-1"))
    s.mark_embedded("b", "emb-1", hb)
    out.append(s.staleness("emb-1"))
    s.upsert_document("b", "text b CHANGED")
    out.append(s.staleness("emb-1"))
    assert s.delete_document("a") and s.doc_count() == 1 and s.doc_count(include_deleted=True) == 2
    out.append(s.get_document("a"))
    s.close()
    return [x if isinstance(x, tuple) else vars(x) if hasattr(x, "__dict__") else repr(x) for x in out]


def test_upsert_dedup_staleness_and_soft_delete():
    rows = both(_dedup_and_staleness)
    assert rows[0][0] and not rows[1][0] and rows[2][0]


def _history_bookmarks_builds(pkg):
    s = pkg.store.Storage()
    s.HISTORY_RETAIN = 100
    for i in range(1200):
        s.record_search(f"q{i}", 10, 3, f"doc-{i % 7}", float(i))
    n_hist = s._conn.execute("SELECT COUNT(*) FROM search_history").fetchone()[0]
    recent = [{k: v for k, v in r.items() if k != "searched_at"} for r in s.recent_searches(limit=5)]
    s.add_bookmark("doc-x", "important")
    for i in range(110):
        s.record_build(i, i % 3, float(i), detail={"i": i})
    builds = [{k: v for k, v in r.items() if k != "built_at"} for r in s.build_history()]
    out = (n_hist, recent, s.bookmarks(), builds)
    s.close()
    return out


def test_history_bookmarks_and_build_history_are_bounded():
    n_hist, recent, marks, builds = both(_history_bookmarks_builds)
    assert n_hist <= 100 + 512 and recent[0]["query"] == "q1199"
    assert marks == [("doc-x", "important")] and len(builds) == 100 and builds[0]["doc_count"] == 109


def _bulk_rows(pkg, path):
    s = pkg.store.Storage(path)
    n = s.upsert_documents_bulk(
        [(f"d{i}", f"content number {i} " * (i + 1), f"title {i}" if i % 2 else None,
          {"links": [f"d{i + 1}"]} if i % 3 == 0 else None) for i in range(40)],
        embedder_id="emb-x",
    )
    rows = [vars(r) for r in s.iter_documents()]
    status = s._conn.execute(
        "SELECT doc_id, embedder_id, content_hash FROM embedding_status ORDER BY doc_id").fetchall()
    s.close()
    return n, rows, status


def test_bulk_upsert_rows_equal(tmp_path):
    n, rows, status = both(lambda pkg: _bulk_rows(pkg, str(tmp_path / f"{pkg.name}.db")))
    assert n == 40 and len(rows) == 40 and len(status) == 40 and rows[0]["metadata"] == {"links": ["d1"]}


# -- storage/job_queue, storage/pipeline ------------------------------------------


def _job_lifecycle(pkg):
    q = pkg.jobs.PersistentJobQueue()
    jid = q.enqueue("embed", {"doc_id": "a"})
    job = q.claim("w1")
    trace = [(job.job_id == jid, job.attempts, dict(job.payload)), q.claim("w2"), q.complete(jid, "w1")]
    q.enqueue("embed", {"doc_id": "b"}, max_attempts=2)
    j1 = q.claim("w1")
    trace += [q.fail(j1.job_id, "w1", "boom"), q.claim("w1").attempts, q.fail(j1.job_id, "w1", "boom2"),
              q.claim("w1"), q.counts()]
    lease = pkg.jobs.PersistentJobQueue(lease_s=0.0)
    lease.enqueue("reingest", {"doc_id": "c"})
    lease.claim("w1")
    trace += [lease.claim("w2").attempts, lease.pending_payloads("reingest")]
    return trace


def test_job_queue_claims_retries_and_reclaims():
    trace = both(_job_lifecycle)
    assert trace[0] == (True, 1, {"doc_id": "a"}) and trace[1] is None and trace[2]
    assert trace[3:8] == ["pending", 2, "failed", None, {"done": 1, "failed": 1}]


def _ingest_and_run(pkg):
    storage, jobs = pkg.store.Storage(), pkg.jobs.PersistentJobQueue()
    pipe = pkg.pipe.IngestPipeline(storage=storage, jobs=jobs)
    doc = pkg.Doc(doc_id="a", content="meaningful text content here")
    flags = [pipe.ingest(doc), pipe.ingest(doc), pipe.ingest(pkg.Doc(doc_id="x", content="!!! ###"))]
    flags.append(pipe.ingest_batch([pkg.Doc(doc_id=f"d{i}", content=f"document number {i} text") for i in range(5)]))
    emb = pkg.hash.HashEmbedder(dim=32)
    sunk = {}
    runner = pkg.pipe.StorageBackedJobRunner(
        jobs=jobs, storage=storage, embedder=emb, sink=lambda ids, vecs: sunk.update(zip(ids, vecs)))
    n = runner.drain()
    return (flags, vars(pipe.stats), n, sorted((k, v.tobytes()) for k, v in sunk.items()),
            storage.staleness(emb.embedder_id).pending)


def test_ingest_pipeline_and_job_runner():
    flags, stats, n, sunk, pending = both(_ingest_and_run)
    assert flags == [True, False, False, 5] and stats["deduped"] == 1 and stats["low_signal"] == 1
    assert n == 6 and len(sunk) == 6 and pending == 0


def _failing_runner(pkg):
    storage, jobs = pkg.store.Storage(), pkg.jobs.PersistentJobQueue()
    pkg.pipe.IngestPipeline(storage=storage, jobs=jobs).ingest(pkg.Doc(doc_id="a", content="some real text"))

    def sink(ids, vecs):
        raise OSError("sink down")

    runner = pkg.pipe.StorageBackedJobRunner(jobs=jobs, storage=storage, embedder=pkg.hash.HashEmbedder(dim=8),
                                             sink=sink)
    return runner.run_once(), jobs.counts()


def test_job_runner_failure_returns_jobs_to_the_queue():
    assert both(_failing_runner) == (0, {"pending": 1})


# -- lexical/fts5_adapter -----------------------------------------------------------


def fts_docs(pkg):
    return [
        pkg.Doc(doc_id="d000", content="rust memory safety borrow checker", title="rust guide"),
        pkg.Doc(doc_id="d001", content="python dynamic typing ecosystem"),
        pkg.Doc(doc_id="d002", content="rust zero cost abstractions performance", metadata={"lang": "rs"}),
        pkg.Doc(doc_id="d003", content="garbage collection pause latency"),
        pkg.Doc(doc_id="d004", content="the rust book teaches ownership", title="book"),
    ]


def fts_index(pkg, docs=None, **kw):
    ix = pkg.fts5.Fts5LexicalIndex(**kw)
    for d in docs or fts_docs(pkg):
        ix.add_document(d)
    ix.commit()
    return ix


FTS_QUERIES = ["rust", "rust book", "python OR garbage", "borrow", "nothing here", 'rust "quoted', "a*b:c"]


def _fts_contract(pkg):
    ix = fts_index(pkg)
    out = [[(c.doc_id, c.score) for c in ix.search_candidates(q, 10)] for q in FTS_QUERIES]
    out.append(ix.search_candidates("", 10) + ix.search_candidates("rust", 0))
    out.append(ix.hydrate_candidates(["d002", "d004", "missing"]))
    out.append([(r.doc_id, r.score) for r in ix.search("rust", 3)])
    ix.add_document(pkg.Doc(doc_id="d005", content="rust staged only"))
    out.append([c.doc_id for c in ix.search_candidates("staged", 5)])
    ix.commit()
    out.append([c.doc_id for c in ix.search_candidates("staged", 5)])
    ix.delete_document("d000")
    ix.add_document(pkg.Doc(doc_id="d001", content="replaced content now rust"))
    ix.commit()
    out.append([c.doc_id for c in ix.search_candidates("rust", 10)])
    out.append([c.doc_id for c in ix.search_candidates("python", 10)])
    out.append((ix.doc_count(), ix.snippet("d002", "rust")))
    ix.close()
    return out


def test_fts5_contract_equals_reference():
    out = both(_fts_contract)
    assert out[0][0][0] in ("d000", "d004", "d002") and out[4] == []
    staged, committed, rust_after, python_after = out[10:14]
    assert staged == [] and committed == ["d005"] and "d000" not in rust_after and python_after == []


def _fts_boolean(pkg):
    mem, f5 = pkg.Mem(), fts_index(pkg, [
        pkg.Doc(doc_id="d000", content="alpha beta gamma"),
        pkg.Doc(doc_id="d001", content="alpha zeta quiet"),
        pkg.Doc(doc_id="d002", content="alpha beta other"),
        pkg.Doc(doc_id="d003", content="alpha beta " + "filler " * 60 + "gamma"),
    ])
    out = []
    for text in ('NOT gamma OR "alpha zeta"', '"alpha beta"', "alpha AND NOT beta", '"beta alpha"'):
        q = pkg.query.parse_query(text)
        out.append((pkg.query.to_fts5_match(q.root), sorted(r.doc_id for r in f5.search_boolean(q, 50))))
    f5.close()
    return out


def test_fts5_boolean_trees_equal_reference():
    out = both(_fts_boolean)
    assert out[0] == (None, ["d001", "d002"])


def _fts_modes(pkg, root):
    stored = fts_index(pkg, [pkg.Doc(doc_id="d000", content="alpha " + "x" * 500)])
    full = stored.hydrate_candidates(["d000"])["d000"]
    stored.close()
    contentless = fts_index(pkg, [pkg.Doc(doc_id="d000", content="alpha beta")], content_mode="contentless")
    hits = [c.doc_id for c in contentless.search_candidates("alpha", 5)]
    preview_only = "content" not in contentless.hydrate_candidates(["d000"])["d000"]
    with pytest.raises(pkg.errors.SearchError):
        contentless.delete_document("d000")
        contentless.commit()
    contentless.close()
    with pytest.raises(pkg.errors.InvalidConfig):
        pkg.fts5.Fts5LexicalIndex(content_mode="external")
    path = os.path.join(root, f"{pkg.name}.db")
    fts_index(pkg, path=path).close()
    reopened = pkg.fts5.Fts5LexicalIndex(path)
    again = [(c.doc_id, c.score) for c in reopened.search_candidates("rust", 5)]
    reopened.close()
    return len(full["content"]), len(full["preview"]), preview_only, hits, again


def test_fts5_content_modes_and_persistence(tmp_path):
    content_len, preview_len, preview_only, hits, again = both(_fts_modes, str(tmp_path))
    assert content_len == 506 and preview_len <= 240 and preview_only and hits == ["d000"] and len(again) == 3


# -- index/rebuild ------------------------------------------------------------------------


def build_root(pkg, root, n=16, dim=32, seed=0):
    """tests/test_durability_repair.py's root: ``n`` docs of six words."""
    rng = np.random.default_rng(seed)
    kw = {"device": "cpu"} if pkg is PORT else {}
    b = pkg.api.IndexBuilder(root, **kw).with_embedder_stack(pkg.api.EmbedderStack(fast=pkg.api.HashEmbedder(dim=dim)))
    for i in range(n):
        words = " ".join(rng.choice(["alpha", "beta", "gamma", "delta", "epsilon", "zeta"], size=12))
        b.add_document(pkg.Doc(doc_id=f"doc-{i:04d}", content=f"{words} topic {i}"))
    b.build()
    return root


def _rebuild(pkg, root, jobs):
    build_root(pkg, root)
    fast = os.path.join(root, "vector.fast.idx")
    emb = pkg.hash.HashEmbedder(dim=32)
    pkg.wal.WriteAheadLog(fast + ".wal").append(
        [f"wal-{i}" for i in range(3)], np.stack([emb.embed(f"walrus doc {i}") for i in range(3)]))
    if jobs:
        pkg.jobs.PersistentJobQueue(os.path.join(root, "jobs.db"))
    os.remove(fast)
    report = pkg.rebuild.rebuild_fast_tier_from_wal(root)
    queued = pkg.jobs.PersistentJobQueue(os.path.join(root, "jobs.db")).pending_payloads("reingest") if jobs else []
    return vars(report), read(fast), queued


@pytest.mark.parametrize("jobs", [False, True])
def test_rebuild_from_wal_equals_reference(tmp_path, jobs):
    report, artifact, queued = both(lambda pkg: _rebuild(pkg, str(tmp_path / pkg.name), jobs))
    assert report["rebuilt"] and report["docs_recovered"] == 3 and len(report["docs_lost"]) == 16
    assert report["reingest_jobs_enqueued"] == (16 if jobs else 0) and len(queued) == report["reingest_jobs_enqueued"]
    assert artifact


@PKGS
def test_rebuild_refuses_without_a_wal(pkg, tmp_path):
    root = build_root(pkg, str(tmp_path / "idx"), n=8)
    os.remove(os.path.join(root, "vector.fast.idx"))
    report = pkg.rebuild.rebuild_fast_tier_from_wal(root)
    assert not report.rebuilt and "no WAL" in report.detail


def test_open_hybrid_rebuilds_an_unrepairable_fast_tier(tmp_path):
    """The durability ladder's last rung through ``open_hybrid``: a fast
    tier truncated past parity repair is quarantined and rebuilt from its
    WAL, and the rebuilt index serves (the reference does the same)."""
    served = {}
    for pkg in (REF, PORT):
        root = build_root(pkg, str(tmp_path / pkg.name))
        fast = os.path.join(root, "vector.fast.idx")
        emb = pkg.api.HashEmbedder(dim=32)
        pkg.wal.WriteAheadLog(fast + ".wal").append(
            [f"wal-{i}" for i in range(8)], np.stack([emb.embed(f"walrus doc {i}") for i in range(8)]))
        with open(fast, "r+b") as f:
            f.truncate(os.path.getsize(fast) // 2)
        kw = {"device": "cpu"} if pkg is PORT else {}
        handle = pkg.api.open_hybrid(root, fast_embedder=emb, **kw)
        assert os.path.exists(os.path.join(root, ".quarantine", "vector.fast.idx"))
        served[pkg.name] = (sorted(handle.index.fast.doc_ids),
                            [r.doc_id for r in handle.searcher.search("walrus doc", k=3).results])
        handle.close()
    assert served["port"] == served["ref"] and served["port"][0] == [f"wal-{i}" for i in range(8)]
