"""The port's TUI (``tui/``, ``fusion/{sync_searcher,incremental}``,
``core/metrics``, the ``tui`` command) against the JAX package's on the CPU.

Oracles: tests/test_tui_fleet.py's shell, screen, determinism and replay
cases (frames byte-equal between the packages for the same event stream),
tests/test_sync_searcher_cache.py (``SyncTwoTierSearcher`` on the same
index in both packages), tests/test_aux_subsystems.py's ``StreamingStats``
cases, tests/test_fusion_extras.py's ``IncrementalSearcher`` cases and
tests/test_cli_e2e.py::test_tui_sync_lane_and_boolean_fallback. The ``tui``
command gets the same stdin script in both packages (tests/test_torch_cli.py's
roots); frames and ``--evidence`` JSONL are equal with the latency numbers
masked, and the ``:status`` screen's root and ``slab`` (the port pads every
slab to 8,192 rows) set aside.

Divergence pinned here: the TUI's reopen on a generation change keeps the
previous generation only on a ``SearchError`` (and writes a
``reload_failed`` line); any other exception propagates.
"""

import json
import os
import re

import numpy as np
import pytest

import frankensearch_tpu.core.metrics as ref_metrics
import frankensearch_tpu.core.types as ref_types
import frankensearch_tpu.fusion.incremental as ref_inc
import frankensearch_tpu.tui.determinism as ref_det
import frankensearch_tpu.tui.screens as ref_screens
import frankensearch_tpu.tui.shell as ref_shell
import frankensearch_tpu_torch.core.metrics as port_metrics
import frankensearch_tpu_torch.core.types as port_types
import frankensearch_tpu_torch.fusion.incremental as port_inc
import frankensearch_tpu_torch.tui.determinism as port_det
import frankensearch_tpu_torch.tui.screens as port_screens
import frankensearch_tpu_torch.tui.shell as port_shell
from frankensearch_tpu_torch.cli import main as port_cli
from frankensearch_tpu_torch.core.errors import IndexCorrupted
from tests.test_torch_cli import (  # noqa: F401
    built, corpus_file, no_pallas, reference_logger_untouched, run, same_rows,
)

PKGS = {
    "port": (port_types, port_shell, port_screens, port_det),
    "ref": (ref_types, ref_shell, ref_screens, ref_det),
}


class FakeOutcome:
    def __init__(self, types, results):
        self.results = results
        self.phases = [types.SearchPhase(types.PhaseKind.INITIAL, results, 1.0)]


def make_shell(pkg: str):
    types, shell_mod, screens, _ = PKGS[pkg]
    shell = shell_mod.AppShell(seed=7, width=60)
    shell.register(screens.SearchScreen(search_fn=lambda q, k: FakeOutcome(
        types, [types.ScoredResult(doc_id=f"{q}-{i}", score=1.0 / (i + 1)) for i in range(3)])))
    shell.register(screens.StatusScreen(status_fn=lambda: {"docs": 42, "tier": "fast"}))
    shell.register(screens.MetricsScreen(stats_fn=lambda: {
        "search": {"count": 5, "mean": 2.0, "p50": 1.5, "p95": 4.0, "p99": 9.0}}))
    return shell


SESSION = [("text", "vector"), ("key", "enter"), ("tick", ""), ("key", "screen:status"), ("tick", ""),
           ("key", "screen:metrics"), ("key", "screen:search"), ("key", "clear")]


def session(pkg: str):
    return [PKGS[pkg][1].InputEvent(kind, value) for kind, value in SESSION]


def test_replay_frames_and_evidence_equal_reference():
    got = port_shell.replay(lambda: make_shell("port"), session("port"))
    want = ref_shell.replay(lambda: make_shell("ref"), session("ref"))
    assert got.frames == want.frames
    assert got.evidence.to_jsonl() == want.evidence.to_jsonl()
    again = port_shell.replay(lambda: make_shell("port"), session("port"))
    assert again.frames == got.frames
    assert got.active == "search" and got.clock.ticks == 2 and any("docs" in f for f in got.frames)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_search_screen_and_hostile_ids(pkg):
    types, shell_mod, screens, _ = PKGS[pkg]
    shell = make_shell(pkg)
    shell.feed(shell_mod.InputEvent("text", "vector"))
    frame = shell.feed(shell_mod.InputEvent("key", "enter"))
    assert "vector-0" in frame and "3 results" in frame
    evil = shell_mod.AppShell(seed=7, width=60)
    evil.register(screens.SearchScreen(search_fn=lambda q, k: FakeOutcome(
        types, [types.ScoredResult(doc_id="e\x1b]0;evil\x07sc", score=1.0)])))
    evil.feed(shell_mod.InputEvent("text", "x"))
    frame = evil.feed(shell_mod.InputEvent("key", "enter"))
    assert "\x1b" not in frame and "\x07" not in frame and "evil" in frame


def test_tick_clock_and_rng_equal_reference():
    for det in (port_det, ref_det):
        c = det.TickClock(tick_ms=50)
        c.tick(3)
        assert c.now_ms() == 150 and c.ticks == 3
    draws = [[det.DeterministicRng(1).fork(n).random() for n in ("x", "x", "y")] for det in (port_det, ref_det)]
    assert draws[0] == draws[1] and draws[0][0] == draws[0][1] != draws[0][2]


def test_streaming_stats_equal_reference():
    data = np.random.default_rng(5).exponential(10.0, 5000)
    out = []
    for m in (port_metrics, ref_metrics):
        s, q = m.StreamingStats(), m.P2Quantile(0.95)
        for x in data:
            s.observe(float(x))
            q.observe(float(x))
        out.append((s.to_dict(), q.value))
    assert out[0] == out[1]
    d = out[0][0]
    assert d["count"] == 5000 and d["mean"] == pytest.approx(data.mean(), rel=0.01)
    assert d["p99"] == pytest.approx(np.quantile(data, 0.99), rel=0.15)
    with pytest.raises(ValueError):
        port_metrics.P2Quantile(1.0)


def sr(types, doc_id, score, **kw):
    return types.ScoredResult(doc_id=doc_id, score=score, **kw)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_incremental_searcher(pkg):
    types, inc = (port_types, port_inc) if pkg == "port" else (ref_types, ref_inc)
    calls = []

    def search_fn(q, k):
        calls.append(q)
        return [sr(types, "apple", 1.0, metadata={"preview": "apple pie recipe"}),
                sr(types, "applet", 0.9, metadata={"preview": "java applet history"}),
                sr(types, "banana", 0.8, metadata={"preview": "banana bread"})]

    s = inc.IncrementalSearcher(search_fn=search_fn)
    s.search("app", k=3)
    s.search("appl", k=3)
    last = s.search("apple", k=3)
    assert len(calls) == 1 and all(r.doc_id != "banana" for r in last)
    assert (s.state.full_searches, s.state.pool_reuses) == (1, 2)
    body = {"sql": "sqlite btree transactions write ahead log", "vec": "vector embeddings cosine"}
    t = inc.IncrementalSearcher(search_fn=lambda q, k: [sr(types, "vec", 1.0, title="Vectors"),
                                                       sr(types, "sql", 0.9, title="SQL Guide")],
                                text_fn=lambda r: body.get(r.doc_id))
    t.search("sqlite transactions", k=1)
    assert [r.doc_id for r in t.search("sqlite transactions write", k=1)] == ["sql"]
    calls.clear()
    s.search("xyz", k=1)
    assert calls == ["xyz"]


# -- SyncTwoTierSearcher on the same index in both packages -------------------------------------

CORPUS = [("d1", "rust async futures executors"), ("d2", "jax tpu jit compilation"),
          ("d3", "bm25 lexical ranking scores"), ("d4", "vector cosine similarity search"),
          ("d5", "sqlite btree write ahead log")]


@pytest.fixture()
def sync_pair(tmp_path):
    import torch

    from frankensearch_tpu.embed.hash_embedder import HashEmbedder
    from frankensearch_tpu.fusion.sync_searcher import SyncTwoTierSearcher
    from frankensearch_tpu.index.two_tier import TwoTierIndex
    from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder as PortHash
    from frankensearch_tpu_torch.fusion.sync_searcher import SyncTwoTierSearcher as PortSync
    from frankensearch_tpu_torch.index.two_tier import TwoTierIndex as PortIndex
    from tests.test_torch_hot_arm import memory_pair

    fe, qe = HashEmbedder(dim=64), HashEmbedder(dim=96)
    pfe, pqe = PortHash(dim=64), PortHash(dim=96)
    texts, ids = [b for _, b in CORPUS], [d for d, _ in CORPUS]
    ref_index = TwoTierIndex.create(str(tmp_path / "r"), fe.embed_batch(texts), ids, fe.identity(),
                                    quality_vectors=qe.embed_batch(texts), quality_identity=qe.identity(),
                                    use_pallas=False)
    port_index = PortIndex.create(str(tmp_path / "p"), pfe.embed_batch(texts), ids, pfe.identity(),
                                  quality_vectors=pqe.embed_batch(texts), quality_identity=pqe.identity(),
                                  device=torch.device("cpu"))
    mem, port_mem = memory_pair([ref_types.IndexableDocument(doc_id=d, content=b) for d, b in CORPUS])
    return (SyncTwoTierSearcher(ref_index, lexical=mem), fe, qe), (PortSync(port_index, lexical=port_mem), pfe, pqe)


def rows(out) -> list[dict]:
    return [r.to_dict() for r in out.results]


@pytest.mark.parametrize("query", ["vector search", "rust futures", "sqlite log", "tpu"])
@pytest.mark.parametrize("quality", [True, False], ids=["refined", "fast_only"])
def test_sync_searcher_equals_reference(sync_pair, query, quality):
    (ref_s, fe, qe), (port_s, pfe, pqe) = sync_pair
    want = ref_s.search(query, fe.embed(query), qe.embed(query) if quality else None, k=5)
    got = port_s.search(query, pfe.embed(query), pqe.embed(query) if quality else None, k=5)
    same_rows(rows(got), rows(want))
    assert [p.kind.value for p in got.phases] == [p.kind.value for p in want.phases] == (
        ["initial", "refined"] if quality else ["initial"])
    if quality:
        assert got.kendall_tau == pytest.approx(want.kendall_tau, abs=1e-12)


# -- the tui command -----------------------------------------------------------------------------

SCRIPT = ("rust ownership\nrust ownership borrowing\nvector\nvector embeddings\nw001 w002\n"
          '"write ahead log"\nrust AND NOT tpu\nsqlite -tpu\n:status\n:metrics\n:nope\n:search\n:q\n')


def masked(text: str) -> str:
    """A ``tui`` frame stream with the metrics numbers, the status
    screen's root and slab set aside."""
    out = []
    for line in text.splitlines():
        if line.startswith(("search_ms", "root ", "slab ")):
            line = line.split()[0] + " <masked>"
        out.append(line)
    return "\n".join(out)


def evidence_masked(path: str) -> list[dict]:
    recs = [json.loads(x) for x in open(path).read().splitlines()]
    for r in recs:
        if r["type"] == "frame" and r["screen"] in ("status", "metrics"):
            r["frame_hash"] = "<masked>"
    return recs


def test_tui_frames_and_evidence_equal_reference(built, tmp_path):
    roots, _ = built
    out = {}
    for pkg in ("port", "ref"):
        ev = str(tmp_path / f"ev_{pkg}.jsonl")
        rc, text = run(pkg, "tui", "--root", roots[pkg], "--evidence", ev, stdin=SCRIPT)
        assert rc == 0
        out[pkg] = (text, ev)
    assert masked(out["port"][0]) == masked(out["ref"][0])
    assert evidence_masked(out["port"][1]) == evidence_masked(out["ref"][1])
    frames = out["port"][0].split("[search]")
    assert "Rust Book" in frames[2] and "Rust Book" in frames[3]  # the sync lane, then the pool's reuse
    assert "SQL Guide" in frames[7] and "1 results" in frames[7]  # the phrase through search()
    assert "unknown screen 'nope'" in out["port"][0]
    slab = re.search(r"^slab\s+(\S+)", out["port"][0], re.M).group(1)
    assert slab.startswith("8192x")


def test_tui_results_are_the_librarys(built, monkeypatch):
    """Each plain line's results are ``SyncTwoTierSearcher`` +
    ``IncrementalSearcher`` over the handle the command opened; boolean and
    negated lines are its ``search()``."""
    from frankensearch_tpu_torch.fusion.incremental import IncrementalSearcher
    from frankensearch_tpu_torch.fusion.sync_searcher import SyncTwoTierSearcher

    roots, _ = built
    handles, seen = [], []
    real_open = port_cli._open

    def spy(args, root=None):
        handles.append(real_open(args, root))
        return handles[-1]

    class Recording(port_screens.SearchScreen):
        def handle(self, event, shell):
            super().handle(event, shell)
            if event.kind == "key" and event.value == "enter":
                seen.append((self.query, [r.to_dict() for r in self.results]))

    monkeypatch.setattr(port_cli, "_open", spy)
    monkeypatch.setattr(port_screens, "SearchScreen", Recording)
    assert run("port", "tui", "--root", roots["port"], stdin=SCRIPT)[0] == 0
    (h,) = handles
    s = h.searcher
    sync = SyncTwoTierSearcher(h.index, lexical=s.lexical, config=s.config)
    inc = IncrementalSearcher(search_fn=lambda q, k: sync.search(q, s.fast_embedder.embed(q), k=k).results,
                              text_fn=lambda r: s.default_text_fn(r.doc_id))
    structured = {'"write ahead log"', "rust AND NOT tpu", "sqlite -tpu"}
    for q, got in seen:
        want = s.search(q, k=8).results if q in structured else inc.search(q, k=8)
        assert got == [r.to_dict() for r in want], q
    assert len(seen) == 8 and inc.state.pool_reuses == 2


class ScriptWithReload:
    """stdin for ``tui`` that moves the root's WAL sentinel after the
    first line, so the second line reopens the root."""

    def __init__(self, root: str):
        self.root = root

    def __iter__(self):
        yield "rust\n"
        with open(os.path.join(self.root, "vector.fast.idx.wal"), "ab") as f:
            f.write(b"")
        os.utime(os.path.join(self.root, "vector.fast.idx.wal"), ns=(1, 1))
        yield "vector\n"
        yield ":q\n"


def tui_with_failing_reopen(root, monkeypatch, exc):
    import contextlib
    import io
    import sys

    real_open, calls = port_cli._open, []

    def opener(args, root=None):
        calls.append(1)
        if len(calls) > 1:
            raise exc
        return real_open(args, root)

    monkeypatch.setattr(port_cli, "_open", opener)
    monkeypatch.setattr(sys, "stdin", ScriptWithReload(root))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(["tui", "--root", root, "--device", "cpu"])
    return rc, out.getvalue(), len(calls)


def test_tui_reload_search_error_keeps_the_generation(built, tmp_path, monkeypatch):
    import shutil

    root = str(tmp_path / "ix")
    shutil.copytree(built[0]["port"], root)
    rc, text, n = tui_with_failing_reopen(root, monkeypatch, IndexCorrupted("torn generation"))
    assert rc == 0 and n >= 2
    failed = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    assert failed and all(f["error"]["code"] == "reload_failed" for f in failed)
    assert "torn generation" in failed[0]["error"]["message"]
    assert text.count("results (") == 2  # both lines answered from the kept generation


def test_tui_reload_device_fault_propagates(built, tmp_path, monkeypatch):
    import shutil

    root = str(tmp_path / "ix")
    shutil.copytree(built[0]["port"], root)
    with pytest.raises(RuntimeError, match="device fault"):
        tui_with_failing_reopen(root, monkeypatch, RuntimeError("device fault"))
