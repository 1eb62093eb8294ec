"""The port's ``serve`` NDJSON loop against the JAX package's on the CPU.

Oracle: tests/test_cli_e2e.py:231-640. Both servers run in-process
(``main(["serve", ...])`` with ``sys.stdin`` swapped for a frame stream)
over roots built from the same seeded corpus; replies are compared frame
by frame (rows as in tests/test_torch_cli.py: doc ids equal, scores
within 1e-6). Pipelined ``search`` frames coalesce into one
``search_batch`` call whose replies equal the library's ``search_batch``
bitwise through JSON; a bad frame errors alone; a negative k is the same
typed error in both lanes; protocol fuzz never kills the server; stream
frames arrive in ``seq`` order; the ``status`` op reports the live handle;
one subprocess serve rebinds after an external ``append-batch``.
"""

import json
import os
import subprocess
import sys

import pytest

import frankensearch_tpu_torch as fst
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from tests.test_torch_cli import (  # noqa: F401
    env_of, no_pallas, reference_logger_untouched, run, same_rows, write_corpus,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESSURE_STATES = {"NORMAL", "ELEVATED", "DEGRADED", "EMERGENCY"}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    corpus = write_corpus(tmp_path_factory.mktemp("corpus") / "docs.jsonl")
    out = {}
    for pkg in ("port", "ref"):
        out[pkg] = str(tmp_path_factory.mktemp(f"serve_{pkg}"))
        env_of(pkg, "index", corpus, "--root", out[pkg])
    return out


def frames(*reqs) -> str:
    return "\n".join(r if isinstance(r, str) else json.dumps(r) for r in reqs) + "\n"


def serve(pkg: str, root: str, stdin: str, *extra) -> list[dict]:
    rc, out = run(pkg, "serve", "--root", root, *extra, stdin=stdin)
    assert rc == 0
    return [json.loads(line) for line in out.strip().splitlines()]


def serve_both(roots, stdin: str, *extra) -> tuple[list[dict], list[dict]]:
    return serve("port", roots["port"], stdin, *extra), serve("ref", roots["ref"], stdin, *extra)


def same_reply(got: dict, want: dict) -> None:
    assert got["ok"] == want["ok"] and got.get("meta") == want.get("meta"), (got, want)
    if not got["ok"]:
        assert got["error"] == want["error"]
    elif isinstance(want["data"], list) and want["data"] and "query" in want["data"][0]:  # search_batch
        assert [r["query"] for r in got["data"]] == [r["query"] for r in want["data"]]
        for g, w in zip(got["data"], want["data"]):
            same_rows(g["results"], w["results"])
    elif isinstance(want["data"], list):
        same_rows(got["data"], want["data"])
    else:
        assert got["data"] == want["data"]


def rows_json(outcomes) -> list:
    return [json.loads(json.dumps([r.to_dict() for r in o.results], default=str)) for o in outcomes]


def test_serve_ndjson_equals_reference(roots):
    stdin = frames({"op": "ping"}, {"op": "search", "query": "jax tpu", "k": 2}, {"op": "nope"},
                   {"op": "shutdown"}, {"op": "ping"})
    got, want = serve_both(roots, stdin)
    assert len(got) == len(want) == 4  # nothing after the shutdown
    for g, w in zip(got, want):
        same_reply(g, w)
    assert got[0]["data"]["op"] == "pong" and got[1]["data"][0]["doc_id"] == "jax-1"
    assert got[2]["error"]["code"] == "unknown_op" and got[3]["data"]["op"] == "shutdown"


def test_pipelined_searches_batch_into_one_call(roots, monkeypatch):
    """Six pipelined searches: one ``search_batch`` call at k = max k, each
    reply its row cut to its own k, bitwise the library's batch through
    JSON, and equal to the reference server's replies."""
    queries = ["jax tpu", "rust ownership", "w001 w002", "sqlite log", "vector search", "w010"]
    stdin = frames(*[{"op": "search", "query": q, "k": 1 + i % 3} for i, q in enumerate(queries)],
                   {"op": "ping"}, {"op": "shutdown"})
    calls = []
    batch = TwoTierSearcher.search_batch

    def spy(self, qs, **kw):
        calls.append((list(qs), kw))
        return batch(self, qs, **kw)

    monkeypatch.setattr(TwoTierSearcher, "search_batch", spy)
    got = serve("port", roots["port"], stdin, "--coalesce-ms", "200")
    monkeypatch.undo()
    want = serve("ref", roots["ref"], stdin, "--coalesce-ms", "200")
    assert calls == [(queries, {"k": 3})]
    assert [g["meta"] for g in got[:6]] == [{"coalesced": 6}] * 6
    for g, w in zip(got, want):
        same_reply(g, w)
    h = fst.open_hybrid(roots["port"], device="cpu")
    lib = rows_json(h.searcher.search_batch(queries, k=3))
    h.close()
    for i, env in enumerate(got[:6]):
        assert env["data"] == lib[i][: 1 + i % 3]
    assert got[6]["data"]["op"] == "pong" and got[7]["data"]["op"] == "shutdown"


def test_search_batch_op_equals_search(roots):
    stdin = frames({"op": "search_batch", "queries": ["jax tpu", "rust", ""], "k": 2},
                   {"op": "search", "query": "jax tpu", "k": 2}, {"op": "shutdown"})
    got, want = serve_both(roots, stdin)
    rows = {r["query"]: r["results"] for r in got[0]["data"]}
    assert rows[""] == [] and [r["doc_id"] for r in rows["jax tpu"]] == [r["doc_id"] for r in got[1]["data"]]
    for g, w in zip(got, want):
        same_reply(g, w)


def test_bad_frame_does_not_poison_its_batch(roots):
    stdin = frames({"op": "search", "query": "jax tpu", "k": 2}, {"op": "search", "query": "jax tpu", "k": "three"},
                   {"op": "search", "query": "jax tpu", "k": 2}, {"op": "shutdown"})
    got, want = serve_both(roots, stdin, "--coalesce-ms", "200")
    assert len(got) == 4
    for g, w in zip(got, want):
        same_reply(g, w)
    assert got[0]["ok"] and got[0]["data"][0]["doc_id"] == "jax-1" and got[2]["ok"]
    assert not got[1]["ok"] and "three" in got[1]["error"]["message"]


@pytest.mark.parametrize("coalesce", ["0", "200"], ids=["direct", "coalesced"])
def test_negative_k_is_typed_in_both_lanes(roots, coalesce):
    stdin = frames({"op": "search", "query": "jax tpu", "k": -2}, {"op": "search", "query": "jax tpu", "k": 2},
                   {"op": "shutdown"})
    got, want = serve_both(roots, stdin, "--coalesce-ms", coalesce)
    for g, w in zip(got, want):
        same_reply(g, w)
    assert got[0]["error"]["code"] == "invalid_config" and got[1]["ok"] and got[1]["data"]


def test_protocol_fuzz_never_kills_the_server(roots):
    nasty = ["not json at all", '{"op": 42}', '{"op": "search"}', '{"op": "search", "query": null, "k": "ten"}',
             '{"op": "search_batch", "queries": "notalist"}', "{}", "[1,2,3]",
             '{"op": "search", "query": "x", "k": -5}', '{"op": "search", "query": "' + "A" * 5000 + '", "k": 2}']
    stdin = frames(*nasty, {"op": "search", "query": "jax tpu", "k": 2}, {"op": "shutdown"})
    got, want = serve_both(roots, stdin)
    assert len(got) == len(want) == len(nasty) + 2
    for g, w in zip(got, want):
        same_reply(g, w)
    assert got[-2]["ok"] and got[-2]["data"][0]["doc_id"] == "jax-1"


def test_stream_frames_in_seq_order(roots):
    stdin = frames({"op": "search", "query": "sqlite log", "k": 3, "stream": True}, {"op": "shutdown"})
    got, want = serve_both(roots, stdin)
    assert [f["seq"] for f in got[:-1]] == list(range(1, len(got)))
    assert [f["kind"] for f in got[:-1]] == [f["kind"] for f in want[:-1]] == ["phase", "metrics", "end"]
    assert got[0]["payload"]["phase"] == want[0]["payload"]["phase"] == "initial"
    same_rows(got[0]["payload"]["results"], want[0]["payload"]["results"])
    assert got[2]["payload"] == want[2]["payload"] == {"result_count": 3}
    assert got[1]["payload"]["device_kind"] == "cpu"


def test_status_op_reports_the_live_handle(roots):
    stdin = frames({"op": "status"}, {"op": "shutdown"})
    got, want = serve_both(roots, stdin)
    g, w = dict(got[0]["data"]), dict(want[0]["data"])
    assert g.pop("pressure") in PRESSURE_STATES and w.pop("pressure") in PRESSURE_STATES
    assert g == w and g["doc_count"] == 64 and g["lexical"] and g["reloads"] == 0


def test_warmup_reports_before_serving(roots):
    got = serve("port", roots["port"], frames({"op": "search", "query": "rust", "k": 1}, {"op": "shutdown"}),
                "--warmup", "--serve-max-batch", "4")
    assert got[0]["ok"] and got[0]["data"]["op"] == "warmup"
    assert got[0]["data"]["upload_ms"] >= 0 and got[0]["data"]["compile_ms"] >= 0
    assert got[1]["data"][0]["doc_id"] == "rust-1"


def test_hot_reload_after_an_external_append(tmp_path):
    """A subprocess serve (``--device cpu``) rebinds to the new generation
    after another process's ``append-batch``."""
    corpus = tmp_path / "c.jsonl"
    corpus.write_text("\n".join(json.dumps({"id": f"d{i}", "content": f"alpha beta doc {i}"}) for i in range(10)))
    root = str(tmp_path / "ix")
    env_of("port", "index", str(corpus), "--root", root)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "frankensearch_tpu_torch.cli", "serve", "--root", root, "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        def ask(q):
            proc.stdin.write(json.dumps({"op": "search", "query": q, "k": 3}) + "\n")
            proc.stdin.flush()
            return json.loads(proc.stdout.readline())

        assert all(r["doc_id"] != "new-1" for r in ask("zeppelin fresh")["data"])
        more = tmp_path / "more.jsonl"
        more.write_text(json.dumps({"id": "new-1", "content": "zeppelin fresh external doc"}) + "\n")
        assert env_of("port", "append-batch", str(more), "--root", root)["data"]["appended"] == 1
        after = ask("zeppelin fresh")
        assert after["ok"] and after["data"][0]["doc_id"] == "new-1"
        proc.stdin.write(json.dumps({"op": "status"}) + "\n" + json.dumps({"op": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["data"]["reloads"] == 1
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
