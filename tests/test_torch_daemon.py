"""The port's warm-embedding daemon (``core/daemon.py``,
``embed/coalescer.py``, ``fusion/daemon_fallback.py``, the ``daemon``
command and ``search --daemon-socket``) against the JAX package's on the CPU.

Oracles: tests/test_aux_subsystems.py's daemon cases (attestation, a silent
client cannot wedge the daemon, malformed payloads fall back, concurrent
clients coalesce), tests/test_fusion_aux.py's coalescer cases,
tests/test_cli_e2e.py::test_wal_poll_daemon_compacts and
tests/test_cli_federated.py's daemon cases (live, dead and mismatched
daemon). The wire protocol is held both ways: a port client against a
reference server, and a reference client against a port server; the
vectors are bitwise the local embedder's. Every wait has a limit:
``serve_one(timeout_s=...)``, socket timeouts, ``join(timeout=10)``, and
the daemon command runs with ``--idle-timeout``.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import frankensearch_tpu.core.daemon as ref_daemon
import frankensearch_tpu.embed.coalescer as ref_coalescer
import frankensearch_tpu.embed.hash_embedder as ref_hash
import frankensearch_tpu.fusion.daemon_fallback as ref_fallback
import frankensearch_tpu_torch.core.daemon as port_daemon
import frankensearch_tpu_torch.embed.coalescer as port_coalescer
import frankensearch_tpu_torch.embed.hash_embedder as port_hash
import frankensearch_tpu_torch.fusion.daemon_fallback as port_fallback
from tests.test_torch_cli import (  # noqa: F401
    both, env_of, no_pallas, reference_logger_untouched, run, same_rows,
)

PKG = {"port": (port_daemon, port_hash, port_fallback, port_coalescer),
       "ref": (ref_daemon, ref_hash, ref_fallback, ref_coalescer)}
TEXTS = ["hello world", "warm embedding daemon", "", "ünïcödé text"]


def pump(server, stop: threading.Event) -> threading.Thread:
    def loop():
        while not stop.is_set():
            server.serve_one(timeout_s=0.2)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def test_attestation_equals_reference():
    for daemon in (port_daemon, ref_daemon):
        att = daemon.Attestation.compute("nonce1", "emb", "r1", 64)
        assert att.verify("nonce1", "emb", "r1", 64)
        assert not att.verify("nonce2", "emb", "r1", 64) and not att.verify("nonce1", "other", "r1", 64)
    assert port_daemon.Attestation.compute("n", "e", "r", 8) == port_daemon.Attestation(
        **vars(ref_daemon.Attestation.compute("n", "e", "r", 8)))
    assert port_daemon.Challenge("n").to_json() == ref_daemon.Challenge("n").to_json()


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "port"), ("port", "ref"), ("ref", "port")],
                         ids=["port-port", "port-server-ref-client", "ref-server-port-client"])
def test_wire_protocol_both_ways(tmp_path, server_pkg, client_pkg):
    """A client of one package against a server of the other: the
    handshake attests, the vectors are bitwise the local embedder's."""
    server_daemon, server_hash = PKG[server_pkg][:2]
    client_daemon = PKG[client_pkg][0]
    sock = str(tmp_path / "d.sock")
    emb = server_hash.HashEmbedder(dim=32)
    with server_daemon.DaemonServer(sock, emb) as server:
        t = threading.Thread(target=lambda: [server.serve_one(timeout_s=5.0) for _ in range(2)])
        t.start()
        client = client_daemon.DaemonClient(sock, expect_embedder_id=emb.embedder_id,
                                            expect_revision=emb.revision, expect_dim=32)
        vecs = client.embed(TEXTS)
        assert client.ping()
        t.join(timeout=10)
        assert not t.is_alive() and server.requests_served == 2
    local = port_hash.HashEmbedder(dim=32).embed_batch(TEXTS)
    got = np.asarray(vecs, dtype=np.float32)
    assert got.tobytes() == local.tobytes()
    assert local.tobytes() == ref_hash.HashEmbedder(dim=32).embed_batch(TEXTS).tobytes()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_wrong_identity_refused(tmp_path, pkg):
    daemon, hashing = PKG[pkg][:2]
    sock = str(tmp_path / "d.sock")
    with daemon.DaemonServer(sock, hashing.HashEmbedder(dim=32)) as server:
        t = threading.Thread(target=lambda: server.serve_one(timeout_s=1.0))
        t.start()
        client = daemon.DaemonClient(sock, expect_embedder_id="different-model", expect_dim=32,
                                     retry=daemon.RetryPolicy(max_attempts=1))
        with pytest.raises(Exception, match="attestation mismatch") as e:
            client.embed(["x"])
        t.join(timeout=10)
    assert type(e.value).__name__ == "EmbeddingFailed"


def test_silent_client_cannot_wedge_the_daemon(tmp_path):
    sock = str(tmp_path / "d.sock")
    with port_daemon.DaemonServer(sock, port_hash.HashEmbedder(dim=32)) as server:
        results = []
        t = threading.Thread(target=lambda: results.extend(server.serve_one(timeout_s=0.5) for _ in range(3)))
        t.start()
        wedger = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        wedger.connect(sock)  # ... and say nothing
        time.sleep(0.8)
        vecs = port_daemon.DaemonClient(sock).embed(["still serving"])
        wedger.close()
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(vecs) == 1


def malformed_replies(pkg, sock) -> list:
    daemon, hashing = PKG[pkg][:2]
    replies = []
    with daemon.DaemonServer(sock, hashing.HashEmbedder(dim=32)) as server:
        for req in ({"op": "embed", "texts": ["t"] * 99_999}, {"op": "embed", "texts": [1]}, {"op": "nope"}):
            t = threading.Thread(target=lambda: server.serve_one(timeout_s=5.0))
            t.start()
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                c.settimeout(5.0)
                c.connect(sock)
                f = c.makefile("rw", encoding="utf-8")
                f.write(json.dumps({"nonce": "x"}) + "\n")
                f.flush()
                replies.append(json.loads(f.readline()))
                f.write(json.dumps(req) + "\n")
                f.flush()
                replies.append(json.loads(f.readline()))
            t.join(timeout=10)
    return replies


def test_oversized_and_malformed_requests_equal_reference(tmp_path):
    """Every reply line (attestations, typed errors) equal between the packages."""
    got = malformed_replies("port", str(tmp_path / "p.sock"))
    assert got == malformed_replies("ref", str(tmp_path / "r.sock"))
    assert got[1] == {"ok": False, "error": "texts must be a list of <= 4096"}
    assert got[3]["ok"] is False and got[5] == {"ok": False, "error": "unknown op"}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_fallback_to_local(tmp_path, pkg):
    daemon, hashing, fallback, _ = PKG[pkg]
    emb = hashing.HashEmbedder(dim=32)
    client = daemon.DaemonClient(str(tmp_path / "missing.sock"), timeout_s=0.2)
    client.retry.max_attempts = 1
    fb = fallback.DaemonFallbackEmbedder(client, emb)
    assert fb.embed_batch(["text"]).tobytes() == emb.embed_batch(["text"]).tobytes()
    assert fb.stats.local_fallbacks == 1
    fb.embed_batch(["more"])  # marked down: the socket is skipped
    assert fb.stats.local_fallbacks == 2 and fb.embed_batch([]).shape == (0, 32)


@pytest.mark.parametrize("payload_fn", [
    lambda n, d: [[0.1] * d] * (n - 1),
    lambda n, d: [[0.1] * (d // 2)] * n,
    lambda n, d: [[float("nan")] * d] * n,
    lambda n, d: [[0.1] * d, [0.1] * (d // 2)],
], ids=["short_count", "wrong_dim", "nan", "ragged"])
def test_malformed_daemon_payload_falls_back(payload_fn):
    emb = port_hash.HashEmbedder(dim=32)

    class EvilClient:
        def embed(self, texts):
            return payload_fn(len(texts), 32)

    fb = port_fallback.DaemonFallbackEmbedder(EvilClient(), emb)
    assert fb.embed_batch(["a", "b"]).tobytes() == emb.embed_batch(["a", "b"]).tobytes()
    assert fb.stats.local_fallbacks == 1 and fb.stats.daemon_marked_down_at is not None


def test_concurrent_clients_correct_and_coalesced(tmp_path):
    sock = str(tmp_path / "d.sock")
    emb = port_hash.HashEmbedder(dim=32)
    results: dict = {}
    with port_daemon.ThreadedDaemonServer(sock, emb, concurrency=8, max_wait_ms=60.0) as server:
        stop = threading.Event()
        acceptor = pump(server, stop)

        def client(i):
            c = port_daemon.DaemonClient(sock, expect_embedder_id=emb.embedder_id,
                                         expect_revision=emb.revision, expect_dim=32, timeout_s=10.0)
            results[i] = c.embed([f"text number {i}"])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        stop.set()
        acceptor.join(timeout=10)
        assert server.coalescer.stats.items == 8 and server.coalescer.stats.batches < 8
    assert server.requests_served == 8
    for i in range(8):
        want = emb.embed_batch([f"text number {i}"])
        assert np.asarray(results[i], dtype=np.float32).tobytes() == want.tobytes()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_coalescer(pkg):
    hashing, coalescer = PKG[pkg][1], PKG[pkg][3]
    inner = hashing.HashEmbedder(dim=32)
    co = coalescer.BatchCoalescer(inner, max_batch=16, max_wait_ms=20)
    texts = [f"doc {i}" for i in range(12)]
    futures = [co.submit(t, coalescer.Priority.BACKGROUND) for t in texts]
    got = np.stack([f.result(timeout=5) for f in futures])
    assert got.tobytes() == inner.embed_batch(texts).tobytes()
    assert co.stats.items == 12 and co.stats.batches <= 12
    co.close()
    slow = coalescer.BatchCoalescer(hashing.HashEmbedder(dim=16), max_batch=1024, max_wait_ms=500)
    t0 = time.perf_counter()
    slow.embed("urgent", coalescer.Priority.INTERACTIVE)
    assert time.perf_counter() - t0 < 0.45  # the interactive deadline is max_wait / 2
    slow.close()
    with pytest.raises(RuntimeError, match="closed"):
        slow.submit("x")


# -- the daemon command, --wal-poll and search --daemon-socket ------------------------------------


def write_jsonl(path, docs) -> str:
    with open(path, "w") as f:
        f.writelines(json.dumps({"id": i, "content": c}) + "\n" for i, c in docs)
    return str(path)


DOCS = [("a-rust", "rust ownership borrowing lifetimes compiler"),
        ("a-jax", "jax jit compilation tpu acceleration"),
        ("a-sql", "sqlite btree transactions journal")]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("daemon_roots")
    corpus = write_jsonl(base / "c.jsonl", DOCS)
    out = {}
    for pkg in ("port", "ref"):
        out[pkg] = str(base / f"ix_{pkg}")
        env_of(pkg, "index", corpus, "--root", out[pkg])
    return out


def daemon_cmd_with_clients(pkg, root, sock, n_clients, *extra) -> tuple[dict, list]:
    """The ``daemon`` command in process, ``n_clients`` embeds against it
    from a thread; (its envelope, the vectors)."""
    daemon = PKG[pkg][0]
    got = []

    def clients():
        for _ in range(100):
            if os.path.exists(sock):
                break
            time.sleep(0.05)
        for i in range(n_clients):
            c = daemon.DaemonClient(sock, timeout_s=10.0)
            got.append(c.embed([f"query {i}"]))

    t = threading.Thread(target=clients)
    t.start()
    rc, out = run(pkg, "--format", "json", "daemon", "--root", root, "--socket", sock, "--max-requests",
                  str(n_clients), "--accept-timeout", "0.2", "--idle-timeout", "3", "--quiet", *extra)
    t.join(timeout=10)
    assert rc == 0 and not t.is_alive()
    return json.loads(out), got


@pytest.mark.parametrize("concurrency", ["1", "4"])
def test_daemon_command_equals_reference(roots, tmp_path, concurrency):
    """Divergence: with ``--concurrency`` > 1 the reference's envelope can
    miss the requests its workers were still serving when the loop read
    the count (it reads it only after an accept, and its loop then waits
    out ``--idle-timeout``); the port re-reads the count after an idle
    accept and reports it once the workers have finished, so its loop
    ends one accept timeout after the last request."""
    envs, vecs = {}, {}
    for pkg in ("port", "ref"):
        sock = str(tmp_path / f"{pkg}.sock")
        env, got = daemon_cmd_with_clients(pkg, roots[pkg], sock, 3, "--concurrency", concurrency)
        env["data"]["socket"] = os.path.basename(env["data"]["socket"])[len(pkg):]
        envs[pkg], vecs[pkg] = env, got
        assert not os.path.exists(sock)
    assert envs["port"]["data"]["requests_served"] == 3 and vecs["port"] == vecs["ref"]
    if concurrency == "1":
        assert envs["port"] == envs["ref"]
    else:
        assert envs["ref"]["data"]["requests_served"] <= 3


def test_wal_poll_daemon_compacts_equals_reference(tmp_path):
    corpus = write_jsonl(tmp_path / "c.jsonl", [(f"d{i}", f"alpha doc {i}") for i in range(10)])
    more = write_jsonl(tmp_path / "more.jsonl", [("extra-1", "zeppelin extra doc")])
    roots = {}
    for pkg in ("port", "ref"):
        roots[pkg] = str(tmp_path / f"ix_{pkg}")
        env_of(pkg, "index", corpus, "--root", roots[pkg])
        env_of(pkg, "append-batch", more, "--root", roots[pkg])
        assert os.path.getsize(os.path.join(roots[pkg], "vector.fast.idx.wal")) > 0
    got, want = both("daemon", "--root", "{root}", "--wal-poll", "--cycles", "2", "--poll-ms", "10",
                     "--wal-threshold-bytes", "1", roots=roots)
    assert got == want and got["data"]["compactions"] == 1
    for root in roots.values():
        wal = os.path.join(root, "vector.fast.idx.wal")
        assert not os.path.exists(wal) or os.path.getsize(wal) == 0
    for q in ("alpha doc", "zeppelin extra"):
        got, want = both("search", q, "--root", "{root}", "-k", "3", roots=roots)
        same_rows(got["data"], want["data"])
    assert got["data"][0]["doc_id"] == "extra-1"


def spy_fallbacks(monkeypatch) -> list:
    made = []
    real = port_fallback.DaemonFallbackEmbedder.__init__

    def spy(self, client, local, **kw):
        real(self, client, local, **kw)
        made.append(self)

    monkeypatch.setattr(port_fallback.DaemonFallbackEmbedder, "__init__", spy)
    return made


def test_search_dead_socket_falls_back_to_local(roots, tmp_path, monkeypatch):
    made = spy_fallbacks(monkeypatch)
    got, want = both("search", "rust ownership", "--root", "{root}", "--daemon-socket",
                     str(tmp_path / "no-daemon.sock"), roots=roots)
    same_rows(got["data"], want["data"])
    assert got["data"][0]["doc_id"] == "a-rust"
    assert made and made[0].stats.daemon_hits == 0 and made[0].stats.local_fallbacks >= 1


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_search_through_a_live_daemon_equals_local(roots, tmp_path, monkeypatch, server_pkg):
    """The query embeds through the socket (the fallback's stats prove the
    transport) and the rows equal the local path's, whichever package
    serves the daemon."""
    daemon, hashing = PKG[server_pkg][:2]
    local = env_of("port", "search", "rust ownership", "--root", roots["port"])
    made = spy_fallbacks(monkeypatch)
    sock = str(tmp_path / "emb.sock")
    stop = threading.Event()
    with daemon.DaemonServer(sock, hashing.HashEmbedder(dim=256)) as server:
        t = pump(server, stop)
        try:
            env = env_of("port", "search", "rust ownership", "--root", roots["port"], "--daemon-socket", sock)
        finally:
            stop.set()
            t.join(timeout=10)
    assert env["data"] == local["data"]
    (fb,) = made
    assert fb.stats.daemon_hits >= 1 and fb.stats.local_fallbacks == 0
    assert server.requests_served == fb.stats.daemon_hits


def test_search_mismatched_daemon_falls_back_not_wrong_space(roots, tmp_path, monkeypatch):
    made = spy_fallbacks(monkeypatch)
    sock = str(tmp_path / "wrong.sock")
    stop = threading.Event()
    with port_daemon.DaemonServer(sock, port_hash.HashEmbedder(dim=64)) as server:
        t = pump(server, stop)
        try:
            env = env_of("port", "search", "rust ownership", "--root", roots["port"], "--daemon-socket", sock)
        finally:
            stop.set()
            t.join(timeout=10)
    assert env["data"][0]["doc_id"] == "a-rust"
    assert made[0].stats.daemon_hits == 0 and made[0].stats.local_fallbacks >= 1


def test_fallback_keeps_the_embedder_identity():
    emb = port_hash.HashEmbedder(dim=32)
    fb = port_fallback.DaemonFallbackEmbedder(port_daemon.DaemonClient("/nonexistent.sock"), emb)
    assert (fb.dim, fb.embedder_id, fb.revision, fb.is_semantic) == (
        emb.dim, emb.embedder_id, emb.revision, emb.is_semantic)
