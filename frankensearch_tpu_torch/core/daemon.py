"""Warm-inference daemon protocol: schemas + client with retry/jitter.

Parity target: reference crates/frankensearch-core/src/daemon.rs —
daemon client protocol for warm embedding/rerank inference over a unix
socket: challenge/attestation handshake V1 (the daemon proves it serves
the expected model identity before any query is sent), NDJSON request/
response frames, bounded retry with jitter.

The daemon is how several CLI processes share one card: a single server
process owns the device and keeps its embedder warm; clients embed via
the socket instead of loading an embedder and a CUDA context of their
own.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import random
import socket
import threading
import time

#: request-size caps (local-trust boundary, but a typo'd client must get
#: a typed error, not an allocation storm)
MAX_EMBED_TEXTS = 4096
MAX_TEXT_CHARS = 100_000
from dataclasses import dataclass

from frankensearch_tpu_torch.core.errors import EmbeddingFailed, SubsystemError

PROTOCOL_VERSION = 1


@dataclass(frozen=True)
class Challenge:
    nonce: str

    def to_json(self) -> str:
        return json.dumps({"v": PROTOCOL_VERSION, "op": "challenge", "nonce": self.nonce})


@dataclass(frozen=True)
class Attestation:
    """Daemon's identity proof: HMAC(nonce, key=identity fingerprint).

    The 'secret' is the embedder identity fingerprint both sides can
    compute — this is model-identity attestation (a client refuses a
    daemon serving the wrong model), not an auth boundary."""

    embedder_id: str
    revision: str
    dim: int
    mac: str

    @staticmethod
    def compute(nonce: str, embedder_id: str, revision: str, dim: int) -> "Attestation":
        key = f"{embedder_id}@{revision}#{dim}".encode()
        mac = hmac.new(key, nonce.encode(), hashlib.sha256).hexdigest()
        return Attestation(embedder_id=embedder_id, revision=revision, dim=dim, mac=mac)

    def verify(self, nonce: str, expected_id: str, expected_rev: str, expected_dim: int) -> bool:
        if self.embedder_id != expected_id or self.dim != expected_dim:
            return False
        if expected_rev and self.revision and self.revision != expected_rev:
            return False
        expected = Attestation.compute(nonce, self.embedder_id, self.revision, self.dim)
        return hmac.compare_digest(self.mac, expected.mac)


@dataclass
class RetryPolicy:
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 1.0
    jitter: float = 0.25

    def delays(self, rng: random.Random | None = None):
        rng = rng or random.Random()
        d = self.base_delay_s
        for _ in range(self.max_attempts):
            yield d * (1.0 + self.jitter * rng.random())
            d = min(d * 2, self.max_delay_s)


class DaemonClient:
    """Unix-socket NDJSON client for embed/rerank requests."""

    def __init__(
        self,
        socket_path: str,
        *,
        expect_embedder_id: str = "",
        expect_revision: str = "",
        expect_dim: int = 0,
        timeout_s: float = 5.0,
        retry: RetryPolicy | None = None,
    ) -> None:
        self.socket_path = socket_path
        self.expect = (expect_embedder_id, expect_revision, expect_dim)
        self.timeout_s = timeout_s
        self.retry = retry or RetryPolicy()

    def _request(self, payload: dict) -> dict:
        last_err: Exception | None = None
        for delay in self.retry.delays():
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(self.timeout_s)
                    s.connect(self.socket_path)
                    f = s.makefile("rw", encoding="utf-8")
                    # challenge/attestation handshake
                    nonce = os.urandom(16).hex()
                    f.write(Challenge(nonce).to_json() + "\n")
                    f.flush()
                    att_raw = json.loads(f.readline())
                    att = Attestation(
                        embedder_id=att_raw["embedder_id"],
                        revision=att_raw.get("revision", ""),
                        dim=att_raw["dim"],
                        mac=att_raw["mac"],
                    )
                    exp_id, exp_rev, exp_dim = self.expect
                    if exp_id and not att.verify(nonce, exp_id, exp_rev, exp_dim):
                        raise EmbeddingFailed(
                            f"daemon attestation mismatch: serves {att.embedder_id}@{att.revision}"
                        )
                    f.write(json.dumps(payload) + "\n")
                    f.flush()
                    resp = json.loads(f.readline())
                    if not resp.get("ok", False):
                        raise SubsystemError(str(resp.get("error")))
                    return resp
            except (OSError, json.JSONDecodeError) as e:
                last_err = e
                time.sleep(delay)
        raise SubsystemError(f"daemon unreachable after retries: {last_err}")

    def embed(self, texts: list[str]) -> list[list[float]]:
        resp = self._request({"op": "embed", "texts": texts})
        return resp["vectors"]

    def ping(self) -> bool:
        try:
            self._request({"op": "ping"})
            return True
        except SubsystemError:
            return False


class DaemonServer:
    """Single-threaded unix-socket server wrapping a local embedder."""

    def __init__(self, socket_path: str, embedder) -> None:
        self.socket_path = socket_path
        self.embedder = embedder
        self._sock: socket.socket | None = None
        self.requests_served = 0

    def __enter__(self) -> "DaemonServer":
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(8)
        return self

    def __exit__(self, *exc) -> None:
        if self._sock is not None:
            self._sock.close()
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)

    def _embed_texts(self, texts: list[str]):
        """Embed hook — the threaded server routes through the coalescer."""
        return self.embedder.embed_batch(texts)

    def _count_served(self) -> None:
        self.requests_served += 1

    def serve_one(self, timeout_s: float = 5.0) -> bool:
        assert self._sock is not None
        self._sock.settimeout(timeout_s)
        try:
            conn, _ = self._sock.accept()
        except socket.timeout:
            return False
        self._handle_conn(conn, timeout_s)
        return True

    def _handle_conn(self, conn, timeout_s: float) -> None:
        with conn:
            # per-connection deadline: a silent/wedged client must not
            # freeze the single-threaded daemon forever (probe: a
            # connect-and-send-nothing client hung serve_one past every
            # idle/max-request bound; socket.timeout is an OSError so the
            # existing typed-error path drops the connection)
            conn.settimeout(timeout_s)
            f = conn.makefile("rw", encoding="utf-8")
            try:
                challenge = json.loads(f.readline())
                att = Attestation.compute(
                    challenge["nonce"],
                    self.embedder.embedder_id,
                    self.embedder.revision,
                    self.embedder.dim,
                )
                f.write(
                    json.dumps(
                        {
                            "embedder_id": att.embedder_id,
                            "revision": att.revision,
                            "dim": att.dim,
                            "mac": att.mac,
                        }
                    )
                    + "\n"
                )
                f.flush()
                req = json.loads(f.readline())
                if req.get("op") == "embed":
                    texts = req["texts"]
                    if not isinstance(texts, list) or len(texts) > MAX_EMBED_TEXTS:
                        raise ValueError(
                            f"texts must be a list of <= {MAX_EMBED_TEXTS}"
                        )
                    if any(
                        not isinstance(t, str) or len(t) > MAX_TEXT_CHARS
                        for t in texts
                    ):
                        raise ValueError(
                            f"each text must be a str of <= {MAX_TEXT_CHARS} chars"
                        )
                    vecs = self._embed_texts(texts)
                    f.write(json.dumps({"ok": True, "vectors": vecs.tolist()}) + "\n")
                elif req.get("op") == "ping":
                    f.write(json.dumps({"ok": True}) + "\n")
                else:
                    f.write(json.dumps({"ok": False, "error": "unknown op"}) + "\n")
                f.flush()
                self._count_served()
            except (json.JSONDecodeError, KeyError, OSError,
                    TypeError, AttributeError, ValueError) as e:
                # TypeError/AttributeError: valid JSON that is not the
                # expected object shape (e.g. an array challenge) must
                # not kill the daemon — same protocol-fuzz class as the
                # NDJSON serve fix
                try:
                    f.write(json.dumps({"ok": False, "error": str(e)}) + "\n")
                    f.flush()
                except OSError:
                    pass


class ThreadedDaemonServer(DaemonServer):
    """Multi-connection daemon: an accept loop hands each connection to a
    worker thread and ALL embed work funnels through one BatchCoalescer,
    so N concurrent clients' requests ride shared device batches
    (reference batch_coalescer.rs: Interactive flushes at max_wait/2,
    measured 29x MiniLM throughput at batch 32 — on the card batching is
    the tensor-core utilization lever). The single-threaded base class remains the
    default; this is opt-in via `daemon --concurrency N`."""

    def __init__(
        self,
        socket_path: str,
        embedder,
        *,
        concurrency: int = 4,
        max_batch: int = 64,
        max_wait_ms: float = 10.0,
    ) -> None:
        super().__init__(socket_path, embedder)
        from concurrent.futures import ThreadPoolExecutor

        from frankensearch_tpu_torch.embed.coalescer import BatchCoalescer

        self.coalescer = BatchCoalescer(
            embedder, max_batch=max_batch, max_wait_ms=max_wait_ms
        )
        self._pool = ThreadPoolExecutor(
            max_workers=max(concurrency, 1), thread_name_prefix="fs-daemon"
        )
        self._served_lock = threading.Lock()

    def _embed_texts(self, texts: list[str]):
        import numpy as np

        futures = [self.coalescer.submit(t) for t in texts]
        return np.stack([f.result() for f in futures]) if futures else np.empty((0, 0))

    def _count_served(self) -> None:
        with self._served_lock:
            self.requests_served += 1

    def serve_one(self, timeout_s: float = 5.0) -> bool:
        assert self._sock is not None
        self._sock.settimeout(timeout_s)
        try:
            conn, _ = self._sock.accept()
        except socket.timeout:
            return False
        self._pool.submit(self._handle_conn, conn, timeout_s)
        return True

    def __exit__(self, *exc) -> None:
        self._pool.shutdown(wait=True)
        self.coalescer.close()
        super().__exit__(*exc)
