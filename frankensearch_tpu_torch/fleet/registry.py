"""Live fleet registry: serving processes publish heartbeats to a shared
directory; the fleet console reconciles them into true node states.

Parity target: reference crates/frankensearch-ops/src/discovery.rs —
heartbeat reconciliation of real serve/daemon processes (PID liveness +
heartbeat staleness decide health), with the simulator remaining the
deterministic test double (simulator.rs role).

Wire format: one ``<node_id>.node.json`` per process, written atomically
(tmp + os.replace) so readers never see torn JSON:

    {"node_id", "pid", "host", "root", "generation_id", "started_at",
     "at": <heartbeat unix-s>, "qps", "p50_ms", "p99_ms",
     "hbm_used_frac", "queue_pressure", "doc_count", "errors"}

A node is healthy iff its pid is alive AND its heartbeat is fresher than
``stale_after_s`` (a live-but-wedged process goes unhealthy when its
publisher thread stops beating — the discovery.rs staleness ladder).

Faults are not published as data. A failure of ``status_fn`` (a read of
the card's memory, the index's doc count) propagates from ``publish``,
and so from ``start()``. The beat thread survives an ``OSError`` (a full
disk) and stops at any other exception, which it keeps: ``check()`` and
``close()`` raise it, so the serving loop that owns the registrar exits
with the fault instead of publishing zeros for a card it could not read.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Callable

from frankensearch_tpu_torch.fleet.datasource import DataSource, NodeInfo, NodeSample
from frankensearch_tpu_torch.runtime.lifecycle import _pid_alive
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

NODE_SUFFIX = ".node.json"
#: wire schema of the node heartbeat file (schemas/fleet-node-v1)
NODE_SCHEMA_VERSION = 1
#: rolling window over which qps / latency percentiles are computed
WINDOW_S = 30.0


class NodeRegistrar:
    """Publishes this process's node file; thread-safe query accounting.

    ``start()`` spawns a daemon publisher thread (an idle server keeps
    beating); ``observe_query`` records served-query latencies;
    ``close()`` removes the node file (a crash leaves it behind — the
    reader's pid-liveness check marks it dead, and ``LiveDataSource``
    reaps files whose pid is gone).
    """

    def __init__(
        self,
        fleet_dir: str,
        node_id: str,
        *,
        root: str = "",
        status_fn: Callable[[], dict] | None = None,
        heartbeat_s: float = 2.0,
    ) -> None:
        # node_id becomes a FILENAME inside the registry: reject path
        # separators / traversal so `--node-id ../../x` cannot write
        # outside the registry dir (generation_root component discipline)
        if (
            not node_id
            or node_id != os.path.basename(node_id)
            or node_id.startswith(".")
            or "/" in node_id or "\\" in node_id or "\x00" in node_id
        ):
            raise ValueError(f"invalid fleet node_id {node_id!r}")
        os.makedirs(fleet_dir, exist_ok=True)
        self.fleet_dir = fleet_dir
        self.node_id = node_id
        self.root = root
        self.status_fn = status_fn
        self.heartbeat_s = heartbeat_s
        self.path = os.path.join(fleet_dir, node_id + NODE_SUFFIX)
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._lat_ms: deque[tuple[float, float]] = deque()
        self._errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: the exception that stopped the beat thread, raised by check()
        self._fault: Exception | None = None

    # -- accounting ---------------------------------------------------------

    def observe_query(self, latency_ms: float, n: int = 1) -> None:
        """Record ``n`` queries served in one dispatch of ``latency_ms``."""
        now = time.time()
        with self._lock:
            for _ in range(max(n, 1)):
                self._lat_ms.append((now, float(latency_ms)))
            self._trim(now)

    def observe_error(self) -> None:
        with self._lock:
            self._errors += 1

    def _trim(self, now: float) -> None:
        while self._lat_ms and now - self._lat_ms[0][0] > WINDOW_S:
            self._lat_ms.popleft()

    def _window_stats(self) -> tuple[float, float, float]:
        now = time.time()
        with self._lock:
            self._trim(now)
            lats = sorted(l for _, l in self._lat_ms)
        if not lats:
            return 0.0, 0.0, 0.0
        span = min(WINDOW_S, max(now - self.started_at, 1e-3))
        qps = len(lats) / span
        p50 = lats[len(lats) // 2]
        p99 = lats[min(int(len(lats) * 0.99), len(lats) - 1)]
        return qps, p50, p99

    # -- publication --------------------------------------------------------

    def publish(self) -> None:
        status = {} if self.status_fn is None else dict(self.status_fn())
        qps, p50, p99 = self._window_stats()
        with self._lock:
            errors = self._errors
        payload = {
            "v": NODE_SCHEMA_VERSION,
            "node_id": self.node_id,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "root": self.root,
            "generation_id": str(status.get("generation_id", "")),
            "started_at": self.started_at,
            "at": time.time(),
            "qps": round(qps, 2),
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
            "hbm_used_frac": float(status.get("hbm_used_frac", 0.0)),
            "queue_pressure": float(status.get("queue_pressure", 0.0)),
            "doc_count": int(status.get("doc_count", 0)),
            "errors": errors,
        }
        atomic_write_text(self.path, json.dumps(payload))

    def start(self) -> "NodeRegistrar":
        self.publish()
        self._thread = threading.Thread(
            target=self._beat, daemon=True, name=f"fleet-beat-{self.node_id}"
        )
        self._thread.start()
        return self

    def _beat(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.publish()
            except OSError:
                continue  # a full disk must not kill the serving loop
            except Exception as e:  # noqa: BLE001 - kept, raised by check()
                self._fault = e
                return

    def check(self) -> None:
        """Raise the exception that stopped the beat thread, if any."""
        if self._fault is not None:
            raise self._fault

    def close(self) -> None:
        """Stop beating and remove the node file; then raise the beat
        thread's fault, if it had one."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.heartbeat_s * 2)
            self._thread = None
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
        self.check()

    def __enter__(self) -> "NodeRegistrar":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class LiveDataSource(DataSource):
    """Reconciles a registry directory of real processes into the fleet
    console's DataSource contract (discovery.rs role)."""

    def __init__(self, fleet_dir: str, *, stale_after_s: float = 15.0,
                 reap_dead: bool = True) -> None:
        self.fleet_dir = fleet_dir
        self.stale_after_s = stale_after_s
        self.reap_dead = reap_dead

    def _records(self, *, reap: bool = False) -> list[dict]:
        out = []
        try:
            names = sorted(os.listdir(self.fleet_dir))
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(NODE_SUFFIX):
                continue
            path = os.path.join(self.fleet_dir, name)
            try:
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # torn/ vanished — skip this cycle
            if not isinstance(rec, dict) or "node_id" not in rec:
                continue
            if rec.get("v", 1) != NODE_SCHEMA_VERSION:
                continue  # foreign/future wire version: not ours to judge
            # hostile/malformed pid must not crash the listing, and a
            # MISSING pid must read as dead (os.kill(-1, 0) would probe
            # the whole process group and report alive forever)
            try:
                pid = int(rec.get("pid", 0))
            except (TypeError, ValueError):
                pid = 0
            rec["_alive"] = pid > 0 and _pid_alive(pid)
            if not rec["_alive"] and reap and self.reap_dead:
                # crash leftovers: reap so dead nodes age out of the
                # console after being reported once. Only nodes() reaps —
                # samples() reaping first would delete a crashed node
                # before nodes() ever reported it DOWN (review finding).
                try:
                    os.remove(path)
                except OSError:
                    pass
            out.append(rec)
        return out

    def nodes(self) -> list[NodeInfo]:
        now = time.time()
        out = []
        for rec in self._records(reap=True):
            hb = float(rec.get("at", 0.0))
            healthy = bool(rec["_alive"]) and (now - hb) <= self.stale_after_s
            out.append(
                NodeInfo(
                    node_id=str(rec["node_id"]),
                    host=str(rec.get("host", "?")),
                    generation_id=str(rec.get("generation_id", "")),
                    healthy=healthy,
                    last_heartbeat_s=hb,
                )
            )
        return out

    def samples(self) -> list[NodeSample]:
        out = []
        for rec in self._records():
            try:
                out.append(
                    NodeSample(
                        node_id=str(rec["node_id"]),
                        at_s=float(rec.get("at", 0.0)),
                        qps=float(rec.get("qps", 0.0)),
                        p50_ms=float(rec.get("p50_ms", 0.0)),
                        p99_ms=float(rec.get("p99_ms", 0.0)),
                        hbm_used_frac=float(rec.get("hbm_used_frac", 0.0)),
                        queue_pressure=float(rec.get("queue_pressure", 0.0)),
                        doc_count=int(rec.get("doc_count", 0)),
                        errors=int(rec.get("errors", 0)),
                    )
                )
            except (TypeError, ValueError):
                continue
        return out
