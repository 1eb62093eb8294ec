"""Fleet telemetry materialization into sqlite.

Parity target: reference crates/frankensearch-ops/src/storage.rs —
telemetry samples materialized into an ops database with per-node
rollups queried by the console screens.
"""

from __future__ import annotations

import sqlite3
import threading
from dataclasses import dataclass
from typing import Iterable

from frankensearch_tpu_torch.fleet.datasource import NodeSample

_SCHEMA = """
CREATE TABLE IF NOT EXISTS samples (
    node_id TEXT NOT NULL,
    at_s REAL NOT NULL,
    qps REAL, p50_ms REAL, p99_ms REAL,
    hbm_used_frac REAL, queue_pressure REAL,
    doc_count INTEGER, errors INTEGER
);
CREATE INDEX IF NOT EXISTS idx_samples_node ON samples(node_id, at_s);
"""


@dataclass(frozen=True)
class NodeRollup:
    node_id: str
    samples: int
    mean_qps: float
    max_p99_ms: float
    total_errors: int
    last_at_s: float


class FleetStore:
    def __init__(self, path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def ingest(self, samples: Iterable[NodeSample]) -> int:
        rows = [
            (s.node_id, s.at_s, s.qps, s.p50_ms, s.p99_ms,
             s.hbm_used_frac, s.queue_pressure, s.doc_count, s.errors)
            for s in samples
        ]
        with self._lock, self._conn:
            self._conn.executemany(
                "INSERT INTO samples VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)", rows
            )
        return len(rows)

    def rollups(self) -> list[NodeRollup]:
        with self._lock:
            rows = self._conn.execute(
                """SELECT node_id, COUNT(*), AVG(qps), MAX(p99_ms),
                          SUM(errors), MAX(at_s)
                   FROM samples GROUP BY node_id ORDER BY node_id"""
            ).fetchall()
        return [
            NodeRollup(
                node_id=r[0], samples=r[1], mean_qps=r[2] or 0.0,
                max_p99_ms=r[3] or 0.0, total_errors=r[4] or 0, last_at_s=r[5] or 0.0,
            )
            for r in rows
        ]

    def fleet_qps(self) -> float:
        with self._lock:
            row = self._conn.execute(
                """SELECT SUM(q) FROM (
                     SELECT node_id, AVG(qps) AS q FROM samples GROUP BY node_id
                   )"""
            ).fetchone()
        return float(row[0] or 0.0)

    def close(self) -> None:
        self._conn.close()
