"""Persistent job queue: claim / complete / retry with worker leases.

Parity target: reference crates/frankensearch-storage/src/job_queue.rs —
``PersistentJobQueue``: jobs survive restarts, workers claim with an id +
lease, failures retry with attempt counting up to max_attempts, expired
leases are reclaimed.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    kind TEXT NOT NULL,
    payload_json TEXT NOT NULL,
    state TEXT NOT NULL DEFAULT 'pending',     -- pending | claimed | done | failed
    attempts INTEGER NOT NULL DEFAULT 0,
    max_attempts INTEGER NOT NULL DEFAULT 3,
    worker_id TEXT,
    lease_expires_at REAL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    last_error TEXT
);
CREATE INDEX IF NOT EXISTS idx_jobs_state ON jobs(state);
"""


@dataclass(frozen=True)
class Job:
    job_id: int
    kind: str
    payload: Mapping[str, Any]
    attempts: int


class PersistentJobQueue:
    def __init__(self, path: str = ":memory:", lease_s: float = 60.0) -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._lock = threading.RLock()
        self.lease_s = lease_s
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def enqueue(self, kind: str, payload: Mapping[str, Any], max_attempts: int = 3) -> int:
        now = time.time()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO jobs (kind, payload_json, max_attempts, created_at, updated_at)"
                " VALUES (?, ?, ?, ?, ?)",
                (kind, json.dumps(dict(payload)), max_attempts, now, now),
            )
            return int(cur.lastrowid)

    def claim(self, worker_id: str, kinds: list[str] | None = None) -> Job | None:
        """Claim the oldest runnable job: pending, or claimed with an
        expired lease (crash reclaim)."""
        now = time.time()
        with self._lock, self._conn:
            q = (
                "SELECT id, kind, payload_json, attempts FROM jobs"
                " WHERE (state = 'pending' OR (state = 'claimed' AND lease_expires_at < ?))"
            )
            args: list[Any] = [now]
            if kinds:
                q += f" AND kind IN ({','.join('?' * len(kinds))})"
                args.extend(kinds)
            q += " ORDER BY id LIMIT 1"
            row = self._conn.execute(q, args).fetchone()
            if row is None:
                return None
            self._conn.execute(
                "UPDATE jobs SET state='claimed', worker_id=?, lease_expires_at=?,"
                " attempts = attempts + 1, updated_at=? WHERE id=?",
                (worker_id, now + self.lease_s, now, row[0]),
            )
            return Job(job_id=row[0], kind=row[1], payload=json.loads(row[2]), attempts=row[3] + 1)

    def complete(self, job_id: int, worker_id: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE jobs SET state='done', updated_at=? WHERE id=? AND worker_id=? AND state='claimed'",
                (time.time(), job_id, worker_id),
            )
            return cur.rowcount > 0

    def fail(self, job_id: int, worker_id: str, error: str) -> str:
        """Returns the job's new state: 'pending' (will retry) or 'failed'."""
        now = time.time()
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT attempts, max_attempts FROM jobs WHERE id=? AND worker_id=?",
                (job_id, worker_id),
            ).fetchone()
            if row is None:
                return "unknown"
            attempts, max_attempts = row
            new_state = "failed" if attempts >= max_attempts else "pending"
            self._conn.execute(
                "UPDATE jobs SET state=?, last_error=?, worker_id=NULL,"
                " lease_expires_at=NULL, updated_at=? WHERE id=?",
                (new_state, error, now, job_id),
            )
            return new_state

    def counts(self) -> dict[str, int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT state, COUNT(*) FROM jobs GROUP BY state"
            ).fetchall()
        return {state: n for state, n in rows}

    def pending_count(self) -> int:
        return self.counts().get("pending", 0)

    def pending_payloads(self, kind: str, limit: int = 1000) -> list[Mapping[str, Any]]:
        """Pending payloads of one kind (e.g. 'reingest' jobs surfaced by
        flush as operator actions)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT payload_json FROM jobs WHERE kind=? AND state='pending' "
                "ORDER BY id LIMIT ?",
                (kind, limit),
            ).fetchall()
        out = []
        for (payload,) in rows:
            try:
                out.append(json.loads(payload))
            except ValueError:
                continue
        return out
