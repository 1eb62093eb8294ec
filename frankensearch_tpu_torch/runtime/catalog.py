"""Incremental indexing catalog with changelog replay classification.

Parity target: reference crates/frankensearch-fsfs/src/catalog.rs —
a sqlite catalog of known files (fsfs_catalog_files) + an append-only
changelog; on startup the changelog replays against the filesystem and
each entry is classified (``ReplayDecision``): still-dirty, already
clean, superseded, or tombstoned, yielding the dirty set to re-index.
"""

from __future__ import annotations

import enum
import sqlite3
import threading
import time
from dataclasses import dataclass

_SCHEMA = """
CREATE TABLE IF NOT EXISTS catalog_files (
    path TEXT PRIMARY KEY,
    mtime REAL NOT NULL,
    size INTEGER NOT NULL,
    indexed_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS changelog (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    path TEXT NOT NULL,
    op TEXT NOT NULL,           -- 'dirty' | 'tombstone'
    mtime REAL,
    size INTEGER,
    logged_at REAL NOT NULL,
    applied INTEGER NOT NULL DEFAULT 0
);
"""


class ReplayDecision(enum.Enum):
    REINDEX = "reindex"  # still dirty: file differs from catalog
    CLEAN = "clean"  # catalog already matches the file
    SUPERSEDED = "superseded"  # a later changelog entry covers this path
    TOMBSTONE = "tombstone"  # file deleted: remove from index
    VANISHED = "vanished"  # dirty entry but file no longer exists


@dataclass(frozen=True)
class ReplayItem:
    path: str
    decision: ReplayDecision
    seq: int


class IndexCatalog:
    def __init__(self, db_path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    # -- writes -----------------------------------------------------------

    def log_dirty(self, path: str, mtime: float, size: int) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO changelog (path, op, mtime, size, logged_at) VALUES (?, 'dirty', ?, ?, ?)",
                (path, mtime, size, time.time()),
            )
            return int(cur.lastrowid)

    def log_tombstone(self, path: str) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO changelog (path, op, logged_at) VALUES (?, 'tombstone', ?)",
                (path, time.time()),
            )
            return int(cur.lastrowid)

    def mark_indexed(self, path: str, mtime: float, size: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO catalog_files (path, mtime, size, indexed_at)
                   VALUES (?, ?, ?, ?)
                   ON CONFLICT(path) DO UPDATE SET
                     mtime=excluded.mtime, size=excluded.size,
                     indexed_at=excluded.indexed_at""",
                (path, mtime, size, time.time()),
            )
            self._conn.execute(
                "UPDATE changelog SET applied = 1 WHERE path = ?", (path,)
            )

    def remove(self, path: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM catalog_files WHERE path = ?", (path,))
            self._conn.execute("UPDATE changelog SET applied = 1 WHERE path = ?", (path,))

    # -- replay -----------------------------------------------------------------

    def replay(self, stat_fn=None) -> list[ReplayItem]:
        """Classify every unapplied changelog entry. stat_fn(path) ->
        (mtime, size) | None; defaults to os.stat."""
        import os

        if stat_fn is None:

            def stat_fn(path):
                try:
                    st = os.stat(path)
                    return (st.st_mtime, st.st_size)
                except OSError:
                    return None

        with self._lock:
            rows = self._conn.execute(
                "SELECT seq, path, op FROM changelog WHERE applied = 0 ORDER BY seq"
            ).fetchall()
            catalog = {
                r[0]: (r[1], r[2])
                for r in self._conn.execute(
                    "SELECT path, mtime, size FROM catalog_files"
                ).fetchall()
            }
        latest_seq: dict[str, int] = {}
        for seq, path, _ in rows:
            latest_seq[path] = seq
        out: list[ReplayItem] = []
        for seq, path, op in rows:
            if latest_seq[path] != seq:
                out.append(ReplayItem(path, ReplayDecision.SUPERSEDED, seq))
                continue
            if op == "tombstone":
                out.append(ReplayItem(path, ReplayDecision.TOMBSTONE, seq))
                continue
            current = stat_fn(path)
            if current is None:
                out.append(ReplayItem(path, ReplayDecision.VANISHED, seq))
                continue
            known = catalog.get(path)
            if known is not None and abs(known[0] - current[0]) < 1e-6 and known[1] == current[1]:
                out.append(ReplayItem(path, ReplayDecision.CLEAN, seq))
            else:
                out.append(ReplayItem(path, ReplayDecision.REINDEX, seq))
        return out

    def dirty_set(self, stat_fn=None) -> list[str]:
        return [
            item.path for item in self.replay(stat_fn)
            if item.decision is ReplayDecision.REINDEX
        ]

    def known_count(self) -> int:
        with self._lock:
            return int(self._conn.execute("SELECT COUNT(*) FROM catalog_files").fetchone()[0])
