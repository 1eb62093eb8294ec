"""Document metadata store: schema, dedup, history, bookmarks, staleness.

Parity target: reference crates/frankensearch-storage — schema v6
(src/schema.rs:9): ``documents`` (content_hash, preview, metadata),
``embedding_status`` per (doc, embedder), search history + bookmarks
(src/history.rs), index build history (last 100 builds,
src/index_metadata.rs), O(1) pending-count staleness quick check
(src/staleness.rs), blake2-based content-hash change detection
(src/content_hash.rs uses xxh3; the hash choice is an implementation
detail, the dedup contract is what carries over).
"""

from __future__ import annotations

import hashlib
import os
import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

SCHEMA_VERSION = 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS documents (
    doc_id TEXT PRIMARY KEY,
    content_hash TEXT NOT NULL,
    preview TEXT,
    title TEXT,
    metadata_json TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    deleted INTEGER NOT NULL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS idx_documents_hash ON documents(content_hash);
CREATE TABLE IF NOT EXISTS embedding_status (
    doc_id TEXT NOT NULL,
    embedder_id TEXT NOT NULL,
    content_hash TEXT NOT NULL,
    embedded_at REAL NOT NULL,
    PRIMARY KEY (doc_id, embedder_id)
);
CREATE TABLE IF NOT EXISTS search_history (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    query TEXT NOT NULL,
    k INTEGER NOT NULL,
    result_count INTEGER NOT NULL,
    top_doc_id TEXT,
    latency_ms REAL,
    searched_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS bookmarks (
    doc_id TEXT PRIMARY KEY,
    note TEXT,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS index_builds (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    doc_count INTEGER NOT NULL,
    error_count INTEGER NOT NULL,
    duration_ms REAL,
    detail_json TEXT,
    built_at REAL NOT NULL
);
"""


def content_hash(text: str) -> str:
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


@dataclass(frozen=True)
class DocumentRow:
    doc_id: str
    content_hash: str
    preview: str | None
    title: str | None
    metadata: Mapping | None
    deleted: bool


@dataclass(frozen=True)
class StalenessReport:
    """Parity: storage/src/staleness.rs — quick pending count + drift."""

    total_docs: int
    pending: int
    stale: int  # embedded but content hash changed since
    deleted_pending_cleanup: int

    @property
    def is_fresh(self) -> bool:
        return self.pending == 0 and self.stale == 0


class Storage:
    """Thread-safe sqlite-backed metadata store."""

    def __init__(self, path: str = ":memory:") -> None:
        self._lock = threading.RLock()
        self.read_only = False
        try:
            self._conn = sqlite3.connect(path, check_same_thread=False)
            self._conn.execute("PRAGMA journal_mode=WAL")
            with self._lock, self._conn:
                self._conn.executescript(_SCHEMA)
                self._conn.execute(
                    "INSERT OR IGNORE INTO meta (key, value) VALUES ('schema_version', ?)",
                    (str(SCHEMA_VERSION),),
                )
        except sqlite3.OperationalError:
            # a FULL or read-only filesystem refuses the WAL/journal
            # writes even though the db bytes are fine — degrade to a
            # read-only handle instead of refusing to serve (probed:
            # ENOSPC made open_hybrid die here with every artifact
            # intact). Mutations raise SubsystemError; record_search is
            # best-effort.
            if path == ":memory:" or not os.path.exists(path):
                raise
            try:
                self._conn.close()
            except Exception:
                pass
            # mode=ro still needs to create the -shm file for a WAL-mode
            # db; on a READ-ONLY filesystem that fails too, so fall
            # through to immutable=1 (no locking, no wal replay — may
            # serve the last checkpointed snapshot, which degraded mode
            # accepts). sqlite connects lazily: force the open with a
            # real statement so failures surface HERE, not mid-search.
            last: Exception | None = None
            for params in ("mode=ro", "mode=ro&immutable=1"):
                try:
                    self._conn = sqlite3.connect(
                        f"file:{path}?{params}", uri=True, check_same_thread=False
                    )
                    self._conn.execute("SELECT 1 FROM sqlite_master LIMIT 1")
                    break
                except sqlite3.OperationalError as e2:
                    last = e2
                    try:
                        self._conn.close()
                    except Exception:
                        pass
            else:
                raise last  # pragma: no cover - both read-only modes failed
            self.read_only = True

    def _require_writable(self) -> None:
        if self.read_only:
            from frankensearch_tpu_torch.core.errors import SubsystemError

            raise SubsystemError(
                "metadata store is open read-only (disk full or read-only "
                "filesystem at open time) — reopen after freeing space"
            )

    def close(self) -> None:
        self._conn.close()

    # -- documents -----------------------------------------------------------

    def upsert_document(
        self,
        doc_id: str,
        content: str,
        *,
        title: str | None = None,
        metadata: Mapping | None = None,
        preview_chars: int = 240,
    ) -> tuple[bool, str]:
        """Returns (changed, content_hash). Unchanged content is a no-op
        (content-hash dedup, storage/pipeline.rs)."""
        self._require_writable()
        h = content_hash(content)
        now = time.time()
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT content_hash, deleted FROM documents WHERE doc_id = ?", (doc_id,)
            ).fetchone()
            if row is not None and row[0] == h and not row[1]:
                return False, h
            self._conn.execute(
                """INSERT INTO documents
                   (doc_id, content_hash, preview, title, metadata_json, created_at, updated_at, deleted)
                   VALUES (?, ?, ?, ?, ?, ?, ?, 0)
                   ON CONFLICT(doc_id) DO UPDATE SET
                     content_hash=excluded.content_hash, preview=excluded.preview,
                     title=excluded.title, metadata_json=excluded.metadata_json,
                     updated_at=excluded.updated_at, deleted=0""",
                (
                    doc_id,
                    h,
                    content[:preview_chars],
                    title,
                    json.dumps(dict(metadata)) if metadata else None,
                    now,
                    now,
                ),
            )
            return True, h

    def upsert_documents_bulk(
        self,
        rows: Iterable[tuple[str, str, str | None, Mapping | None]],
        *,
        embedder_id: str | None = None,
        preview_chars: int = 240,
    ) -> int:
        """Bulk ingest lane: upsert (doc_id, content, title, metadata)
        rows — and optionally their embedding status — in ONE transaction
        (one fsync instead of one per doc; the >=10k docs/s ingest
        contract needs this). Returns the row count."""
        self._require_writable()
        now = time.time()
        doc_rows = []
        emb_rows = []
        for doc_id, content, title, metadata in rows:
            h = content_hash(content)
            doc_rows.append(
                (
                    doc_id, h, content[:preview_chars], title,
                    json.dumps(dict(metadata)) if metadata else None, now, now,
                )
            )
            if embedder_id is not None:
                emb_rows.append((doc_id, embedder_id, h, now))
        with self._lock, self._conn:
            self._conn.executemany(
                """INSERT INTO documents
                   (doc_id, content_hash, preview, title, metadata_json, created_at, updated_at, deleted)
                   VALUES (?, ?, ?, ?, ?, ?, ?, 0)
                   ON CONFLICT(doc_id) DO UPDATE SET
                     content_hash=excluded.content_hash, preview=excluded.preview,
                     title=excluded.title, metadata_json=excluded.metadata_json,
                     updated_at=excluded.updated_at, deleted=0""",
                doc_rows,
            )
            if emb_rows:
                self._conn.executemany(
                    """INSERT INTO embedding_status (doc_id, embedder_id, content_hash, embedded_at)
                       VALUES (?, ?, ?, ?)
                       ON CONFLICT(doc_id, embedder_id) DO UPDATE SET
                         content_hash=excluded.content_hash, embedded_at=excluded.embedded_at""",
                    emb_rows,
                )
        return len(doc_rows)

    def delete_document(self, doc_id: str) -> bool:
        self._require_writable()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE documents SET deleted = 1, updated_at = ? WHERE doc_id = ?",
                (time.time(), doc_id),
            )
            return cur.rowcount > 0

    def get_document(self, doc_id: str) -> DocumentRow | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT doc_id, content_hash, preview, title, metadata_json, deleted "
                "FROM documents WHERE doc_id = ?",
                (doc_id,),
            ).fetchone()
        if row is None:
            return None
        return DocumentRow(
            doc_id=row[0],
            content_hash=row[1],
            preview=row[2],
            title=row[3],
            metadata=json.loads(row[4]) if row[4] else None,
            deleted=bool(row[5]),
        )

    def doc_count(self, include_deleted: bool = False) -> int:
        q = "SELECT COUNT(*) FROM documents" + ("" if include_deleted else " WHERE deleted = 0")
        with self._lock:
            return int(self._conn.execute(q).fetchone()[0])

    def iter_documents(self) -> Iterable[DocumentRow]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc_id, content_hash, preview, title, metadata_json, deleted "
                "FROM documents WHERE deleted = 0 ORDER BY doc_id"
            ).fetchall()
        for row in rows:
            yield DocumentRow(
                doc_id=row[0], content_hash=row[1], preview=row[2], title=row[3],
                metadata=json.loads(row[4]) if row[4] else None, deleted=bool(row[5]),
            )

    # -- embedding status ------------------------------------------------------

    def mark_embedded(self, doc_id: str, embedder_id: str, hash_value: str) -> None:
        self._require_writable()
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO embedding_status (doc_id, embedder_id, content_hash, embedded_at)
                   VALUES (?, ?, ?, ?)
                   ON CONFLICT(doc_id, embedder_id) DO UPDATE SET
                     content_hash=excluded.content_hash, embedded_at=excluded.embedded_at""",
                (doc_id, embedder_id, hash_value, time.time()),
            )

    def staleness(self, embedder_id: str) -> StalenessReport:
        with self._lock:
            total = self.doc_count()
            pending = int(
                self._conn.execute(
                    """SELECT COUNT(*) FROM documents d
                       WHERE d.deleted = 0 AND NOT EXISTS (
                         SELECT 1 FROM embedding_status e
                         WHERE e.doc_id = d.doc_id AND e.embedder_id = ?)""",
                    (embedder_id,),
                ).fetchone()[0]
            )
            stale = int(
                self._conn.execute(
                    """SELECT COUNT(*) FROM documents d
                       JOIN embedding_status e ON e.doc_id = d.doc_id AND e.embedder_id = ?
                       WHERE d.deleted = 0 AND e.content_hash != d.content_hash""",
                    (embedder_id,),
                ).fetchone()[0]
            )
            deleted_pending = int(
                self._conn.execute(
                    """SELECT COUNT(*) FROM documents d
                       JOIN embedding_status e ON e.doc_id = d.doc_id AND e.embedder_id = ?
                       WHERE d.deleted = 1""",
                    (embedder_id,),
                ).fetchone()[0]
            )
        return StalenessReport(
            total_docs=total, pending=pending, stale=stale,
            deleted_pending_cleanup=deleted_pending,
        )

    # -- history / bookmarks ----------------------------------------------------

    HISTORY_RETAIN = 10_000

    def record_search(
        self, query: str, k: int, result_count: int,
        top_doc_id: str | None = None, latency_ms: float | None = None,
    ) -> None:
        if self.read_only:
            return  # best-effort journaling: serving beats history
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO search_history (query, k, result_count, top_doc_id, latency_ms, searched_at)"
                " VALUES (?, ?, ?, ?, ?, ?)",
                (query, k, result_count, top_doc_id, latency_ms, time.time()),
            )
            # bounded history (history.rs retention contract): without a
            # cap a serving daemon grows metadata.db forever; amortized
            # prune every 512 inserts keeps the hot path one INSERT
            self._history_since_prune = getattr(self, "_history_since_prune", 0) + 1
            if self._history_since_prune >= 512:
                self._history_since_prune = 0
                self._conn.execute(
                    "DELETE FROM search_history WHERE id NOT IN ("
                    " SELECT id FROM search_history ORDER BY id DESC LIMIT ?)",
                    (self.HISTORY_RETAIN,),
                )

    def recent_searches(self, limit: int = 50) -> list[dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT query, k, result_count, top_doc_id, latency_ms, searched_at "
                "FROM search_history ORDER BY id DESC LIMIT ?",
                (limit,),
            ).fetchall()
        return [
            {
                "query": r[0], "k": r[1], "result_count": r[2],
                "top_doc_id": r[3], "latency_ms": r[4], "searched_at": r[5],
            }
            for r in rows
        ]

    def add_bookmark(self, doc_id: str, note: str | None = None) -> None:
        self._require_writable()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO bookmarks (doc_id, note, created_at) VALUES (?, ?, ?)",
                (doc_id, note, time.time()),
            )

    def bookmarks(self) -> list[tuple[str, str | None]]:
        with self._lock:
            return [
                (r[0], r[1])
                for r in self._conn.execute(
                    "SELECT doc_id, note FROM bookmarks ORDER BY created_at DESC"
                ).fetchall()
            ]

    # -- build history -------------------------------------------------------------

    def record_build(
        self, doc_count: int, error_count: int, duration_ms: float | None = None,
        detail: Mapping | None = None,
    ) -> None:
        self._require_writable()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO index_builds (doc_count, error_count, duration_ms, detail_json, built_at)"
                " VALUES (?, ?, ?, ?, ?)",
                (doc_count, error_count, duration_ms, json.dumps(dict(detail)) if detail else None, time.time()),
            )
            # retain last 100 (index_metadata.rs contract)
            self._conn.execute(
                "DELETE FROM index_builds WHERE id NOT IN ("
                "  SELECT id FROM index_builds ORDER BY id DESC LIMIT 100)"
            )

    def build_history(self, limit: int = 100) -> list[dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc_count, error_count, duration_ms, detail_json, built_at "
                "FROM index_builds ORDER BY id DESC LIMIT ?",
                (limit,),
            ).fetchall()
        return [
            {
                "doc_count": r[0], "error_count": r[1], "duration_ms": r[2],
                "detail": json.loads(r[3]) if r[3] else None, "built_at": r[4],
            }
            for r in rows
        ]
