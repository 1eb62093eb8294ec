"""SQLite FTS5 lexical backend — the third interchangeable engine.

Parity target: reference crates/frankensearch-storage/src/fts5_adapter.rs
(FTS5 as an alternative ``LexicalRead``/``LexicalWrite`` backend: zero
extra binary size, MVCC reads/writes, one ``.db`` deployment artifact;
title boost 2.0 mirroring the Tantivy adapter; Stored and Contentless
content modes; 10k-char query truncation).

Implementation is stdlib ``sqlite3`` (FTS5 is compiled into CPython's
bundled SQLite), not a translation: staging + single-transaction commit
gives the same snapshot-publication semantics as the other backends, and
queries use the oracle's Should-union term semantics (deduplicated
quoted terms OR-ed) so all three engines agree on the match set.

Note the scores are FTS5's own BM25 (different IDF/norm details from the
Tantivy-pinned arithmetic in :mod:`frankensearch_tpu_torch.lexical.bm25`) —
same as the reference, where the FTS5 arm is rank-compatible but not
score-identical with Quill.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Mapping, Sequence

from frankensearch_tpu_torch.core.errors import InvalidConfig
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead, LexicalWrite
from frankensearch_tpu_torch.lexical.tokenizer import simple_tokenize

TITLE_BOOST = 2.0
CONTENT_BOOST = 1.0
MAX_QUERY_LENGTH = 10_000
PREVIEW_CHARS = 240


def fts5_available() -> bool:
    try:
        conn = sqlite3.connect(":memory:")
        try:
            conn.execute("CREATE VIRTUAL TABLE _probe USING fts5(c)")
            return True
        finally:
            conn.close()
    except sqlite3.OperationalError:
        return False


class Fts5LexicalIndex(LexicalRead, LexicalWrite):
    """FTS5-backed lexical arm.

    ``content_mode='stored'`` (default) keeps the text inside the FTS
    table (snippets + previews work). ``'contentless'`` indexes without
    storing text — smaller on disk, but this SQLite version cannot
    delete from contentless tables, so ``delete_document`` fails typed.
    """

    def __init__(
        self,
        path: str = ":memory:",
        *,
        content_mode: str = "stored",
        tokenizer: str = "unicode61",
    ) -> None:
        if content_mode not in ("stored", "contentless"):
            raise InvalidConfig(
                f"content_mode must be 'stored' or 'contentless', got {content_mode!r}"
            )
        self.content_mode = content_mode
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._staged: list[tuple[str, IndexableDocument | None]] = []
        content_opt = ", content=''" if content_mode == "contentless" else ""
        with self._conn:
            self._conn.execute(
                "CREATE VIRTUAL TABLE IF NOT EXISTS fts USING fts5("
                "doc_id UNINDEXED, title, content, metadata UNINDEXED"
                f", tokenize='{tokenizer}'{content_opt})"
            )
            # doc_id -> rowid map: FTS5 MATCH can't be combined with an
            # indexed equality on an UNINDEXED column, and contentless
            # tables can't read columns back at all
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS doc_map ("
                "doc_id TEXT PRIMARY KEY, rowid_ref INTEGER NOT NULL,"
                "title TEXT, metadata TEXT, preview TEXT)"
            )

    # -- LexicalWrite -----------------------------------------------------

    def add_document(self, doc: IndexableDocument) -> None:
        self._staged.append((doc.doc_id, doc))

    def delete_document(self, doc_id: str) -> None:
        if self.content_mode == "contentless":
            raise InvalidConfig(
                "contentless FTS5 tables do not support deletes on this "
                "SQLite version; use content_mode='stored'"
            )
        self._staged.append((doc_id, None))

    def commit(self) -> None:
        with self._lock, self._conn:
            for doc_id, doc in self._staged:
                row = self._conn.execute(
                    "SELECT rowid_ref FROM doc_map WHERE doc_id = ?", (doc_id,)
                ).fetchone()
                if row is not None:
                    if self.content_mode == "contentless":
                        raise InvalidConfig(
                            "contentless FTS5 tables cannot replace documents"
                        )
                    self._conn.execute("DELETE FROM fts WHERE rowid = ?", (row[0],))
                    self._conn.execute("DELETE FROM doc_map WHERE doc_id = ?", (doc_id,))
                if doc is None:
                    continue
                meta = json.dumps(doc.metadata) if doc.metadata is not None else None
                cur = self._conn.execute(
                    "INSERT INTO fts (doc_id, title, content, metadata) VALUES (?,?,?,?)",
                    (doc.doc_id, doc.title or "", doc.content, meta or ""),
                )
                self._conn.execute(
                    "INSERT INTO doc_map (doc_id, rowid_ref, title, metadata, preview)"
                    " VALUES (?,?,?,?,?)",
                    (
                        doc.doc_id,
                        cur.lastrowid,
                        doc.title,
                        meta,
                        doc.content[:PREVIEW_CHARS],
                    ),
                )
        self._staged.clear()

    # -- LexicalRead ------------------------------------------------------

    def doc_count(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) FROM doc_map").fetchone()[0]

    @staticmethod
    def _match_expr(query: str) -> str | None:
        """Should-union of deduplicated quoted terms — the same match
        semantics as the oracle (Tantivy Should dedup)."""
        terms = simple_tokenize(query[:MAX_QUERY_LENGTH])
        seen: set[str] = set()
        parts = []
        for t in terms:
            if t not in seen:
                seen.add(t)
                parts.append('"' + t.replace('"', '""') + '"')
        return " OR ".join(parts) if parts else None

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        expr = self._match_expr(query)
        if expr is None or budget <= 0:
            return []
        # bm25() returns lower-is-better (negative); negate for the
        # higher-is-better contract. Column weights: doc_id(0), title,
        # content, metadata(0). doc_id comes from doc_map via rowid —
        # contentless tables return NULL for every stored-column read.
        sql = (
            "SELECT dm.doc_id, -bm25(fts, 0.0, ?, ?, 0.0) AS s FROM fts "
            "JOIN doc_map dm ON dm.rowid_ref = fts.rowid "
            "WHERE fts MATCH ? ORDER BY s DESC, dm.doc_id ASC LIMIT ?"
        )
        with self._lock:
            rows = self._conn.execute(
                sql, (TITLE_BOOST, CONTENT_BOOST, expr, budget)
            ).fetchall()
        return [LexicalCandidate(doc_id=d, score=float(s)) for d, s in rows]

    def search_boolean(self, query, limit: int):
        """Tree retrieval via native FTS5 MATCH syntax (fts5_adapter.rs
        role): phrases map to quoted strings, AND/OR/NOT to operators.
        Scores are FTS5's own bm25 over the matched set — rank-compatible
        with the oracle's match set, not score-identical (same contract
        as the bag lane). Trees FTS5 cannot express (pure-negative roots,
        NOT under OR) fall back to the bag+post-filter default."""
        from frankensearch_tpu_torch.core.types import ScoredResult
        from frankensearch_tpu_torch.lexical.query import to_fts5_match

        if query.root is None or limit <= 0:
            return []
        expr = to_fts5_match(query.root)
        if expr is None:
            return super().search_boolean(query, limit)
        sql = (
            "SELECT dm.doc_id, -bm25(fts, 0.0, ?, ?, 0.0) AS s FROM fts "
            "JOIN doc_map dm ON dm.rowid_ref = fts.rowid "
            "WHERE fts MATCH ? ORDER BY s DESC, dm.doc_id ASC LIMIT ?"
        )
        try:
            with self._lock:
                rows = self._conn.execute(
                    sql, (TITLE_BOOST, CONTENT_BOOST, expr, limit)
                ).fetchall()
        except sqlite3.OperationalError:
            # lenient contract: a MATCH the engine rejects degrades to
            # the post-filter lane instead of erroring
            return super().search_boolean(query, limit)
        meta = self.hydrate_candidates([d for d, _ in rows])
        out = []
        for d, s in rows:
            m = meta.get(d) or {}
            out.append(
                ScoredResult(
                    doc_id=d, score=float(s), lexical_score=float(s),
                    title=m.get("title"), metadata=m.get("metadata"),
                )
            )
        return out

    def hydrate_candidates(self, doc_ids: Sequence[str]) -> dict[str, Mapping]:
        if not doc_ids:
            return {}
        qmarks = ",".join("?" for _ in doc_ids)
        if self.content_mode == "stored":
            # Surface the FULL content (it is stored in the fts table) so
            # the generic boolean post-filter (base.search_boolean) runs
            # in exact mode for trees MATCH cannot express — without this
            # the fallback judged NOT/phrase on the 240-char preview and
            # kept false matches leniently (probed: NOT-under-OR trees
            # returned docs the oracle rejects).
            with self._lock:
                rows = self._conn.execute(
                    f"SELECT dm.doc_id, dm.title, dm.metadata, dm.preview,"
                    f" f.content FROM doc_map dm"
                    f" JOIN fts f ON f.rowid = dm.rowid_ref"
                    f" WHERE dm.doc_id IN ({qmarks})",
                    list(doc_ids),
                ).fetchall()
            return {
                d: {
                    "title": title,
                    "metadata": json.loads(meta) if meta else None,
                    "preview": preview,
                    "content": content,
                }
                for d, title, meta, preview, content in rows
            }
        with self._lock:
            rows = self._conn.execute(
                f"SELECT doc_id, title, metadata, preview FROM doc_map "
                f"WHERE doc_id IN ({qmarks})",
                list(doc_ids),
            ).fetchall()
        return {
            d: {
                "title": title,
                "metadata": json.loads(meta) if meta else None,
                "preview": preview,
            }
            for d, title, meta, preview in rows
        }

    # -- delta-compatible write surface -------------------------------------
    # As a product backend the FTS5 arm serves as its OWN delta: sqlite
    # commits are transactional and searchable immediately, so the
    # lease/seal machinery has nothing to fold. Writers (watch /
    # append-batch / delete) drive the same add/commit/seal calls they
    # use on DeltaLexicalIndex.

    def seal(self):
        """No-op freeze boundary: commit IS publication here."""
        return None

    @property
    def unsealed_docs(self) -> int:
        return 0

    # -- extras -------------------------------------------------------------

    def snippet(self, query: str, doc_id: str, tokens: int = 20) -> str | None:
        """FTS5-native highlighted snippet (fts5_adapter.rs snippet path);
        stored mode only."""
        if self.content_mode == "contentless":
            return None
        expr = self._match_expr(query)
        if expr is None:
            return None
        with self._lock:
            row = self._conn.execute(
                "SELECT snippet(fts, 2, '[', ']', '…', ?) FROM fts "
                "WHERE fts MATCH ? AND doc_id = ?",
                (tokens, expr, doc_id),
            ).fetchone()
        return row[0] if row else None

    def close(self) -> None:
        self._conn.close()
