"""Lexical backend interfaces.

Parity target: reference crates/frankensearch-core/src/traits.rs —
``LexicalRead::search / search_candidates / hydrate_candidates``
(:927-1010) and ``LexicalWrite`` (:1022). Three interchangeable backends
exist in the reference (Quill native / Tantivy oracle / FTS5); here the
in-memory engine (CPU oracle) and the device-side scorer implement the
same protocol.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Mapping, Sequence

from frankensearch_tpu_torch.core.types import IndexableDocument, ScoredResult


@dataclass(frozen=True)
class LexicalCandidate:
    """A scored lexical hit before hydration (doc id + BM25 score)."""

    doc_id: str
    score: float


class LexicalRead(abc.ABC):
    @abc.abstractmethod
    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        """Top ``budget`` BM25 candidates, descending score, deterministic
        (score desc, doc_id asc) tie-break."""

    @abc.abstractmethod
    def hydrate_candidates(
        self, doc_ids: Sequence[str]
    ) -> dict[str, Mapping]:
        """Metadata (title/snippet source/meta) for the given doc ids,
        pinned to the snapshot that produced the candidates."""

    def search(self, query: str, limit: int) -> list[ScoredResult]:
        cands = self.search_candidates(query, limit)
        meta = self.hydrate_candidates([c.doc_id for c in cands])
        out = []
        for c in cands:
            m = meta.get(c.doc_id, {})
            out.append(
                ScoredResult(
                    doc_id=c.doc_id,
                    score=c.score,
                    lexical_score=c.score,
                    title=m.get("title"),
                    metadata=m.get("metadata"),
                )
            )
        return out

    def search_boolean(self, query, limit: int) -> list[ScoredResult]:
        """Boolean/phrase retrieval (reference quill/src/query.rs trees).

        Default strategy — correct for any backend, and exactly the
        device-arm contract (VERDICT r2 task 7): BM25-score the bag of
        positive terms (on-device for the device arms), then post-filter
        the candidate pool by the full tree against hydrated text.
        When hydration exposes the FULL content (``"content"`` key —
        oracle-backed arms do), the tree evaluates exactly; when only a
        truncated preview is available (bulk 1M+ lanes keep previews to
        bound host memory), a failed match drops the doc only on FULL
        positive evidence — every positive term visible in the available
        text — because absence may be preview truncation while the bag
        retrieval already proved the terms exist (same rule as the fused
        -result tree filter). Backends with richer access override: the
        in-memory oracle evaluates the tree over postings + full-content
        tokens; FTS5 compiles to MATCH syntax.

        ``query`` is a :class:`~frankensearch_tpu_torch.lexical.query.ParsedBooleanQuery`.
        """
        from frankensearch_tpu_torch.lexical.query import field_tokens, tree_drop_verdict

        if query.root is None or limit <= 0:
            return []
        positive = " ".join(query.positive_terms())
        if not positive:
            return []  # pure-negative queries retrieve nothing (Must-Not only)
        pos_terms = query.positive_terms()
        # Escalation ladder: the bag ranking can bury every true tree
        # match below any fixed overfetch (100 word-stuffed docs outrank
        # the one adjacent-phrase doc — probed, the fixed 4x bound
        # returned EMPTY while the oracle matched). Widen along FIXED
        # rungs until the pool under-fills (no more docs carry a
        # positive term), covers the corpus, or hits the device-work
        # cap: the blocked kernel merges a (B, k) carry per block, so an
        # unbounded k would let one adversarial query (rare phrase +
        # common terms) force corpus-wide top-k sorts, and each DISTINCT
        # k compiles its own device program (~15 s per remote compile) —
        # quantized rungs bound the jit-variant set. Beyond the cap the
        # result is bag-rank-bounded — the documented limit of the
        # generic strategy (the oracle/FTS5 overrides stay exact).
        n_docs = max(self.doc_count(), 1)
        cap = min(n_docs, max(2048, limit * 64))
        rungs = [r for r in (32, 256, 2048, 16384, 131072) if r < cap]
        rungs.append(cap)
        start = min(max(limit * 4, 32), cap)
        ladder = [r for r in rungs if r >= start] or [cap]
        out: list[ScoredResult] = []
        for budget in ladder:
            cands = self.search_candidates(positive, budget)
            meta = self.hydrate_candidates([c.doc_id for c in cands])
            out = []
            for c in cands:
                m = meta.get(c.doc_id) or {}
                full = m.get("content") or None  # "" = unknown, not empty doc
                body = str(full) if full is not None else str(m.get("preview", ""))
                tokens = field_tokens(m.get("title"), body)
                if tree_drop_verdict(
                    query.root, tokens,
                    full_known=full is not None,
                    positive_terms=pos_terms,
                ):
                    continue
                out.append(
                    ScoredResult(
                        doc_id=c.doc_id,
                        score=c.score,
                        lexical_score=c.score,
                        title=m.get("title"),
                        metadata=m.get("metadata"),
                    )
                )
                if len(out) >= limit:
                    return out
            if len(cands) < budget:
                return out  # pool exhausted: every positive-term doc seen
        return out

    @abc.abstractmethod
    def doc_count(self) -> int: ...


class LexicalWrite(abc.ABC):
    @abc.abstractmethod
    def add_document(self, doc: IndexableDocument) -> None: ...

    @abc.abstractmethod
    def delete_document(self, doc_id: str) -> None: ...

    @abc.abstractmethod
    def commit(self) -> None:
        """Make pending writes visible to readers (snapshot publication)."""
