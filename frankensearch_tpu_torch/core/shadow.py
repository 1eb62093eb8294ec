"""Shadow lexical backend: run a candidate engine alongside the serving
one and record divergences without affecting results.

Parity target: reference crates/frankensearch-core/src/shadow.rs —
``ShadowLexical``: every read goes to the primary; the shadow engine runs
the same query and rank/score divergences are recorded for offline
analysis (the migration-confidence tool for swapping lexical backends).

Divergence from the JAX package: only the shadow's ``SearchError``
counts as a ``shadow_error``; any other exception (a device fault in a
device candidate) propagates.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from frankensearch_tpu_torch.core.errors import SearchError
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead


@dataclass(frozen=True)
class Divergence:
    query: str
    kind: str  # "missing_doc" | "extra_doc" | "rank_moved" | "score_drift" | "shadow_error"
    doc_id: str | None
    detail: str


@dataclass
class ShadowReport:
    queries: int = 0
    divergent_queries: int = 0
    divergences: list[Divergence] = field(default_factory=list)
    shadow_errors: int = 0
    primary_ms: float = 0.0
    shadow_ms: float = 0.0

    @property
    def agreement_rate(self) -> float:
        if self.queries == 0:
            return 1.0
        return 1.0 - self.divergent_queries / self.queries


class ShadowLexical(LexicalRead):
    """Primary + shadow pair implementing LexicalRead via the primary."""

    def __init__(
        self,
        primary: LexicalRead,
        shadow: LexicalRead,
        *,
        score_rel_tolerance: float = 1e-3,
        max_recorded: int = 1000,
    ) -> None:
        self.primary = primary
        self.shadow = shadow
        self.score_rel_tolerance = score_rel_tolerance
        self.max_recorded = max_recorded
        self.report = ShadowReport()

    def doc_count(self) -> int:
        return self.primary.doc_count()

    def hydrate_candidates(self, doc_ids: Sequence[str]) -> dict[str, Mapping]:
        return self.primary.hydrate_candidates(doc_ids)

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        t0 = time.monotonic()
        primary = self.primary.search_candidates(query, budget)
        self.report.primary_ms += (time.monotonic() - t0) * 1000.0
        self.report.queries += 1
        t1 = time.monotonic()
        try:
            shadow = self.shadow.search_candidates(query, budget)
        except SearchError as e:
            self.report.shadow_errors += 1
            self._record(Divergence(query, "shadow_error", None, f"{type(e).__name__}: {e}"))
            return primary
        self.report.shadow_ms += (time.monotonic() - t1) * 1000.0
        self._compare(query, primary, shadow)
        return primary

    def _compare(
        self, query: str, primary: list[LexicalCandidate], shadow: list[LexicalCandidate]
    ) -> None:
        p_by = {c.doc_id: (i, c.score) for i, c in enumerate(primary)}
        s_by = {c.doc_id: (i, c.score) for i, c in enumerate(shadow)}
        divergent = False
        for doc_id, (p_rank, p_score) in p_by.items():
            if doc_id not in s_by:
                divergent = True
                self._record(Divergence(query, "missing_doc", doc_id, f"primary rank {p_rank}"))
                continue
            s_rank, s_score = s_by[doc_id]
            if s_rank != p_rank:
                divergent = True
                self._record(
                    Divergence(query, "rank_moved", doc_id, f"{p_rank} -> {s_rank}")
                )
            denom = max(abs(p_score), 1e-9)
            if abs(s_score - p_score) / denom > self.score_rel_tolerance:
                divergent = True
                self._record(
                    Divergence(query, "score_drift", doc_id, f"{p_score:.6f} vs {s_score:.6f}")
                )
        for doc_id in s_by:
            if doc_id not in p_by:
                divergent = True
                self._record(Divergence(query, "extra_doc", doc_id, ""))
        if divergent:
            self.report.divergent_queries += 1

    def _record(self, d: Divergence) -> None:
        if len(self.report.divergences) < self.max_recorded:
            self.report.divergences.append(d)
