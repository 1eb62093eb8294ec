"""Ranking priors: recency, path proximity, symbol-aware boosts.

Parity target: reference crates/frankensearch-fsfs/src/ranking_priors.rs
(+ code_structure_sidecar.rs) — post-fusion multiplicative priors:
recently-modified documents and documents near the user's working path
get a bounded boost; documents whose symbol sidecar matches a query
identifier get a symbol boost. Priors are DISABLED under pressure
(the governor gate), and every boost is bounded so priors can reorder
near-ties but never overturn a clear relevance win.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from frankensearch_tpu_torch.core.query_class import QueryClass
from frankensearch_tpu_torch.core.types import ScoredResult


@dataclass
class RankingPriors:
    #: max multiplicative boost any single prior can contribute
    max_boost: float = 1.15
    recency_half_life_days: float = 30.0
    proximity_weight: float = 0.5
    symbol_weight: float = 1.0
    #: the user's working directory for path proximity
    working_path: str = ""
    #: doc_id -> symbol list (code_structure_sidecar)
    symbols: Mapping[str, Sequence[str]] = field(default_factory=dict)
    governor: object | None = None  # ResourcePressureGovernor
    clock: "callable" = time.time

    def _enabled(self) -> bool:
        if self.governor is None:
            return True
        return bool(getattr(self.governor, "allow_ranking_priors", True))

    def _recency_boost(self, metadata: Mapping | None) -> float:
        if not metadata or "mtime" not in metadata:
            return 1.0
        try:
            age_days = max(self.clock() - float(metadata["mtime"]), 0.0) / 86400.0
        except (TypeError, ValueError):
            return 1.0
        f = math.pow(0.5, age_days / self.recency_half_life_days)
        return 1.0 + (self.max_boost - 1.0) * f

    def _proximity_boost(self, doc_id: str) -> float:
        if not self.working_path:
            return 1.0
        doc_dir = os.path.dirname(doc_id)
        wp = self.working_path.rstrip(os.sep)
        common = os.path.commonprefix([doc_dir + os.sep, wp + os.sep])
        depth_common = common.count(os.sep)
        depth_total = max(wp.count(os.sep) + 1, 1)
        f = self.proximity_weight * depth_common / depth_total
        return 1.0 + (self.max_boost - 1.0) * min(f, 1.0)

    def _symbol_boost(self, doc_id: str, query: str, qclass: QueryClass) -> float:
        if qclass is not QueryClass.IDENTIFIER or not self.symbols:
            return 1.0
        syms = self.symbols.get(doc_id)
        if not syms:
            return 1.0
        q = query.strip().lower()
        if any(q == s.lower() for s in syms):
            return self.max_boost
        if any(q in s.lower() for s in syms):
            return 1.0 + (self.max_boost - 1.0) * 0.5
        return 1.0

    def apply(
        self, results: Sequence[ScoredResult], query: str
    ) -> list[ScoredResult]:
        if not self._enabled():
            return list(results)
        qclass = QueryClass.classify(query)
        out = []
        for r in results:
            boost = (
                self._recency_boost(r.metadata)
                * self._proximity_boost(r.doc_id)
                * self._symbol_boost(r.doc_id, query, qclass)
            )
            boost = min(boost, self.max_boost**2)  # combined cap
            if boost == 1.0:
                out.append(r)
            else:
                out.append(
                    ScoredResult(
                        doc_id=r.doc_id, score=r.score * boost,
                        lexical_score=r.lexical_score, fast_score=r.fast_score,
                        quality_score=r.quality_score, rerank_score=r.rerank_score,
                        sources=r.sources, title=r.title, snippet=r.snippet,
                        metadata=r.metadata, explanation=r.explanation,
                    )
                )
        out.sort(key=lambda r: (-r.score, r.doc_id))
        return out
