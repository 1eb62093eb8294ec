"""Rerank step: look up doc text, rerank top-N, combine, graceful skip.

Parity target: reference crates/frankensearch-rerank/src/pipeline.rs —
``rerank_step[_with_combine]``: text lookup via closure, rerank the top-N
of the fused results, combine strategies, graceful skip on failure.

The skip catches a typed ``SearchError`` only: the cross-encoder runs on
the card, and a device fault there propagates instead of reading as a
skipped phase (the reference skips on any exception).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from frankensearch_tpu_torch.core.errors import SearchError
from frankensearch_tpu_torch.core.types import ScoredResult, SearchSource


class CombineStrategy(enum.Enum):
    #: reranker score fully replaces the fused score for reranked docs
    REPLACE = "replace"
    #: weighted mix of normalized fused score and reranker score
    WEIGHTED = "weighted"
    #: reorder the top-N by reranker score, keep fused scores (rank-only)
    RANK_ONLY = "rank_only"


@dataclass
class RerankOutcome:
    results: list[ScoredResult]
    reranked_count: int = 0
    skipped: bool = False
    skip_reason: str | None = None
    rerank_ms: float = 0.0
    scores: dict[str, float] = field(default_factory=dict)


def rerank_step(
    reranker,
    query: str,
    results: Sequence[ScoredResult],
    text_fn: Callable[[str], str | None],
    *,
    top_n: int = 20,
    combine: CombineStrategy = CombineStrategy.WEIGHTED,
    weight: float = 0.7,
) -> RerankOutcome:
    """Rerank the top-N results; the tail keeps its order below them.
    A typed reranker failure or missing text degrades gracefully (a skip);
    any other exception propagates."""
    results = list(results)
    if not results or reranker is None:
        return RerankOutcome(results=results, skipped=True, skip_reason="no_input")

    head = results[:top_n]
    tail = results[top_n:]
    pairs: list[tuple[str, str]] = []
    for r in head:
        text = text_fn(r.doc_id)
        if text is None and r.title:
            text = r.title
        if text is not None:
            pairs.append((r.doc_id, text))
    if not pairs:
        return RerankOutcome(results=results, skipped=True, skip_reason="no_text")

    t0 = time.monotonic()
    try:
        scored = reranker.score_pairs(query, pairs)
    except SearchError:
        return RerankOutcome(results=results, skipped=True, skip_reason="rerank_error")
    rerank_ms = (time.monotonic() - t0) * 1000.0
    # non-finite scores are garbage, not signal: a NaN-scoring reranker
    # poisoned every result score shown to the user (probed 2026-08-18;
    # NaN also destabilizes the sort and propagates through feedback
    # boosts). Unscored docs keep their fused position.
    import math

    by_doc = {s.doc_id: s.score for s in scored if math.isfinite(s.score)}

    # min-max normalize fused scores over the head for WEIGHTED combine
    fused = [r.score for r in head]
    lo, hi = min(fused), max(fused)
    rng = hi - lo

    def norm(s: float) -> float:
        return (s - lo) / rng if rng > 1e-12 else 1.0

    new_head: list[ScoredResult] = []
    for r in head:
        rr = by_doc.get(r.doc_id)
        if rr is None:
            new_head.append(r)
            continue
        if combine is CombineStrategy.REPLACE:
            new_score = rr
        elif combine is CombineStrategy.RANK_ONLY:
            new_score = r.score
        else:
            new_score = weight * rr + (1.0 - weight) * norm(r.score)
        new_head.append(
            ScoredResult(
                doc_id=r.doc_id,
                score=new_score,
                lexical_score=r.lexical_score,
                fast_score=r.fast_score,
                quality_score=r.quality_score,
                rerank_score=rr,
                graph_score=r.graph_score,
                sources=r.sources | SearchSource.RERANKER,
                title=r.title,
                snippet=r.snippet,
                metadata=r.metadata,
                explanation=r.explanation,
            )
        )
    if combine is CombineStrategy.RANK_ONLY:
        new_head.sort(
            key=lambda r: (-(by_doc.get(r.doc_id, float("-inf"))), r.doc_id)
        )
    else:
        new_head.sort(key=lambda r: (-r.score, r.doc_id))
    return RerankOutcome(
        results=new_head + tail,
        reranked_count=len(by_doc),
        rerank_ms=rerank_ms,
        scores=by_doc,
    )
