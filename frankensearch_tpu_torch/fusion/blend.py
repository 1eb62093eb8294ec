"""Two-tier score blending: min-max normalize + alpha blend.

Parity target: reference crates/frankensearch-fusion/src/blend.rs —
``blended = alpha * quality + (1 - alpha) * fast`` (alpha default 0.7,
:107), both sides min-max normalized independently; missing-source docs
keep their own normalized score; non-finite scores fall back to 0.0;
final order is (score desc, doc_id asc). ``blend_two_tier_aligned``
(:213) consumes per-hit optional quality scores (the aligned rescoring
path) without materializing a quality hit list. Rank-change metrics
(:365) and Kendall tau (:417,:461).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from frankensearch_tpu_torch.core.types import VectorHit

DEFAULT_BLEND_FACTOR = 0.7
_NON_FINITE_FALLBACK = 0.0
_EPS = 1.1920929e-07  # f32 epsilon, matching the reference's range guard


def _sanitize_alpha(alpha: float) -> float:
    if not math.isfinite(alpha):
        return DEFAULT_BLEND_FACTOR
    return min(max(alpha, 0.0), 1.0)


def _sanitize_score(s: float) -> float:
    return s if math.isfinite(s) else _NON_FINITE_FALLBACK


@dataclass(frozen=True)
class _Bounds:
    min: float
    range: float
    saw_finite: bool

    @staticmethod
    def from_scores(scores) -> "_Bounds":
        lo, hi, saw = math.inf, -math.inf, False
        for s in scores:
            if math.isfinite(s):
                lo = min(lo, s)
                hi = max(hi, s)
                saw = True
        return _Bounds(lo, hi - lo if saw else 0.0, saw)

    def apply(self, score: float) -> float:
        if not self.saw_finite or not math.isfinite(score):
            return _NON_FINITE_FALLBACK
        if self.range > _EPS:
            v = (score - self.min) / self.range
        else:
            v = 1.0
        return min(max(v, 0.0), 1.0)


def _merge_and_rank(merged: dict[str, tuple[float | None, float | None, int]], alpha: float):
    out = []
    for doc_id, (fast, quality, row) in merged.items():
        if fast is not None and quality is not None:
            score = alpha * quality + (1.0 - alpha) * fast
        elif fast is not None:
            score = fast
        elif quality is not None:
            score = quality
        else:
            score = 0.0
        out.append(VectorHit(doc_id=doc_id, score=_sanitize_score(score), row=row))
    out.sort(key=lambda h: (-_sanitize_score(h.score), h.doc_id))
    return out


def blend_two_tier(
    fast_results: Sequence[VectorHit],
    quality_results: Sequence[VectorHit],
    blend_factor: float = DEFAULT_BLEND_FACTOR,
) -> list[VectorHit]:
    alpha = _sanitize_alpha(blend_factor)
    fast_bounds = _Bounds.from_scores(h.score for h in fast_results)
    quality_bounds = _Bounds.from_scores(h.score for h in quality_results)

    merged: dict[str, tuple[float | None, float | None, int]] = {}
    for h in fast_results:
        cur = merged.get(h.doc_id)
        if cur is None or cur[0] is None:
            q = cur[1] if cur else None
            merged[h.doc_id] = (fast_bounds.apply(h.score), q, h.row)
    for h in quality_results:
        cur = merged.get(h.doc_id)
        if cur is None:
            merged[h.doc_id] = (None, quality_bounds.apply(h.score), h.row)
        elif cur[1] is None:
            merged[h.doc_id] = (cur[0], quality_bounds.apply(h.score), cur[2])
    return _merge_and_rank(merged, alpha)


def blend_two_tier_aligned(
    fast_hits: Sequence[VectorHit],
    quality_scores: Sequence[float | None],
    blend_factor: float = DEFAULT_BLEND_FACTOR,
) -> list[VectorHit]:
    """Aligned fast path: quality_scores[i] is the optional quality score of
    fast_hits[i] (output of quality_scores_for_hits). Bit-identical to
    materializing the Some-subset and calling blend_two_tier."""
    alpha = _sanitize_alpha(blend_factor)
    fast_bounds = _Bounds.from_scores(h.score for h in fast_hits)
    quality_bounds = _Bounds.from_scores(s for s in quality_scores if s is not None)

    merged: dict[str, tuple[float | None, float | None, int]] = {}
    for i, h in enumerate(fast_hits):
        q = quality_scores[i] if i < len(quality_scores) else None
        cur = merged.get(h.doc_id)
        if cur is None:
            merged[h.doc_id] = (
                fast_bounds.apply(h.score),
                quality_bounds.apply(q) if q is not None else None,
                h.row,
            )
        else:
            f0, q0, r0 = cur
            if f0 is None:
                f0, r0 = fast_bounds.apply(h.score), h.row
            if q0 is None and q is not None:
                q0 = quality_bounds.apply(q)
            merged[h.doc_id] = (f0, q0, r0)
    return _merge_and_rank(merged, alpha)


@dataclass(frozen=True)
class RankChanges:
    """Phase-1 -> Phase-2 rank movement summary (blend.rs:365)."""

    promoted: int
    demoted: int
    unchanged: int
    entered: int  # present in refined, absent from initial
    dropped: int  # present in initial, absent from refined
    max_promotion: int
    max_demotion: int


def rank_changes(
    initial: Sequence[VectorHit], refined: Sequence[VectorHit]
) -> RankChanges:
    pos0 = {h.doc_id: i for i, h in enumerate(initial)}
    pos1 = {h.doc_id: i for i, h in enumerate(refined)}
    promoted = demoted = unchanged = entered = 0
    max_p = max_d = 0
    for doc, i1 in pos1.items():
        i0 = pos0.get(doc)
        if i0 is None:
            entered += 1
        elif i1 < i0:
            promoted += 1
            max_p = max(max_p, i0 - i1)
        elif i1 > i0:
            demoted += 1
            max_d = max(max_d, i1 - i0)
        else:
            unchanged += 1
    dropped = sum(1 for doc in pos0 if doc not in pos1)
    return RankChanges(promoted, demoted, unchanged, entered, dropped, max_p, max_d)


def kendall_tau(
    initial: Sequence[VectorHit], refined: Sequence[VectorHit]
) -> float | None:
    """Kendall tau-a over the shared doc set; None when overlap < 2
    (blend.rs:461)."""
    pos1 = {h.doc_id: i for i, h in enumerate(refined)}
    common = [h.doc_id for h in initial if h.doc_id in pos1]
    n = len(common)
    if n < 2:
        return None
    concordant = discordant = 0
    for i in range(n):
        for j in range(i + 1, n):
            d = pos1[common[i]] - pos1[common[j]]
            if d < 0:
                concordant += 1
            elif d > 0:
                discordant += 1
    total = n * (n - 1) // 2
    return (concordant - discordant) / total
