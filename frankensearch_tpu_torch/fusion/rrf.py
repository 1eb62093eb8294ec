"""Reciprocal Rank Fusion with the reference's deterministic ordering.

Parity target: reference crates/frankensearch-fusion/src/rrf.rs —
``score(doc) = sum_i w_i / (K + rank_i + 1)`` with 0-based ranks, K=60
default (:223), per-tier weight sanitization, first-occurrence dedup
within a source, and the exact 4-level ordering (:51-64):

    1. RRF score descending
    2. in_both_sources (true preferred)
    3. tiebreak: LexicalThenId (lexical score desc, missing = -inf)
       or Hash (FNV-1a of doc_id ascending)
    4. doc_id ascending (absolute determinism)

Also provides the pool min-max fusion alternative (FusionStrategy) and
the graph-source variant (rrf_fuse_with_graph :~240).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from frankensearch_tpu_torch.core.config import FusionStrategy, TiebreakStrategy
from frankensearch_tpu_torch.core.types import FusedHit, ScoredResult, SearchSource, VectorHit
from frankensearch_tpu_torch.embed.hash_embedder import fnv1a_64

DEFAULT_RRF_K = 60.0


@dataclass(frozen=True)
class RrfConfig:
    k: float = DEFAULT_RRF_K
    lexical_weight: float = 1.0
    semantic_weight: float = 1.0
    tiebreak: TiebreakStrategy = TiebreakStrategy.LEXICAL_THEN_ID


def candidate_count(limit: int, offset: int, multiplier: int) -> int:
    """How many candidates to fetch per source (rrf.rs candidate_count)."""
    return (limit + offset) * multiplier


def _sanitize_weight(w: float) -> float:
    return w if math.isfinite(w) and w > 0.0 else 1.0


def _sanitize_k(k: float) -> float:
    return k if math.isfinite(k) and k >= 0.0 else DEFAULT_RRF_K


def _sanitize_graph_weight(w: float) -> float:
    return w if math.isfinite(w) and w > 0.0 else 0.0


def _rank_contribution(k: float, rank: int) -> float:
    return 1.0 / (k + float(rank) + 1.0)


@dataclass
class _Scratch:
    doc_id: str
    rrf_score: float = 0.0
    lexical_rank: int | None = None
    semantic_rank: int | None = None
    semantic_row: int = -1
    graph_rank: int | None = None
    lexical_score: float | None = None
    semantic_score: float | None = None
    graph_score: float | None = None
    in_both_sources: bool = False


def _sort_key(h: _Scratch, tiebreak: TiebreakStrategy):
    if tiebreak is TiebreakStrategy.NEUTRAL_HASH:
        tb = fnv1a_64(h.doc_id.encode("utf-8"))
    else:
        lex = h.lexical_score if h.lexical_score is not None else float("-inf")
        tb = -lex  # lexical score descending
    return (-h.rrf_score, not h.in_both_sources, tb, h.doc_id)


def rrf_fuse(
    lexical: Sequence[ScoredResult],
    semantic: Sequence[VectorHit],
    limit: int,
    offset: int = 0,
    config: RrfConfig | None = None,
) -> list[FusedHit]:
    return rrf_fuse_with_graph(lexical, semantic, (), 0.0, limit, offset, config)


_POS_INF = float("inf")
_DEFAULT_CFG = RrfConfig()


def rrf_fuse_with_graph(
    lexical: Sequence[ScoredResult],
    semantic: Sequence[VectorHit],
    graph: Sequence[ScoredResult],
    graph_weight: float,
    limit: int,
    offset: int = 0,
    config: RrfConfig | None = None,
) -> list[FusedHit]:
    # Hot path: this runs once per query (twice with phase-2 lexical
    # re-fusion) and is the host-side throughput ceiling for batched
    # search, so the per-doc scratch is a plain list, not an object
    # (measured ~4x: the dataclass-per-doc variant cost ~174us/fusion).
    # Slots: [rrf, lex_rank, lex_score, sem_rank, graph_rank]
    cfg = config or _DEFAULT_CFG
    k = _sanitize_k(cfg.k)
    lw = _sanitize_weight(cfg.lexical_weight)
    sw = _sanitize_weight(cfg.semantic_weight)
    gw = _sanitize_graph_weight(graph_weight)

    hits: dict[str, list] = {}
    get = hits.get
    base = k + 1.0

    for rank, result in enumerate(lexical):
        doc_id = result.doc_id
        h = get(doc_id)
        if h is None:
            hits[doc_id] = [1.0 / (base + rank) * lw, rank, result.score, None, None]
        elif h[1] is None:  # first (best) occurrence per source wins
            h[0] += 1.0 / (base + rank) * lw
            h[1] = rank
            h[2] = result.score

    for rank, vh in enumerate(semantic):
        doc_id = vh.doc_id
        h = get(doc_id)
        if h is None:
            hits[doc_id] = [1.0 / (base + rank) * sw, None, None, rank, None]
        elif h[3] is None:
            h[0] += 1.0 / (base + rank) * sw
            h[3] = rank

    if gw > 0.0:
        for rank, result in enumerate(graph):
            doc_id = result.doc_id
            h = get(doc_id)
            if h is None:
                hits[doc_id] = [1.0 / (base + rank) * gw, None, None, None, rank]
            elif h[4] is None:
                h[0] += 1.0 / (base + rank) * gw
                h[4] = rank

    # exact 4-level ordering (rrf.rs :51-64): score desc, in-both
    # preferred, tiebreak (lexical score desc / FNV hash asc), id asc
    if cfg.tiebreak is TiebreakStrategy.NEUTRAL_HASH:
        def keyf(item):
            doc_id, h = item
            return (
                -h[0],
                h[1] is None or h[3] is None,
                fnv1a_64(doc_id.encode("utf-8")),
                doc_id,
            )
    else:
        def keyf(item):
            doc_id, h = item
            lex = h[2]
            return (
                -h[0],
                h[1] is None or h[3] is None,
                -lex if lex is not None else _POS_INF,
                doc_id,
            )

    ordered = sorted(hits.items(), key=keyf)
    window = ordered[offset : offset + limit]
    out: list[FusedHit] = []
    for doc_id, h in window:
        sources = SearchSource.NONE
        if h[1] is not None:
            sources |= SearchSource.LEXICAL
        if h[3] is not None:
            sources |= SearchSource.FAST_VECTOR
        if h[4] is not None:
            sources |= SearchSource.GRAPH
        out.append(
            FusedHit(
                doc_id=doc_id,
                score=h[0],
                sources=sources,
                lexical_rank=h[1],
                fast_rank=h[3],
                graph_rank=h[4],
            )
        )
    return out


def pool_minmax_fuse(
    lexical: Sequence[ScoredResult],
    semantic: Sequence[VectorHit],
    limit: int,
    offset: int = 0,
    lexical_weight: float = 0.5,
) -> list[FusedHit]:
    """Score-based alternative to RRF (FusionStrategy::PoolMinmax,
    core/config.rs:31): min-max normalize each pool, weighted sum."""
    lw = min(max(lexical_weight, 0.0), 1.0)

    def bounds(scores: list[float]) -> tuple[float, float]:
        finite = [s for s in scores if math.isfinite(s)]
        if not finite:
            return (0.0, 0.0)
        lo, hi = min(finite), max(finite)
        return (lo, hi - lo)

    l_lo, l_rng = bounds([r.score for r in lexical])
    s_lo, s_rng = bounds([h.score for h in semantic])

    def norm(score: float, lo: float, rng: float) -> float:
        if not math.isfinite(score):
            return 0.0
        if rng > 1e-12:
            return min(max((score - lo) / rng, 0.0), 1.0)
        return 1.0

    acc: dict[str, _Scratch] = {}
    for rank, r in enumerate(lexical):
        h = acc.setdefault(r.doc_id, _Scratch(doc_id=r.doc_id))
        if h.lexical_rank is None:
            h.lexical_rank = rank
            h.lexical_score = r.score
            h.rrf_score += lw * norm(r.score, l_lo, l_rng)
            if h.semantic_rank is not None:
                h.in_both_sources = True
    for rank, vh in enumerate(semantic):
        h = acc.setdefault(vh.doc_id, _Scratch(doc_id=vh.doc_id))
        if h.semantic_rank is None:
            h.semantic_rank = rank
            h.semantic_score = vh.score
            h.semantic_row = vh.row
            h.rrf_score += (1.0 - lw) * norm(vh.score, s_lo, s_rng)
            if h.lexical_rank is not None:
                h.in_both_sources = True

    ordered = sorted(acc.values(), key=lambda h: _sort_key(h, TiebreakStrategy.LEXICAL_THEN_ID))
    window = ordered[offset : offset + limit]
    return [
        FusedHit(
            doc_id=h.doc_id,
            score=h.rrf_score,
            sources=(
                (SearchSource.LEXICAL if h.lexical_rank is not None else SearchSource.NONE)
                | (SearchSource.FAST_VECTOR if h.semantic_rank is not None else SearchSource.NONE)
            ),
            lexical_rank=h.lexical_rank,
            fast_rank=h.semantic_rank,
        )
        for h in window
    ]


def fuse_by_strategy(
    strategy: FusionStrategy,
    lexical: Sequence[ScoredResult],
    semantic: Sequence[VectorHit],
    limit: int,
    offset: int = 0,
    rrf_config: RrfConfig | None = None,
) -> list[FusedHit]:
    """Dispatch on FusionStrategy (rrf.rs fuse_by_strategy :788)."""
    if strategy is FusionStrategy.POOL_MINMAX:
        return pool_minmax_fuse(lexical, semantic, limit, offset)
    return rrf_fuse(lexical, semantic, limit, offset, rrf_config)
