"""Synchronous two-tier searcher over precomputed embeddings.

Parity target: reference crates/frankensearch-fusion/src/sync_searcher.rs
(:267) — a synchronous mirror of the two-phase contract operating on
precomputed query embeddings + in-memory indices, the low-latency TUI
path (no embedder in the loop, no timeouts needed).

The async/sync split of the reference collapses here (the main searcher
is already synchronous), so this class is the *embedder-free* variant:
callers supply query vectors directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from frankensearch_tpu_torch.core.config import TwoTierConfig
from frankensearch_tpu_torch.core.types import (
    PhaseKind,
    ScoredResult,
    SearchPhase,
    SearchSource,
)
from frankensearch_tpu_torch.fusion.blend import blend_two_tier_aligned, kendall_tau
from frankensearch_tpu_torch.fusion.rrf import RrfConfig, fuse_by_strategy
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical.base import LexicalRead


@dataclass
class SyncSearchOutcome:
    results: list[ScoredResult]
    phases: list[SearchPhase] = field(default_factory=list)
    kendall_tau: float | None = None


class SyncTwoTierSearcher:
    """Two-phase search from precomputed vectors; deterministic and
    allocation-light, mirroring the async searcher's fusion contract
    (asserted by parity tests against TwoTierSearcher)."""

    def __init__(
        self,
        index: TwoTierIndex,
        *,
        lexical: LexicalRead | None = None,
        config: TwoTierConfig | None = None,
    ) -> None:
        self.index = index
        self.lexical = lexical
        self.config = (config or TwoTierConfig()).validate()

    def search(
        self,
        query_text: str,
        fast_vec: np.ndarray,
        quality_vec: np.ndarray | None = None,
        k: int = 10,
    ) -> SyncSearchOutcome:
        if k < 0:
            from frankensearch_tpu_torch.core.errors import InvalidConfig

            raise InvalidConfig(f"k must be >= 0, got {k}")
        cfg = self.config
        phases: list[SearchPhase] = []

        lexical_pool: list[ScoredResult] = []
        if self.lexical is not None and query_text.strip():
            lexical_pool = self.lexical.search(query_text, k * cfg.candidate_multiplier)

        classified = self.index.search_fast_classified(fast_vec, k * cfg.candidate_multiplier)
        fast_hits = list(classified.hits)

        rrf_cfg = RrfConfig(
            k=float(cfg.rrf_k),
            lexical_weight=cfg.lexical_rrf_weight,
            semantic_weight=cfg.fast_rrf_weight,
            tiebreak=cfg.tiebreak,
        )
        fused = fuse_by_strategy(cfg.fusion_strategy, lexical_pool, fast_hits, k, 0, rrf_cfg)
        lex_by = {r.doc_id: r for r in lexical_pool}
        fast_by = {h.doc_id: h for h in fast_hits}

        def to_results(hits, qscores=None):
            out = []
            for h in hits:
                lex = lex_by.get(h.doc_id)
                out.append(
                    ScoredResult(
                        doc_id=h.doc_id, score=h.score,
                        lexical_score=lex.score if lex else None,
                        fast_score=fast_by[h.doc_id].score if h.doc_id in fast_by else None,
                        quality_score=(qscores or {}).get(h.doc_id),
                        sources=h.sources,
                        title=lex.title if lex else None,
                        metadata=lex.metadata if lex else None,
                    )
                )
            return out

        initial = to_results(fused)
        phases.append(SearchPhase(PhaseKind.INITIAL, list(initial), 0.0))
        results = initial
        tau = None

        if (
            not cfg.fast_only
            and quality_vec is not None
            and self.index.has_quality_tier
            and fast_hits
        ):
            qscores = self.index.quality_scores_for_hits(quality_vec, fast_hits)
            aligned = [qscores.get(h.doc_id) for h in fast_hits]
            blended = blend_two_tier_aligned(fast_hits, aligned, cfg.quality_weight)
            tau = kendall_tau(fast_hits, blended)
            refused = fuse_by_strategy(
                cfg.fusion_strategy, lexical_pool, blended, k, 0, rrf_cfg
            )
            results = to_results(refused, qscores)
            for r in results:
                if r.quality_score is not None:
                    r.sources |= SearchSource.QUALITY_VECTOR
            phases.append(SearchPhase(PhaseKind.REFINED, list(results), 0.0))
        return SyncSearchOutcome(results=results[:k], phases=phases, kendall_tau=tau)
