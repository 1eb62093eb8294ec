"""Maximal Marginal Relevance diversification.

Parity target: reference crates/frankensearch-fusion/src/mmr.rs (:1-8) —
re-rank the top pool by ``lambda * relevance - (1 - lambda) * max_sim``
against already-selected docs, using the fast-tier semantic vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.core.types import ScoredResult


@dataclass
class MmrDiversifier:
    lambda_relevance: float = 0.7
    pool_size: int = 20

    def apply(self, results: Sequence[ScoredResult], index) -> list[ScoredResult]:
        """index: TwoTierIndex (fast-tier vectors drive the similarity)."""
        results = list(results)
        pool = results[: self.pool_size]
        tail = results[self.pool_size :]
        if len(pool) <= 2:
            return results

        vecs = []
        kept: list[ScoredResult] = []
        for r in pool:
            row = index.fast.row_for(r.doc_id)
            if row is None:
                kept.append(r)  # docs without vectors keep their position
                continue
            vecs.append((r, index.fast.vector_for_row(row)))
        if len(vecs) <= 2:
            return results

        rel = np.array([r.score for r, _ in vecs], dtype=np.float64)
        lo, hi = rel.min(), rel.max()
        rel = (rel - lo) / (hi - lo) if hi > lo else np.ones_like(rel)
        mat = np.stack([v for _, v in vecs])
        sims = mat @ mat.T

        n = len(vecs)
        selected: list[int] = []
        remaining = set(range(n))
        while remaining:
            best_i, best_score = None, -np.inf
            for i in sorted(remaining):
                if selected:
                    max_sim = max(sims[i][j] for j in selected)
                else:
                    max_sim = 0.0
                mmr = self.lambda_relevance * rel[i] - (1 - self.lambda_relevance) * max_sim
                if mmr > best_score:
                    best_i, best_score = i, mmr
            selected.append(best_i)
            remaining.discard(best_i)
        ordered = [vecs[i][0] for i in selected]
        # merge back docs that had no vectors, preserving their relative spot
        out = ordered + kept
        return out + tail
