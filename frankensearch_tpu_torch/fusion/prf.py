"""Rocchio pseudo-relevance feedback for the quality query vector.

Parity target: reference crates/frankensearch-fusion/src/prf.rs (:1-8) —
the quality query vector is interpolated with the centroid of the top-k
Phase-1 document vectors: ``q' = alpha * q + beta * centroid``,
re-normalized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.core.types import VectorHit


@dataclass
class RocchioPrf:
    alpha: float = 0.7
    beta: float = 0.3
    top_k: int = 5

    def expand(
        self, query_vec: np.ndarray, fast_hits: Sequence[VectorHit], index
    ) -> np.ndarray:
        """index: TwoTierIndex; centroids come from the QUALITY tier when
        available (the vector space the expanded query will score in),
        else the fast tier."""
        tier = index.quality if index.quality is not None else index.fast
        rows = []
        for h in fast_hits[: self.top_k]:
            row = tier.row_for(h.doc_id)
            if row is not None:
                rows.append(tier.vector_for_row(row))
        if not rows:
            return query_vec
        centroid = np.mean(np.stack(rows), axis=0)
        if centroid.shape != query_vec.shape:
            return query_vec  # tier mismatch; fail open with original query
        out = self.alpha * np.asarray(query_vec, dtype=np.float32) + self.beta * centroid
        norm = np.linalg.norm(out)
        return out / norm if norm > 1e-12 else query_vec
