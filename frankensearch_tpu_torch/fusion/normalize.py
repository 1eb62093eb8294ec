"""Score normalization + NQC dense down-weighting.

Parity target: reference crates/frankensearch-fusion/src/normalize.rs —
min-max / z-score normalizers plus the NQC (Normalized Query Commitment)
dense down-weight: a query-difficulty estimate from the lexical score
distribution that lowers the semantic tier's RRF weight on queries where
lexical evidence is sharp and semantic evidence is likely noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from frankensearch_tpu_torch.core.types import ScoredResult


def minmax_normalize(scores: Sequence[float]) -> list[float]:
    finite = [s for s in scores if math.isfinite(s)]
    if not finite:
        return [0.0] * len(scores)
    lo, hi = min(finite), max(finite)
    rng = hi - lo
    if rng <= 1e-12:
        return [1.0 if math.isfinite(s) else 0.0 for s in scores]
    return [
        min(max((s - lo) / rng, 0.0), 1.0) if math.isfinite(s) else 0.0 for s in scores
    ]


def zscore_normalize(scores: Sequence[float]) -> list[float]:
    finite = [s for s in scores if math.isfinite(s)]
    if len(finite) < 2:
        return [0.0] * len(scores)
    mean = sum(finite) / len(finite)
    var = sum((s - mean) ** 2 for s in finite) / (len(finite) - 1)
    std = math.sqrt(var)
    if std <= 1e-12:
        return [0.0] * len(scores)
    return [(s - mean) / std if math.isfinite(s) else 0.0 for s in scores]


@dataclass
class NqcDownweight:
    """NQC: commitment = std(top scores) / mean(top scores). High
    commitment = the lexical ranking is confident; down-weight the dense
    tier toward ``min_weight``."""

    top_k: int = 10
    #: commitment at/above which the dense weight floors out
    saturation: float = 0.8
    min_weight: float = 0.3

    def commitment(self, lexical: Sequence[ScoredResult]) -> float:
        scores = [r.score for r in lexical[: self.top_k] if math.isfinite(r.score)]
        if len(scores) < 2:
            return 0.0
        mean = sum(scores) / len(scores)
        if mean <= 1e-12:
            return 0.0
        var = sum((s - mean) ** 2 for s in scores) / len(scores)
        return math.sqrt(var) / mean

    def semantic_weight_multiplier(self, lexical: Sequence[ScoredResult]) -> float:
        c = min(self.commitment(lexical) / self.saturation, 1.0)
        return 1.0 - (1.0 - self.min_weight) * c
