"""Score calibrators applied to raw scores pre-fusion.

Parity target: reference crates/frankensearch-fusion/src/calibration.rs
(:1-8) — temperature scaling, Platt (logistic) scaling, and isotonic
regression (PAV), fit on (raw score, relevance) pairs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class TemperatureCalibrator:
    temperature: float = 1.0

    def __call__(self, score: float) -> float:
        return score / self.temperature if self.temperature > 0 else score


@dataclass(frozen=True)
class PlattCalibrator:
    """sigmoid(a * score + b); fit via a few Newton steps on logistic loss."""

    a: float = 1.0
    b: float = 0.0

    def __call__(self, score: float) -> float:
        z = self.a * score + self.b
        if z >= 0:
            return 1.0 / (1.0 + math.exp(-z))
        e = math.exp(z)
        return e / (1.0 + e)

    @staticmethod
    def fit(scores: Sequence[float], labels: Sequence[int], iters: int = 50) -> "PlattCalibrator":
        a, b = 1.0, 0.0
        n = len(scores)
        if n == 0:
            return PlattCalibrator()
        lr = 0.5
        for _ in range(iters):
            ga = gb = 0.0
            for s, y in zip(scores, labels):
                p = 1.0 / (1.0 + math.exp(-(a * s + b)))
                ga += (p - y) * s
                gb += p - y
            a -= lr * ga / n
            b -= lr * gb / n
        return PlattCalibrator(a=a, b=b)


@dataclass
class IsotonicCalibrator:
    """Pool-adjacent-violators isotonic regression; piecewise-constant map."""

    thresholds: list[float] = field(default_factory=list)
    values: list[float] = field(default_factory=list)

    def __call__(self, score: float) -> float:
        if not self.thresholds:
            return score
        # find the rightmost threshold <= score
        import bisect

        i = bisect.bisect_right(self.thresholds, score) - 1
        if i < 0:
            return self.values[0]
        return self.values[i]

    @staticmethod
    def fit(scores: Sequence[float], labels: Sequence[float]) -> "IsotonicCalibrator":
        pairs = sorted(zip(scores, labels))
        if not pairs:
            return IsotonicCalibrator()
        # PAV: blocks of (weight, mean)
        blocks: list[list[float]] = []  # [sum, count, min_score]
        for s, y in pairs:
            blocks.append([float(y), 1.0, s])
            while len(blocks) >= 2 and blocks[-2][0] / blocks[-2][1] >= blocks[-1][0] / blocks[-1][1]:
                b = blocks.pop()
                blocks[-1][0] += b[0]
                blocks[-1][1] += b[1]
        return IsotonicCalibrator(
            thresholds=[b[2] for b in blocks],
            values=[b[0] / b[1] for b in blocks],
        )
