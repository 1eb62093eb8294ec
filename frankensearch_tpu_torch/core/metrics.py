"""Streaming robust statistics for latency monitoring.

Parity target: reference crates/frankensearch-core/src/metrics.rs —
P² (Jain & Chlamtac) streaming quantile estimation + streaming
mean/min/max/count, constant memory, used for per-phase latency
monitoring without retaining samples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


class P2Quantile:
    """P² single-quantile estimator (constant space)."""

    def __init__(self, quantile: float) -> None:
        if not 0.0 < quantile < 1.0:
            raise ValueError("quantile must be in (0,1)")
        self.p = quantile
        self._q: list[float] = []  # marker heights
        self._n: list[int] = []  # marker positions
        self._np: list[float] = []  # desired positions
        self._dn: list[float] = []  # position increments
        self.count = 0

    def observe(self, x: float) -> None:
        self.count += 1
        if len(self._q) < 5:
            self._q.append(x)
            if len(self._q) == 5:
                self._q.sort()
                self._n = [1, 2, 3, 4, 5]
                p = self.p
                self._np = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
                self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(3, -1, -1):
                if x >= q[i]:
                    k = i
                    break
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in range(1, 4):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or (d <= -1 and n[i - 1] - n[i] < -1):
                sign = 1 if d >= 1 else -1
                q_new = self._parabolic(i, sign)
                if q[i - 1] < q_new < q[i + 1]:
                    q[i] = q_new
                else:
                    q[i] = self._linear(i, sign)
                n[i] += sign

    def _parabolic(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])

    @property
    def value(self) -> float:
        if not self._q:
            return math.nan
        if len(self._q) < 5:
            s = sorted(self._q)
            idx = min(int(self.p * len(s)), len(s) - 1)
            return s[idx]
        return self._q[2]


@dataclass
class StreamingStats:
    """Latency stream summary: mean/min/max + P² p50/p95/p99."""

    count: int = 0
    mean: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    _m2: float = 0.0
    p50: P2Quantile = field(default_factory=lambda: P2Quantile(0.5))
    p95: P2Quantile = field(default_factory=lambda: P2Quantile(0.95))
    p99: P2Quantile = field(default_factory=lambda: P2Quantile(0.99))

    def observe(self, x: float) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        self.p50.observe(x)
        self.p95.observe(x)
        self.p99.observe(x)

    @property
    def std(self) -> float:
        return math.sqrt(self._m2 / (self.count - 1)) if self.count > 1 else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "std": self.std,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.p50.value,
            "p95": self.p95.value,
            "p99": self.p99.value,
        }
