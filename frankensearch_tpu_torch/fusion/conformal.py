"""Distribution-free conformal coverage for result-set size.

Parity target: reference crates/frankensearch-fusion/src/conformal.rs
(:1-8) — given calibration data of "rank at which the relevant doc
appeared", compute the k required for coverage 1 - alpha via the split
conformal quantile, with an online adaptive update (Gibbs & Candès
style: inflate/deflate the quantile as observed coverage drifts).

Calibration ranks are bounded integers in [1, max_k + 1], so the set is
stored as COUNTS PER RANK — a fixed-size representation with the exact
same quantiles. The previous sorted-list storage grew one entry per
feedback event forever (persisted into control_plane.json, O(n) insort
per event — probed 2026-08-18, same slow-leak class as the feedback
booster's per-event signal lists).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class ConformalK:
    alpha: float = 0.1
    max_k: int = 100
    #: online learning rate for adaptive conformal
    gamma: float = 0.02
    #: rank (1..max_k+1; max_k+1 = "not found") -> observation count
    _rank_counts: dict[int, int] = field(default_factory=dict)
    _n: int = 0
    _alpha_t: float | None = None

    def calibrate(self, ranks: list[int]) -> None:
        """ranks: 1-based rank of the first relevant result per query
        (use max_k + 1 for 'not found')."""
        self._rank_counts = {}
        self._n = 0
        for r in ranks:
            self._bump(int(r))
        self._alpha_t = self.alpha

    def _bump(self, rank: int) -> None:
        rank = min(max(rank, 1), self.max_k + 1)
        self._rank_counts[rank] = self._rank_counts.get(rank, 0) + 1
        self._n += 1

    def required_k(self, confidence: float | None = None) -> int:
        """Smallest k such that P(relevant in top-k) >= confidence,
        by the split-conformal quantile with the +1 correction."""
        alpha = 1.0 - confidence if confidence is not None else (self._alpha_t or self.alpha)
        alpha = min(max(alpha, 1e-6), 1.0)
        n = self._n
        if n == 0:
            # no calibration data: no coverage guarantee is claimable, so
            # claim NO widening — returning max_k here silently inflated
            # every cold-start search to k=100 (review finding)
            return 0
        q_index = math.ceil((n + 1) * (1.0 - alpha)) - 1
        q_index = min(max(q_index, 0), n - 1)
        # the rank at sorted position q_index, walked over the counts
        seen = 0
        for rank in sorted(self._rank_counts):
            seen += self._rank_counts[rank]
            if seen > q_index:
                return min(rank, self.max_k)
        return self.max_k  # pragma: no cover (counts always cover n)

    def observe(self, covered: bool) -> None:
        """Adaptive conformal update: alpha_t += gamma * (alpha - err)."""
        if self._alpha_t is None:
            self._alpha_t = self.alpha
        err = 0.0 if covered else 1.0
        self._alpha_t = min(max(self._alpha_t + self.gamma * (self.alpha - err), 1e-4), 0.5)

    @property
    def empirical_coverage_target(self) -> float:
        return 1.0 - (self._alpha_t if self._alpha_t is not None else self.alpha)

    def add_rank(self, rank: int) -> None:
        """Online calibration: fold one observed first-relevant rank into
        the calibration counts (the CLI feedback path records these)."""
        self._bump(int(rank))
        if self._alpha_t is None:
            self._alpha_t = self.alpha

    def to_state(self) -> dict:
        return {
            "alpha": self.alpha,
            "max_k": self.max_k,
            "gamma": self.gamma,
            # fixed-size counts map (rank -> n); replaces the unbounded
            # "ranks" event list of pre-fold states
            "rank_counts": {str(r): c for r, c in sorted(self._rank_counts.items())},
            "n": self._n,
            "alpha_t": self._alpha_t,
        }

    @classmethod
    def from_state(cls, state: dict) -> "ConformalK":
        self = cls(
            alpha=float(state.get("alpha", 0.1)),
            max_k=int(state.get("max_k", 100)),
            gamma=float(state.get("gamma", 0.02)),
        )
        if "rank_counts" in state:
            for r, c in state["rank_counts"].items():
                rank = min(max(int(r), 1), self.max_k + 1)
                self._rank_counts[rank] = self._rank_counts.get(rank, 0) + int(c)
                self._n += int(c)
        else:
            # pre-fold state: an event list of ranks — fold exactly
            for r in state.get("ranks", []):
                self._bump(int(r))
        at = state.get("alpha_t")
        self._alpha_t = float(at) if at is not None else None
        return self
