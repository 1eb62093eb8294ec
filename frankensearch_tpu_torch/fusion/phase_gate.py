"""Anytime-valid e-process gate for Phase 2.

Parity target: reference crates/frankensearch-fusion/src/phase_gate.rs
(:1-8, :100) — a sequential test that accumulates evidence across
searches and skips Phase 2 once it is *statistically proven unhelpful*,
with anytime validity (no peeking penalty).

Model: each completed Phase 2 yields a Bernoulli observation
``improved in {0,1}`` (did refinement meaningfully change the top-k?).
H0: P(improved) >= p0 (refinement is useful). The e-process bets
against improvement:

    E_t = prod_i (1 + lam * (p0 - x_i) / p0)

E_t is a nonnegative supermartingale under H0, so by Ville's inequality
P(sup E_t >= 1/alpha) <= alpha: crossing 1/alpha rejects usefulness
with anytime validity. After ``reprobe_every`` consecutive skips the
gate admits one probe so a drifting workload can re-enable Phase 2.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PhaseGate:
    #: usefulness floor under H0 (fraction of searches Phase 2 should improve)
    p0: float = 0.2
    #: bet aggressiveness in (0, 1)
    lam: float = 0.5
    #: significance level
    alpha: float = 0.05
    #: admit a probe after this many consecutive skips
    reprobe_every: int = 50

    e_value: float = 1.0
    observations: int = 0
    skips: int = 0
    _consecutive_skips: int = 0

    @property
    def threshold(self) -> float:
        return 1.0 / self.alpha

    @property
    def proven_unhelpful(self) -> bool:
        return self.e_value >= self.threshold

    def should_skip_quality(self) -> bool:
        if not self.proven_unhelpful:
            return False
        if self._consecutive_skips >= self.reprobe_every:
            self._consecutive_skips = 0
            return False  # probe
        self.skips += 1
        self._consecutive_skips += 1
        return True

    def record(self, improved: bool) -> None:
        x = 1.0 if improved else 0.0
        factor = 1.0 + self.lam * (self.p0 - x) / self.p0
        self.e_value = max(self.e_value * max(factor, 0.0), 1e-12)
        self.observations += 1
        if improved:
            # strong evidence of usefulness resets the skip streak
            self._consecutive_skips = 0
