"""Quality-tier circuit breaker.

Parity target: reference crates/frankensearch-fusion/src/circuit_breaker.rs
(:1-8, :169) — Closed/Open/HalfOpen state machine over Phase-2 outcomes
(slow / failing / non-improving); when Open, Phase 2 is skipped outright
(skip_reason = "circuit_open"); after a cooldown the breaker admits one
trial probe (HalfOpen) and closes again only on success.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclass
class Phase2Outcome:
    failed: bool = False
    timed_out: bool = False
    slow: bool = False
    improved: bool = True

    @property
    def is_bad(self) -> bool:
        return self.failed or self.timed_out or self.slow or not self.improved


@dataclass
class CircuitBreaker:
    #: consecutive bad outcomes before opening
    failure_threshold: int = 3
    #: seconds the breaker stays open before admitting a half-open probe
    cooldown_s: float = 30.0
    #: injectable clock (tests)
    clock: "callable" = time.monotonic

    state: BreakerState = BreakerState.CLOSED
    consecutive_bad: int = 0
    opened_at: float = 0.0
    trips: int = 0
    _history: list[bool] = field(default_factory=list)

    def should_skip_quality(self) -> bool:
        """True -> skip Phase 2 (searcher.rs:1080 gate)."""
        if self.state is BreakerState.CLOSED:
            return False
        if self.state is BreakerState.OPEN:
            if self.clock() - self.opened_at >= self.cooldown_s:
                self.state = BreakerState.HALF_OPEN
                return False  # admit one probe
            return True
        return False  # HALF_OPEN: probe in flight

    def record_outcome(self, outcome: Phase2Outcome) -> None:
        bad = outcome.is_bad
        self._history.append(bad)
        if self.state is BreakerState.HALF_OPEN:
            if bad:
                self._open()
            else:
                self.state = BreakerState.CLOSED
                self.consecutive_bad = 0
            return
        if bad:
            self.consecutive_bad += 1
            if self.consecutive_bad >= self.failure_threshold:
                self._open()
        else:
            self.consecutive_bad = 0

    def _open(self) -> None:
        self.state = BreakerState.OPEN
        self.opened_at = self.clock()
        self.trips += 1
        self.consecutive_bad = 0
