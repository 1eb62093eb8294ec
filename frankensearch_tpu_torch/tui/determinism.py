"""Deterministic time + randomness for replayable TUI sessions.

Parity target: reference crates/frankensearch-tui/src/determinism.rs —
``TickClock`` virtual time advanced only by explicit ticks, plus a
seeded RNG, so a recorded session replays frame-identically.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class TickClock:
    """Virtual monotonic clock: advances only via tick()/advance()."""

    tick_ms: float = 100.0
    _now_ms: float = 0.0
    ticks: int = 0

    def now_ms(self) -> float:
        return self._now_ms

    def now_s(self) -> float:
        return self._now_ms / 1000.0

    def tick(self, n: int = 1) -> float:
        self.ticks += n
        self._now_ms += self.tick_ms * n
        return self._now_ms

    def advance(self, ms: float) -> float:
        self._now_ms += ms
        return self._now_ms


@dataclass
class DeterministicRng:
    seed: int = 0
    _rng: random.Random = field(init=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def random(self) -> float:
        return self._rng.random()

    def randint(self, a: int, b: int) -> int:
        return self._rng.randint(a, b)

    def choice(self, seq):
        return self._rng.choice(seq)

    def fork(self, label: str) -> "DeterministicRng":
        """Independent stream derived from (seed, label) — stable across
        runs regardless of draw order elsewhere."""
        import hashlib

        h = hashlib.blake2b(f"{self.seed}:{label}".encode(), digest_size=8)
        return DeterministicRng(seed=int.from_bytes(h.digest(), "big"))
