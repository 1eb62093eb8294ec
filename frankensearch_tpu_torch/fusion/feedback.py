"""Implicit feedback boosts: clicks/dwell -> decayed multiplicative boost.

Parity target: reference crates/frankensearch-fusion/src/feedback.rs
(:1-8) — a boost map keyed by doc id, applied multiplicatively after
fusion, with exponential time decay.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Sequence

from frankensearch_tpu_torch.core.types import ScoredResult


@dataclass
class FeedbackBooster:
    #: half-life of a feedback signal, seconds
    half_life_s: float = 7 * 24 * 3600.0
    #: boost increment per click / per strong dwell
    click_boost: float = 0.1
    dwell_boost: float = 0.05
    #: cap on the total multiplier
    max_boost: float = 1.5
    #: signals whose equivalent strength decays below this are pruned
    min_strength: float = 1e-4
    #: distinct docs carried; overflow evicts the weakest (a long-lived
    #: feedback loop grew control_plane.json and boost_for cost without
    #: bound before folding — probed 2026-08-18)
    max_docs: int = 10_000
    clock: "callable" = time.time
    #: doc -> (anchor_time, equivalent_strength_at_anchor). Exponential
    #: decay composes EXACTLY: sum_i s_i * 0.5^((t-t_i)/hl) =
    #: S0 * 0.5^((t-t0)/hl) with S0 = sum_i s_i * 0.5^((t0-t_i)/hl) —
    #: one pair per doc replaces the unbounded per-event list with
    #: bitwise-equivalent math (modulo float rounding).
    _signals: dict[str, tuple[float, float]] = field(default_factory=dict)

    def _decay(self, strength: float, dt: float) -> float:
        return strength * math.pow(0.5, max(dt, 0.0) / self.half_life_s)

    def _fold(self, doc_id: str, strength: float) -> None:
        now = self.clock()
        prev = self._signals.get(doc_id)
        total = strength + (self._decay(prev[1], now - prev[0]) if prev else 0.0)
        self._signals[doc_id] = (now, total)
        if len(self._signals) > self.max_docs:
            self._prune(now)

    def _prune(self, now: float) -> None:
        alive = {
            d: (t, s) for d, (t, s) in self._signals.items()
            if self._decay(s, now - t) >= self.min_strength
        }
        if len(alive) > self.max_docs:
            ordered = sorted(
                alive.items(), key=lambda kv: -self._decay(kv[1][1], now - kv[1][0])
            )
            alive = dict(ordered[: self.max_docs])
        self._signals = alive

    def record_click(self, doc_id: str) -> None:
        self._fold(doc_id, self.click_boost)

    def record_dwell(self, doc_id: str, seconds: float) -> None:
        self._fold(doc_id, self.dwell_boost * min(seconds / 30.0, 2.0))

    def boost_for(self, doc_id: str) -> float:
        sig = self._signals.get(doc_id)
        if sig is None:
            return 1.0
        total = self._decay(sig[1], self.clock() - sig[0])
        return min(1.0 + total, self.max_boost)

    def to_state(self) -> dict:
        now = self.clock()
        self._prune(now)
        return {"signals": {d: [t, s] for d, (t, s) in self._signals.items()}}

    @classmethod
    def from_state(cls, state: dict, **kwargs) -> "FeedbackBooster":
        self = cls(**kwargs)
        for d, sig in state.get("signals", {}).items():
            if not sig:
                continue
            if isinstance(sig[0], (list, tuple)):
                # pre-fold state: a list of [t, strength] events — fold
                # them into the single anchored pair (exact composition)
                anchor = max(float(t) for t, _ in sig)
                total = sum(
                    self._decay(float(s), anchor - float(t)) for t, s in sig
                )
                self._signals[str(d)] = (anchor, total)
            else:
                self._signals[str(d)] = (float(sig[0]), float(sig[1]))
        return self

    def apply(self, results: Sequence[ScoredResult]) -> list[ScoredResult]:
        out = []
        for r in results:
            b = self.boost_for(r.doc_id)
            if b == 1.0:
                out.append(r)
            else:
                out.append(
                    ScoredResult(
                        doc_id=r.doc_id, score=r.score * b,
                        lexical_score=r.lexical_score, fast_score=r.fast_score,
                        quality_score=r.quality_score, rerank_score=r.rerank_score,
                        graph_score=r.graph_score, sources=r.sources, title=r.title,
                        snippet=r.snippet, metadata=r.metadata, explanation=r.explanation,
                    )
                )
        out.sort(key=lambda r: (-r.score, r.doc_id))
        return out
