"""Shared types for adaptive ranking controls.

Parity target: reference crates/frankensearch-core/src/decision_plane.rs —
loss vectors, resource budgets, pipeline actions, and reason codes shared
by every adaptive control (breaker, gate, adaptive fusion, governor), so
decisions are explainable with one taxonomy.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Mapping


class PipelineAction(enum.Enum):
    RUN_FULL = "run_full"
    SKIP_QUALITY = "skip_quality"
    SKIP_RERANK = "skip_rerank"
    LEXICAL_ONLY = "lexical_only"
    REDUCE_BUDGET = "reduce_budget"
    REJECT = "reject"


class ReasonCode(enum.Enum):
    """One taxonomy for every skip/degrade decision (metrics carry these)."""

    OK = "ok"
    FAST_ONLY_CONFIG = "fast_only"
    NO_QUALITY_TIER = "no_quality_tier"
    NO_QUALITY_EMBEDDER = "no_quality_embedder"
    NO_CANDIDATES = "no_candidates"
    NO_SEMANTIC_CANDIDATES = "no_semantic_candidates"
    CIRCUIT_OPEN = "circuit_open"
    PHASE_GATE = "phase_gate"
    TIMEOUT = "timeout"
    ERROR = "error"
    PRESSURE = "pressure"
    IDENTITY_REJECTED = "identity_rejected"
    BUDGET_EXHAUSTED = "budget_exhausted"


@dataclass(frozen=True)
class LossVector:
    """Multi-objective outcome of a pipeline decision: what it cost and
    what it bought (decision_plane.rs loss vectors)."""

    latency_ms: float = 0.0
    device_ms: float = 0.0
    quality_delta: float = 0.0  # estimated nDCG-ish gain of the step
    tokens_embedded: int = 0

    def dominated_by(self, other: "LossVector") -> bool:
        """other is at least as good on every axis and better on one."""
        le = (
            other.latency_ms <= self.latency_ms
            and other.device_ms <= self.device_ms
            and other.quality_delta >= self.quality_delta
        )
        lt = (
            other.latency_ms < self.latency_ms
            or other.device_ms < self.device_ms
            or other.quality_delta > self.quality_delta
        )
        return le and lt


@dataclass
class ResourceBudget:
    """Per-request budget envelope the planner decrements."""

    wall_ms: float = 1000.0
    device_ms: float = 500.0
    embed_tokens: int = 8192
    spent: LossVector = field(default_factory=LossVector)

    def charge(self, loss: LossVector) -> bool:
        """Apply a loss; False when the budget is exhausted."""
        self.spent = LossVector(
            latency_ms=self.spent.latency_ms + loss.latency_ms,
            device_ms=self.spent.device_ms + loss.device_ms,
            quality_delta=self.spent.quality_delta + loss.quality_delta,
            tokens_embedded=self.spent.tokens_embedded + loss.tokens_embedded,
        )
        return not self.exhausted

    @property
    def exhausted(self) -> bool:
        return (
            self.spent.latency_ms >= self.wall_ms
            or self.spent.device_ms >= self.device_ms
            or self.spent.tokens_embedded >= self.embed_tokens
        )


@dataclass(frozen=True)
class Decision:
    action: PipelineAction
    reason: ReasonCode
    detail: Mapping[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "action": self.action.value,
            "reason": self.reason.value,
            "detail": dict(self.detail),
        }
