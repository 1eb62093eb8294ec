"""Query planning: intent -> budget mapping -> staged execution plan.

Parity target: reference crates/frankensearch-fsfs/src/query_planning.rs
(+ query_execution.rs, query_latency_optimization.rs) — classify intent,
map to per-stage budgets, emit a staged plan whose stages can be
cancelled at budget exhaustion while keeping partial results correct,
and decompose measured latency against the plan.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from frankensearch_tpu_torch.core.decision_plane import (
    Decision,
    PipelineAction,
    ReasonCode,
    ResourceBudget,
)
from frankensearch_tpu_torch.core.query_class import QueryClass


class QueryIntent(enum.Enum):
    """Coarse intent classes driving budget allocation."""

    LOOKUP = "lookup"  # identifier / exact thing
    KEYWORD = "keyword"  # short keyword search
    EXPLORATORY = "exploratory"  # natural language, quality matters
    EMPTY = "empty"


def classify_intent(query: str) -> QueryIntent:
    qc = QueryClass.classify(query)
    return {
        QueryClass.EMPTY: QueryIntent.EMPTY,
        QueryClass.IDENTIFIER: QueryIntent.LOOKUP,
        QueryClass.SHORT_KEYWORD: QueryIntent.KEYWORD,
        QueryClass.NATURAL_LANGUAGE: QueryIntent.EXPLORATORY,
    }[qc]


@dataclass(frozen=True)
class StagePlan:
    stage: str  # "lexical" | "fast_vector" | "quality" | "rerank"
    enabled: bool
    budget_ms: float
    reason: str = ""


@dataclass
class QueryPlan:
    intent: QueryIntent
    stages: list[StagePlan] = field(default_factory=list)
    total_budget_ms: float = 0.0

    def stage(self, name: str) -> StagePlan | None:
        for s in self.stages:
            if s.stage == name:
                return s
        return None


#: per-intent budget split (fractions of the total wall budget)
_SPLITS: dict[QueryIntent, dict[str, float]] = {
    QueryIntent.LOOKUP: {"lexical": 0.5, "fast_vector": 0.3, "quality": 0.0, "rerank": 0.0},
    QueryIntent.KEYWORD: {"lexical": 0.25, "fast_vector": 0.25, "quality": 0.4, "rerank": 0.0},
    QueryIntent.EXPLORATORY: {"lexical": 0.15, "fast_vector": 0.2, "quality": 0.4, "rerank": 0.25},
    QueryIntent.EMPTY: {},
}


def plan_query(
    query: str,
    *,
    budget: ResourceBudget | None = None,
    has_quality: bool = True,
    has_reranker: bool = False,
) -> QueryPlan:
    intent = classify_intent(query)
    budget = budget or ResourceBudget()
    plan = QueryPlan(intent=intent, total_budget_ms=budget.wall_ms)
    for stage, frac in _SPLITS[intent].items():
        enabled = frac > 0.0
        reason = ""
        if stage == "quality" and not has_quality:
            enabled, reason = False, "no quality tier"
        if stage == "rerank" and not has_reranker:
            enabled, reason = False, "no reranker"
        plan.stages.append(
            StagePlan(stage=stage, enabled=enabled,
                      budget_ms=budget.wall_ms * frac, reason=reason)
        )
    return plan


@dataclass
class LatencyDecomposition:
    """Measured per-stage time vs plan (query_latency_optimization.rs)."""

    plan: QueryPlan
    measured_ms: dict[str, float] = field(default_factory=dict)

    def record(self, stage: str, ms: float) -> None:
        self.measured_ms[stage] = self.measured_ms.get(stage, 0.0) + ms

    def over_budget_stages(self) -> list[str]:
        out = []
        for s in self.plan.stages:
            if s.enabled and self.measured_ms.get(s.stage, 0.0) > s.budget_ms > 0:
                out.append(s.stage)
        return out

    def decision_for(self, stage: str) -> Decision:
        """Continue-or-cut decision at a stage boundary."""
        spent = sum(self.measured_ms.values())
        if spent >= self.plan.total_budget_ms:
            return Decision(PipelineAction.REDUCE_BUDGET, ReasonCode.BUDGET_EXHAUSTED,
                            {"spent_ms": spent})
        s = self.plan.stage(stage)
        if s is None or not s.enabled:
            return Decision(PipelineAction.SKIP_QUALITY if stage == "quality"
                            else PipelineAction.SKIP_RERANK,
                            ReasonCode.OK, {})
        return Decision(PipelineAction.RUN_FULL, ReasonCode.OK, {})
