"""Cross-feature invariant oracles + lane catalog for composition testing.

Parity target: reference crates/frankensearch-fusion/src/interaction_oracles.rs
(+ lanes) — a catalog of searcher feature "lanes" (each a config knob)
and oracles (invariants that must hold for ANY combination of lanes),
so feature interactions are tested as a matrix instead of ad hoc.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from frankensearch_tpu_torch.core.config import TwoTierConfig
from frankensearch_tpu_torch.core.types import PhaseKind


@dataclass(frozen=True)
class Lane:
    """One feature toggle: name + config mutation."""

    name: str
    apply: Callable[[TwoTierConfig], TwoTierConfig]


def _with(**kwargs) -> Callable[[TwoTierConfig], TwoTierConfig]:
    def apply(cfg: TwoTierConfig) -> TwoTierConfig:
        d = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
        d.update(kwargs)
        return TwoTierConfig(**d)

    return apply


LANE_CATALOG: tuple[Lane, ...] = (
    Lane("baseline", _with()),
    Lane("fast_only", _with(fast_only=True)),
    Lane("explain", _with(explain=True)),
    Lane("pool_minmax", _with()),  # strategy switched by oracle harness
    Lane("mrl", _with(mrl_search_dims=32)),
    Lane("low_rrf_k", _with(rrf_k=20)),
    Lane("nqc", _with(nqc_downweight=True)),
    # intent-aware stage planning: budgets + plan-gated phases must hold
    # every oracle in combination with the rest of the catalog
    Lane("plan", _with(query_planning=True)),
)


@dataclass(frozen=True)
class OracleViolation:
    oracle: str
    lane: str
    detail: str


@dataclass
class OracleReport:
    checked: int = 0
    violations: list[OracleViolation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


# --- oracles: invariants over a SearchOutcome ------------------------------


def oracle_results_sorted(outcome) -> str | None:
    scores = [r.score for r in outcome.results]
    if any(a < b - 1e-9 for a, b in zip(scores, scores[1:])):
        return "results not sorted by score desc"
    return None


def oracle_no_duplicate_docs(outcome) -> str | None:
    ids = [r.doc_id for r in outcome.results]
    if len(ids) != len(set(ids)):
        return "duplicate doc ids in results"
    return None


def oracle_phases_ordered(outcome) -> str | None:
    order = {PhaseKind.INITIAL: 0, PhaseKind.REFINED: 1,
             PhaseKind.REFINEMENT_FAILED: 1, PhaseKind.RERANKED: 2}
    seq = [order[p.kind] for p in outcome.phases]
    if seq != sorted(seq):
        return f"phase order violated: {[p.kind.value for p in outcome.phases]}"
    if seq and seq[0] != 0:
        return "first phase is not INITIAL"
    return None


def oracle_metrics_consistent(outcome) -> str | None:
    m = outcome.metrics
    if m.total_ms < 0 or m.phase1_ms < 0:
        return "negative timings"
    if m.fused_candidates < len(outcome.results):
        return "fewer fused candidates than returned results"
    return None


def oracle_skip_reason_excludes_refined(outcome) -> str | None:
    if outcome.metrics.phase2_skip_reason:
        if any(p.kind is PhaseKind.REFINED for p in outcome.phases):
            return "REFINED emitted despite a phase-2 skip reason"
    return None


ORACLES: dict[str, Callable] = {
    "results_sorted": oracle_results_sorted,
    "no_duplicate_docs": oracle_no_duplicate_docs,
    "phases_ordered": oracle_phases_ordered,
    "metrics_consistent": oracle_metrics_consistent,
    "skip_reason_excludes_refined": oracle_skip_reason_excludes_refined,
}


def run_interaction_matrix(
    make_searcher: Callable[[TwoTierConfig], object],
    queries: Sequence[str],
    *,
    lanes: Sequence[Lane] = LANE_CATALOG,
    k: int = 5,
) -> OracleReport:
    """Run every lane x query x oracle combination."""
    report = OracleReport()
    for lane in lanes:
        cfg = lane.apply(TwoTierConfig())
        searcher = make_searcher(cfg)
        for query in queries:
            outcome = searcher.search(query, k=k)
            for name, oracle in ORACLES.items():
                report.checked += 1
                detail = oracle(outcome)
                if detail is not None:
                    report.violations.append(
                        OracleViolation(oracle=name, lane=lane.name, detail=detail)
                    )
    return report
