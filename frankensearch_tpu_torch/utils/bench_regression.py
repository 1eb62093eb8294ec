"""Statistical benchmark-regression lane: golden profiles + bootstrap gate.

Parity target: reference crates/frankensearch-fsfs/tests/
benchmark_baseline_matrix.rs (:16-43) — golden per-profile baselines
(tiny/small/medium), bootstrap comparison at 95% CI, stability pre-gate
(CV <= 0.15, >= 5 samples post IQR-trim), max regression 20%, and a
drift report with the fixed replay command.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Mapping

from frankensearch_tpu_torch.core.metrics_eval import (
    bootstrap_compare,
    iqr_trim,
    stability_verdict,
)

GOLDEN_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class GoldenProfile:
    """A pinned baseline for one corpus/workload shape."""

    name: str  # "tiny" | "small" | ...
    n_docs: int
    metrics: Mapping[str, float]  # metric -> baseline mean (ms or docs/s)
    replay_command: str = ""

    def to_dict(self) -> dict:
        return {
            "v": GOLDEN_SCHEMA_VERSION,
            "name": self.name,
            "n_docs": self.n_docs,
            "metrics": dict(self.metrics),
            "replay_command": self.replay_command,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "GoldenProfile":
        return GoldenProfile(
            name=d["name"], n_docs=d["n_docs"], metrics=dict(d["metrics"]),
            replay_command=d.get("replay_command", ""),
        )


def load_golden(path: str) -> GoldenProfile:
    with open(path, encoding="utf-8") as f:
        return GoldenProfile.from_dict(json.load(f))


def save_golden(path: str, profile: GoldenProfile) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(profile.to_dict(), f, indent=2)


@dataclass
class MetricVerdict:
    metric: str
    admissible: bool  # measurement stable enough to judge
    regressed: bool
    baseline: float
    measured_mean: float
    ratio: float
    detail: str

    def to_dict(self) -> dict:
        return {
            "metric": self.metric,
            "admissible": self.admissible,
            "regressed": self.regressed,
            "baseline": self.baseline,
            "measured_mean": self.measured_mean,
            "ratio": self.ratio,
            "detail": self.detail,
        }


@dataclass
class RegressionReport:
    profile: str
    verdicts: list[MetricVerdict] = field(default_factory=list)
    replay_command: str = ""

    @property
    def passed(self) -> bool:
        return all(not v.regressed for v in self.verdicts if v.admissible)

    def to_dict(self) -> dict:
        return {
            "profile": self.profile,
            "passed": self.passed,
            "verdicts": [v.to_dict() for v in self.verdicts],
            "replay_command": self.replay_command,
        }


def check_regression(
    golden: GoldenProfile,
    measured_samples: Mapping[str, list[float]],
    *,
    max_regression: float = 0.20,
    max_cv: float = 0.15,
    min_samples: int = 5,
    lower_is_better: Mapping[str, bool] | None = None,
) -> RegressionReport:
    """Compare measured sample sets against the golden means.

    A metric regresses when the measurement is stable AND the bootstrap CI
    of (measured - baseline) shows a change beyond max_regression in the
    bad direction. Unstable metrics are reported but never fail the gate
    (the stability PRE-gate, benchmark_baseline_matrix.rs).
    """
    lower = lower_is_better or {}
    report = RegressionReport(profile=golden.name, replay_command=golden.replay_command)
    for metric, baseline in golden.metrics.items():
        samples = list(measured_samples.get(metric, []))
        if not samples:
            report.verdicts.append(
                MetricVerdict(metric, False, False, baseline, float("nan"), 1.0, "no samples")
            )
            continue
        sv = stability_verdict(samples, max_cv=max_cv, min_samples=min_samples)
        trimmed = iqr_trim(samples)
        mean = sum(trimmed) / len(trimmed)
        ratio = mean / baseline if baseline else 1.0
        if not sv.stable:
            report.verdicts.append(
                MetricVerdict(metric, False, False, baseline, mean, ratio,
                              f"unstable: {sv.reason}")
            )
            continue
        is_lower_better = lower.get(metric, metric.endswith("_ms"))
        bad = ratio > 1.0 + max_regression if is_lower_better else ratio < 1.0 - max_regression
        regressed = False
        detail = "within gate"
        if bad:
            baseline_samples = [baseline] * len(trimmed)
            cmp = bootstrap_compare(baseline_samples, trimmed)
            regressed = cmp.significant
            detail = (
                f"{'regression' if regressed else 'not significant'}: ratio {ratio:.3f} "
                f"(gate {1 + max_regression:.2f} {'max' if is_lower_better else 'min'})"
            )
        report.verdicts.append(
            MetricVerdict(metric, True, regressed, baseline, mean, ratio, detail)
        )
    return report


def measure_profile(
    run_once: Callable[[], Mapping[str, float]], samples: int = 7, warmup: int = 1
) -> dict[str, list[float]]:
    """Collect per-metric sample lists from repeated workload runs."""
    for _ in range(warmup):
        run_once()
    out: dict[str, list[float]] = {}
    for _ in range(samples):
        for metric, value in run_once().items():
            out.setdefault(metric, []).append(float(value))
    return out
