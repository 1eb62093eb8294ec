"""SLO error budgets + anomaly payloads over fleet telemetry.

Parity target: reference docs/slo-anomaly-contract.md — the canonical
versioned contract for SLO metrics, error-budget computation across
fixed windows, anomaly payload semantics, and alert reason codes with
confidence bands. The formulas are the contract's machine-testable v1:

    bad_ratio_w = bad_events_w / max(total_events_w, 1)
    consumed_w  = clamp01(bad_ratio_w / objective_bad_ratio)
    remaining_w = 1 - consumed_w
    burn_rate_w = consumed_w / budget_fraction_w

Reason codes follow ``slo.<metric>.<condition>`` /
``anomaly.<metric>.<condition>``; anomalies carry baseline context,
deviation (absolute / relative / z-score), suppression metadata, and
confidence {score, band, evidence_points}.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

FORMULA_VERSION = "v1"

#: canonical metric registry (contract: required metric IDs)
METRICS: dict[str, dict] = {
    "search_latency_p95": {
        "objective_bad_ratio": 0.05,  # <=5% of samples may breach
        "objective_threshold": 100.0,  # ms
        "unit": "ms",
        "reason_code_prefix": "search_latency_p95",
    },
    "query_failure_rate": {
        "objective_bad_ratio": 0.01,
        "objective_threshold": 0.0,  # any error event is bad
        "unit": "errors",
        "reason_code_prefix": "query_failure_rate",
    },
    "stale_index_lag": {
        "objective_bad_ratio": 0.10,
        "objective_threshold": 300.0,  # seconds behind
        "unit": "s",
        "reason_code_prefix": "stale_index_lag",
    },
    "embedding_backlog_age": {
        "objective_bad_ratio": 0.10,
        "objective_threshold": 600.0,  # seconds queued
        "unit": "s",
        "reason_code_prefix": "embedding_backlog_age",
    },
}

#: required windows (seconds) with per-window budget fractions > 0
WINDOWS: dict[str, float] = {
    "1m": 60.0, "15m": 900.0, "1h": 3600.0, "6h": 21600.0,
    "24h": 86400.0, "3d": 259200.0, "1w": 604800.0,
}
BUDGET_FRACTIONS: dict[str, float] = {
    "1m": 0.02, "15m": 0.05, "1h": 0.10, "6h": 0.25,
    "24h": 0.50, "3d": 0.75, "1w": 1.00,
}

#: burn-rate alert thresholds (severity ladder)
_BURN_WARN = 1.0
_BURN_CRITICAL = 2.0


def _clamp01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def error_budget(
    bad_events: int, total_events: int, *, metric_id: str, window: str
) -> dict:
    """The contract's v1 formulas, verbatim."""
    spec = METRICS[metric_id]
    budget_fraction = BUDGET_FRACTIONS[window]
    bad_ratio = bad_events / max(total_events, 1)
    consumed = _clamp01(bad_ratio / spec["objective_bad_ratio"])
    return {
        "formula_version": FORMULA_VERSION,
        "metric_id": metric_id,
        "window": window,
        "bad_events": bad_events,
        "total_events": total_events,
        "bad_ratio": bad_ratio,
        "consumed": consumed,
        "remaining": 1.0 - consumed,
        "burn_rate": consumed / budget_fraction,
    }


def budget_alert(budget: dict) -> dict | None:
    """slo.<metric>.<condition> alert from a budget row, or None."""
    burn = budget["burn_rate"]
    if burn < _BURN_WARN:
        return None
    severity = "critical" if burn >= _BURN_CRITICAL else "warn"
    return {
        "reason_code": f"slo.{budget['metric_id']}.budget_burn_high",
        "severity": severity,
        "metric_id": budget["metric_id"],
        "window": budget["window"],
        "burn_rate": budget["burn_rate"],
        "remaining": budget["remaining"],
    }


@dataclass
class Event:
    metric_id: str
    at_s: float
    value: float


@dataclass
class SloEvaluator:
    """Ingest timestamped metric events; evaluate budgets + anomalies.

    ``now_s`` is injected (no wall-clock reads: deterministic tests and
    replayable fixtures, the repo-wide determinism stance)."""

    events: list[Event] = field(default_factory=list)

    def record(self, metric_id: str, value: float, at_s: float) -> None:
        if metric_id not in METRICS:
            raise KeyError(f"unknown SLO metric {metric_id!r}")
        self.events.append(Event(metric_id, at_s, value))

    def _window_events(self, metric_id: str, window: str, now_s: float) -> list[Event]:
        lo = now_s - WINDOWS[window]
        return [e for e in self.events if e.metric_id == metric_id and e.at_s > lo]

    def budgets(self, now_s: float) -> list[dict]:
        out = []
        for metric_id, spec in METRICS.items():
            for window in WINDOWS:
                evs = self._window_events(metric_id, window, now_s)
                bad = sum(1 for e in evs if e.value > spec["objective_threshold"])
                out.append(error_budget(
                    bad, len(evs), metric_id=metric_id, window=window,
                ))
        return out

    def anomalies(self, now_s: float, *, short: str = "15m", long: str = "6h") -> list[dict]:
        """Spike/regression detection: the short-window mean against the
        long-window baseline (method recorded in the payload)."""
        out = []
        for metric_id in METRICS:
            cur_evs = self._window_events(metric_id, short, now_s)
            # baseline = the long window EXCLUDING the short window —
            # otherwise a spike contaminates its own baseline and the
            # z-score can never clear the gate
            cur_lo = now_s - WINDOWS[short]
            base_evs = [
                e for e in self._window_events(metric_id, long, now_s)
                if e.at_s <= cur_lo
            ]
            if len(base_evs) < 5 or not cur_evs:
                continue
            base_vals = [e.value for e in base_evs]
            mean = sum(base_vals) / len(base_vals)
            var = sum((v - mean) ** 2 for v in base_vals) / len(base_vals)
            std = math.sqrt(var)
            observed = sum(e.value for e in cur_evs) / len(cur_evs)
            z = (observed - mean) / std if std > 1e-12 else 0.0
            if z < 3.0:
                continue
            n = len(cur_evs)
            confidence = _clamp01(min(z / 6.0, 1.0) * min(n / 10.0, 1.0))
            band = "high" if confidence >= 0.7 else ("medium" if confidence >= 0.4 else "low")
            out.append({
                "metric_id": metric_id,
                "window": short,
                "reason_code": f"anomaly.{metric_id}.spike",
                "severity": "critical" if band == "high" else "warn",
                "baseline": {
                    "method": "mean_z_score",
                    "baseline_value": mean,
                    "lookback_points": len(base_evs),
                },
                "observed_value": observed,
                "deviation": {
                    "absolute": observed - mean,
                    "relative_pct": ((observed - mean) / mean * 100.0) if mean else 0.0,
                    "z_score": z,
                },
                "is_suppressed": False,
                "policy_id": None,
                "until_ts": None,
                "suppress_reason_code": None,
                "confidence": {
                    "score": confidence,
                    "band": band,
                    "evidence_points": n,
                },
            })
        return out

    def report(self, now_s: float) -> dict:
        budgets = self.budgets(now_s)
        alerts = [a for a in (budget_alert(b) for b in budgets) if a]
        return {
            "v": 1,
            "formula_version": FORMULA_VERSION,
            "budgets": budgets,
            "alerts": alerts,
            "anomalies": self.anomalies(now_s),
        }


def from_fleet_samples(samples) -> SloEvaluator:
    """Feed fleet NodeSamples (fleet/registry.py) into the evaluator:
    p99_ms -> search_latency_p95 events, errors -> query_failure_rate
    events (a sample with errors > threshold 0 counts as bad)."""
    ev = SloEvaluator()
    for s in samples:
        ev.record("search_latency_p95", float(s.p99_ms), float(s.at_s))
        ev.record("query_failure_rate", float(getattr(s, "errors", 0)), float(s.at_s))
    return ev
