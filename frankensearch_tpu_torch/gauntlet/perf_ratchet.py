"""Performance ratchet with A/A null controls and stability gates.

Parity target: reference gauntlet/src/perf_ratchet.rs + docs/PERF_LEDGER.md
— perf claims require: same-invocation incumbent A/B, an A/A null control
(the measurement must NOT find a difference between two runs of the same
code), CV stability pre-gate, and a persisted bench-history ledger.

:func:`measure` times ``fn()`` on the host clock with no device
synchronisation, as the reference does. A caller that times work on the
card passes a function that ends on host values: ``search_batch`` and
``search()`` return hydrated host results, so each is such a function.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Sequence

from frankensearch_tpu_torch.core.metrics_eval import (
    bootstrap_compare,
    stability_verdict,
)


@dataclass(frozen=True)
class RatchetGate:
    """QG-style gate: candidate must not regress more than max_regression
    and the measurement must pass stability + A/A null checks."""

    name: str
    max_regression: float = 0.20  # 20% (benchmark_baseline_matrix.rs)
    max_cv: float = 0.15
    min_samples: int = 5
    confidence: float = 0.95


@dataclass
class RatchetOutcome:
    gate: str
    passed: bool
    reason: str
    incumbent_mean: float = 0.0
    candidate_mean: float = 0.0
    ratio: float = 1.0
    aa_null_ok: bool = True
    stable: bool = True

    def to_dict(self) -> dict:
        return {
            "gate": self.gate,
            "passed": self.passed,
            "reason": self.reason,
            "incumbent_mean": self.incumbent_mean,
            "candidate_mean": self.candidate_mean,
            "ratio": self.ratio,
            "aa_null_ok": self.aa_null_ok,
            "stable": self.stable,
        }


def measure(fn: Callable[[], None], samples: int = 7, warmup: int = 2) -> list[float]:
    """Wall-time samples of fn (seconds)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def run_ratchet(
    gate: RatchetGate,
    incumbent: Sequence[float],
    candidate: Sequence[float],
    incumbent_null: Sequence[float] | None = None,
) -> RatchetOutcome:
    """Lower is better (latency samples). incumbent_null is a second run of
    the incumbent for the A/A control."""
    sv_i = stability_verdict(incumbent, max_cv=gate.max_cv, min_samples=gate.min_samples)
    sv_c = stability_verdict(candidate, max_cv=gate.max_cv, min_samples=gate.min_samples)
    if not (sv_i.stable and sv_c.stable):
        return RatchetOutcome(
            gate=gate.name, passed=False, stable=False,
            reason=f"unstable measurement: incumbent={sv_i.reason}, candidate={sv_c.reason}",
        )
    aa_ok = True
    if incumbent_null is not None:
        n = min(len(incumbent), len(incumbent_null))
        aa = bootstrap_compare(list(incumbent)[:n], list(incumbent_null)[:n],
                               confidence=gate.confidence)
        aa_ok = not aa.significant
    inc_mean = sum(incumbent) / len(incumbent)
    cand_mean = sum(candidate) / len(candidate)
    ratio = cand_mean / inc_mean if inc_mean else 1.0
    if not aa_ok:
        return RatchetOutcome(
            gate=gate.name, passed=False, aa_null_ok=False,
            incumbent_mean=inc_mean, candidate_mean=cand_mean, ratio=ratio,
            reason="A/A null control found a significant difference; measurement untrusted",
        )
    if ratio > 1.0 + gate.max_regression:
        n = min(len(incumbent), len(candidate))
        cmp = bootstrap_compare(list(incumbent)[:n], list(candidate)[:n],
                                confidence=gate.confidence)
        if cmp.significant:
            return RatchetOutcome(
                gate=gate.name, passed=False,
                incumbent_mean=inc_mean, candidate_mean=cand_mean, ratio=ratio,
                reason=f"regression {ratio:.2f}x exceeds {1 + gate.max_regression:.2f}x (significant)",
            )
    return RatchetOutcome(
        gate=gate.name, passed=True,
        incumbent_mean=inc_mean, candidate_mean=cand_mean, ratio=ratio,
        reason="within ratchet",
    )


@dataclass
class BenchLedger:
    """Persisted bench history (.bench-history/*.json parity)."""

    dir: str

    def record(self, outcome: RatchetOutcome, context: dict | None = None) -> str:
        os.makedirs(self.dir, exist_ok=True)
        entry = {"at": time.time(), **outcome.to_dict(), "context": context or {}}
        path = os.path.join(self.dir, f"{outcome.gate}.latest.json")
        history_path = os.path.join(self.dir, f"{outcome.gate}.history.jsonl")
        with open(history_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(entry) + "\n")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(entry, f, indent=2)
        return path

    def latest(self, gate: str) -> dict | None:
        path = os.path.join(self.dir, f"{gate}.latest.json")
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return json.load(f)
