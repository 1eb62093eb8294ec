"""Canonical e2e test artifact schemas.

Parity target: reference crates/frankensearch-core/src/e2e_artifact.rs —
manifest / events / oracle-report / replay / snapshot-diff envelopes with
a stable JSON shape, so every e2e lane emits comparable artifacts.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

E2E_SCHEMA_VERSION = 1


@dataclass
class E2eManifest:
    run_id: str
    lane: str  # "cli" | "searcher" | "gauntlet" | ...
    started_at: float = field(default_factory=time.time)
    config: Mapping[str, Any] = field(default_factory=dict)
    corpus_fingerprint: str = ""

    def to_dict(self) -> dict:
        return {
            "v": E2E_SCHEMA_VERSION,
            "kind": "manifest",
            "run_id": self.run_id,
            "lane": self.lane,
            "started_at": self.started_at,
            "config": dict(self.config),
            "corpus_fingerprint": self.corpus_fingerprint,
        }


@dataclass
class OracleReport:
    """Differential-oracle outcome (gauntlet lanes)."""

    run_id: str
    oracle: str
    cases: int = 0
    agreements: int = 0
    divergences: list[dict] = field(default_factory=list)

    @property
    def agreement_rate(self) -> float:
        return self.agreements / self.cases if self.cases else 1.0

    def to_dict(self) -> dict:
        return {
            "v": E2E_SCHEMA_VERSION,
            "kind": "oracle_report",
            "run_id": self.run_id,
            "oracle": self.oracle,
            "cases": self.cases,
            "agreements": self.agreements,
            "agreement_rate": self.agreement_rate,
            "divergences": self.divergences,
        }


@dataclass
class SnapshotDiff:
    """State-before vs state-after comparison envelope."""

    run_id: str
    subject: str
    added: list[str] = field(default_factory=list)
    removed: list[str] = field(default_factory=list)
    changed: list[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not (self.added or self.removed or self.changed)

    def to_dict(self) -> dict:
        return {
            "v": E2E_SCHEMA_VERSION,
            "kind": "snapshot_diff",
            "run_id": self.run_id,
            "subject": self.subject,
            "added": self.added,
            "removed": self.removed,
            "changed": self.changed,
            "clean": self.clean,
        }


class E2eArtifactWriter:
    """Appends schema-stable artifact envelopes to a JSONL file."""

    def __init__(self, path: str) -> None:
        self.path = path

    def write(self, artifact) -> None:
        with open(self.path, "a", encoding="utf-8") as f:
            d = artifact.to_dict() if hasattr(artifact, "to_dict") else dict(artifact)
            f.write(json.dumps(d, default=str) + "\n")

    def read_all(self) -> list[dict]:
        out = []
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    out.append(json.loads(line))
        return out


def validate_artifact(d: Mapping[str, Any]) -> list[str]:
    """Schema lint for artifact envelopes (observability_lint.rs role):
    returns violations, empty = valid."""
    violations = []
    if d.get("v") != E2E_SCHEMA_VERSION:
        violations.append(f"bad version {d.get('v')!r}")
    if "kind" not in d:
        violations.append("missing kind")
    if "run_id" not in d or not d["run_id"]:
        violations.append("missing run_id")
    kind = d.get("kind")
    required = {
        "manifest": ("lane", "started_at"),
        "oracle_report": ("oracle", "cases"),
        "snapshot_diff": ("subject",),
    }.get(kind, ())
    for key in required:
        if key not in d:
            violations.append(f"{kind}: missing {key}")
    return violations
