"""High-cost artifact detection: typed skip/metadata-only decisions.

Parity target: reference crates/frankensearch-fsfs/src/high_cost_artifact.rs
(contract v1) — five detectors (giant_log size/churn/redundancy,
vendor_tree, generated_file, archive_container, transient_build_artifact),
per-detector default actions (vendor/archive/transient -> skip,
giant_log/generated -> index_metadata_only), FSFS_HIGH_COST_* reason
codes, a cost score, and a user force-include override policy
(reason-required, TTL-bounded, 24 h max).

The build wires this into corpus discovery (`cli _iter_corpus` dir
walks and the watcher) so `index <dir>` stops embedding vendor trees and
build artifacts — O(corpus) embed work is the expensive resource here,
the exact analogue of the reference's indexing cost.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

__all__ = [
    "CONTRACT_VERSION",
    "ACTION_SKIP",
    "ACTION_METADATA_ONLY",
    "ACTION_INDEX_FULL",
    "HighCostContract",
    "Decision",
    "HighCostEngine",
    "OverrideStore",
]

CONTRACT_VERSION = 1
KIND_CONTRACT = "fsfs_high_cost_artifact_contract_definition"
KIND_DECISION = "fsfs_high_cost_artifact_decision"
KIND_OVERRIDE = "fsfs_high_cost_override_event"

# actions, ordered by strictness (max() of fired detectors wins)
ACTION_INDEX_FULL = "index_full"
ACTION_METADATA_ONLY = "index_metadata_only"
ACTION_SKIP = "skip"
_STRICTNESS = {ACTION_INDEX_FULL: 0, ACTION_METADATA_ONLY: 1, ACTION_SKIP: 2}

# reason codes (high_cost_artifact.rs:29-38)
REASON = {
    "giant_log": "FSFS_HIGH_COST_SIZE_EXCEEDED",
    "giant_log_churn": "FSFS_HIGH_COST_CHURN_DETECTED",
    "giant_log_redundancy": "FSFS_HIGH_COST_REDUNDANCY_HIGH",
    "vendor_tree": "FSFS_HIGH_COST_VENDOR_PATH",
    "generated_file": "FSFS_HIGH_COST_GENERATED_MARKER",
    "archive_container": "FSFS_HIGH_COST_ARCHIVE_EXT",
    "transient_build_artifact": "FSFS_HIGH_COST_TRANSIENT_DIR",
}
REASON_OVERRIDE = "FSFS_HIGH_COST_OVERRIDE_APPLIED"
REASON_MANUAL = "FSFS_HIGH_COST_MANUAL_REVIEW"


@dataclass(frozen=True)
class HighCostContract:
    """Detector thresholds + default actions (reference defaults)."""

    giant_log_max_mb: int = 100
    giant_log_churn_per_hour: int = 60
    giant_log_redundancy_ratio: float = 0.8
    vendor_path_patterns: tuple[str, ...] = (
        "vendor", "node_modules", "third_party", ".cargo",
    )
    generated_markers: tuple[str, ...] = (
        "code generated", "do not edit", "auto-generated", "@generated",
    )
    library_tree_depth_threshold: int = 5
    archive_extensions: tuple[str, ...] = (
        ".zip", ".tar", ".gz", ".tgz", ".rar", ".7z",
    )
    transient_directories: tuple[str, ...] = (
        "target", "build", "dist", ".cache", "__pycache__",
    )
    build_artifact_extensions: tuple[str, ...] = (
        ".o", ".a", ".so", ".dylib", ".dll",
    )
    # override policy
    allow_user_force_include: bool = True
    requires_reason: bool = True
    max_override_ttl_seconds: int = 86_400
    # default actions per detector
    default_actions: dict = field(
        default_factory=lambda: {
            "giant_log": ACTION_METADATA_ONLY,
            "vendor_tree": ACTION_SKIP,
            "generated_file": ACTION_METADATA_ONLY,
            "archive_container": ACTION_SKIP,
            "transient_build_artifact": ACTION_SKIP,
        }
    )

    def to_dict(self) -> dict:
        return {
            "kind": KIND_CONTRACT,
            "v": CONTRACT_VERSION,
            "giant_log_detector": {
                "max_size_mb": self.giant_log_max_mb,
                "churn_window_minutes": 60,
                "redundancy_ratio_threshold": self.giant_log_redundancy_ratio,
            },
            "vendor_generated_detector": {
                "vendor_path_patterns": list(self.vendor_path_patterns),
                "generated_markers": list(self.generated_markers),
                "library_tree_depth_threshold": self.library_tree_depth_threshold,
            },
            "archive_transient_detector": {
                "archive_extensions": list(self.archive_extensions),
                "transient_directories": list(self.transient_directories),
                "build_artifact_patterns": [
                    "*" + e for e in self.build_artifact_extensions
                ],
            },
            "override_policy": {
                "allow_user_force_include": self.allow_user_force_include,
                "requires_reason": self.requires_reason,
                "max_override_ttl_seconds": self.max_override_ttl_seconds,
            },
            "default_actions": dict(self.default_actions),
        }


DEFAULT_CONTRACT = HighCostContract()


@dataclass(frozen=True)
class Decision:
    """One file's verdict (high_cost_artifact.rs HighCostArtifactDecision)."""

    path: str
    detectors_fired: tuple[str, ...]
    evidence: dict
    final_action: str
    reason_code: str
    cost_score: float
    override_applied: bool = False
    needs_manual_review: bool = False

    @property
    def is_skipped(self) -> bool:
        return self.final_action == ACTION_SKIP

    @property
    def is_metadata_only(self) -> bool:
        return self.final_action == ACTION_METADATA_ONLY

    def to_dict(self) -> dict:
        return {
            "kind": KIND_DECISION,
            "v": CONTRACT_VERSION,
            "path": self.path,
            "detectors_fired": list(self.detectors_fired),
            "evidence": dict(self.evidence),
            "final_action": self.final_action,
            "reason_code": self.reason_code,
            "cost_score": round(self.cost_score, 4),
            "override_applied": self.override_applied,
            "needs_manual_review": self.needs_manual_review,
        }


def _redundancy_ratio(head: str) -> float:
    """1 - unique_lines/lines over the sampled head; 0 when trivial."""
    lines = [ln for ln in head.splitlines() if ln.strip()]
    if len(lines) < 8:
        return 0.0
    return 1.0 - len(set(lines)) / len(lines)


class OverrideStore:
    """Force-include overrides: reason-required, TTL-bounded, persisted.

    One JSON file of KIND_OVERRIDE events keyed by normalized relpath;
    expired entries are ignored on read and pruned on write.
    """

    def __init__(self, path: str, contract: HighCostContract = DEFAULT_CONTRACT,
                 *, clock=time.time) -> None:
        self.path = path
        self.contract = contract
        self.clock = clock

    def _load(self) -> dict[str, dict]:
        if not os.path.isfile(self.path):
            return {}
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (json.JSONDecodeError, OSError):
            return {}

    def _save(self, events: dict[str, dict]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        atomic_write_text(
            self.path, json.dumps(events, indent=2, sort_keys=True)
        )

    @staticmethod
    def _key(path: str) -> str:
        return os.path.normpath(path).replace(os.sep, "/")

    def request(self, path: str, reason: str, *,
                requested_action: str = ACTION_INDEX_FULL,
                ttl_seconds: int | None = None) -> dict:
        if not self.contract.allow_user_force_include:
            raise ValueError("override policy forbids user force-include")
        if self.contract.requires_reason and not reason.strip():
            raise ValueError("override policy requires a reason")
        if requested_action not in _STRICTNESS:
            raise ValueError(f"unknown action {requested_action!r}")
        ttl = self.contract.max_override_ttl_seconds if ttl_seconds is None else ttl_seconds
        if ttl <= 0 or ttl > self.contract.max_override_ttl_seconds:
            raise ValueError(
                f"ttl {ttl}s outside (0, {self.contract.max_override_ttl_seconds}]"
            )
        event = {
            "kind": KIND_OVERRIDE,
            "v": CONTRACT_VERSION,
            "path": self._key(path),
            "requested_action": requested_action,
            "approved": True,
            "expires_at": self.clock() + ttl,
            "reason": reason,
            "reason_code": REASON_OVERRIDE,
        }
        events = {
            k: v for k, v in self._load().items()
            if float(v.get("expires_at", 0)) > self.clock()
        }
        events[event["path"]] = event
        self._save(events)
        return event

    def active(self, path: str) -> dict | None:
        ev = self._load().get(self._key(path))
        if ev and float(ev.get("expires_at", 0)) > self.clock() and ev.get("approved"):
            return ev
        return None


class HighCostEngine:
    """Stateful decision engine: contract + overrides + decision log."""

    def __init__(self, contract: HighCostContract = DEFAULT_CONTRACT,
                 overrides: OverrideStore | None = None) -> None:
        self.contract = contract
        self.overrides = overrides
        self.decisions: list[Decision] = []

    def decide(self, path: str, *, size_bytes: int = 0,
               content_head: str = "", churn_per_hour: int = 0,
               record: bool = True) -> Decision:
        c = self.contract
        norm = path.replace(os.sep, "/")
        parts = [p for p in norm.split("/") if p and p != "."]
        ext = os.path.splitext(norm)[1].lower()
        size_mb = size_bytes / 1_000_000
        redundancy = _redundancy_ratio(content_head)

        fired: list[str] = []
        reasons: list[str] = []

        if size_mb > c.giant_log_max_mb:
            fired.append("giant_log")
            reasons.append(REASON["giant_log"])
        elif churn_per_hour > c.giant_log_churn_per_hour:
            fired.append("giant_log")
            reasons.append(REASON["giant_log_churn"])
        elif redundancy > c.giant_log_redundancy_ratio and size_mb > 1:
            fired.append("giant_log")
            reasons.append(REASON["giant_log_redundancy"])

        dirs = parts[:-1]
        if any(d in c.vendor_path_patterns for d in dirs):
            fired.append("vendor_tree")
            reasons.append(REASON["vendor_tree"])

        head_low = content_head[:4096].lower()
        if any(m in head_low for m in c.generated_markers):
            fired.append("generated_file")
            reasons.append(REASON["generated_file"])

        if ext in c.archive_extensions or norm.lower().endswith(
            (".tar.gz", ".tar.bz2", ".tar.xz")
        ):
            fired.append("archive_container")
            reasons.append(REASON["archive_container"])

        if any(d in c.transient_directories for d in dirs):
            fired.append("transient_build_artifact")
            reasons.append(REASON["transient_build_artifact"])
        elif ext in c.build_artifact_extensions:
            fired.append("transient_build_artifact")
            reasons.append(REASON["transient_build_artifact"])

        if fired:
            action = max(
                (c.default_actions[d] for d in fired),
                key=_STRICTNESS.__getitem__,
            )
            # reason code of the strictest-action detector that fired
            reason_code = next(
                r for d, r in zip(fired, reasons)
                if c.default_actions[d] == action
            )
        else:
            action, reason_code = ACTION_INDEX_FULL, ""

        cost = min(
            1.0,
            0.3 * len(fired)
            + min(size_mb / max(c.giant_log_max_mb, 1), 1.0) * 0.3
            + redundancy * 0.1,
        )
        decision = Decision(
            path=norm,
            detectors_fired=tuple(fired),
            evidence={
                "size_mb": int(size_mb),
                "churn_rate_per_hour": int(churn_per_hour),
                "redundancy_ratio": round(redundancy, 4),
                "path_depth": len(parts) - 1,
                "extension": ext,
            },
            final_action=action,
            reason_code=reason_code,
            cost_score=cost,
            needs_manual_review=(
                len(fired) >= 2 and action == ACTION_METADATA_ONLY
            ),
        )
        if decision.detectors_fired and self.overrides is not None:
            ev = self.overrides.active(norm)
            if ev is not None:
                decision = Decision(
                    path=decision.path,
                    detectors_fired=decision.detectors_fired,
                    evidence=decision.evidence,
                    final_action=ev["requested_action"],
                    reason_code=REASON_OVERRIDE,
                    cost_score=decision.cost_score,
                    override_applied=True,
                    needs_manual_review=False,
                )
        if record and decision.detectors_fired:
            self.decisions.append(decision)
        return decision

    def report(self) -> dict:
        by_action: dict[str, int] = {}
        for d in self.decisions:
            by_action[d.final_action] = by_action.get(d.final_action, 0) + 1
        return {
            "contract": self.contract.to_dict(),
            "decisions": [d.to_dict() for d in self.decisions],
            "by_action": by_action,
        }
