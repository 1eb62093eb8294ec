"""Structured events for the generation lifecycle in distributed mode.

Parity target: reference crates/frankensearch-core/src/
distributed_observability.rs — typed events/metrics for generation
builds, replication, activation, rollback, and repair, with one stable
taxonomy so fleet tooling can aggregate across nodes.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Mapping


class GenerationEventKind(enum.Enum):
    BUILD_STARTED = "generation.build.started"
    BUILD_COMPLETED = "generation.build.completed"
    BUILD_FAILED = "generation.build.failed"
    REPLICATION_STARTED = "generation.replication.started"
    REPLICATION_COMPLETED = "generation.replication.completed"
    VERIFICATION_PASSED = "generation.verification.passed"
    VERIFICATION_FAILED = "generation.verification.failed"
    ACTIVATED = "generation.activated"
    ACTIVATION_REFUSED = "generation.activation.refused"
    ROLLBACK = "generation.rollback"
    REPAIR_STARTED = "generation.repair.started"
    REPAIR_COMPLETED = "generation.repair.completed"
    PRUNED = "generation.pruned"


@dataclass(frozen=True)
class GenerationEvent:
    kind: GenerationEventKind
    generation_id: str
    node_id: str
    at: float
    commit_seq: int = 0
    detail: Mapping[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind.value,
            "generation_id": self.generation_id,
            "node_id": self.node_id,
            "at": self.at,
            "commit_seq": self.commit_seq,
            "detail": dict(self.detail),
        }


@dataclass
class GenerationLifecycleEmitter:
    """Emits lifecycle events through a RuntimeMetricsCollector (or any
    record(kind, payload) sink)."""

    node_id: str
    collector: object | None = None  # RuntimeMetricsCollector-compatible
    emitted: list[GenerationEvent] = field(default_factory=list)

    def emit(
        self, kind: GenerationEventKind, generation_id: str,
        commit_seq: int = 0, **detail: str,
    ) -> GenerationEvent:
        event = GenerationEvent(
            kind=kind, generation_id=generation_id, node_id=self.node_id,
            at=time.time(), commit_seq=commit_seq,
            detail={k: str(v) for k, v in detail.items()},
        )
        self.emitted.append(event)
        if self.collector is not None:
            self.collector.record(kind.value, event.to_dict(), correlation_id=generation_id)
        return event

    def lifecycle_of(self, generation_id: str) -> list[GenerationEvent]:
        return [e for e in self.emitted if e.generation_id == generation_id]


def validate_lifecycle(events: list[GenerationEvent]) -> list[str]:
    """Sanity over one generation's event sequence: activation requires a
    prior verification pass; rollback requires a prior activation."""
    violations = []
    seen: set[GenerationEventKind] = set()
    for e in events:
        if e.kind is GenerationEventKind.ACTIVATED:
            if GenerationEventKind.VERIFICATION_PASSED not in seen:
                violations.append("activated without a verification pass")
        if e.kind is GenerationEventKind.ROLLBACK:
            if GenerationEventKind.ACTIVATED not in seen:
                violations.append("rollback without a prior activation")
        seen.add(e.kind)
    return violations
