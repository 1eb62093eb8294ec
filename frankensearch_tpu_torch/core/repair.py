"""Repair orchestration: corruption events -> repair attempts -> state.

Parity target: reference crates/frankensearch-core/src/repair.rs —
``RepairOrchestrator``: records corruption events, tracks repair
attempts, and drives ``ServiceState`` (healthy / degraded / suspended)
with typed transitions. The reference repairs via RaptorQ sidecars; the
port's repair actions are re-fetch/rebuild callbacks (artifacts
live in replicated storage — SURVEY §7 "what we deliberately do NOT
port"), but the orchestration contract is identical.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable


class ServiceState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"  # some arm unusable; serving continues
    SUSPENDED = "suspended"  # repeated repair failures; stop serving writes


@dataclass(frozen=True)
class CorruptionEvent:
    artifact: str
    detail: str
    detected_at: float


@dataclass(frozen=True)
class RepairAttempt:
    artifact: str
    succeeded: bool
    detail: str
    attempted_at: float


@dataclass
class RepairOrchestrator:
    #: artifact name -> repair callable returning True on success
    repair_actions: dict[str, Callable[[], bool]] = field(default_factory=dict)
    max_attempts_per_artifact: int = 3
    clock: Callable[[], float] = time.monotonic

    state: ServiceState = ServiceState.HEALTHY
    events: list[CorruptionEvent] = field(default_factory=list)
    attempts: list[RepairAttempt] = field(default_factory=list)
    _attempt_counts: dict[str, int] = field(default_factory=dict)
    _unrepaired: set[str] = field(default_factory=set)

    def report_corruption(self, artifact: str, detail: str = "") -> ServiceState:
        self.events.append(
            CorruptionEvent(artifact=artifact, detail=detail, detected_at=self.clock())
        )
        self._unrepaired.add(artifact)
        self._transition()
        return self.state

    def attempt_repair(self, artifact: str) -> bool:
        count = self._attempt_counts.get(artifact, 0)
        if count >= self.max_attempts_per_artifact:
            self._transition()
            return False
        self._attempt_counts[artifact] = count + 1
        action = self.repair_actions.get(artifact)
        ok = False
        detail = "no repair action registered"
        if action is not None:
            try:
                ok = bool(action())
                detail = "repaired" if ok else "repair action returned false"
            except Exception as e:
                detail = f"{type(e).__name__}: {e}"
        self.attempts.append(
            RepairAttempt(artifact=artifact, succeeded=ok, detail=detail, attempted_at=self.clock())
        )
        if ok:
            self._unrepaired.discard(artifact)
            self._attempt_counts.pop(artifact, None)
        self._transition()
        return ok

    def repair_all(self) -> bool:
        for artifact in sorted(self._unrepaired):
            self.attempt_repair(artifact)
        return self.state is ServiceState.HEALTHY

    def _transition(self) -> None:
        if not self._unrepaired:
            self.state = ServiceState.HEALTHY
            return
        exhausted = any(
            self._attempt_counts.get(a, 0) >= self.max_attempts_per_artifact
            for a in self._unrepaired
        )
        self.state = ServiceState.SUSPENDED if exhausted else ServiceState.DEGRADED
