"""Structural race prevention: lock ordering + access matrix.

Parity target: reference crates/frankensearch-fsfs/src/concurrency.rs —
``LockOrderGuard`` / ``LockLevel`` (acquiring locks out of level order is
a programming error caught at runtime, not a deadlock found in prod),
the pipeline access matrix (which component may touch which resource),
and contention metrics.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field


class LockLevel(enum.IntEnum):
    """Global lock ordering. A thread may only acquire a lock with a level
    STRICTLY GREATER than every lock it already holds."""

    CONFIG = 10
    CATALOG = 20
    LEXICAL_WRITER = 30
    VECTOR_WRITER = 40
    PUBLICATION = 50
    TELEMETRY = 60


class LockOrderViolation(RuntimeError):
    pass


_held = threading.local()


@dataclass
class ContentionStats:
    acquisitions: int = 0
    contended: int = 0
    total_wait_s: float = 0.0


class OrderedLock:
    """An RLock-like lock bound to a LockLevel with order enforcement."""

    def __init__(self, level: LockLevel, name: str = "") -> None:
        self.level = level
        self.name = name or level.name
        self._lock = threading.Lock()
        self.stats = ContentionStats()

    def _stack(self) -> list["OrderedLock"]:
        if not hasattr(_held, "stack"):
            _held.stack = []
        return _held.stack

    def __enter__(self) -> "OrderedLock":
        stack = self._stack()
        if stack and stack[-1].level >= self.level:
            raise LockOrderViolation(
                f"acquiring {self.name} (level {self.level}) while holding "
                f"{stack[-1].name} (level {stack[-1].level}); order must increase"
            )
        t0 = time.monotonic()
        acquired = self._lock.acquire(blocking=False)
        if not acquired:
            self.stats.contended += 1
            self._lock.acquire()
        self.stats.total_wait_s += time.monotonic() - t0
        self.stats.acquisitions += 1
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        stack = self._stack()
        assert stack and stack[-1] is self, "unbalanced lock release"
        stack.pop()
        self._lock.release()


# --- pipeline access matrix ---------------------------------------------------

#: component -> resources it may touch (anything else is a violation).
#: Mirrors the reference's pipeline_access_matrix: single-writer
#: disciplines become auditable data instead of tribal knowledge.
PIPELINE_ACCESS_MATRIX: dict[str, frozenset[str]] = {
    "searcher": frozenset({"vector_read", "lexical_read", "storage_read", "telemetry"}),
    "refresh_worker": frozenset({"vector_write", "lexical_write", "storage_write", "telemetry"}),
    "watcher": frozenset({"catalog_write", "storage_write", "telemetry"}),
    "compactor": frozenset({"vector_write", "publication", "telemetry"}),
    "daemon": frozenset({"vector_read", "telemetry"}),
    "cli": frozenset(
        {"vector_read", "vector_write", "lexical_read", "lexical_write",
         "storage_read", "storage_write", "catalog_write", "publication", "telemetry"}
    ),
}


class AccessViolation(RuntimeError):
    pass


def check_access(component: str, resource: str) -> None:
    allowed = PIPELINE_ACCESS_MATRIX.get(component)
    if allowed is None:
        raise AccessViolation(f"unknown component {component!r}")
    if resource not in allowed:
        raise AccessViolation(f"{component!r} may not access {resource!r}")


def single_writer_resources() -> set[str]:
    """Resources with exactly one writing component (the single-writer
    audit the reference enforces for refresh)."""
    writers: dict[str, list[str]] = {}
    for component, resources in PIPELINE_ACCESS_MATRIX.items():
        if component == "cli":  # cli is the human override lane
            continue
        for r in resources:
            if r.endswith("_write") or r == "publication":
                writers.setdefault(r, []).append(component)
    return {r for r, cs in writers.items() if len(cs) == 1}
