"""Crash-safe indexing orchestration: state machine + resume tokens.

Parity target: reference crates/frankensearch-fsfs/src/orchestration.rs
(:20-249) — bootstrap/backfill plan, bounded queues with BackpressureMode,
``ResumeToken`` crash recovery, lane budgets.
"""

from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass, field
from typing import Iterable

from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text


class IndexingPhase(enum.Enum):
    BOOTSTRAP = "bootstrap"  # initial full scan
    BACKFILL = "backfill"  # embedding the scanned docs
    STEADY = "steady"  # watch-driven incremental
    DONE = "done"


class BackpressureMode(enum.Enum):
    BLOCK = "block"
    SHED_OLDEST = "shed_oldest"
    REJECT_NEW = "reject_new"


@dataclass
class ResumeToken:
    """Persisted progress marker: restart resumes exactly here."""

    phase: IndexingPhase = IndexingPhase.BOOTSTRAP
    cursor: str = ""  # last fully-processed doc id / path (ordered scan)
    processed: int = 0
    total_planned: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "phase": self.phase.value,
                "cursor": self.cursor,
                "processed": self.processed,
                "total_planned": self.total_planned,
            }
        )

    @staticmethod
    def from_json(raw: str) -> "ResumeToken":
        d = json.loads(raw)
        return ResumeToken(
            phase=IndexingPhase(d["phase"]),
            cursor=d.get("cursor", ""),
            processed=d.get("processed", 0),
            total_planned=d.get("total_planned", 0),
        )


class IndexingOrchestrator:
    """Drives bootstrap -> backfill -> steady with persisted resume."""

    def __init__(
        self,
        token_path: str,
        *,
        batch_size: int = 32,
        backpressure: BackpressureMode = BackpressureMode.BLOCK,
    ) -> None:
        self.token_path = token_path
        self.batch_size = batch_size
        self.backpressure = backpressure
        self.token = self._load()

    def _load(self) -> ResumeToken:
        if os.path.exists(self.token_path):
            try:
                with open(self.token_path, encoding="utf-8") as f:
                    return ResumeToken.from_json(f.read())
            except (json.JSONDecodeError, OSError, KeyError, ValueError):
                pass
        return ResumeToken()

    def persist(self) -> None:
        atomic_write_text(self.token_path, self.token.to_json(), fsync=True)

    def plan_bootstrap(self, doc_ids: Iterable[str]) -> list[str]:
        """Docs still to process, honoring the resume cursor over a sorted
        plan (restart-safe: the cursor is the last *completed* id)."""
        ordered = sorted(doc_ids)
        self.token.total_planned = len(ordered)
        if self.token.cursor:
            ordered = [d for d in ordered if d > self.token.cursor]
        return ordered

    def run_bootstrap(self, docs: dict[str, IndexableDocument], process_batch) -> int:
        """process_batch(list[IndexableDocument]) -> None; called per batch,
        resume token persisted after each completed batch."""
        todo = self.plan_bootstrap(docs.keys())
        done = 0
        for start in range(0, len(todo), self.batch_size):
            batch_ids = todo[start : start + self.batch_size]
            process_batch([docs[d] for d in batch_ids])
            done += len(batch_ids)
            self.token.cursor = batch_ids[-1]
            self.token.processed += len(batch_ids)
            self.persist()
        self.token.phase = IndexingPhase.STEADY
        self.token.cursor = ""
        self.persist()
        return done
