"""Commit-stream replay: rebuild index state from document operations.

Parity target: reference crates/frankensearch-core/src/commit_replay.rs —
Native Mode "Option A": a follower reconstructs a generation by replaying
an ordered stream of document ops (upsert/delete) up to a commit seq;
replay is idempotent (ops at or below the applied seq are skipped).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Iterable, Mapping


class OpKind(enum.Enum):
    UPSERT = "upsert"
    DELETE = "delete"


@dataclass(frozen=True)
class CommitOp:
    seq: int
    kind: OpKind
    doc_id: str
    content: str | None = None
    title: str | None = None
    metadata: Mapping | None = None

    def to_json(self) -> str:
        return json.dumps(
            {
                "seq": self.seq,
                "kind": self.kind.value,
                "doc_id": self.doc_id,
                "content": self.content,
                "title": self.title,
                "metadata": dict(self.metadata) if self.metadata else None,
            },
            separators=(",", ":"),
        )

    @staticmethod
    def from_json(raw: str) -> "CommitOp":
        d = json.loads(raw)
        return CommitOp(
            seq=d["seq"],
            kind=OpKind(d["kind"]),
            doc_id=d["doc_id"],
            content=d.get("content"),
            title=d.get("title"),
            metadata=d.get("metadata"),
        )


@dataclass
class ReplayState:
    """Materialized document state after replay."""

    applied_seq: int = 0
    docs: dict[str, CommitOp] = field(default_factory=dict)
    skipped_stale: int = 0
    skipped_duplicate: int = 0


def replay(
    ops: Iterable[CommitOp],
    *,
    from_state: ReplayState | None = None,
    up_to_seq: int | None = None,
) -> ReplayState:
    """Apply ops in seq order; idempotent over already-applied seqs.
    Out-of-order ops below the applied watermark are counted, not applied."""
    state = from_state or ReplayState()
    for op in sorted(ops, key=lambda o: o.seq):
        if up_to_seq is not None and op.seq > up_to_seq:
            break
        if op.seq <= state.applied_seq:
            if op.seq == state.applied_seq:
                state.skipped_duplicate += 1
            else:
                state.skipped_stale += 1
            continue
        if op.kind is OpKind.UPSERT:
            state.docs[op.doc_id] = op
        else:
            state.docs.pop(op.doc_id, None)
        state.applied_seq = op.seq
    return state


class CommitLog:
    """Append-only JSONL commit log (the replication stream substrate)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._next_seq = 1
        try:
            for op in self.read():
                self._next_seq = max(self._next_seq, op.seq + 1)
        except FileNotFoundError:
            pass

    def append(
        self, kind: OpKind, doc_id: str, content: str | None = None,
        title: str | None = None, metadata: Mapping | None = None,
    ) -> CommitOp:
        op = CommitOp(
            seq=self._next_seq, kind=kind, doc_id=doc_id,
            content=content, title=title, metadata=metadata,
        )
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(op.to_json() + "\n")
        self._next_seq += 1
        return op

    def read(self, from_seq: int = 0) -> list[CommitOp]:
        out = []
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                op = CommitOp.from_json(line)
                if op.seq > from_seq:
                    out.append(op)
        return out
