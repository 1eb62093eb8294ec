"""Bounded embedding queue with content-hash dedup + backpressure.

Parity target: reference crates/frankensearch-fusion/src/queue.rs (:1-9,
:195) — ``EmbeddingQueue``: bounded, deduplicates by content hash,
reports backpressure to the producer instead of blocking unboundedly.
"""

from __future__ import annotations

import enum
import hashlib
import threading
from dataclasses import dataclass, field


class EnqueueResult(enum.Enum):
    ENQUEUED = "enqueued"
    DUPLICATE = "duplicate"
    FULL = "full"  # backpressure signal


@dataclass(frozen=True)
class EmbedJob:
    doc_id: str
    content: str
    content_hash: str
    priority: int = 0


def content_hash(text: str) -> str:
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


@dataclass
class EmbeddingQueue:
    capacity: int = 1024
    _items: list[EmbedJob] = field(default_factory=list)
    _hashes: set[str] = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    enqueued: int = 0
    deduped: int = 0
    rejected: int = 0

    def push(self, doc_id: str, content: str, priority: int = 0) -> EnqueueResult:
        h = content_hash(content)
        with self._lock:
            if h in self._hashes:
                self.deduped += 1
                return EnqueueResult.DUPLICATE
            if len(self._items) >= self.capacity:
                self.rejected += 1
                return EnqueueResult.FULL
            self._items.append(
                EmbedJob(doc_id=doc_id, content=content, content_hash=h, priority=priority)
            )
            self._hashes.add(h)
            self.enqueued += 1
            return EnqueueResult.ENQUEUED

    def drain(self, max_items: int | None = None) -> list[EmbedJob]:
        with self._lock:
            n = len(self._items) if max_items is None else min(max_items, len(self._items))
            # higher priority first, then FIFO
            self._items.sort(key=lambda j: -j.priority)
            batch = self._items[:n]
            self._items = self._items[n:]
            for j in batch:
                self._hashes.discard(j.content_hash)
            return batch

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def pressure(self) -> float:
        with self._lock:
            return len(self._items) / self.capacity if self.capacity else 1.0
