"""Deadline-aware batching of concurrent embed requests.

Parity target: reference crates/frankensearch-embed/src/batch_coalescer.rs
(:1-35) — Interactive requests fire at max_wait/2; Background requests
accumulate until max_batch; measured 29x throughput for MiniLM at batch 32.

On the card batching is *the* throughput lever (tensor-core utilization
scales with batch), so the coalescer sits directly in front of every
device embedder.
"""

from __future__ import annotations

import enum
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from frankensearch_tpu_torch.embed.base import Embedder


class Priority(enum.Enum):
    INTERACTIVE = "interactive"
    BACKGROUND = "background"


@dataclass
class _Pending:
    text: str
    priority: Priority
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)


@dataclass
class CoalescerStats:
    batches: int = 0
    items: int = 0
    max_batch_seen: int = 0

    @property
    def mean_batch(self) -> float:
        return self.items / self.batches if self.batches else 0.0


class BatchCoalescer:
    """Thread-based coalescer: submit() returns a Future; a worker drains
    the queue into device-sized batches.

    Flush policy (reference parity): an Interactive item forces a flush
    once it has waited max_wait/2; Background items wait for a full
    max_batch or max_wait. Queue reaching max_batch always flushes.
    """

    def __init__(
        self,
        embedder: Embedder,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 10.0,
    ) -> None:
        self.embedder = embedder
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.stats = CoalescerStats()
        self._pending: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, text: str, priority: Priority = Priority.INTERACTIVE) -> Future:
        item = _Pending(text=text, priority=priority)
        with self._wake:
            if self._closed:
                raise RuntimeError("coalescer closed")
            self._pending.append(item)
            self._wake.notify()
        return item.future

    def embed(self, text: str, priority: Priority = Priority.INTERACTIVE) -> np.ndarray:
        return self.submit(text, priority).result()

    def close(self) -> None:
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=5)

    # -- worker ---------------------------------------------------------

    def _should_flush_locked(self, now: float) -> bool:
        if len(self._pending) >= self.max_batch:
            return True
        for p in self._pending:
            waited = now - p.enqueued_at
            if p.priority is Priority.INTERACTIVE and waited >= self.max_wait_s / 2:
                return True
            if waited >= self.max_wait_s:
                return True
        return False

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._pending and not self._closed:
                    self._wake.wait(timeout=0.05)
                if self._closed and not self._pending:
                    return
                now = time.monotonic()
                if not self._should_flush_locked(now) and not self._closed:
                    # sleep until the earliest deadline
                    deadlines = []
                    for p in self._pending:
                        d = self.max_wait_s / 2 if p.priority is Priority.INTERACTIVE else self.max_wait_s
                        deadlines.append(p.enqueued_at + d - now)
                    self._wake.wait(timeout=max(min(deadlines), 0.0005))
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch :]
            if not batch:
                continue
            try:
                vecs = self.embedder.embed_batch([p.text for p in batch])
                for p, v in zip(batch, vecs):
                    p.future.set_result(v)
            except Exception as e:  # pragma: no cover
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
            self.stats.batches += 1
            self.stats.items += len(batch)
            self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(batch))
