"""Background refresh worker: drain queue -> embed -> rebuild -> swap.

Port of frankensearch_tpu/fusion/refresh.py. Parity target: reference
crates/frankensearch-fusion/src/refresh.rs (:1-8, :830) — a single-writer
background task that drains the EmbeddingQueue, embeds the batch, appends
to the index (WAL path), and atomically swaps the serving index;
backpressure flows through the queue.

The tiers may live on the card: the embedders return host rows, and
``TwoTierIndex.append_fast`` / ``append_quality`` write them into the
slabs. The loop keeps the reference's skip for a typed ``SearchError``
(an ``EmbeddingFailed`` from a rate-limited API embedder, say): it is
counted in ``stats.errors`` and the loop goes on. Any other exception (a
CUDA fault in an embed or an append) ends the loop, and ``stop()`` raises
it; the reference's loop counted it and retried forever.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from frankensearch_tpu_torch.core.errors import SearchError
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.fusion.queue import EmbeddingQueue
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex


@dataclass
class RefreshStats:
    batches: int = 0
    docs_embedded: int = 0
    errors: int = 0
    last_swap_at: float = 0.0


class RefreshWorker:
    """Single-writer refresh loop (thread). Drains up to ``max_batch`` jobs
    per cycle, embeds them with the fast (and optional quality) embedder,
    appends through the index's WAL path, which atomically replaces the
    in-memory device index."""

    def __init__(
        self,
        queue: EmbeddingQueue,
        index: TwoTierIndex,
        fast_embedder: Embedder,
        quality_embedder: Embedder | None = None,
        *,
        max_batch: int = 64,
        poll_interval_s: float = 0.05,
    ) -> None:
        self.queue = queue
        self.index = index
        self.fast_embedder = fast_embedder
        self.quality_embedder = quality_embedder
        self.max_batch = max_batch
        self.poll_interval_s = poll_interval_s
        self.stats = RefreshStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._write_lock = threading.Lock()  # single-writer guarantee
        # the exception that ended the loop, raised by stop()
        self._fault: Exception | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True, name="fs-refresh")
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Drain one more batch (unless the loop died of a fault), end the
        loop and join it; then raise the fault that ended it, if any."""
        if drain and self._fault is None:
            self.process_once()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._fault is not None:
            fault, self._fault = self._fault, None
            raise fault

    def process_once(self) -> int:
        """Drain + embed + append one batch synchronously; returns docs
        processed. Exposed for deterministic tests and CLI flush."""
        batch = self.queue.drain(self.max_batch)
        if not batch:
            return 0
        with self._write_lock:
            try:
                texts = [j.content for j in batch]
                ids = [j.doc_id for j in batch]
                fast_vecs = self.fast_embedder.embed_batch(texts)
                self.index.append_fast(ids, np.asarray(fast_vecs))
                if self.quality_embedder is not None and self.index.has_quality_tier:
                    q_vecs = self.quality_embedder.embed_batch(texts)
                    self.index.append_quality(ids, np.asarray(q_vecs))
                self.stats.batches += 1
                self.stats.docs_embedded += len(batch)
                self.stats.last_swap_at = time.time()
            except Exception:
                self.stats.errors += 1
                raise
        return len(batch)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.process_once()
            except SearchError:
                n = 0
            except Exception as e:
                self._fault = e
                return
            if n == 0:
                self._stop.wait(self.poll_interval_s)
