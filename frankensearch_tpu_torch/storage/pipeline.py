"""Ingest pipeline: canonicalize -> dedup -> upsert -> enqueue embedding.

Parity target: reference crates/frankensearch-storage/src/pipeline.rs —
``IngestRequest`` flow: canonicalize, content-hash dedup, document upsert,
enqueue quality embedding jobs; ``StorageBackedJobRunner`` drains the
persistent queue through an embedder into a vector sink.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from frankensearch_tpu_torch.core.canonicalize import DefaultCanonicalizer
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.storage.job_queue import PersistentJobQueue
from frankensearch_tpu_torch.storage.store import Storage


@dataclass
class IngestStats:
    submitted: int = 0
    ingested: int = 0
    deduped: int = 0
    low_signal: int = 0
    enqueued_jobs: int = 0


@dataclass
class IngestPipeline:
    storage: Storage
    jobs: PersistentJobQueue | None = None
    canonicalizer: DefaultCanonicalizer = field(default_factory=DefaultCanonicalizer)
    stats: IngestStats = field(default_factory=IngestStats)

    def ingest(self, doc: IndexableDocument) -> bool:
        """Returns True if the document changed (new/updated content)."""
        self.stats.submitted += 1
        canonical, cstats = self.canonicalizer.canonicalize_document_with_stats(doc.content)
        if cstats.low_signal:
            self.stats.low_signal += 1
            return False
        changed, h = self.storage.upsert_document(
            doc.doc_id, canonical, title=doc.title, metadata=doc.metadata
        )
        if not changed:
            self.stats.deduped += 1
            return False
        self.stats.ingested += 1
        if self.jobs is not None:
            self.jobs.enqueue(
                "embed",
                {"doc_id": doc.doc_id, "content": canonical, "content_hash": h},
            )
            self.stats.enqueued_jobs += 1
        return True

    def ingest_batch(self, docs: Sequence[IndexableDocument]) -> int:
        return sum(1 for d in docs if self.ingest(d))


@dataclass
class StorageBackedJobRunner:
    """Drain 'embed' jobs through an embedder into a vector sink
    (pipeline.rs StorageBackedJobRunner / EmbeddingVectorSink)."""

    jobs: PersistentJobQueue
    storage: Storage
    embedder: Embedder
    #: sink(doc_ids, vectors) — e.g. TwoTierIndex.append_quality
    sink: Callable[[list[str], np.ndarray], None]
    worker_id: str = "worker-0"
    batch_size: int = 32

    def run_once(self) -> int:
        """Claim up to batch_size jobs, embed as one batch, complete/fail.
        Returns jobs processed."""
        claimed = []
        for _ in range(self.batch_size):
            job = self.jobs.claim(self.worker_id, kinds=["embed"])
            if job is None:
                break
            claimed.append(job)
        if not claimed:
            return 0
        texts = [j.payload["content"] for j in claimed]
        ids = [j.payload["doc_id"] for j in claimed]
        try:
            vecs = self.embedder.embed_batch(texts)
            self.sink(ids, np.asarray(vecs))
            for j in claimed:
                self.jobs.complete(j.job_id, self.worker_id)
                self.storage.mark_embedded(
                    j.payload["doc_id"], self.embedder.embedder_id, j.payload["content_hash"]
                )
        except Exception as e:
            for j in claimed:
                self.jobs.fail(j.job_id, self.worker_id, f"{type(e).__name__}: {e}")
            return 0
        return len(claimed)

    def drain(self, max_batches: int = 1000) -> int:
        total = 0
        for _ in range(max_batches):
            n = self.run_once()
            if n == 0:
                break
            total += n
        return total
