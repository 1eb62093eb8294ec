"""Lease-bounded searchable-before-seal lexical delta.

Parity target: reference crates/frankensearch-quill/src/delta.rs:1-6 —
a lease-bounded mutable delta segment that is SEARCHABLE BEFORE SEAL,
with an immutable freeze boundary. The r1 WAL-staging approximation
made appends durable but reads only saw them after a full republish;
this arm closes that gap with the TPU-shaped split:

- **sealed**: the packed FLXB device arm (immutable; batched device
  BM25 — the performance path),
- **delta**: the mutable in-memory oracle holding ALL docs (sealed +
  unsealed). While any unsealed docs exist, reads serve from the oracle
  (host-side, rank-exact over the full corpus — BM25 stats from two
  disjoint segments are not mergeable without shared idf/avgdl, so this
  is the correct-by-construction choice; the delta window is small by
  lease), then ``seal()`` folds everything into a fresh packed
  generation and the device arm takes back over.
- **lease**: a writer budget (max unsealed docs + max window age).
  Exceeding it either auto-seals (default) or refuses the append
  (``auto_seal=False``), matching the reference's lease-expiry
  semantics (delta.rs lease bounds).

The port's copy of frankensearch_tpu/lexical/delta.py: a rooted delta
names the device its sealed arm reloads onto (``device``, by default the
sealed arm's own).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping, Sequence

from frankensearch_tpu_torch.core.errors import InvalidConfig, SubsystemError
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex


class LeaseExceeded(SubsystemError):
    """The delta writer lease budget is exhausted and auto_seal=False."""


@dataclass
class DeltaLease:
    """Writer budget for the unsealed window (delta.rs lease bounds)."""

    max_docs: int = 4096
    max_age_s: float = 60.0
    acquired_at: float | None = None
    docs_written: int = 0

    def acquire(self, now: float) -> None:
        if self.acquired_at is None:
            self.acquired_at = now

    def exceeded(self, now: float) -> str | None:
        if self.acquired_at is None:
            return None
        if self.docs_written >= self.max_docs:
            return f"doc budget exhausted ({self.docs_written}/{self.max_docs})"
        if now - self.acquired_at >= self.max_age_s:
            return f"window aged out ({now - self.acquired_at:.1f}s >= {self.max_age_s}s)"
        return None

    def reset(self) -> None:
        self.acquired_at = None
        self.docs_written = 0


@dataclass
class SealReceipt:
    generation: str
    docs_sealed: int
    sealed_at: float


class DeltaLexicalIndex(LexicalRead):
    """Sealed packed device arm + lease-bounded searchable delta."""

    def __init__(
        self,
        oracle: MemoryLexicalIndex,
        *,
        sealed: LexicalRead | None = None,
        root: str | None = None,
        lease: DeltaLease | None = None,
        auto_seal: bool = True,
        clock=time.monotonic,
        device=None,
    ) -> None:
        if oracle is None:
            raise InvalidConfig("DeltaLexicalIndex requires the oracle arm")
        if device is None:
            device = getattr(sealed, "device", None)
        if root is not None and device is None:
            raise InvalidConfig("a rooted DeltaLexicalIndex needs the device its seals load onto")
        self.device = device
        self.oracle = oracle
        self.sealed = sealed
        self.root = root
        self.lease = lease or DeltaLease()
        self.auto_seal = auto_seal
        self.clock = clock
        self._delta_count = 0
        # append-fast-path bookkeeping: the window's NEW docs, and
        # whether anything disqualified the incremental seal (deletes,
        # doc-id supersession) — those need the full republish
        self._window_docs: list[IndexableDocument] = []
        self._window_dirty = False
        self.seal_history: list[SealReceipt] = []
        # in-process write-path mutex: an auto-seal triggered by one
        # writer thread must not serialize the oracle's postings while
        # another thread's add/commit mutates them (found: "dictionary
        # changed size during iteration" inside save_lexical under a
        # 2-writer + sealer race). Reentrant: add_document's auto-seal
        # path calls seal() while already holding it.
        import threading

        self._write_lock = threading.RLock()

    # -- write path (lease-bounded) -----------------------------------------

    @property
    def unsealed_docs(self) -> int:
        return self._delta_count

    def add_document(self, doc: IndexableDocument) -> None:
        with self._write_lock:
            now = self.clock()
            reason = self.lease.exceeded(now)
            if reason is not None:
                if not self.auto_seal:
                    raise LeaseExceeded(f"delta lease: {reason}; seal() required")
                self.seal()
            self.lease.acquire(self.clock())
            if doc.doc_id in self.oracle._docs or any(
                d.doc_id == doc.doc_id for d in self._window_docs
            ):
                self._window_dirty = True  # supersession: full republish
            else:
                self._window_docs.append(doc)
            self.oracle.add_document(doc)
            self.lease.docs_written += 1
            self._delta_count += 1

    def delete_document(self, doc_id: str) -> None:
        # deletes ride the same lease window (tombstone folds at seal)
        with self._write_lock:
            self.lease.acquire(self.clock())
            self._window_dirty = True
            self.oracle.delete_document(doc_id)
            self._delta_count += 1

    def commit(self) -> None:
        """Make pending delta writes searchable (NOT a seal — the
        searchable-before-seal point of this arm)."""
        with self._write_lock:
            self.oracle.commit()

    def seal(self) -> SealReceipt | None:
        """Freeze boundary: fold the delta into a fresh packed
        generation (blue-green publish) and hand reads back to the
        device arm. No-op when nothing is unsealed."""
        with self._write_lock:
            if self._delta_count == 0:
                self.lease.reset()
                return None
            self.oracle.commit()
            generation = ""
            incremental = not self._window_dirty and self._window_docs
            if self.root is not None:
                from frankensearch_tpu_torch.lexical.persist import (
                    load_packed_lexical,
                    publish_incremental,
                    republish_lexical,
                )

                generation = None
                if incremental:
                    # APPEND fast path (keeper/quiver concat-merge
                    # parity): stack the window as a new device segment
                    # — the main segment's layouts are untouched, so
                    # seal cost tracks the DELTA, not the corpus.
                    # None => stack full / no packed base: compaction
                    # falls through to the republish below.
                    from frankensearch_tpu_torch.lexical.memory_index import (
                        MemoryLexicalIndex,
                    )

                    delta_mem = MemoryLexicalIndex()
                    for d in self._window_docs:
                        delta_mem.add_document(d)
                    delta_mem.commit()
                    generation = publish_incremental(delta_mem, self.root)
                if generation is None:
                    generation = republish_lexical(self.oracle, self.root)
                packed = load_packed_lexical(self.root, device=self.device)
                if packed is not None:
                    self.sealed = packed
                from frankensearch_tpu_torch.core.generation import refresh_manifest

                refresh_manifest(self.root)  # new lexical generation in the census
            else:
                from frankensearch_tpu_torch.lexical.segments import (
                    SegmentedBm25,
                    append_segment,
                )

                stacked = None
                if incremental and (
                    hasattr(self.sealed, "_dispatch_rows")
                    or isinstance(self.sealed, SegmentedBm25)
                ):
                    # in-memory append fast path over a DEVICE sealed arm
                    stacked = append_segment(self.sealed, self._window_docs)
                # stack full / non-device arm: the oracle IS the sealed arm
                self.sealed = stacked if stacked is not None else self.oracle
            receipt = SealReceipt(
                generation=generation,
                docs_sealed=self._delta_count,
                sealed_at=self.clock(),
            )
            self.seal_history.append(receipt)
            self._delta_count = 0
            self._window_docs = []
            self._window_dirty = False
            self.lease.reset()
            return receipt

    # -- read path (searchable before seal) ----------------------------------

    def _read_arm(self) -> LexicalRead:
        if self._delta_count > 0 or self.sealed is None:
            return self.oracle
        return self.sealed

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        return self._read_arm().search_candidates(query, budget)

    def search_boolean(self, query, limit: int):
        # delta window serves from the oracle (exact trees); sealed
        # window serves the device arm (bag + post-filter default)
        return self._read_arm().search_boolean(query, limit)

    def search_candidates_batch(self, queries: Sequence[str], budget: int):
        arm = self._read_arm()
        if hasattr(arm, "search_candidates_batch"):
            return arm.search_candidates_batch(queries, budget)
        return [arm.search_candidates(q, budget) for q in queries]

    def hydrate_candidates(self, doc_ids: Sequence[str]) -> dict[str, Mapping]:
        # the oracle always holds the superset snapshot
        return self.oracle.hydrate_candidates(doc_ids)

    def doc_count(self) -> int:
        return self.oracle.doc_count()
