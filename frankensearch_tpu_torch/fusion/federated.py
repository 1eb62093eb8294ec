"""Federated search: fan one query over N searchers, fuse the results.

Parity target: reference crates/frankensearch-fusion/src/federated.rs
(:26-259) — ``FederatedSearcher`` fans out over shards (each a full
TwoTierSearcher), merges via RRF or score merge, reports per-shard errors
and a ``FederatedCoverage`` receipt instead of failing the whole query.

The within-device analog is a sharded device scan (not ported yet);
this host-level federation covers
multi-index / multi-corpus composition where indexes are separate
artifacts (and, later, separate hosts).

Divergence from the JAX package: a shard's ``SearchError`` becomes its
coverage entry as there, but any other exception from a shard's search
(a device fault) is raised again from ``search()`` instead of being
folded into the receipt.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

from frankensearch_tpu_torch.core.errors import SearchError
from frankensearch_tpu_torch.core.types import ScoredResult
from frankensearch_tpu_torch.fusion.rrf import RrfConfig, _rank_contribution, _sanitize_k


class MergeStrategy(enum.Enum):
    RRF = "rrf"
    SCORE = "score"  # raw score merge (requires comparable score scales)


@dataclass(frozen=True)
class ShardError:
    shard: str
    error: str


@dataclass(frozen=True)
class FederatedCoverage:
    """Which shards answered (parity: federated.rs FederatedCoverage)."""

    total_shards: int
    responded: int
    failed: tuple[ShardError, ...] = ()
    timed_out: tuple[str, ...] = ()

    @property
    def complete(self) -> bool:
        return self.responded == self.total_shards


@dataclass
class FederatedResult:
    results: list[ScoredResult]
    coverage: FederatedCoverage
    latency_ms: float = 0.0


@dataclass
class FederatedSearcher:
    #: (name, searcher) pairs; searcher must expose .search(query, k=...)
    shards: list[tuple[str, object]] = field(default_factory=list)
    merge: MergeStrategy = MergeStrategy.RRF
    rrf_k: float = 60.0
    timeout_s: float | None = None
    #: shard name -> still-running thread from an earlier timed-out call;
    #: such a shard is reported timed_out again WITHOUT spawning a new
    #: probe, bounding the leak to one thread per stuck shard
    _inflight: dict = field(default_factory=dict, repr=False)

    def add_shard(self, name: str, searcher) -> None:
        if any(n == name for n, _ in self.shards):
            # per-shard results are keyed by name: a duplicate would
            # silently overwrite the other shard's hits in the merge
            raise ValueError(f"duplicate shard name {name!r}")
        self.shards.append((name, searcher))

    def search(self, query: str, k: int = 10, **kwargs) -> FederatedResult:
        """Fan out with a HARD latency bound. Design notes (both probed):
        a ThreadPoolExecutor ``with`` block waits for running threads, so
        one hung shard held the whole query for its full duration; and
        its non-daemon workers are joined at interpreter exit, so a
        permanently hung shard would block a one-shot CLI from ever
        exiting. Daemon threads + the ``_inflight`` guard give a bounded
        call, a clean exit, and at most one abandoned thread per stuck
        shard (a stuck shard is not re-probed while its old probe runs —
        it keeps appearing in ``timed_out`` until it answers).

        A shard's ``SearchError`` is reported in the coverage receipt;
        any other exception is relayed out of the thread and raised here
        once every shard has been joined."""
        t0 = time.monotonic()
        per_shard: dict[str, list[ScoredResult]] = {}
        errors: list[ShardError] = []
        timed_out: list[str] = []
        boxes: dict[str, dict] = {}
        threads: dict[str, threading.Thread] = {}
        for name, s in self.shards:
            prev = self._inflight.get(name)
            if prev is not None and prev.is_alive():
                timed_out.append(name)  # still stuck from an earlier call
                continue
            self._inflight.pop(name, None)
            box: dict = {}

            def run(s=s, box=box):
                try:
                    box["result"] = self._search_one(s, query, k, kwargs)
                except SearchError as e:  # reported per shard
                    box["error"] = e
                except Exception as e:  # noqa: BLE001 - relayed, raised below
                    box["fault"] = e

            t = threading.Thread(target=run, daemon=True, name=f"fed-{name}")
            t.start()
            boxes[name] = box
            threads[name] = t
        deadline = (
            None if self.timeout_s is None else time.monotonic() + self.timeout_s
        )
        faults: list[BaseException] = []
        for name, t in threads.items():
            t.join(
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            if t.is_alive():
                timed_out.append(name)
                self._inflight[name] = t  # abandon; result discarded
                continue
            box = boxes[name]
            if "fault" in box:
                faults.append(box["fault"])
            elif "error" in box:
                e = box["error"]
                errors.append(
                    ShardError(shard=name, error=f"{type(e).__name__}: {e}")
                )
            else:
                per_shard[name] = box["result"]
        if faults:
            raise faults[0]

        merged = self._merge(per_shard, k)
        coverage = FederatedCoverage(
            total_shards=len(self.shards),
            responded=len(per_shard),
            failed=tuple(errors),
            timed_out=tuple(timed_out),
        )
        return FederatedResult(
            results=merged,
            coverage=coverage,
            latency_ms=(time.monotonic() - t0) * 1000.0,
        )

    @staticmethod
    def _search_one(searcher, query: str, k: int, kwargs) -> list[ScoredResult]:
        out = searcher.search(query, k=k, **kwargs)
        return out.results if hasattr(out, "results") else list(out)

    def _merge(
        self, per_shard: dict[str, list[ScoredResult]], k: int
    ) -> list[ScoredResult]:
        best: dict[str, ScoredResult] = {}
        fused_score: dict[str, float] = {}
        if self.merge is MergeStrategy.RRF:
            kk = _sanitize_k(self.rrf_k)
            for _, results in sorted(per_shard.items()):
                for rank, r in enumerate(results):
                    fused_score[r.doc_id] = fused_score.get(r.doc_id, 0.0) + _rank_contribution(
                        kk, rank
                    )
                    if r.doc_id not in best or r.score > best[r.doc_id].score:
                        best[r.doc_id] = r
        else:
            for _, results in sorted(per_shard.items()):
                for r in results:
                    if r.doc_id not in fused_score or r.score > fused_score[r.doc_id]:
                        fused_score[r.doc_id] = r.score
                        best[r.doc_id] = r
        ranked = sorted(fused_score.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        out = []
        for doc_id, score in ranked:
            r = best[doc_id]
            out.append(
                ScoredResult(
                    doc_id=doc_id, score=score,
                    lexical_score=r.lexical_score, fast_score=r.fast_score,
                    quality_score=r.quality_score, rerank_score=r.rerank_score,
                    sources=r.sources, title=r.title, snippet=r.snippet,
                    metadata=r.metadata,
                )
            )
        return out
