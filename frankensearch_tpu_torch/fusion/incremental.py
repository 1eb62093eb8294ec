"""As-you-type incremental search state machine.

Parity target: reference crates/frankensearch-fusion/src/incremental.rs
(:1-8) — prefix-extension queries reuse the previous result pool
(re-rank the cached pool lexically) instead of re-running the full
pipeline; a non-extension edit resets the state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from frankensearch_tpu_torch.core.types import ScoredResult


@dataclass
class IncrementalState:
    last_query: str = ""
    pool: list[ScoredResult] = field(default_factory=list)
    pool_created_at: float = 0.0
    full_searches: int = 0
    pool_reuses: int = 0


@dataclass
class IncrementalSearcher:
    """Wraps a full searcher with prefix-reuse.

    search_fn(query, k) must return the over-fetched pool (the wrapper
    asks for pool_multiplier * k so prefix refinements have headroom).
    """

    search_fn: Callable[[str, int], list[ScoredResult]]
    #: doc text source for pool refinement (e.g. the searcher's
    #: storage-backed default_text_fn applied to r.doc_id). Without one,
    #: only title + metadata preview are visible — results that carry
    #: neither are UNPROVABLE and kept (the "available text" contract,
    #: same as the negation filter), found ranking garbage above real
    #: hits when the filter dropped titled docs on title-only evidence.
    text_fn: Callable[[ScoredResult], str | None] | None = None
    pool_multiplier: int = 5
    max_pool_age_s: float = 10.0
    min_prefix_len: int = 2
    state: IncrementalState = field(default_factory=IncrementalState)
    clock: Callable[[], float] = time.monotonic

    def search(self, query: str, k: int = 10) -> list[ScoredResult]:
        q = query.strip().lower()
        st = self.state
        fresh = (self.clock() - st.pool_created_at) <= self.max_pool_age_s
        is_extension = (
            bool(st.last_query)
            and len(q) >= self.min_prefix_len
            and q.startswith(st.last_query)
            and q != st.last_query
        )
        if is_extension and fresh and st.pool:
            st.pool_reuses += 1
            st.last_query = q
            refined = self._filter_pool(q, st.pool)
            if len(refined) >= min(k, 2):
                return refined[:k]
            # pool too thin after filtering: fall through to a full search
        pool = self.search_fn(query, k * self.pool_multiplier)
        st.pool = pool
        st.last_query = q
        st.pool_created_at = self.clock()
        st.full_searches += 1
        return pool[:k]

    def _text_of(self, r: ScoredResult) -> str | None:
        parts = [r.title or "", str((r.metadata or {}).get("preview", ""))]
        if self.text_fn is not None:
            try:
                parts.append(self.text_fn(r) or "")
            except Exception:
                pass
        hay = " ".join(p for p in parts if p)
        return hay.lower() or None

    def _filter_pool(self, q: str, pool: list[ScoredResult]) -> list[ScoredResult]:
        """Keep pool docs whose available text still matches every term;
        docs with NO available text are unprovable and kept (the
        documented "available text" bound, same as the negation filter)."""
        terms = q.split()
        matched, unprovable = [], []
        for r in pool:
            hay = self._text_of(r)
            if hay is None:
                unprovable.append(r)
            elif all(t in hay for t in terms):
                matched.append(r)
        # proven matches outrank unprovable carries (each keeps pool order)
        return matched + unprovable
