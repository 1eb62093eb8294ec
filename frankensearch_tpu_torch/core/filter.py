"""Search-time filters applied during the scan.

Parity target: reference crates/frankensearch-core/src/filter.rs —
BitsetFilter / DocTypeFilter / DateRangeFilter / PredicateFilter /
FilterChain.

TPU-first design: every filter lowers to a **dense bool mask over slab
rows** (``mask(n_rows, doc_ids) -> np.ndarray[bool]``) which the device
scan consumes as a score mask (masked rows get -inf before top-k), so
filtering happens *during* the scan like the reference's filter-aware
scan fast path (index/src/search.rs:26-33). Host-side ``admit`` is kept
for post-hydration predicates.

``doc_ids`` may be a packed store (index/doc_id_store.py) that decodes a
row on each read. So only a filter that judges ids reads them: a bitset
asks the store for its rows by id (``isin``), and the metadata filters
read the metadata alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np


class SearchFilter:
    """Base filter interface."""

    def mask(self, doc_ids: Sequence[str], metadata: Sequence[Mapping | None]) -> np.ndarray:
        """Dense admission mask aligned with slab rows."""
        raise NotImplementedError

    def admit(self, doc_id: str, metadata: Mapping | None) -> bool:
        raise NotImplementedError


@dataclass
class BitsetFilter(SearchFilter):
    """Admit only doc ids in the given set (filter.rs BitsetFilter; the
    reference hashes ids with fnv1a — here a Python set suffices)."""

    allowed: frozenset[str]

    def mask(self, doc_ids, metadata) -> np.ndarray:
        isin = getattr(doc_ids, "isin", None)
        if isin is not None:  # a packed store: look the allowed ids up
            return isin(self.allowed)
        return np.fromiter((d in self.allowed for d in doc_ids), dtype=bool, count=len(doc_ids))

    def admit(self, doc_id, metadata) -> bool:
        return doc_id in self.allowed


@dataclass
class DocTypeFilter(SearchFilter):
    """Admit docs whose metadata ``doc_type`` is in the allowed set."""

    allowed_types: frozenset[str]
    type_key: str = "doc_type"

    def admit(self, doc_id, metadata) -> bool:
        if not metadata:
            return False
        return metadata.get(self.type_key) in self.allowed_types

    def mask(self, doc_ids, metadata) -> np.ndarray:
        # the ids play no part: read the metadata alone
        return np.fromiter((self.admit("", m) for m in metadata), dtype=bool, count=len(doc_ids))


@dataclass
class DateRangeFilter(SearchFilter):
    """Admit docs whose metadata timestamp (epoch seconds) is in range."""

    start: float | None = None
    end: float | None = None
    time_key: str = "mtime"

    def admit(self, doc_id, metadata) -> bool:
        if not metadata or self.time_key not in metadata:
            return False
        try:
            t = float(metadata[self.time_key])
        except (TypeError, ValueError):
            return False
        if self.start is not None and t < self.start:
            return False
        if self.end is not None and t > self.end:
            return False
        return True

    def mask(self, doc_ids, metadata) -> np.ndarray:
        # the ids play no part: read the metadata alone
        return np.fromiter((self.admit("", m) for m in metadata), dtype=bool, count=len(doc_ids))


@dataclass
class PredicateFilter(SearchFilter):
    """Arbitrary host predicate (doc_id, metadata) -> bool."""

    predicate: Callable[[str, Mapping | None], bool]

    def admit(self, doc_id, metadata) -> bool:
        return self.predicate(doc_id, metadata)

    def mask(self, doc_ids, metadata) -> np.ndarray:
        return np.fromiter(
            (self.predicate(d, m) for d, m in zip(doc_ids, metadata)),
            dtype=bool,
            count=len(doc_ids),
        )


@dataclass
class FilterChain(SearchFilter):
    """AND-composition of filters (filter.rs FilterChain)."""

    filters: list[SearchFilter] = field(default_factory=list)

    def add(self, f: SearchFilter) -> "FilterChain":
        self.filters.append(f)
        return self

    def admit(self, doc_id, metadata) -> bool:
        return all(f.admit(doc_id, metadata) for f in self.filters)

    def mask(self, doc_ids, metadata) -> np.ndarray:
        if not self.filters:
            return np.ones(len(doc_ids), dtype=bool)
        out = self.filters[0].mask(doc_ids, metadata)
        for f in self.filters[1:]:
            out &= f.mask(doc_ids, metadata)
        return out
