"""S3-FIFO cache (Small / Main / Ghost queues).

Parity target: reference crates/frankensearch-core/src/cache.rs — the
SOSP'23 S3-FIFO eviction policy used for embedding and result caches:
new keys enter the Small queue (10% of capacity); on eviction from Small,
items that were re-referenced are promoted to Main, others fall to the
Ghost queue (key-only); a key re-inserted while ghost-resident goes
straight to Main. Frequency counters are capped at 3.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_FREQ_CAP = 3


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class S3FifoCache(Generic[K, V]):
    """A small, dependency-free S3-FIFO implementation."""

    def __init__(self, capacity: int, small_ratio: float = 0.1) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.small_cap = max(1, int(capacity * small_ratio))
        self.main_cap = max(1, capacity - self.small_cap)
        self.ghost_cap = max(1, self.main_cap)
        self._small: OrderedDict[K, V] = OrderedDict()
        self._main: OrderedDict[K, V] = OrderedDict()
        self._ghost: OrderedDict[K, None] = OrderedDict()
        self._freq: dict[K, int] = {}
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._small) + len(self._main)

    def __contains__(self, key: K) -> bool:
        return key in self._small or key in self._main

    def get(self, key: K) -> V | None:
        if key in self._small:
            self._freq[key] = min(self._freq.get(key, 0) + 1, _FREQ_CAP)
            self.stats.hits += 1
            return self._small[key]
        if key in self._main:
            self._freq[key] = min(self._freq.get(key, 0) + 1, _FREQ_CAP)
            self.stats.hits += 1
            return self._main[key]
        self.stats.misses += 1
        return None

    def put(self, key: K, value: V) -> None:
        if key in self._small:
            self._small[key] = value
            return
        if key in self._main:
            self._main[key] = value
            return
        if key in self._ghost:
            # ghost hit: insert directly into Main
            del self._ghost[key]
            self._insert_main(key, value)
        else:
            self._insert_small(key, value)

    def _insert_small(self, key: K, value: V) -> None:
        while len(self._small) >= self.small_cap:
            self._evict_small()
        self._small[key] = value
        self._freq[key] = 0

    def _insert_main(self, key: K, value: V) -> None:
        while len(self._main) >= self.main_cap:
            self._evict_main()
        self._main[key] = value
        self._freq.setdefault(key, 0)

    def _evict_small(self) -> None:
        key, value = self._small.popitem(last=False)
        if self._freq.get(key, 0) > 0:
            # re-referenced while in Small: promote to Main
            self._freq[key] = 0
            self._insert_main(key, value)
        else:
            self._freq.pop(key, None)
            self._ghost[key] = None
            while len(self._ghost) > self.ghost_cap:
                self._ghost.popitem(last=False)
            self.stats.evictions += 1

    def _evict_main(self) -> None:
        # Main is FIFO with lazy second chance: re-referenced heads are
        # reinserted with decremented frequency instead of evicted.
        while True:
            key, value = self._main.popitem(last=False)
            freq = self._freq.get(key, 0)
            if freq > 0:
                self._freq[key] = freq - 1
                self._main[key] = value  # reinsert at tail
            else:
                self._freq.pop(key, None)
                self.stats.evictions += 1
                return

    def clear(self) -> None:
        self._small.clear()
        self._main.clear()
        self._ghost.clear()
        self._freq.clear()
