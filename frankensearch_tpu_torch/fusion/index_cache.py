"""Index cache: staleness detection + atomic serving-index replacement.

Parity target: reference crates/frankensearch-fusion/src/cache.rs —
``IndexCache`` with a ``SentinelFileDetector``: a sentinel (the lexical
CURRENT pointer / FTVI mtime) is polled cheaply; when it changes, the
index is reloaded once and atomically swapped into serving, so readers
never see a half-open index.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class SentinelState:
    fingerprint: tuple


class SentinelFileDetector:
    """Cheap staleness probe over a set of sentinel files: (mtime_ns, size,
    inode) of each — any change means the generation moved."""

    def __init__(self, paths: list[str]) -> None:
        self.paths = list(paths)

    def snapshot(self) -> SentinelState:
        parts = []
        for p in self.paths:
            try:
                st = os.stat(p)
                parts.append((p, st.st_mtime_ns, st.st_size, st.st_ino))
            except OSError:
                parts.append((p, None))
        return SentinelState(fingerprint=tuple(parts))


class IndexCache:
    """Holds the serving index; reloads on sentinel change, atomically."""

    def __init__(
        self,
        loader: Callable[[], object],
        detector: SentinelFileDetector,
    ) -> None:
        self._loader = loader
        self._detector = detector
        self._lock = threading.Lock()
        self._index = loader()
        self._state = detector.snapshot()
        self.reloads = 0
        self.probes = 0

    def get(self) -> object:
        """Current serving index; probes the sentinel and swaps if stale.
        The swap happens fully before the new index becomes visible."""
        self.probes += 1
        current = self._detector.snapshot()
        if current != self._state:
            with self._lock:
                # re-check under the lock (another thread may have swapped)
                current = self._detector.snapshot()
                if current != self._state:
                    new_index = self._loader()  # fully built BEFORE swap
                    self._index = new_index
                    self._state = current
                    self.reloads += 1
        return self._index

    @classmethod
    def for_root(cls, root: str, **open_kwargs) -> "IndexCache":
        """Cache over TwoTierIndex.open(root) with the standard sentinels
        (fast artifact + its WAL + the lexical CURRENT pointer)."""
        from frankensearch_tpu_torch.index.two_tier import TwoTierIndex, TwoTierPaths

        paths = TwoTierPaths(root)
        sentinels = [paths.fast, paths.wal_for(paths.fast),
                     os.path.join(root, "lexical", "CURRENT"),
                     # fts5 backend: the .db IS the publication artifact
                     os.path.join(root, "lexical", "fts5.db")]
        return cls(
            loader=lambda: TwoTierIndex.open(root, **open_kwargs),
            detector=SentinelFileDetector(sentinels),
        )
