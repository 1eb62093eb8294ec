"""Query-embedding cache wrapper.

Parity target: reference crates/frankensearch-embed/src/cached_embedder.rs —
a small cache in front of an embedder for repeated queries (the reference
uses a 128-entry FIFO; here the core S3-FIFO gives strictly better hit
rates at the same capacity).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.core.cache import S3FifoCache
from frankensearch_tpu_torch.embed.base import Embedder


class CachedEmbedder(Embedder):
    def __init__(self, inner: Embedder, capacity: int = 128) -> None:
        self.inner = inner
        self._cache: S3FifoCache[str, np.ndarray] = S3FifoCache(capacity)

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def embedder_id(self) -> str:
        return self.inner.embedder_id

    @property
    def revision(self) -> str:
        return self.inner.revision

    @property
    def is_semantic(self) -> bool:
        return self.inner.is_semantic

    @property
    def stats(self):
        return self._cache.stats

    def embed_prefetch(self, text: str):
        """Pass the prefetch THROUGH to the inner embedder on a miss —
        without this override the base-class lazy fallback silently
        disabled the phase-2 overlap for the default (cached) searcher
        wiring. The collected vector lands in the cache."""
        hit = self._cache.get(text)
        if hit is not None:
            return lambda: hit
        collect = self.inner.embed_prefetch(text)

        def collect_and_cache():
            vec = collect()
            self._cache.put(text, vec)
            return vec

        return collect_and_cache

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        missing: list[int] = []
        for i, t in enumerate(texts):
            hit = self._cache.get(t)
            if hit is not None:
                out[i] = hit
            else:
                missing.append(i)
        if missing:
            fresh = self.inner.embed_batch([texts[i] for i in missing])
            for j, i in enumerate(missing):
                out[i] = fresh[j]
                self._cache.put(texts[i], fresh[j])
        return out
