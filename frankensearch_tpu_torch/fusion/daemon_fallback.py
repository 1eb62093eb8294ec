"""Daemon-first embedding with bounded-retry local fallback.

Parity target: reference crates/frankensearch-fusion/src/daemon_fallback.rs
(:1-4) — try the warm daemon first; on failure fall back to the local
embedder; remember daemon health with a cooldown so a dead daemon isn't
re-probed on every query.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.core.daemon import DaemonClient
from frankensearch_tpu_torch.core.errors import EmbeddingFailed, SubsystemError
from frankensearch_tpu_torch.embed.base import Embedder


@dataclass
class FallbackStats:
    daemon_hits: int = 0
    local_fallbacks: int = 0
    daemon_marked_down_at: float | None = None


class DaemonFallbackEmbedder(Embedder):
    def __init__(
        self,
        client: DaemonClient,
        local: Embedder,
        *,
        down_cooldown_s: float = 10.0,
        clock=time.monotonic,
    ) -> None:
        self.client = client
        self.local = local
        self.down_cooldown_s = down_cooldown_s
        self.clock = clock
        self.stats = FallbackStats()

    @property
    def dim(self) -> int:
        return self.local.dim

    @property
    def embedder_id(self) -> str:
        return self.local.embedder_id

    @property
    def revision(self) -> str:
        return self.local.revision

    @property
    def is_semantic(self) -> bool:
        return self.local.is_semantic

    def _daemon_usable(self) -> bool:
        down_at = self.stats.daemon_marked_down_at
        if down_at is None:
            return True
        return self.clock() - down_at >= self.down_cooldown_s

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            # never probe the daemon with an empty batch: np.asarray([])
            # has shape (0,), which would fail the (0, dim) payload gate
            # and mark a HEALTHY daemon down for the cooldown
            return np.zeros((0, self.local.dim), np.float32)
        if self._daemon_usable():
            try:
                vectors = self.client.embed(list(texts))
                # Attestation pins identity at the HANDSHAKE; each
                # response payload still needs validation (probed: a
                # short vector list silently misaligned queries with
                # each other's vectors downstream, wrong-dim/NaN rows
                # flowed into the scan, ragged lists crashed instead of
                # falling back). Any malformed payload is a daemon
                # fault: mark down, serve locally.
                arr = np.asarray(vectors, dtype=np.float32)
                if arr.shape != (len(texts), self.local.dim) or not np.isfinite(
                    arr
                ).all():
                    raise EmbeddingFailed(
                        f"daemon returned malformed vectors: shape "
                        f"{arr.shape}, expected {(len(texts), self.local.dim)}"
                    )
                self.stats.daemon_hits += 1
                self.stats.daemon_marked_down_at = None
                return arr
            except (SubsystemError, EmbeddingFailed, ValueError, TypeError):
                # EmbeddingFailed here is the client's attestation-mismatch
                # refusal (daemon serves a DIFFERENT model) or the payload
                # validation above; ValueError/TypeError are ragged or
                # non-numeric payloads. Falling back to the local embedder
                # is safe — local IS the correct space — and the cooldown
                # stops re-probing a daemon that will keep misbehaving
                self.stats.daemon_marked_down_at = self.clock()
        self.stats.local_fallbacks += 1
        return self.local.embed_batch(texts)
