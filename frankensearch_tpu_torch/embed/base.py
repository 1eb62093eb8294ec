"""Embedder protocol + sync/batch adapters.

Parity target: reference crates/frankensearch-core/src/traits.rs —
``Embedder`` (:220) / ``SyncEmbed`` (:401): dim(), id(), revision(),
is_semantic(), embed/embed_batch, plus the identity bundle used for
fail-closed index admission.
"""

from __future__ import annotations

import abc
from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity


class Embedder(abc.ABC):
    """A text -> unit-norm f32 vector embedder."""

    @property
    @abc.abstractmethod
    def dim(self) -> int: ...

    @property
    @abc.abstractmethod
    def embedder_id(self) -> str: ...

    @property
    def revision(self) -> str:
        return ""

    @property
    def is_semantic(self) -> bool:
        """Hash embeddings are NOT semantic and are never admitted as
        semantic results (reference hash_embedder.rs contract)."""
        return True

    def identity(self) -> EmbeddingIdentity:
        return EmbeddingIdentity(
            embedder_id=self.embedder_id,
            embedder_revision=self.revision,
            dim=self.dim,
            is_semantic=self.is_semantic,
        )

    @abc.abstractmethod
    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """(len(texts), dim) f32, row-L2-normalized."""

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_prefetch(self, text: str):
        """Start the embedding NOW (device dispatch) and return a
        zero-arg collector. Device embedders override this so the
        forward runs while the caller does host work (e.g. Phase 2's
        query embed overlapping Phase 1's fusion + delivery — SURVEY §7
        'overlapping Phase-2 compute with Phase-1 result return').
        Default: lazy (no early dispatch)."""
        return lambda: self.embed(text)


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(norms > 1e-12, x / np.maximum(norms, 1e-12), x).astype(np.float32)
