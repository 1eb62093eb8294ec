"""Cloud-API embedder with retry/rate-limit handling (transport-pluggable).

Parity target: reference crates/frankensearch-embed/src/api_embedder.rs +
api_provider.rs — OpenAI/Gemini-style embedding APIs behind a feature
gate, with retry/backoff on rate limits and L2 normalization of returned
vectors.

This environment is zero-egress, so the HTTP transport is injected: the
default transport raises (fail-closed); deployments supply a real one
(e.g. urllib/requests-based) or tests a fake. The retry/normalize/shape
contract is what carries over.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np

from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.embed.base import Embedder, l2_normalize_rows

#: transport(payload: dict) -> dict response; raises TransportError-ish on failure
Transport = Callable[[Mapping], Mapping]


class RateLimited(Exception):
    """Transport signals a retryable rate limit (HTTP 429 class)."""

    def __init__(self, retry_after_s: float = 0.5) -> None:
        super().__init__(f"rate limited; retry after {retry_after_s}s")
        self.retry_after_s = retry_after_s


def _no_transport(_payload: Mapping) -> Mapping:
    raise EmbeddingFailed(
        "ApiEmbedder has no transport configured (this build is offline; "
        "inject a transport to enable cloud embeddings)"
    )


@dataclass
class ApiEmbedderConfig:
    provider: str = "openai"  # "openai" | "gemini" | custom
    model: str = "text-embedding-3-small"
    dim: int = 1536
    max_retries: int = 3
    base_backoff_s: float = 0.25
    batch_limit: int = 128


class ApiEmbedder(Embedder):
    def __init__(
        self,
        config: ApiEmbedderConfig | None = None,
        transport: Transport = _no_transport,
        *,
        clock_sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.config = config or ApiEmbedderConfig()
        self.transport = transport
        self._sleep = clock_sleep
        self.requests = 0
        self.retries = 0

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def embedder_id(self) -> str:
        return f"api-{self.config.provider}-{self.config.model}"

    @property
    def revision(self) -> str:
        return self.config.model

    def _call(self, texts: Sequence[str]) -> list[list[float]]:
        payload = {
            "provider": self.config.provider,
            "model": self.config.model,
            "input": list(texts),
        }
        backoff = self.config.base_backoff_s
        last: Exception | None = None
        for _ in range(self.config.max_retries + 1):
            try:
                self.requests += 1
                resp = self.transport(payload)
                vectors = resp["embeddings"]
                if len(vectors) != len(texts):
                    raise EmbeddingFailed(
                        f"provider returned {len(vectors)} vectors for {len(texts)} inputs"
                    )
                return vectors
            except RateLimited as e:
                last = e
                self.retries += 1
                self._sleep(max(e.retry_after_s, backoff))
                backoff *= 2
            except EmbeddingFailed:
                raise
            except Exception as e:  # transport-level failure: retry
                last = e
                self.retries += 1
                self._sleep(backoff)
                backoff *= 2
        raise EmbeddingFailed(f"api embedding failed after retries: {last}")

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        out: list[list[float]] = []
        for start in range(0, len(texts), self.config.batch_limit):
            out.extend(self._call(texts[start : start + self.config.batch_limit]))
        arr = np.asarray(out, dtype=np.float32)
        if arr.shape[1] != self.dim:
            raise EmbeddingFailed(f"provider dim {arr.shape[1]} != configured {self.dim}")
        return l2_normalize_rows(arr)
