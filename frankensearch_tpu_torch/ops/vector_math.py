"""Element-wise vector math (PyTorch port of frankensearch_tpu/ops/vector_math.py).

Parity target: reference SIMD helpers — l2 normalization / cosine /
mean pooling (core/src/simd.rs, embed/src/simd.rs).
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization; zero rows stay zero (reference contract:
    l2_normalize leaves zero vectors untouched)."""
    norm = torch.linalg.vector_norm(x.to(torch.float32), dim=-1, keepdim=True)
    return torch.where(norm > eps, x / norm.to(x.dtype), x)


def cosine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity (A rows x B rows), f32 accumulation."""
    an = l2_normalize(a).to(torch.float32)
    bn = l2_normalize(b).to(torch.float32)
    return an @ bn.T


def mean_pool(token_embeddings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling over the token axis.

    token_embeddings: (B, T, D); mask: (B, T) 1/0. Matches the reference's
    Model2Vec / MiniLM mean-pool contract (embed/src/model2vec_embedder.rs,
    fastembed mean pooling).
    """
    mask_f = mask.to(torch.float32)[..., None]
    summed = torch.sum(token_embeddings.to(torch.float32) * mask_f, dim=1)
    counts = torch.clamp(torch.sum(mask_f, dim=1), min=1.0)
    return summed / counts
