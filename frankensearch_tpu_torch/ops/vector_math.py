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


def int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 x (k, n) int8 -> (m, n) exact int32 sums. On CUDA
    ``torch._int_mm``, whose shape rules (more than 16 rows, k and n
    multiples of 8) are met by zero padding, which adds exact zeros; on
    the CPU an int32 product."""
    m, k = x_i8.shape
    n = w_i8.shape[1]
    if not x_i8.is_cuda:
        return torch.matmul(x_i8.to(torch.int32), w_i8.to(torch.int32))
    m_pad, k_pad, n_pad = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    if (m_pad, k_pad) != (m, k):
        x_i8 = torch.nn.functional.pad(x_i8, (0, k_pad - k, 0, m_pad - m))
    if (k_pad, n_pad) != (k, n):
        w_i8 = torch.nn.functional.pad(w_i8, (0, n_pad - n, 0, k_pad - k))
    return torch._int_mm(x_i8, w_i8.contiguous())[:m, :n]


def mm_bf16_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (or f16) (..., m, k) x (..., k, n) -> f32 sums and output
    (batched over one leading dim at most). On CUDA cuBLAS with an f32
    output; on the CPU the values widened to f32 (exact products, f32
    sums)."""
    if not a.is_cuda:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    if a.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)
