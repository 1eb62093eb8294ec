"""Fused phase 1: vector scan + dense device BM25 in one device pass (PyTorch).

Port of the dense lane of frankensearch_tpu/ops/hybrid_phase1.py. Both arms
are enqueued on the same CUDA stream and the caller fetches all results
with one host sync. The blocked, DAAT and Model2Vec-embed variants are not
ported yet.
"""

from __future__ import annotations

import torch

from frankensearch_tpu_torch.lexical.device_bm25 import DocSteps, _device_bm25
from frankensearch_tpu_torch.ops import topk_scan


def _vector_arm(slab, mask, q, *, k: int, scan_mode: str) -> topk_scan.TopKResult:
    if scan_mode == "hierarchical":
        return topk_scan.scan_topk_hierarchical(slab, q, k, mask)
    if scan_mode == "xla":
        return topk_scan.scan_topk_xla(slab, q, k, mask)
    raise NotImplementedError(f"scan mode {scan_mode!r} is not ported yet")


def _lex_dense(post_term, post_tf, steps: DocSteps, q_idf, *, k_lex: int, n_docs_lex: int):
    """The dense lexical arm: exactly the dense lane's ``_device_bm25``."""
    return _device_bm25(post_term, post_tf, steps, q_idf, n_docs=n_docs_lex, k=k_lex)


def _pad_q(q: torch.Tensor, d_pad: int) -> torch.Tensor:
    d = q.shape[1]
    if d == d_pad:
        return q
    return torch.nn.functional.pad(q, (0, d_pad - d))


def fused_phase1_dense(
    slab, mask, q_vecs,
    post_term, post_tf, steps: DocSteps, q_idf,
    *, k_vec: int, k_lex: int, scan_mode: str, n_docs_lex: int,
):
    """(vec scores, vec rows i32, lex scores, lex rows) for a query batch."""
    vec = _vector_arm(slab, mask, q_vecs, k=k_vec, scan_mode=scan_mode)
    lex_s, lex_i = _lex_dense(
        post_term, post_tf, steps, q_idf, k_lex=k_lex, n_docs_lex=n_docs_lex
    )
    return vec.scores, vec.indices, lex_s, lex_i.to(torch.int32)
