"""Fused phase 1: vector scan + device BM25 in one device pass (PyTorch).

Port of frankensearch_tpu/ops/hybrid_phase1.py, query vectors given: the
dense lane (``fused_phase1_dense``), the exhaustive blocked lanes
(``fused_phase1_blocked``: the flat hot-arm scan on split corpora, the
pruned scan otherwise), the term-driven lane (``fused_phase1_daat``) and
mixed batches (``fused_phase1_daat_mixed``: both lexical lanes, each query
keeping its own lane's bits). Both arms are enqueued on the same CUDA
stream and the caller fetches all results with one host sync. The
``fused_phase1_embed_*`` variants put the Model2Vec gather + mean-pool
embed (``embed/model2vec.gather_pool_normalize``) in front of the same
bodies, so phase 1 starts from token ids: embed, scan, BM25 (and the
caller's device RRF) in one pass. ``fused_phase1_sharded`` is the mesh's
phase 1: the row-sharded vector scan and the block-sharded BM25 arm
(parallel/) over the same shards, their merged heaps on the lead device.
"""

from __future__ import annotations

import torch

from frankensearch_tpu_torch.embed.model2vec import gather_pool_normalize
from frankensearch_tpu_torch.lexical.device_bm25 import (
    DocSteps,
    _blocked_hot_body,
    _device_bm25,
    _graded_scan_pruned,
)
from frankensearch_tpu_torch.lexical.daat import daat_topk_tm
from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.parallel.sharded_bm25 import sharded_bm25_topk
from frankensearch_tpu_torch.parallel.sharded_scan import sharded_scan_topk, sharded_scan_topk_hier


def _vector_arm(slab, mask, q, *, k: int, scan_mode: str) -> topk_scan.TopKResult:
    if scan_mode == "hierarchical":
        return topk_scan.scan_topk_hierarchical(slab, q, k, mask)
    if scan_mode == "xla":
        return topk_scan.scan_topk_xla(slab, q, k, mask)
    raise ValueError(f"unknown scan mode {scan_mode!r}")


def _lex_dense(post_term, post_tf, steps: DocSteps, q_idf, *, k_lex: int, n_docs_lex: int):
    """The dense lexical arm: exactly the dense lane's ``_device_bm25``."""
    return _device_bm25(post_term, post_tf, steps, q_idf, n_docs=n_docs_lex, k=k_lex)


def _lex_blocked(classes, bounds_list, q_ids, q_w, *, k_lex: int, hot=None):
    """Exhaustive lexical arm. ``hot`` is the split layout's hot arm as
    (cols_phys, q_hot, cold_cols, cold_rows, dmap_groups): the flat scan
    runs and ``bounds_list`` is unused (None). Without it, the pruned scan
    runs on ``bounds_list``. Both are the unfused lanes' own bodies, so the
    fused bits equal ``search_candidates_batch``'s."""
    if hot is not None:
        cols_phys, q_hot, cold_cols, cold_rows, dmap_groups = hot
        lex_s, lex_i, _ = _blocked_hot_body(
            classes, q_ids, q_w, cols_phys, q_hot, cold_cols, cold_rows, dmap_groups, k=k_lex,
        )
        return lex_s, lex_i
    lex_s, lex_i, _ = _graded_scan_pruned(classes, bounds_list, q_ids, q_w, k=k_lex)
    return lex_s, lex_i


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
    """(vec scores, vec rows i32, lex scores, lex rows i32) for a query batch."""
    vec = _vector_arm(slab, mask, q_vecs, k=k_vec, scan_mode=scan_mode)
    lex_s, lex_i = _lex_dense(
        post_term, post_tf, steps, q_idf, k_lex=k_lex, n_docs_lex=n_docs_lex
    )
    return vec.scores, vec.indices, lex_s, lex_i.to(torch.int32)


def fused_phase1_blocked(
    slab, mask, q_vecs,
    classes, bounds_list, q_ids, q_w, hot=None,
    *, k_vec: int, k_lex: int, scan_mode: str,
):
    vec = _vector_arm(slab, mask, q_vecs, k=k_vec, scan_mode=scan_mode)
    lex_s, lex_i = _lex_blocked(classes, bounds_list, q_ids, q_w, k_lex=k_lex, hot=hot)
    return vec.scores, vec.indices, lex_s, lex_i


def fused_phase1_daat(
    slab, mask, q_vecs,
    tm, row_idx, row_w, span_lo, span_hi,
    *, k_vec: int, k_lex: int, scan_mode: str, t_run: int, tm_packed: bool = False,
):
    """Vector scan + term-driven BM25 (``tm`` is
    ``TermMajorPostings.device_arrays()``): the lane for batches whose every
    query is daat-eligible and pure-tail."""
    vec = _vector_arm(slab, mask, q_vecs, k=k_vec, scan_mode=scan_mode)
    lex_s, lex_i = daat_topk_tm(
        tm, row_idx, row_w, span_lo, span_hi, k=k_lex, t_run=t_run, packed=tm_packed,
    )
    return vec.scores, vec.indices, lex_s, lex_i


def _lex_select(elig, daat_s, daat_i, blk_s, blk_i):
    """Per-query lane selection, a row-wise where: eligible queries take
    their term-driven bits, the rest their exhaustive bits."""
    sel = elig[:, None]
    return torch.where(sel, daat_s, blk_s), torch.where(sel, daat_i, blk_i)


def fused_phase1_daat_mixed(
    slab, mask, q_vecs,
    tm, row_idx, row_w, span_lo, span_hi, elig,
    classes, bounds_list, q_ids, q_w, hot=None,
    *, k_vec: int, k_lex: int, scan_mode: str, t_run: int, tm_packed: bool = False,
):
    """Mixed-eligibility batch: both lexical lanes run over the whole batch
    (the ineligible queries' daat plan is empty) and each query keeps its
    own lane's bits."""
    vec = _vector_arm(slab, mask, q_vecs, k=k_vec, scan_mode=scan_mode)
    d_s, d_i = daat_topk_tm(
        tm, row_idx, row_w, span_lo, span_hi, k=k_lex, t_run=t_run, packed=tm_packed,
    )
    b_s, b_i = _lex_blocked(classes, bounds_list, q_ids, q_w, k_lex=k_lex, hot=hot)
    lex_s, lex_i = _lex_select(elig, d_s, d_i, b_s, b_i)
    return vec.scores, vec.indices, lex_s, lex_i


def _embed_q(emb, tok_ids, tok_mask, d_pad: int) -> torch.Tensor:
    return _pad_q(gather_pool_normalize(emb, tok_ids, tok_mask), d_pad)


def fused_phase1_embed_dense(
    emb, tok_ids, tok_mask, slab, mask,
    post_term, post_tf, steps: DocSteps, q_idf,
    *, k_vec: int, k_lex: int, scan_mode: str, n_docs_lex: int, d_pad: int,
):
    """Model2Vec embed + :func:`fused_phase1_dense`."""
    return fused_phase1_dense(
        slab, mask, _embed_q(emb, tok_ids, tok_mask, d_pad), post_term, post_tf, steps, q_idf,
        k_vec=k_vec, k_lex=k_lex, scan_mode=scan_mode, n_docs_lex=n_docs_lex,
    )


def fused_phase1_embed_blocked(
    emb, tok_ids, tok_mask, slab, mask,
    classes, bounds_list, q_ids, q_w, hot=None,
    *, k_vec: int, k_lex: int, scan_mode: str, d_pad: int,
):
    """Model2Vec embed + :func:`fused_phase1_blocked`."""
    return fused_phase1_blocked(
        slab, mask, _embed_q(emb, tok_ids, tok_mask, d_pad), classes, bounds_list, q_ids, q_w, hot,
        k_vec=k_vec, k_lex=k_lex, scan_mode=scan_mode,
    )


def fused_phase1_embed_daat(
    emb, tok_ids, tok_mask, slab, mask,
    tm, row_idx, row_w, span_lo, span_hi,
    *, k_vec: int, k_lex: int, scan_mode: str, t_run: int, d_pad: int, tm_packed: bool = False,
):
    """Model2Vec embed + :func:`fused_phase1_daat`."""
    return fused_phase1_daat(
        slab, mask, _embed_q(emb, tok_ids, tok_mask, d_pad), tm, row_idx, row_w, span_lo, span_hi,
        k_vec=k_vec, k_lex=k_lex, scan_mode=scan_mode, t_run=t_run, tm_packed=tm_packed,
    )


def fused_phase1_embed_daat_mixed(
    emb, tok_ids, tok_mask, slab, mask,
    tm, row_idx, row_w, span_lo, span_hi, elig,
    classes, bounds_list, q_ids, q_w, hot=None,
    *, k_vec: int, k_lex: int, scan_mode: str, t_run: int, d_pad: int, tm_packed: bool = False,
):
    """Model2Vec embed + :func:`fused_phase1_daat_mixed`."""
    return fused_phase1_daat_mixed(
        slab, mask, _embed_q(emb, tok_ids, tok_mask, d_pad),
        tm, row_idx, row_w, span_lo, span_hi, elig, classes, bounds_list, q_ids, q_w, hot,
        k_vec=k_vec, k_lex=k_lex, scan_mode=scan_mode, t_run=t_run, tm_packed=tm_packed,
    )


def fused_phase1_sharded(
    slab, mask, q_vecs,
    sharded_blocks, bounds, q_ids, q_w,
    *, k_vec: int, k_lex: int, scan_mode: str = "xla",
):
    """Phase 1 on a mesh: the document-sharded vector scan over ``slab`` /
    ``mask`` (per-shard tensors, ``ShardedDeviceVectorIndex``'s) and the
    block-sharded pruned BM25 arm over ``sharded_blocks`` with its per-shard
    ``bounds`` (``ShardedBulkDeviceBm25Index``'s ``_sharded`` and
    ``place_bounds``). ``scan_mode="hier"`` runs K1 + K2 per shard (the
    shards 8192-row aligned), ``"xla"`` the plain exact body. The results
    are the separate sharded calls', merged on the lead device."""
    if scan_mode == "hier":
        vec = sharded_scan_topk_hier(slab, mask, q_vecs, k_vec)
    elif scan_mode == "xla":
        vec = sharded_scan_topk(slab, mask, q_vecs, k_vec)
    else:
        raise ValueError(f"unknown sharded scan mode {scan_mode!r}")
    lex_s, lex_i, _ = sharded_bm25_topk(sharded_blocks, bounds, q_ids, q_w, k=k_lex)
    return vec.scores, vec.indices, lex_s, lex_i
