"""Device-side BM25 scoring: the dense, pruned, flat (hot-arm) and DAAT lanes
(PyTorch port of frankensearch_tpu/lexical/device_bm25.py).

Below ``BLOCKED_THRESHOLD_POSTINGS`` the postings live on the device as
flat arrays and the dense lane scores every posting of every query:

    post_term (P,) i32   term id of posting p
    post_tf   (P,) f32   precomputed tf-side score
                         boost * (k1+1) * tf / (tf + norm_cache[normid[doc]])
    contrib (P, B) = post_tf[p] * q_idf[b, post_term[p]]
    scores (N, B)  = per-doc sum of contrib, then top-k (score desc, row asc).

The per-doc sum is a doc-major plan built once at upload: step j adds the
j-th posting of every doc with more than j postings to a running f32 sum,
the sequential order of the reference's segment sum on the CPU, so the
two agree bit for bit (no float atomics).

At or above the threshold the postings go into the length-graded blocked
layout, and the layout SPLITS (lexical/hot_arm.py) when the df head fits
the hot arm's budget:

- split corpora store the blocks transposed, (n_c, L, d_pad) per class;
  the FLAT lane runs kernel K3 (:func:`flat_class_fused`,
  ops/csrc/flat_score.cu) once per class: it scores every tail slot, adds
  the hot partial in the same slot space and reduces per 128-slot group
  to (max, row of the first max) in one pass; the lane then selects the
  top-k groups per query and finishes with an exact sort of their slots;
- unsplit corpora keep the doc-major blocks and run the PRUNED lane: the
  blocks in descending order of their block-max bound, each skipped when
  its bound is below every query's running k-th score;
- pure-tail queries whose own postings are few take the term-driven DAAT
  lane (lexical/daat.py), as the reference's ``daat_mode = "auto"``
  dispatch sends them.

Summation orders, and where the bits stand against the reference:
- K3 sums each slot's contributions in (l, j) order with no fused
  multiply-add: the reference's Pallas kernel's order, bit for bit. The
  reference's default flat scorer is an XLA chunked einsum instead
  (``FLAT_PALLAS = False``), which differs by up to ~1e-7 relative; the
  port has no such knob and K3's order is its only flat scorer.
- The pruned lane's 8-term chunks reproduce the reference's XLA einsum on
  the CPU, a sequential fused multiply-add over the chunk's terms, by an
  exact f32 FMA (:func:`_fma_f32`), so it is bitwise equal there too.
- The hot partial is a plain f32 product at a fixed row count
  (hot_arm.hot_partial): its bits differ from the reference's XLA dot by
  a few 1e-7 relative, so hot-term queries hold ranks plus a tolerance.

The host builders are copied from the reference (its module imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import NamedTuple

import numpy as np
import torch

from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu_torch.lexical.bm25 import BM25_K1, idf, tf_norm_cache
from frankensearch_tpu_torch.lexical.memory_index import _BOOSTS, _FIELDS, MemoryLexicalIndex
from frankensearch_tpu_torch.lexical.tokenizer import simple_tokenize
from frankensearch_tpu_torch.ops.topk_scan import (
    NEG_INF,
    _pad_topk,
    float_order_key,
    topk_desc_rowasc,
)

#: postings count from which the dense lane gives way to the blocked layout
BLOCKED_THRESHOLD_POSTINGS = 1 << 21
#: posting slots per block in the graded layout
DEFAULT_BLOCK_POSTINGS = 1 << 18
#: the sparse query rows' term axis pads to a multiple of this, and the
#: pruned lane sums the terms in chunks of this width
T_PAD_GRANULE = 8
#: batch tile of the flat hot-arm lane: the dense score space is
#: (B, NP_pad) f32, so the batch runs in tiles of this many rows. The
#: hot partial always runs at exactly this many rows (bit purity,
#: hot_arm.hot_partial). The reference's TPU-sized value, kept for parity.
FLAT_B_TILE = 64


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad_rows_to(b_pad: int, *xs: np.ndarray) -> tuple:
    """Each (B, ...) host array padded to ``b_pad`` rows by repeating its
    first row (a padding query that changes no real query's bits)."""
    return tuple(np.concatenate([x, np.repeat(x[:1], b_pad - x.shape[0], axis=0)]) for x in xs)


# --------------------------------------------------------------------------
# dense lane
# --------------------------------------------------------------------------


class DocSteps(NamedTuple):
    """Doc-major plan of the postings for the deterministic per-doc sum.

    Docs are ranked by posting count, longest first; step j adds the j-th
    posting of every doc with more than j postings, and those docs are a
    prefix of the ranking. Postings with tf-side 0 (the upload padding) add
    exactly +0.0 and are left out."""

    posts: torch.Tensor  # (P',) int64 posting ids, step-major
    bounds: tuple[int, ...]  # step j = posts[bounds[j]:bounds[j+1]]
    doc_of_slot: torch.Tensor  # (n_docs,) int64: running-sum slot i -> doc row


def build_doc_steps(post_doc: np.ndarray, post_tf: np.ndarray, n_docs: int, device) -> DocSteps:
    live = np.flatnonzero(np.asarray(post_tf) != 0.0)
    docs = np.asarray(post_doc, dtype=np.int64)[live]
    order = live[np.argsort(docs, kind="stable")]  # doc asc, posting order kept
    counts = np.bincount(docs, minlength=n_docs)[:n_docs]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    doc_of_slot = np.argsort(-counts, kind="stable")
    neg_sorted = -counts[doc_of_slot]  # ascending
    pieces, bounds = [], [0]
    for j in range(int(counts.max()) if n_docs else 0):
        n_j = int(np.searchsorted(neg_sorted, -j, side="left"))  # docs with count > j
        pieces.append(order[starts[doc_of_slot[:n_j]] + j])
        bounds.append(bounds[-1] + n_j)
    posts = np.concatenate(pieces) if pieces else np.zeros(0, np.int64)
    return DocSteps(
        posts=torch.from_numpy(posts.astype(np.int64)).to(device),
        bounds=tuple(bounds),
        doc_of_slot=torch.from_numpy(doc_of_slot.astype(np.int64)).to(device),
    )


def _device_bm25(
    post_term: torch.Tensor,  # (P,) i32
    post_tf: torch.Tensor,  # (P,) f32
    steps: DocSteps,
    q_idf: torch.Tensor,  # (B, V) f32
    *,
    n_docs: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense BM25 top-k: ((B, k) f32 scores, (B, k) int64 doc rows)."""
    b = q_idf.shape[0]
    q_t = q_idf.T.contiguous()  # (V, B): one row gather per posting
    acc = torch.zeros((n_docs, b), dtype=torch.float32, device=q_idf.device)
    for j in range(len(steps.bounds) - 1):
        p = steps.posts[steps.bounds[j] : steps.bounds[j + 1]]
        acc[: p.shape[0]] += post_tf[p, None] * q_t[post_term[p].to(torch.int64)]
    scores = torch.empty_like(acc)
    scores[steps.doc_of_slot] = acc
    return topk_desc_rowasc(scores.T, min(k, n_docs))


# --------------------------------------------------------------------------
# shared pieces of the blocked lanes
# --------------------------------------------------------------------------


def _score_row_key(s: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One int64 key per (score, row) pair that sorts descending in the
    order of the reference's two-key ``lax.sort`` on (-score, row): score
    desc, then row asc. Rows lie in [-1, 2^30)."""
    return (float_order_key(s) << 32) | (0xFFFFFFFF - (rows.to(torch.int64) + 1))


def _topk_score_row(s: torch.Tensor, rows: torch.Tensor, k: int):
    """Top ``k`` of (B, M) (score, row) pairs in (score desc, row asc)
    order. Pairs that tie on both keys are equal, so which one
    ``torch.topk`` picks cannot change the output.
    Returns (f32 scores, i32 rows)."""
    pos = torch.topk(_score_row_key(s, rows), k, dim=1, largest=True, sorted=True).indices
    return torch.gather(s, 1, pos), torch.gather(rows, 1, pos).to(torch.int32)


def _merge_topk_exact(top_s, top_i, s2, i2, k: int):
    """(score desc, row asc) exact merge of two (B, *) candidate sets: any
    block processing order gives the same result."""
    return _topk_score_row(torch.cat([top_s, s2], dim=1), torch.cat([top_i, i2], dim=1), k)


class _GradedClass(NamedTuple):
    """One length class of the graded blocked layout (device tensors)."""

    term: torch.Tensor | None  # (n_blk_c, P_blk) i32, doc-major, per-doc L-padded
    tf: torch.Tensor | None  # (n_blk_c, P_blk) f32 tf-side scores (0 on padding)
    doc_map: torch.Tensor  # (n_blk_c, d_blk_c) i32 global doc rows asc; -1 pad
    #: transposed layout of the flat lane (split corpora store only this
    #: form): (n_blk_c, L, d_pad), term padding -1, tf padding 0
    term_t: torch.Tensor | None = None
    tf_t: torch.Tensor | None = None


# --------------------------------------------------------------------------
# pruned lane (unsplit layout)
# --------------------------------------------------------------------------


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a*b + c`` rounded once, as a fused multiply-add does.

    The f32 product is exact in f64, and the f64 sum is made to round to
    odd (TwoSum gives its error; an inexact sum with an even last bit steps
    one ulp toward the exact value); rounding that to f32 is then the
    correctly rounded f32 result (f64 carries 29 more bits than f32 needs)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _group_block_scores(tb: torch.Tensor, fb: torch.Tensor, q_ids: torch.Tensor, q_w: torch.Tensor):
    """(B, d) f32 scores of one doc-major block ``tb``/``fb`` (d, l).

    The reference's shipped step (SEQ_T_ACCUM): the term axis in chunks of
    T_PAD_GRANULE, each chunk's (B, 8, d) per-term masses contracted with
    the weights by XLA's einsum, which on the CPU is a sequential fused
    multiply-add over the chunk's terms from 0; the chunks add in order. A
    doc holds at most one posting per term id (ids are field-namespaced),
    so each mass is one posting's tf-side value or 0 in any order."""
    b = q_ids.shape[0]
    scores = torch.zeros((b, tb.shape[0]), dtype=torch.float32, device=tb.device)
    for j0 in range(0, q_ids.shape[1], T_PAD_GRANULE):
        chunk = torch.zeros_like(scores)
        for j in range(j0, min(j0 + T_PAD_GRANULE, q_ids.shape[1])):
            hit = tb[None] == q_ids[:, j, None, None]  # (B, d, l)
            mass = (fb[None] * hit.to(torch.float32)).sum(dim=2)  # (B, d)
            chunk = _fma_f32(q_w[:, j, None], mass, chunk)
        scores = scores + chunk
    return scores


def _graded_scan_pruned(classes, bounds_list, q_ids, q_w, *, k: int):
    """The pruned scan over the doc-major graded classes: the reference's
    ``_graded_scan_body_grouped`` at its shipped MERGE_GROUP = 1,
    SEQ_T_ACCUM = True. Returns ((B, k) f32 scores, (B, k) i32 global
    rows, blocks skipped).

    Within a class the blocks run in descending order of their largest
    per-query bound (stable); a block is skipped when every query's bound,
    with a 1e-6 slack for f32 summation order, is below its running k-th
    score, or every bound is 0. The skip test is exact, and it is read on
    the host once per block. Every merge is the exact two-key sort, so the
    result does not depend on the order."""
    b = q_ids.shape[0]
    dev = q_ids.device
    top_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    skipped = 0
    slack_mul = torch.tensor(1.0 + 1e-6, dtype=torch.float32, device=dev)
    slack_add = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    for cls, bnd in zip(classes, bounds_list):
        n_c, p_blk = cls.term.shape
        d_c = cls.doc_map.shape[1]
        l_c = p_blk // d_c
        kk = min(k, d_c)
        perm = torch.argsort(-bnd.amax(dim=1), stable=True)
        for p in perm.tolist():
            bound = bnd[p]  # (B,)
            safe_bound = bound * slack_mul + slack_add
            skip = (safe_bound < top_s[:, -1]).all() | (bound <= 0.0).all()
            if bool(skip):
                skipped += 1
                continue
            scores = _group_block_scores(
                cls.term[p].reshape(d_c, l_c), cls.tf[p].reshape(d_c, l_c), q_ids, q_w
            )
            s2, loc = topk_desc_rowasc(scores, kk)  # local index asc == row asc
            rows = cls.doc_map[p][loc]
            top_s, top_i = _merge_topk_exact(top_s, top_i, s2, rows, k)
    return top_s, top_i, skipped


# --------------------------------------------------------------------------
# K3: one class of the flat lane (split layout)
# --------------------------------------------------------------------------


def flat_class_scores_plain(term_t, tf_t, q_ids, q_w) -> torch.Tensor:
    """The scoring half of K3's plain twin: (n_c, B, d_pad) f32 tail scores
    of one class,

        out[p, b, d] = Σ_l Σ_j q_w[b, j] · tf_t[p, l, d] · [term_t[p, l, d] == q_ids[b, j]]

    summed from +0.0 in (l outer, j inner) order, one rounded product and
    one rounded add per step: the order of the reference's Pallas kernel."""
    n_c, l_c, d_pad = term_t.shape
    b, t_q = q_ids.shape
    acc = torch.zeros((n_c, b, d_pad), dtype=torch.float32, device=term_t.device)
    for l in range(l_c):
        tl = term_t[:, l, None, :]  # (n_c, 1, d_pad)
        fl = tf_t[:, l, None, :]
        for j in range(t_q):
            hit = tl == q_ids[None, :, j, None]  # (n_c, B, d_pad)
            acc = acc + torch.where(hit, q_w[None, :, j, None] * fl, 0.0)
    return acc


def _flat_step_stats(scores: torch.Tensor, dm: torch.Tensor):
    """Per-128-group (max, row of the first max) of (n_c, B, d_pad) masked
    scores with their (n_c, d_pad) global-row map. The first max is the
    lowest row: slots ascend by row within a block."""
    n_c, b, d_pad = scores.shape
    gc = d_pad // 128
    sg = scores.reshape(n_c, b, gc, 128)
    gmax = sg.amax(dim=3)
    lane = torch.arange(128, dtype=torch.int32, device=scores.device)
    am = torch.where(sg == gmax[..., None], lane, 128).amin(dim=3)  # first max
    dmg = dm.reshape(n_c, 1, gc, 128).expand(n_c, b, gc, 128)
    grow = torch.gather(dmg, 3, am[..., None].to(torch.int64)).squeeze(3)
    return gmax, grow


def _flat_class_poststats(sc0, s_phys, off: int, dmap_blocks):
    """The shared tail of the flat lane for one class: add the hot
    partial's slice of each block (slot ``off + p*d_pad + d``, the
    reference's element pairing), mask padding slots to -inf, reduce to
    group stats. Returns (masked (n_c, B, d_pad), gmax, grow (n_c, B, gc))."""
    n_c, b, d_pad = sc0.shape
    scores = sc0
    if s_phys is not None:
        hot = s_phys[:, off : off + n_c * d_pad].reshape(b, n_c, d_pad).transpose(0, 1)
        scores = scores + hot
    scores = torch.where(dmap_blocks[:, None, :] >= 0, scores, NEG_INF)
    gmax, grow = _flat_step_stats(scores, dmap_blocks)
    return scores, gmax, grow


def flat_class_fused_plain(term_t, tf_t, q_ids, q_w, s_phys, off: int, dmap_blocks):
    """Plain twin of K3: :func:`flat_class_scores_plain`, then
    :func:`_flat_class_poststats` (the reference's Pallas kernel and its
    post-pass). Returns (masked (n_c, B, d_pad) f32, gmax (n_c, B, gc)
    f32, grow (n_c, B, gc) i32)."""
    return _flat_class_poststats(flat_class_scores_plain(term_t, tf_t, q_ids, q_w), s_phys, off, dmap_blocks)


def flat_class_fused(term_t, tf_t, q_ids, q_w, s_phys, off: int, dmap_blocks):
    """K3 (replaces ``_flat_score_kernel`` and its post-pass
    ``_flat_hot_mask_stats``): one class of the flat lane in one pass: the
    tail scores, the hot partial's slice ``s_phys[:, off : off + n_c*d_pad]``
    added (``s_phys`` may be None), padding slots (``dmap_blocks < 0``)
    masked to -inf, and each 128-slot group reduced to (max, row of its
    first max). CUDA tensors run csrc/flat_score.cu (any B and L, T <=
    4095); CPU tensors the plain twin. Both take the same rounded steps in
    the same order, so they agree bit for bit. Returns (masked (n_c, B,
    d_pad) f32, gmax (n_c, B, gc) f32, grow (n_c, B, gc) i32)."""
    if term_t.device.type == "cpu":
        return flat_class_fused_plain(term_t, tf_t, q_ids, q_w, s_phys, off, dmap_blocks)
    n_c, l_c, d_pad = term_t.shape
    b, t_q = q_ids.shape
    if (
        term_t.dtype != torch.int32 or tf_t.dtype != torch.float32 or dmap_blocks.dtype != torch.int32
        or q_ids.dtype != torch.int32 or q_w.dtype != torch.float32
        or (s_phys is not None and s_phys.dtype != torch.float32)
    ):
        raise ValueError("flat_class_fused takes i32 terms/ids/rows and f32 tf/weights/hot partial")
    if tf_t.shape != term_t.shape or q_w.shape != q_ids.shape or dmap_blocks.shape != (n_c, d_pad):
        raise ValueError(f"shape mismatch: {tuple(term_t.shape)}/{tuple(tf_t.shape)}/{tuple(dmap_blocks.shape)}, "
                         f"{tuple(q_ids.shape)}/{tuple(q_w.shape)}")
    if s_phys is not None and (s_phys.dim() != 2 or s_phys.shape[0] != b or off + n_c * d_pad > s_phys.shape[1]):
        raise ValueError(f"hot partial {tuple(s_phys.shape)} does not hold {b} rows of slots "
                         f"{off}..{off + n_c * d_pad}")
    operands = (term_t, tf_t, q_ids, q_w, dmap_blocks) + (() if s_phys is None else (s_phys,))
    if len({t.device for t in operands}) != 1:
        raise ValueError("flat_class_fused operands must share one device")
    if d_pad % 128 or (t_q | 1) > 4096:
        raise ValueError(f"flat_class_fused needs d_pad % 128 == 0 and T <= 4095, got {d_pad}, {t_q}")
    dev = term_t.device
    out = torch.empty((n_c, b, d_pad), dtype=torch.float32, device=dev)
    gmax = torch.empty((n_c, b, d_pad // 128), dtype=torch.float32, device=dev)
    grow = torch.empty((n_c, b, d_pad // 128), dtype=torch.int32, device=dev)
    if n_c == 0 or b == 0:
        return out, gmax, grow
    term_t, tf_t, dmap_blocks = term_t.contiguous(), tf_t.contiguous(), dmap_blocks.contiguous()
    q_ids, q_w = q_ids.contiguous(), q_w.contiguous()
    hot = None if s_phys is None else s_phys.contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.fs_flat_fused(
            q_ids.data_ptr(), q_w.data_ptr(), term_t.data_ptr(), tf_t.data_ptr(),
            None if hot is None else hot.data_ptr(), 0 if hot is None else hot.shape[1], off,
            dmap_blocks.data_ptr(), out.data_ptr(), gmax.data_ptr(), grow.data_ptr(),
            n_c, l_c, d_pad, b, t_q, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flat_fused kernel launch failed: CUDA error {rc}")
    flat_class_fused.launches += 1
    return out, gmax, grow


flat_class_fused.launches = 0


# --------------------------------------------------------------------------
# flat lane (split layout)
# --------------------------------------------------------------------------


def _graded_scan_flat(classes, q_ids, q_w, s_phys, dmap_groups, *, k: int):
    """Flat exhaustive scan over the graded classes of the split layout.
    Returns ((B, k) f32 scores, (B, k) i32 global rows, skipped = 0).

    Each class is one K3 pass: its tail scores, the hot partial added in
    the same group-aligned slot space, padding slots masked to -inf, and
    each 128-slot group reduced to (max, row of its first max). The top-k
    groups per query by (max desc, row asc) cover the exact top-k: an
    element of a group left out is dominated by k others, by score or, at
    equal score, by row. Their slots are gathered from the class scores
    and one exact (score desc, row asc) sort finishes."""
    b = q_ids.shape[0]
    scores_cls: list = []
    meta: list = []
    gmax_parts: list = []
    grow_parts: list = []
    off = 0
    goff = 0
    for cls in classes:
        n_c, d_pad = cls.term_t.shape[0], cls.term_t.shape[2]
        gc = d_pad // 128
        dmap_blocks = dmap_groups[goff : goff + n_c * gc].reshape(n_c, d_pad)
        sc, gmax, grow = flat_class_fused(cls.term_t, cls.tf_t, q_ids, q_w, s_phys, off, dmap_blocks)
        scores_cls.append(sc)
        meta.append((goff, gc, n_c))
        gmax_parts.append(gmax.transpose(0, 1).reshape(b, n_c * gc))
        grow_parts.append(grow.transpose(0, 1).reshape(b, n_c * gc))
        off += n_c * d_pad
        goff += n_c * gc

    gmax_all = torch.cat(gmax_parts, dim=1)  # (B, TG)
    grow_all = torch.cat(grow_parts, dim=1)
    tg = dmap_groups.shape[0]
    kg = min(k, tg)
    # group key (max desc, row of first max asc): groups that tie on both
    # are all padding, (-inf, -1), and hold the same slots' values
    key = _score_row_key(gmax_all, grow_all)
    gid = torch.topk(key, kg, dim=1, largest=True, sorted=True).indices  # (B, kg)

    cand_r = dmap_groups[gid.reshape(-1)].reshape(b, kg * 128)
    brow = torch.arange(b, dtype=torch.int64, device=q_ids.device)[:, None].expand(b, kg)
    cand_s = torch.zeros((b, kg, 128), dtype=torch.float32, device=q_ids.device)
    for sc, (goff_c, gc, n_c) in zip(scores_cls, meta):
        local = gid - goff_c
        in_cls = (local >= 0) & (local < n_c * gc)
        loc = torch.where(in_cls, local, 0)
        p = loc // gc
        g = loc - p * gc
        idx = (p * b + brow) * gc + g  # row of (n_c*B*gc, 128)
        got = sc.reshape(n_c * b * gc, 128)[idx.reshape(-1)].reshape(b, kg, 128)
        cand_s = torch.where(in_cls[..., None], got, cand_s)
    cand_s = cand_s.reshape(b, kg * 128)

    kk = min(k, kg * 128)
    top_s, top_i = _topk_score_row(cand_s, cand_r, kk)
    fin = torch.isfinite(top_s)
    top_i = torch.where(fin, top_i, -1)
    top_s, top_i = _pad_topk(top_s, top_i, k)
    return top_s, top_i, 0


def _blocked_hot_body_tile(
    classes, q_ids, q_w, cols_phys, q_hot, cold_cols, cold_rows, dmap_groups, *, k: int,
):
    from frankensearch_tpu_torch.lexical.hot_arm import cold_doc_topk, hot_partial

    s_phys = hot_partial(cols_phys, q_hot)  # (tile, NP_pad), slot order
    top_s, top_i, skipped = _graded_scan_flat(classes, q_ids, q_w, s_phys, dmap_groups, k=k)
    ds, di = cold_doc_topk(cold_cols, cold_rows, q_hot, k=k)
    top_s, top_i = _merge_topk_exact(top_s, top_i, ds, di, k)
    return top_s, top_i, skipped


def _blocked_hot_body(
    classes, q_ids, q_w, cols_phys, q_hot, cold_cols, cold_rows, dmap_groups, *, k: int,
):
    """Hot-arm exhaustive body: the dense head product in the blocked
    layout's physical slot order, the flat tail scan with the hot partial
    added in the same slot space, and the zero-tail-posting docs' small
    dense top-k merged exactly; batch-tiled at FLAT_B_TILE rows (a ragged
    batch pads by repeating row 0). Every per-query value depends only on
    its own row, so tiling changes no bit."""
    b = q_ids.shape[0]
    tile = FLAT_B_TILE
    if b <= tile:
        return _blocked_hot_body_tile(
            classes, q_ids, q_w, cols_phys, q_hot, cold_cols, cold_rows, dmap_groups, k=k
        )
    pad = (-b) % tile
    if pad:
        q_ids = torch.cat([q_ids, q_ids[:1].expand(pad, -1)])
        q_w = torch.cat([q_w, q_w[:1].expand(pad, -1)])
        q_hot = torch.cat([q_hot, q_hot[:1].expand(pad, -1)])
    s_parts, i_parts = [], []
    for t0 in range(0, b + pad, tile):
        s, i, _ = _blocked_hot_body_tile(
            classes, q_ids[t0 : t0 + tile], q_w[t0 : t0 + tile], cols_phys,
            q_hot[t0 : t0 + tile], cold_cols, cold_rows, dmap_groups, k=k,
        )
        s_parts.append(s)
        i_parts.append(i)
    return torch.cat(s_parts)[:b], torch.cat(i_parts)[:b], 0


# --------------------------------------------------------------------------
# layout build
# --------------------------------------------------------------------------


@dataclass
class _BlockedPostings:
    """Length-graded blocked device postings.

    Blocks are grouped into length classes (uniform per-doc padded L per
    class); global block ids are class-major in ``classes`` order, and
    the block-max CSR and ``query_bounds`` address that id space."""

    classes: tuple  # tuple[_GradedClass]
    class_offsets: tuple  # tuple[int], len == len(classes)
    n_blk: int = 0
    #: global doc row of every class-major block slot (host; -1 on
    #: in-block padding): the hot arm's column order
    phys_doc: np.ndarray | None = None  # (Σ_c n_c*d_c,) i64
    #: per-term block-max CSR (host): term t's blocks are
    #: bm_blk[bm_ptr[t]:bm_ptr[t+1]] with max tf-side scores bm_max[...]
    bm_ptr: np.ndarray | None = None  # (V+1,) i64
    bm_blk: np.ndarray | None = None  # (nnz,) i32
    bm_max: np.ndarray | None = None  # (nnz,) f32

    def split_bounds(self, bounds: np.ndarray, device) -> tuple:
        """Host (n_blk, B) bounds -> the per-class device tensors the
        pruned lane consumes (a contiguous slice per class)."""
        out = []
        for c, cls in enumerate(self.classes):
            start = self.class_offsets[c]
            n_c = cls.doc_map.shape[0]
            out.append(torch.from_numpy(np.ascontiguousarray(bounds[start : start + n_c])).to(device))
        return tuple(out)

    def query_bounds(self, ids: np.ndarray, w: np.ndarray) -> np.ndarray:
        """(n_blk, B) per-block per-query score upper bounds
        Σ_t w[b,t] * blockmax(block, t), by the native pass where it
        loads and by one vectorized numpy scatter-add otherwise."""
        b = ids.shape[0]
        if self.bm_ptr is None:
            return np.full((self.n_blk, b), np.float32(np.inf))
        flat_ids = ids.reshape(-1).astype(np.int64)
        flat_w = w.reshape(-1).astype(np.float32)
        flat_q = np.repeat(np.arange(b, dtype=np.int64), ids.shape[1])
        active = flat_w > 0.0
        flat_ids, flat_w, flat_q = flat_ids[active], flat_w[active], flat_q[active]
        from frankensearch_tpu_torch import native as _native

        via_native = _native.bm25_bounds_native(
            flat_ids, flat_w, flat_q, self.bm_ptr, self.bm_blk, self.bm_max, self.n_blk, b,
        )
        if via_native is not None:
            return via_native
        lo = self.bm_ptr[flat_ids]
        hi = self.bm_ptr[flat_ids + 1]
        seg_len = (hi - lo).astype(np.int64)
        total = int(seg_len.sum())
        bound = np.zeros(self.n_blk * b, dtype=np.float32)
        if total:
            j_of = np.repeat(np.arange(len(seg_len)), seg_len)
            seg_start = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
            offset = np.arange(total, dtype=np.int64) - seg_start[j_of]
            pos = lo[j_of] + offset
            contrib = flat_w[j_of] * self.bm_max[pos]
            key = self.bm_blk[pos].astype(np.int64) * b + flat_q[j_of]
            bound = np.bincount(
                key, weights=contrib.astype(np.float64), minlength=self.n_blk * b
            ).astype(np.float32)
        return bound.reshape(self.n_blk, b)


def _build_blocked(
    terms_all: np.ndarray,
    docs_all: np.ndarray,
    tf_all: np.ndarray,
    *,
    n_docs: int,
    vocab_size: int,
    device,
    transpose_for_flat: bool = False,
    block_postings: int | None = None,
) -> _BlockedPostings:
    """Length-graded block build (host-side, vectorized per block).

    Docs are ordered by posting count descending and packed into blocks of
    ``p_blk`` posting slots where every doc is padded to the block's
    uniform L (its longest doc's count rounded up to the granule). A block
    closes early when the next doc's count falls under L/2. Docs with no
    postings are left out (they never score > 0). Blocks sharing L form a
    class; classes run longest-L first. ``transpose_for_flat`` stores the
    (n_c, L, d_pad) form of the flat lane, with granule 4 and class widths
    sized by the blocks' actual occupancy. ``block_postings`` (default
    ``DEFAULT_BLOCK_POSTINGS``) is the smallest block width in slots."""
    gran = 4 if transpose_for_flat else 8
    order = np.argsort(docs_all, kind="stable")
    terms = np.ascontiguousarray(terms_all[order]).astype(np.int32)
    docs = np.ascontiguousarray(docs_all[order]).astype(np.int64)
    tfs = np.ascontiguousarray(tf_all[order]).astype(np.float32)

    counts = np.bincount(docs, minlength=max(n_docs, 1)).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(counts)])  # (n_docs+1,)
    max_count = int(counts.max()) if n_docs else 0
    if block_postings is None:
        block_postings = DEFAULT_BLOCK_POSTINGS  # read at call time, so tests can lower it
    p_blk = int(max(block_postings, _round_up(max(max_count, 1), gran)))

    # grade: count desc, doc id asc among equals; drop empty docs
    doc_order = np.lexsort((np.arange(len(counts)), -counts))
    doc_order = doc_order[counts[doc_order] > 0]

    blocks: list[tuple[np.ndarray, int]] = []
    i = 0
    while i < len(doc_order):
        c0 = int(counts[doc_order[i]])
        l_blk = max(_round_up(c0, gran), gran)
        d_cap = max(p_blk // l_blk, 1)
        j = min(i + d_cap, len(doc_order))
        if l_blk > gran:
            # close early once occupancy would halve: the next block regrades
            seg = counts[doc_order[i:j]]
            brk = np.flatnonzero(seg * 2 < l_blk)
            if len(brk) and brk[0] > 0:
                j = i + int(brk[0])
        blocks.append((np.sort(doc_order[i:j]), l_blk))  # rows asc in-block
        i = j
    if not blocks:
        blocks = [(np.zeros(0, np.int64), gran)]

    from collections import defaultdict

    by_l: dict[int, list[np.ndarray]] = defaultdict(list)
    for block_docs, l_blk in blocks:
        by_l[l_blk].append(block_docs)
    class_ls = sorted(by_l.keys(), reverse=True)

    def dev(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device)

    post_blk = np.zeros(len(terms), dtype=np.int64)  # posting -> global blk
    classes: list[_GradedClass] = []
    class_offsets: list[int] = []
    phys_parts: list[np.ndarray] = []
    gid = 0
    for l_blk in class_ls:
        blks = by_l[l_blk]
        d_cap = max(p_blk // l_blk, 1)
        n_c = len(blks)
        if transpose_for_flat:
            d_width = max(max(len(bd) for bd in blks), 1)
            d_pad = max(_round_up(d_width, 128), 128)
            bt_t = np.full((n_c, l_blk, d_pad), -1, dtype=np.int32)
            bf_t = np.zeros((n_c, l_blk, d_pad), dtype=np.float32)
            dm = np.full((n_c, d_pad), -1, dtype=np.int32)
        else:
            # exactly (d_cap * l_blk) wide: the block reshapes to (d_cap, l_blk)
            bt = np.zeros((n_c, d_cap * l_blk), dtype=np.int32)
            bf = np.zeros((n_c, d_cap * l_blk), dtype=np.float32)
            dm = np.full((n_c, d_cap), -1, dtype=np.int32)
        class_offsets.append(gid)
        for r, block_docs in enumerate(blks):
            nd = len(block_docs)
            dm[r, :nd] = block_docs
            lens = counts[block_docs]
            starts = csum[block_docs]
            total = int(lens.sum())
            if total:
                j_of = np.repeat(np.arange(nd), lens)
                seg_start = np.concatenate([[0], np.cumsum(lens)[:-1]])
                off = np.arange(total, dtype=np.int64) - seg_start[j_of]
                src = starts[j_of] + off
                if transpose_for_flat:
                    bt_t[r, off, j_of] = terms[src]
                    bf_t[r, off, j_of] = tfs[src]
                else:
                    dst = j_of * l_blk + off
                    bt[r, dst] = terms[src]
                    bf[r, dst] = tfs[src]
                post_blk[src] = gid + r
        if transpose_for_flat:
            classes.append(_GradedClass(
                term=None, tf=None, doc_map=dev(dm), term_t=dev(bt_t), tf_t=dev(bf_t),
            ))
        else:
            classes.append(_GradedClass(term=dev(bt), tf=dev(bf), doc_map=dev(dm)))
        phys_parts.append(dm.reshape(-1).astype(np.int64))
        gid += n_c
    n_blk = gid
    phys_doc = np.concatenate(phys_parts) if phys_parts else np.zeros(0, np.int64)

    # per-(term, global block) max tf-side: the block-max pruning metadata
    key = terms.astype(np.int64) * n_blk + post_blk
    order_k = np.argsort(key, kind="stable")
    key_s = key[order_k]
    tf_s = tfs[order_k]
    if len(key_s):
        group_start = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        starts_idx = np.flatnonzero(group_start)
        grp_max = np.maximum.reduceat(tf_s, starts_idx).astype(np.float32)
        grp_key = key_s[starts_idx]
        grp_term = (grp_key // n_blk).astype(np.int64)
        grp_blk = (grp_key % n_blk).astype(np.int32)
    else:
        grp_max = np.zeros(0, np.float32)
        grp_term = np.zeros(0, np.int64)
        grp_blk = np.zeros(0, np.int32)
    bm_ptr = np.zeros(vocab_size + 1, dtype=np.int64)
    np.add.at(bm_ptr, grp_term + 1, 1)
    bm_ptr = np.cumsum(bm_ptr)

    return _BlockedPostings(
        classes=tuple(classes),
        class_offsets=tuple(class_offsets),
        n_blk=n_blk,
        phys_doc=phys_doc,
        bm_ptr=bm_ptr,
        bm_blk=grp_blk,
        bm_max=grp_max,
    )


def _upload_postings(index, terms_all, docs_all, tf_all, raw=None, *, device) -> None:
    """Finalize postings onto the device: the dense lane's flat arrays and
    doc-major plan below BLOCKED_THRESHOLD_POSTINGS, the blocked layout
    (split by the hot arm where it applies) at or above it.

    ``raw`` = (tf_raw, fidx, cache_flat, bk): per-posting integer tf and
    field·256 + fieldnorm id, with the per-field norm caches and boost
    products; the packed DAAT layout needs them."""
    p = len(terms_all)
    index.posting_count = p
    index.device = torch.empty(0, device=device).device  # "cuda" -> "cuda:N"
    index._daat = False  # the term-major CSR builds lazily from these postings
    index._hot = None
    index._post_host = (
        terms_all.astype(np.int32),
        docs_all.astype(np.int32),
        tf_all.astype(np.float32),
    )
    index._raw_host = raw  # the FLXB writer's raw sections
    index._cold_host = index._post_host
    index._cold_raw = raw
    index.cold_posting_count = p
    if p >= BLOCKED_THRESHOLD_POSTINGS:
        from frankensearch_tpu_torch.lexical import hot_arm as _hot_arm

        split = _hot_arm.split_postings(
            terms_all, docs_all, tf_all, n_docs=index.n_docs, vocab_size=index.vocab_size,
        )
        t_cold, d_cold, f_cold = terms_all, docs_all, tf_all
        if split is not None:
            cold_sel = split.hot_row_of[terms_all.astype(np.int64)] < 0
            t_cold = terms_all[cold_sel]
            d_cold = docs_all[cold_sel]
            f_cold = tf_all[cold_sel]
            index._cold_host = (
                t_cold.astype(np.int32), d_cold.astype(np.int32), f_cold.astype(np.float32),
            )
            if raw is not None:
                index._cold_raw = (raw[0][cold_sel], raw[1][cold_sel], raw[2], raw[3])
            index.cold_posting_count = len(t_cold)
        index._blocked = _build_blocked(
            t_cold, d_cold, f_cold, n_docs=index.n_docs, vocab_size=index.vocab_size,
            device=device, transpose_for_flat=split is not None,
        )
        if split is not None:
            index._hot = _hot_arm.finalize_hot_arm(split, index._blocked, index.n_docs, device)
        index._post_term = index._post_tf = index._doc_steps = None
        return
    index._blocked = None
    p_pad = max(_round_up(max(p, 1), 128), 128)
    pt = np.zeros(p_pad, dtype=np.int32)
    pd = np.zeros(p_pad, dtype=np.int32)
    pf = np.zeros(p_pad, dtype=np.float32)  # padded postings score 0
    pt[:p] = terms_all
    pd[:p] = docs_all
    pf[:p] = tf_all
    index._post_term = torch.from_numpy(pt).to(device)
    index._post_tf = torch.from_numpy(pf).to(device)
    index._doc_steps = build_doc_steps(pd, pf, index.n_docs, device)


# --------------------------------------------------------------------------
# the index
# --------------------------------------------------------------------------


class FusedLexPlan(NamedTuple):
    """A lexical arm's half of the fused phase-1 pass for a padded batch."""

    lane: str  # the batch's lane: dense, blocked, daat, mixed or sharded
    lanes: list  # each query's lane: dense, flat, pruned or daat
    args: tuple  # the lane body's lexical arguments, after the vector arm's
    kwargs: dict  # its lexical keyword arguments


@dataclass
class _FieldArm:
    term_ids: dict[str, int]
    idf_host: np.ndarray  # (V_field,) f32, indexed by (tid - base)
    boost: np.float32
    base: int = 0
    #: docs-with-term per field (the idf numerator input): segmented reads
    #: (lexical/segments.py) sum these across segments to weight every
    #: segment with the global corpus's idf; None on FLXB-loaded arms
    df_host: np.ndarray | None = None


class DeviceBm25Index(LexicalRead):
    """Immutable device-side snapshot of a committed lexical index."""

    #: "auto" picks term-driven (DAAT) vs exhaustive per query
    #: (daat.daat_eligible); "daat"/"blocked" force a lane. DAAT exists
    #: only where the blocked layout does.
    daat_mode = "auto"

    def __init__(self, mem: MemoryLexicalIndex, *, device: torch.device) -> None:
        postings, field_stats, docs = mem.snapshot_postings()
        self._source = mem
        doc_ids = sorted(docs.keys())
        row_of = {d: i for i, d in enumerate(doc_ids)}
        n = len(doc_ids)

        arms: dict[str, _FieldArm] = {}
        terms_parts, docs_parts, tf_parts, raw_tf_parts, raw_fx_parts = [], [], [], [], []
        cache_flat = np.zeros(len(_FIELDS) * 256, dtype=np.float32)
        bk_arr = np.zeros(len(_FIELDS), dtype=np.float32)
        vocab_offset = 0
        for ford, fname in enumerate(_FIELDS):
            stats = field_stats[fname]
            field_postings = postings[fname]
            vocab = sorted(field_postings.keys())
            term_ids = {t: vocab_offset + i for i, t in enumerate(vocab)}
            cache = tf_norm_cache(stats.avgdl)
            boost = _BOOSTS[fname]
            cache_flat[ford * 256 : (ford + 1) * 256] = cache
            bk_arr[ford] = np.float32(boost) * (BM25_K1 + np.float32(1.0))
            plists = [field_postings[term] for term in vocab]
            df_host = np.fromiter(map(len, plists), dtype=np.int64, count=len(vocab))
            idf_host = np.array([idf(n, int(df)) for df in df_host], dtype=np.float32)
            # the postings term by term, each term's in its insertion order
            p = int(df_host.sum())
            rows = np.fromiter(map(row_of.__getitem__, chain.from_iterable(plists)), dtype=np.int64, count=p)
            tf = np.fromiter(chain.from_iterable(pl.values() for pl in plists), dtype=np.int64, count=p)
            fid_of_row = np.fromiter((docs[d].fieldnorm_id.get(fname, 0) for d in doc_ids), dtype=np.int64,
                                     count=n)
            fid = fid_of_row[rows]
            tf32 = tf.astype(np.float32)
            # f32 throughout, in the order boost * (k1 + 1) * tf / (tf + norm)
            tf_parts.append(np.float32(boost) * (BM25_K1 + np.float32(1.0)) * tf32 / (tf32 + cache[fid]))
            terms_parts.append(np.repeat(np.arange(vocab_offset, vocab_offset + len(vocab), dtype=np.int64),
                                         df_host))
            docs_parts.append(rows)
            raw_tf_parts.append(tf)
            raw_fx_parts.append(ford * 256 + fid)
            arms[fname] = _FieldArm(
                term_ids=term_ids, idf_host=idf_host, boost=boost, base=vocab_offset,
                df_host=df_host,
            )
            vocab_offset += len(vocab)
        self._init_state(
            doc_ids, arms, vocab_offset,
            np.concatenate(terms_parts),
            np.concatenate(docs_parts),
            np.concatenate(tf_parts).astype(np.float32),
            raw=(
                np.concatenate(raw_tf_parts),
                np.concatenate(raw_fx_parts).astype(np.uint16),
                cache_flat,
                bk_arr,
            ),
            device=device,
        )

    def _init_state(
        self, doc_ids, arms, vocab_size, terms_all, docs_all, tf_all, *, raw=None, device
    ) -> None:
        """Doc table + query arms, then the postings upload."""
        self.doc_ids = list(doc_ids)
        self._row_of = {d: i for i, d in enumerate(self.doc_ids)}
        self.n_docs = len(self.doc_ids)
        self._arms = arms
        self.vocab_size = int(vocab_size)
        self.last_lane: str | None = None
        self.last_hot_queries = 0
        self.last_blocks_skipped = 0
        _upload_postings(self, terms_all, docs_all, tf_all, raw=raw, device=device)

    # -- LexicalRead -------------------------------------------------------

    def doc_count(self) -> int:
        return self.n_docs

    def _query_terms(self, query: str) -> list[tuple[int, float]]:
        """Resolve a query's (term id, idf weight) pairs across all field
        arms (dedup per field)."""
        terms = simple_tokenize(query)
        out: list[tuple[int, float]] = []
        for arm in self._arms.values():
            seen: set[str] = set()
            for t in terms:
                if t in seen:
                    continue
                seen.add(t)
                tid = arm.term_ids.get(t)
                if tid is not None:
                    out.append((tid, float(arm.idf_host[tid - arm.base])))
        return out

    def _query_idf_rows(self, queries: list[str]) -> np.ndarray:
        v_pad = max(_round_up(max(self.vocab_size, 1), 128), 128)
        q = np.zeros((len(queries), v_pad), dtype=np.float32)
        for b, query in enumerate(queries):
            for tid, w in self._query_terms(query):
                q[b, tid] = w
        return q

    def _query_sparse_rows(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(B, T) term ids + weights, T rounded up to T_PAD_GRANULE. Padding
        is (id 0, weight 0.0)."""
        per_q = [self._query_terms(q) for q in queries]
        t_max = max(max((len(p) for p in per_q), default=1), 1)
        t_pad = max(_round_up(t_max, T_PAD_GRANULE), T_PAD_GRANULE)
        ids = np.zeros((len(queries), t_pad), dtype=np.int32)
        w = np.zeros((len(queries), t_pad), dtype=np.float32)
        for b, pairs in enumerate(per_q):
            for j, (tid, weight) in enumerate(pairs):
                ids[b, j] = tid
                w[b, j] = weight
        return ids, w

    def _term_major(self):
        """Lazy term-major layout for the DAAT lane, built once from the
        host tail postings (hot terms' spans are empty by construction);
        packed when the raw arrays allow it, None when unavailable."""
        if self._daat is False:
            from frankensearch_tpu_torch.lexical import daat as _daat

            self._daat = _daat.build_term_major(
                *self._cold_host, vocab_size=self.vocab_size, device=self.device,
                raw=self._cold_raw,
            )
        return self._daat

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _search_daat_chunks(self, ids: np.ndarray, w: np.ndarray, k: int) -> list:
        """Device results of the term-driven lane for pure-tail queries, in
        chunks of DAAT_CHUNK_QUERIES (each padded to a multiple of 8 by
        repeating its first query). Returns ((b_real, k) s, i) pairs."""
        from frankensearch_tpu_torch.lexical import daat as _daat

        tm = self._term_major()
        out = []
        for c0 in range(0, ids.shape[0], _daat.DAAT_CHUNK_QUERIES):
            cids = ids[c0 : c0 + _daat.DAAT_CHUNK_QUERIES]
            cw = w[c0 : c0 + _daat.DAAT_CHUNK_QUERIES]
            b_real = cids.shape[0]
            cids, cw = _pad_rows_to(max(_round_up(b_real, 8), 8), cids, cw)
            plan = _daat.build_gather_plan(tm.ptr, cids, cw)
            top_s, top_i = _daat.daat_topk_tm(
                tm.device_arrays(), *(self._dev(x) for x in plan),
                k=k, t_run=cids.shape[1], packed=tm.packed,
            )
            out.append((top_s[:b_real], top_i[:b_real]))
        return out

    def _search_blocked(
        self, ids: np.ndarray, w: np.ndarray, k: int, q_hot: np.ndarray | None = None
    ):
        """One exhaustive call; returns the (s, i) device pair. The split
        layout always takes the flat hot lane (a corpus constant, so a
        query's bits never depend on its sub-batch); the unsplit layout
        takes the pruned lane with its host block bounds. B pads to a
        multiple of 8 by repeating query 0. ``q_hot`` is the (B, H_pad)
        hot rows, given exactly when the layout is split."""
        b_real = ids.shape[0]
        b_pad = max(_round_up(b_real, 8), 8)
        ids, w = _pad_rows_to(b_pad, ids, w)
        hot = self._hot
        if hot is None:
            bounds = self._blocked.query_bounds(ids, w)
            top_s, top_i, skipped = _graded_scan_pruned(
                self._blocked.classes, self._blocked.split_bounds(bounds, self.device),
                self._dev(ids), self._dev(w), k=k,
            )
        else:
            (q_hot,) = _pad_rows_to(b_pad, q_hot)
            top_s, top_i, skipped = _blocked_hot_body(
                self._blocked.classes, self._dev(ids), self._dev(w),
                hot.cols_phys, self._dev(q_hot), hot.cold_cols, hot.cold_rows,
                hot.dmap_groups, k=k,
            )
        self.last_blocks_skipped = int(skipped)
        return top_s[:b_real], top_i[:b_real]

    def search_candidates_batch(
        self, queries: list[str], budget: int
    ) -> list[list[LexicalCandidate]]:
        if self.n_docs == 0 or not queries:
            return [[] for _ in queries]
        k = min(budget, self.n_docs)
        ids, w = self._query_sparse_rows(queries)
        s, i = self._dispatch_rows(ids, w, k)
        return self.rows_to_candidates(s, i)

    def _route_rows(self, ids: np.ndarray, w: np.ndarray, daat_mode: str):
        """Each query's way through the blocked layout, decided per query so
        that a query's lane, and so its bits, never depend on its
        batchmates. On a split corpus its hot terms become a dense hot row
        and its sparse row keeps only tail terms (the tail layouts hold no
        hot posting); hot-term queries always take the exhaustive lane.
        Under ``daat_mode`` ``"auto"`` the pure-tail queries whose own tail
        postings are few (``daat_eligible``) take the term-driven lane,
        under ``"daat"`` every pure-tail query does, under ``"blocked"``
        none. Returns (tail ids, tail weights, (B, H_pad) hot rows or None,
        (B,) has a hot term, the term-major layout or None, (B,) takes the
        term-driven lane)."""
        from frankensearch_tpu_torch.lexical import daat as _daat

        n = ids.shape[0]
        hot = self._hot
        q_hot = None
        has_hot = np.zeros(n, dtype=bool)
        if hot is not None:
            from frankensearch_tpu_torch.lexical import hot_arm as _hot_arm

            q_hot = _hot_arm.split_hot_rows(hot.hot_row_of, ids, w, hot.h_pad)
            has_hot = (q_hot > 0.0).any(axis=1)
            ids, w = _hot_arm.compact_tail_rows(hot.hot_row_of, ids, w)
        tm = self._term_major() if daat_mode != "blocked" else None
        if tm is None:
            take_daat = np.zeros(n, dtype=bool)
        elif daat_mode == "daat":
            take_daat = ~has_hot
        else:
            take_daat = _daat.daat_eligible(
                tm.ptr, ids, w, total_postings=self.cold_posting_count
            ) & ~has_hot
        return ids, w, q_hot, has_hot, tm, take_daat

    def _dispatch_rows(self, ids: np.ndarray, w: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Lane dispatch over resolved sparse query rows; returns host
        ((B, k) scores, (B, k) rows)."""
        n = ids.shape[0]
        if self._blocked is None:
            v_pad = max(_round_up(max(self.vocab_size, 1), 128), 128)
            q_idf = np.zeros((n, v_pad), dtype=np.float32)
            rows_b = np.repeat(np.arange(n), ids.shape[1])
            np.maximum.at(
                q_idf, (rows_b, ids.reshape(-1).astype(np.int64)),
                np.where(w > 0.0, w, 0.0).reshape(-1),
            )
            top_s, top_i = _device_bm25(
                self._post_term, self._post_tf, self._doc_steps, self._dev(q_idf),
                n_docs=self.n_docs, k=k,
            )
            self.last_lane = "dense"
            return top_s.cpu().numpy(), top_i.to(torch.int32).cpu().numpy()

        from frankensearch_tpu_torch.lexical import daat as _daat

        ids, w, q_hot_all, has_hot, _, take_daat = self._route_rows(ids, w, self.daat_mode)
        self.last_blocks_skipped = 0
        self.last_hot_queries = int(has_hot.sum())
        pieces: list = []  # (dest rows, device s, device i)
        if take_daat.any():
            sel = np.flatnonzero(take_daat)
            for ci, pair in enumerate(self._search_daat_chunks(ids[sel], w[sel], k)):
                rows = sel[ci * _daat.DAAT_CHUNK_QUERIES : (ci + 1) * _daat.DAAT_CHUNK_QUERIES]
                pieces.append((rows, pair[0], pair[1]))
        if (~take_daat).any():
            sel = np.flatnonzero(~take_daat)
            bs, bi = self._search_blocked(
                ids[sel], w[sel], k, q_hot=None if q_hot_all is None else q_hot_all[sel],
            )
            pieces.append((sel, bs, bi))
        self.last_lane = (
            "mixed"
            if take_daat.any() and not take_daat.all()
            else ("daat" if take_daat.all() else "blocked")
        )
        s = np.empty((n, k), dtype=np.float32)
        i = np.empty((n, k), dtype=np.int32)
        for rows, ps, pi in pieces:
            s[rows] = ps.cpu().numpy()
            i[rows] = pi.cpu().numpy()
        return s, i

    def fused_plan(self, queries: list[str]) -> FusedLexPlan:
        """The lexical half of the fused phase-1 pass (ops/hybrid_phase1.py)
        for a padded query batch. Below the blocked threshold: the
        ``dense`` lane. Over the blocked layout, the reference's dispatch
        (its searcher takes the term-driven lane only under ``daat_mode ==
        "auto"``): every query term-driven, the ``daat`` lane; some,
        ``mixed`` (both lanes, each query keeps its own); none, or a gather
        plan past DAAT_MAX_FUSED_ELEMENTS, ``blocked``. A query's own lane
        is ``dense``, ``daat``, or else ``flat`` (K3 over the split layout)
        or ``pruned`` (the unsplit layout's block-max scan)."""
        n = len(queries)
        if self._blocked is None:
            args = (self._post_term, self._post_tf, self._doc_steps, self._dev(self._query_idf_rows(queries)))
            return FusedLexPlan("dense", ["dense"] * n, args, {"n_docs_lex": self.n_docs})
        from frankensearch_tpu_torch.lexical import daat as _daat

        ids, w = self._query_sparse_rows(queries)
        ids, w, q_hot, _, tm, elig = self._route_rows(
            ids, w, "auto" if self.daat_mode == "auto" else "blocked"
        )
        hot = self._hot
        exhaustive = "flat" if hot is not None else "pruned"
        daat_plan = None
        if elig.any():
            # ineligible queries gather nothing: their lane is the exhaustive one
            plan = _daat.build_gather_plan(tm.ptr, ids, np.where(elig[:, None], w, np.float32(0.0)))
            if plan[0].size * 128 <= _daat.DAAT_MAX_FUSED_ELEMENTS:
                daat_plan = tuple(self._dev(x) for x in plan)
        daat_kwargs = {"t_run": ids.shape[1], "tm_packed": tm.packed} if daat_plan is not None else {}
        if daat_plan is not None and bool(elig.all()):
            return FusedLexPlan("daat", ["daat"] * n, (tm.device_arrays(), *daat_plan), daat_kwargs)
        if hot is None:
            bounds_list = self._blocked.split_bounds(self._blocked.query_bounds(ids, w), self.device)
            hot_args = None
        else:
            # the flat lane consumes no block-max bounds; a zero hot row adds exactly +0.0
            bounds_list = None
            hot_args = (hot.cols_phys, self._dev(q_hot), hot.cold_cols, hot.cold_rows, hot.dmap_groups)
        lex_args = (self._blocked.classes, bounds_list, self._dev(ids), self._dev(w), hot_args)
        if daat_plan is None:
            return FusedLexPlan("blocked", [exhaustive] * n, lex_args, {})
        lanes = ["daat" if e else exhaustive for e in elig.tolist()]
        return FusedLexPlan("mixed", lanes, (tm.device_arrays(), *daat_plan, self._dev(elig)) + lex_args, daat_kwargs)

    def rows_to_candidates(self, s: np.ndarray, i: np.ndarray) -> list[list[LexicalCandidate]]:
        """Host (B, k) scores and rows -> each query's candidates, the rows
        that scored above 0."""
        out: list[list[LexicalCandidate]] = []
        for b in range(s.shape[0]):
            out.append([
                LexicalCandidate(doc_id=self.doc_ids[int(i[b, j])], score=float(s[b, j]))
                for j in range(s.shape[1])
                if s[b, j] > 0.0
            ])
        return out

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        return self.search_candidates_batch([query], budget)[0]

    def hydrate_candidates(self, doc_ids):
        if self._source is None:  # built from raw arrays: no stored fields
            return {}
        return self._source.hydrate_candidates(doc_ids)

    @classmethod
    def from_postings(
        cls, post_term, post_doc, post_tf, arms, doc_ids, vocab_size, *, raw=None, device
    ) -> "DeviceBm25Index":
        """An index over given postings and query arms (no stored fields)."""
        index = cls.__new__(cls)
        index._source = None
        index._init_state(
            doc_ids, arms, vocab_size,
            np.asarray(post_term), np.asarray(post_doc), np.asarray(post_tf),
            raw=raw, device=device,
        )
        return index


class NativePostingsUnavailable(RuntimeError):
    """The native postings builder cannot serve this corpus (no native
    library, or text it does not tokenize): the bulk index does not apply."""


class BulkDeviceBm25Index(DeviceBm25Index):
    """Device BM25 built straight from the native ingest kernel's flat
    arrays: tokenize+accumulate in C++, vectorized numpy for idf /
    fieldnorm / tf-side folding, then one upload."""

    def __init__(self, docs, *, device: torch.device, preview_chars: int = 240) -> None:
        from frankensearch_tpu_torch import native
        from frankensearch_tpu_torch.lexical.fieldnorm import field_norms_table

        # row order == doc_id order so the top-k's lower-row tiebreak
        # reproduces the oracle's (score desc, doc_id asc) contract
        docs = sorted(docs, key=lambda d: d.doc_id)
        self._source = None
        self._meta = {
            d.doc_id: {
                "title": d.title,
                "metadata": d.metadata,
                "preview": d.content[:preview_chars],
            }
            for d in docs
        }
        n_docs = len(docs)
        norm_table = np.asarray(field_norms_table(), dtype=np.int64)
        field_texts = {
            "content": [d.content for d in docs],
            "title": [(d.title or "") for d in docs],
        }
        arms: dict[str, _FieldArm] = {}
        parts_term, parts_doc, parts_tf = [], [], []
        parts_rtf, parts_rfx = [], []
        cache_flat = np.zeros(len(_FIELDS) * 256, dtype=np.float32)
        bk_arr = np.zeros(len(_FIELDS), dtype=np.float32)
        vocab_offset = 0
        for ford, fname in enumerate(_FIELDS):
            bp = native.build_postings_native(field_texts[fname])
            if bp is None:
                raise NativePostingsUnavailable(
                    "native kernel unavailable or non-ASCII corpus; use "
                    "DeviceBm25Index(MemoryLexicalIndex.bulk_build(docs)) instead"
                )
            counts = bp.doc_token_counts.astype(np.int64)
            n_field_docs = int((counts > 0).sum())
            if n_field_docs == 0:
                arms[fname] = _FieldArm({}, np.zeros(0, np.float32), _BOOSTS[fname], vocab_offset)
                continue
            avgdl = counts.sum() / n_field_docs
            fieldnorm_ids = np.searchsorted(norm_table, counts, side="right") - 1
            cache = tf_norm_cache(avgdl)
            n_terms = len(bp.terms)
            df_i = np.bincount(bp.post_term, minlength=n_terms)
            df = df_i.astype(np.float32)
            big_n = np.float32(n_docs)
            idf_host = np.log1p(
                (big_n - df + np.float32(0.5)) / (df + np.float32(0.5))
            ).astype(np.float32)
            boost = _BOOSTS[fname]
            cache_flat[ford * 256 : (ford + 1) * 256] = cache
            bk_arr[ford] = np.float32(boost) * (BM25_K1 + np.float32(1.0))
            tf32 = bp.post_tf.astype(np.float32)
            post_fid = fieldnorm_ids[bp.post_doc]
            norms = cache[post_fid]
            tf_side = (
                np.float32(boost) * (BM25_K1 + np.float32(1.0)) * tf32 / (tf32 + norms)
            ).astype(np.float32)
            parts_term.append(bp.post_term.astype(np.int64) + vocab_offset)
            parts_doc.append(bp.post_doc.astype(np.int64))
            parts_tf.append(tf_side)
            parts_rtf.append(bp.post_tf.astype(np.int64))
            parts_rfx.append((ford * 256 + post_fid).astype(np.uint16))
            arms[fname] = _FieldArm(
                term_ids={t: vocab_offset + i for i, t in enumerate(bp.terms)},
                idf_host=idf_host,
                boost=boost,
                base=vocab_offset,
                df_host=df_i.astype(np.int64),
            )
            vocab_offset += n_terms
        if parts_term:
            terms_all = np.concatenate(parts_term)
            docs_all = np.concatenate(parts_doc)
            tf_all = np.concatenate(parts_tf)
            raw = (np.concatenate(parts_rtf), np.concatenate(parts_rfx), cache_flat, bk_arr)
        else:
            terms_all = np.zeros(0, np.int64)
            docs_all = np.zeros(0, np.int64)
            tf_all = np.zeros(0, np.float32)
            raw = None
        self._init_state(
            [d.doc_id for d in docs], arms, vocab_offset,
            terms_all, docs_all, tf_all, raw=raw, device=device,
        )

    def hydrate_candidates(self, doc_ids):
        return {d: self._meta[d] for d in doc_ids if d in self._meta}
