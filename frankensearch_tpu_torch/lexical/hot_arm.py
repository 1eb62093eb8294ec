"""Hot-term dense arm: the head of the df distribution as one matmul (PyTorch).

Port of frankensearch_tpu/lexical/hot_arm.py. At blocked scale the
layout SPLITS, once per corpus: terms whose posting count is at least
P // HOT_DF_DIVISOR become HOT. Their per-doc tf-side values densify into
columns scored by one (B, H)·(H, N) f32 product per batch, and their
postings leave both tail structures (the blocked flat layout and the
term-major DAAT CSR). The columns are stored in the blocked layout's own
group-aligned slot order, so the flat scan adds each block's hot partial
as a contiguous slice. Docs with no tail posting never enter a block:
their columns live apart (``cold_cols``/``cold_rows``) and surface
through a small exact top-k.

The host builders are copied from the reference (its module imports
jax). The module constants keep the reference's values and are read at
call time, so tests can lower them as the reference's tests do.

Bit purity: ``torch.matmul`` gives a row bits that depend on the row
count of the product (on the CPU, and by cuBLAS's shape-driven choice of
algorithm on the card), though not on the other rows' values at a fixed
shape. :func:`hot_partial` therefore always multiplies exactly
``device_bm25.FLAT_B_TILE`` rows: a query's hot partial never depends on
its batchmates. Its bits differ from the reference's XLA dot by up to a
few 1e-7 relative (another f32 summation order over H).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: a term is HOT when its posting count >= total_postings // divisor
HOT_DF_DIVISOR = 16384

#: hard cap on the dense head width
HOT_MAX_TERMS = 512

#: device-memory budget for the dense columns (f32): 1.5 GiB, the
#: reference's value (it was sized for a TPU's HBM; ROADMAP queues
#: re-deciding it on the H100). Past it the head trims and finally the
#: arm disables: the tail lanes remain exact on the full postings.
HOT_MAX_BYTES = 3 << 29

#: the arm only exists where the blocked layout does
HOT_MIN_POSTINGS = 1 << 21


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass
class HotSplit:
    """Host-side head selection, picked before the blocked tail layout
    exists and consumed by :func:`finalize_hot_arm` after."""

    hot_row_of: np.ndarray  # (V,) i32, -1 when the term is not hot
    cols_np: np.ndarray  # (H_pad, N) f32 global doc order (host only)
    n_hot: int

    @property
    def h_pad(self) -> int:
        return int(self.cols_np.shape[0])


@dataclass
class HotArm:
    """Device arm: group-aligned physical dense columns + host routing."""

    cols_phys: torch.Tensor  # (H_pad, NP_pad) f32, blocked slot order
    cold_cols: torch.Tensor  # (H_pad, C_pad) f32, zero-tail-posting docs
    cold_rows: torch.Tensor  # (C_pad,) i32 global rows ascending, -1 pad
    #: (TG, 128) i32: global row of every 128-slot group slot, class-major
    #: in the order the flat scan emits groups (-1 padding)
    dmap_groups: torch.Tensor
    hot_row_of: np.ndarray  # (V,) i32 host, -1 when the term is not hot
    n_hot: int
    n_docs: int

    @property
    def h_pad(self) -> int:
        return int(self.cols_phys.shape[0])


def split_postings(
    terms_all: np.ndarray,
    docs_all: np.ndarray,
    tf_all: np.ndarray,
    *,
    n_docs: int,
    vocab_size: int,
) -> HotSplit | None:
    """Pick the head of the df distribution and densify it (host).

    Returns None when no term qualifies, the corpus is below
    HOT_MIN_POSTINGS, or the dense columns cannot fit HOT_MAX_BYTES even
    at the minimum useful width."""
    p = len(terms_all)
    if p < HOT_MIN_POSTINGS or n_docs == 0 or vocab_size == 0:
        return None
    df = np.bincount(terms_all.astype(np.int64), minlength=vocab_size)
    thresh = max(p // HOT_DF_DIVISOR, 1)
    hot_ids = np.flatnonzero(df >= thresh)
    if len(hot_ids) == 0:
        return None
    # rank by df desc (term id asc among equals) and apply the caps
    order = np.lexsort((hot_ids, -df[hot_ids]))
    hot_ids = hot_ids[order]
    n_pad = max(_round_up(n_docs, 128), 128)
    h_budget = HOT_MAX_BYTES // (n_pad * 4)
    h = min(len(hot_ids), HOT_MAX_TERMS, int(h_budget))
    if h <= 0:
        return None
    hot_ids = hot_ids[:h]
    h_pad = max(_round_up(h, 8), 8)

    hot_row_of = np.full(vocab_size, -1, dtype=np.int32)
    hot_row_of[hot_ids] = np.arange(h, dtype=np.int32)

    rows = hot_row_of[terms_all]
    sel = rows >= 0
    cols = np.zeros((h_pad, n_docs), dtype=np.float32)
    # one value per (term, doc) in real builds; add.at keeps synthetic
    # duplicate postings additive like the tail lanes
    np.add.at(cols, (rows[sel], docs_all[sel].astype(np.int64)), tf_all[sel])
    return HotSplit(hot_row_of=hot_row_of, cols_np=cols, n_hot=h)


def finalize_hot_arm(split: HotSplit, blocked, n_docs: int, device) -> HotArm:
    """Reorder the head columns into the blocked layout's group-aligned
    physical slot order (host-side: no device gathers at query time) and
    extract the zero-tail-posting docs' columns.

    ``blocked`` is the tail ``_BlockedPostings``; its ``phys_doc`` maps
    unpadded class-major slot -> global row (-1 on block padding). The
    device slot space pads every block's width to a 128 multiple, so
    128-slot groups never straddle blocks: the hot-partial matrix, the
    flat scan's per-block score rows and ``dmap_groups`` share one slot
    numbering."""
    phys_doc = blocked.phys_doc
    group_parts: list[np.ndarray] = []
    doc_parts: list[np.ndarray] = []
    off = 0
    for cls in blocked.classes:
        n_c, d_c = cls.doc_map.shape
        gc = -(-d_c // 128)
        dm = phys_doc[off : off + n_c * d_c].reshape(n_c, d_c)
        dmp = np.full((n_c, gc * 128), -1, dtype=np.int64)
        dmp[:, :d_c] = dm
        group_parts.append(dmp.reshape(n_c * gc, 128).astype(np.int32))
        doc_parts.append(dmp.reshape(-1))
        off += n_c * d_c
    dmap_groups = (
        np.concatenate(group_parts) if group_parts else np.full((1, 128), -1, np.int32)
    )
    phys_padded = np.concatenate(doc_parts) if doc_parts else np.full(128, -1, np.int64)
    n_phys = len(phys_padded)
    np_pad = max(_round_up(max(n_phys, 1), 128), 128)
    cols_phys = np.zeros((split.h_pad, np_pad), dtype=np.float32)
    real = phys_padded >= 0
    cols_phys[:, np.flatnonzero(real)] = split.cols_np[:, phys_padded[real]]

    in_blocks = np.zeros(n_docs, dtype=bool)
    in_blocks[phys_padded[real]] = True
    cold = np.flatnonzero(~in_blocks).astype(np.int64)  # ascending rows
    c_pad = max(_round_up(max(len(cold), 1), 128), 128)
    cold_cols = np.zeros((split.h_pad, c_pad), dtype=np.float32)
    if len(cold):
        cold_cols[:, : len(cold)] = split.cols_np[:, cold]
    cold_rows = np.full(c_pad, -1, dtype=np.int32)
    cold_rows[: len(cold)] = cold

    return HotArm(
        cols_phys=torch.from_numpy(cols_phys).to(device),
        cold_cols=torch.from_numpy(cold_cols).to(device),
        cold_rows=torch.from_numpy(cold_rows).to(device),
        dmap_groups=torch.from_numpy(dmap_groups).to(device),
        hot_row_of=split.hot_row_of,
        n_hot=split.n_hot,
        n_docs=n_docs,
    )


def split_hot_rows(
    hot_row_of: np.ndarray, ids: np.ndarray, w: np.ndarray, h_pad: int
) -> np.ndarray:
    """(B, T) sparse query rows -> (B, H_pad) dense hot weight rows."""
    b = ids.shape[0]
    q_hot = np.zeros((b, h_pad), dtype=np.float32)
    rows = hot_row_of[ids.astype(np.int64)]
    sel = (rows >= 0) & (w > 0.0)
    if sel.any():
        bi, _ = np.nonzero(sel)
        np.add.at(q_hot, (bi, rows[sel]), w[sel])
    return q_hot


def compact_tail_rows(
    hot_row_of: np.ndarray,
    ids: np.ndarray,
    w: np.ndarray,
    granule: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """(B, T) sparse query rows -> (B, T_tail) tail-only rows, left-packed
    in original term order and re-padded to ``granule``. Hot terms match
    nothing in the tail layouts, so dropping them changes no score bit:
    they contributed exactly +0.0f."""
    b, t = ids.shape
    is_tail = (hot_row_of[ids.astype(np.int64)] < 0) & (w > 0.0)
    counts = is_tail.sum(axis=1).astype(np.int64)
    t_tail = int(counts.max()) if b else 0
    t_pad = max(_round_up(max(t_tail, 1), granule), granule)
    out_ids = np.zeros((b, t_pad), dtype=np.int32)
    out_w = np.zeros((b, t_pad), dtype=np.float32)
    bi, _ = np.nonzero(is_tail)
    if len(bi):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(len(bi), dtype=np.int64) - starts[bi]
        out_ids[bi, pos] = ids[is_tail]
        out_w[bi, pos] = w[is_tail]
    return out_ids, out_w


def hot_partial(cols: torch.Tensor, q_hot: torch.Tensor) -> torch.Tensor:
    """(B, N) dense hot partial scores: one f32 product (TF32 off, as
    ``resolve_device`` sets it), always at exactly ``FLAT_B_TILE`` rows.
    A larger batch runs in tiles of that many rows; a ragged tile pads by
    repeating its first row, and the padding rows are sliced off."""
    from frankensearch_tpu_torch.lexical import device_bm25

    tile = device_bm25.FLAT_B_TILE
    b = q_hot.shape[0]
    parts = []
    for t0 in range(0, b, tile):
        q = q_hot[t0 : t0 + tile]
        n = q.shape[0]
        if n < tile:
            q = torch.cat([q, q[:1].expand(tile - n, -1)])
        parts.append(torch.matmul(q, cols)[:n])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def cold_doc_topk(
    cold_cols: torch.Tensor,  # (H_pad, C_pad) f32
    cold_rows: torch.Tensor,  # (C_pad,) i32 global rows asc, -1 pad
    q_hot: torch.Tensor,  # (B, H_pad) f32
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the zero-tail-posting docs' hot scores. Ties break
    (score desc, row asc) because ``cold_rows`` ascend. Score-0 docs mask
    out, so a query with a zero hot row gets no cold candidate at all.
    Returns ((B, k) f32 scores, (B, k) i32 global rows), -inf/-1 padded."""
    from frankensearch_tpu_torch.ops.topk_scan import NEG_INF, _pad_topk, topk_desc_rowasc

    s_cold = hot_partial(cold_cols, q_hot)  # (B, C_pad)
    s_cold = torch.where((cold_rows[None, :] >= 0) & (s_cold > 0.0), s_cold, NEG_INF)
    kk = min(k, s_cold.shape[1])
    ds, pos = topk_desc_rowasc(s_cold, kk)
    di = cold_rows.to(torch.int64)[pos]
    fin = torch.isfinite(ds)
    di = torch.where(fin, di, -1)
    ds, di = _pad_topk(ds, di, k)
    return ds, di.to(torch.int32)
