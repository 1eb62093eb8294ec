"""Term-addressed (DAAT) device BM25 lane: cost ∝ Σ df(query terms) (PyTorch).

Port of frankensearch_tpu/lexical/daat.py. The postings lie on the device
sorted by (term, doc asc), padded to a multiple of 128 and cut into row
tiles, with a host CSR ``ptr (V+1,)`` of each term's flat span. A query
batch becomes a host gather plan (the rows covering each active term's
span, with the term's idf weight and the span bounds); the device gathers
those rows, masks each element to its span, multiplies by the weight,
sorts each query's (doc key, contribution) pairs by doc with a stable
sort, and adds each doc's run of at most T entries left to right in the
plan's term order. Every op is elementwise, a stable sort or a gather, so
the lane's bits equal the reference's on the CPU and are the same on the
card.

Two layouts, chosen at build: f32 (doc i32 + tf-side f32, 8 B/posting)
and packed (5 B/posting: three u8 doc planes and one u16 word
``tf<<9 | field<<8 | fieldnorm_id``, the tf-side score recomputed on the
device as ``bk[field]·tf / (tf + cache[idx])`` in the host build's f32 op
order, so both layouts give the same bits).

The host builders are copied from the reference (its module imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from frankensearch_tpu_torch.ops.topk_scan import NEG_INF, _pad_topk, topk_desc_rowasc

#: sentinel doc key sorting after every real doc row (rows are < 2^30)
_BIG_DOC = 1 << 30

#: a query goes term-driven when its gathered elements < P / DIVISOR (the
#: reference's TPU-derived crossover; ROADMAP queues re-deriving it on the
#: H100). A pure per-query function: a query's lane never depends on its
#: batchmates.
DAAT_CROSSOVER_DIVISOR = 128

#: flat posting positions are i32 on the device
_MAX_P = (1 << 31) - 256

#: device-memory budget for the term-major copy, which lives next to the
#: blocked layout
DAAT_MAX_LAYOUT_BYTES = 2 * (1 << 30)
#: the same budget as a postings count for the f32 layout
DAAT_MAX_LAYOUT_POSTINGS = 250 * (1 << 20)

#: packed-layout gates: doc rows fit 24 bits and raw tf 7 bits
PACKED_MAX_DOCS = 1 << 24
PACKED_MAX_TF = 127

#: per-query element ceiling for the term-driven lane
DAAT_PER_QUERY_CAP = 1 << 20

#: unfused daat calls chunk to this many queries
DAAT_CHUNK_QUERIES = 32

#: the fused phase-1 daat lane is one unchunked call; batches whose total
#: padded gather would exceed this take the exhaustive lane
DAAT_MAX_FUSED_ELEMENTS = 32 * (1 << 20)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


@dataclass
class TermMajorPostings:
    """Device term-major postings + host span CSR, f32 or packed."""

    tm_doc: torch.Tensor | None  # (P_pad/128, 128) i32, -1 on tail padding
    tm_tf: torch.Tensor | None  # (P_pad/128, 128) f32, 0 on tail padding
    ptr: np.ndarray  # (V+1,) i64 flat span offsets per term id
    n_postings: int
    packed: bool = False
    tm_d0: torch.Tensor | None = None  # (P_pad/128, 128) u8 doc bits 0-7
    tm_d1: torch.Tensor | None = None  # u8 doc bits 8-15
    tm_d2: torch.Tensor | None = None  # u8 doc bits 16-23
    tm_w: torch.Tensor | None = None  # (P_pad/128, 128) i16 tf|field|fid bits
    cache512: torch.Tensor | None = None  # (F*256 pad 512,) f32
    bk: torch.Tensor | None = None  # (F pad 8,) f32

    def device_arrays(self) -> tuple:
        """The tensors the device lane consumes (layout-dependent)."""
        if self.packed:
            return (self.tm_d0, self.tm_d1, self.tm_d2, self.tm_w, self.cache512, self.bk)
        return (self.tm_doc, self.tm_tf)


def build_term_major(
    terms_all: np.ndarray,
    docs_all: np.ndarray,
    tf_all: np.ndarray,
    *,
    vocab_size: int,
    device,
    raw=None,
) -> TermMajorPostings | None:
    """Sort postings by (term, doc asc), pad to 128, upload row tiles.

    ``raw`` = (tf_raw, fidx, cache_flat, bk) host arrays enables the
    packed layout when its gates hold. Returns None when the flat space
    would overflow i32 positions or the layout would exceed
    DAAT_MAX_LAYOUT_BYTES (the exhaustive lane still serves those)."""
    p = len(terms_all)
    p_pad = max(_round_up(max(p, 1), 128), 128)
    if p_pad >= _MAX_P:
        return None
    use_packed = False
    if raw is not None:
        tf_raw, fidx, cache_flat, bk = raw
        use_packed = bool(
            (len(tf_raw) == p)
            and (p == 0 or int(tf_raw.max(initial=0)) <= PACKED_MAX_TF)
            and (p == 0 or int(docs_all.max(initial=0)) < PACKED_MAX_DOCS)
        )
    budget = 5 * p_pad if use_packed else 8 * p_pad
    if budget > DAAT_MAX_LAYOUT_BYTES or (not use_packed and p_pad > DAAT_MAX_LAYOUT_POSTINGS):
        return None
    order = np.lexsort((docs_all, terms_all))
    counts = np.bincount(terms_all.astype(np.int64), minlength=max(vocab_size, 1)).astype(np.int64)
    ptr = np.concatenate([[0], np.cumsum(counts)])

    def dev(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if use_packed:
        d = np.zeros(p_pad, dtype=np.int64)
        d[:p] = docs_all[order]
        w16 = np.zeros(p_pad, dtype=np.uint16)
        w16[:p] = (tf_raw[order].astype(np.uint16) << 9) | fidx[order].astype(np.uint16)
        c512 = np.zeros(max(_round_up(len(cache_flat), 512), 512), np.float32)
        c512[: len(cache_flat)] = cache_flat
        bk8 = np.zeros(8, np.float32)
        bk8[: len(bk)] = bk
        return TermMajorPostings(
            tm_doc=None, tm_tf=None, ptr=ptr, n_postings=p, packed=True,
            tm_d0=dev((d & 0xFF).astype(np.uint8).reshape(-1, 128)),
            tm_d1=dev(((d >> 8) & 0xFF).astype(np.uint8).reshape(-1, 128)),
            tm_d2=dev(((d >> 16) & 0xFF).astype(np.uint8).reshape(-1, 128)),
            # torch has no general uint16 tensor ops: the same 16 bits as i16
            tm_w=dev(w16.view(np.int16).reshape(-1, 128)),
            cache512=dev(c512),
            bk=dev(bk8),
        )
    doc_flat = np.full(p_pad, -1, dtype=np.int32)
    tf_flat = np.zeros(p_pad, dtype=np.float32)
    doc_flat[:p] = docs_all[order]
    tf_flat[:p] = tf_all[order]
    return TermMajorPostings(
        tm_doc=dev(doc_flat.reshape(-1, 128)),
        tm_tf=dev(tf_flat.reshape(-1, 128)),
        ptr=ptr,
        n_postings=p,
    )


def build_gather_plan(
    ptr: np.ndarray, ids: np.ndarray, w: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized host plan: per query, the row ids covering its terms'
    spans plus per-row (idf weight, flat span bounds). Padding terms
    (weight 0) are excluded by the weight, not the id (id 0 is a real
    term). Returns (row_idx, row_w, span_lo, span_hi), all (B, R) with R
    a power of two; padded slots gather row 0 with an empty span."""
    b, t = ids.shape
    ids64 = ids.astype(np.int64)
    lo = ptr[ids64]
    hi = ptr[ids64 + 1]
    active = w > 0.0
    lo = np.where(active, lo, 0)
    hi = np.where(active, hi, 0)
    row_lo = lo >> 7
    row_hi = (hi + 127) >> 7
    # empty spans (df-0 terms, hot terms in the tail CSR) cover no rows
    nrows = np.where(hi > lo, np.maximum(row_hi - row_lo, 0), 0)

    nrows_f = nrows.reshape(-1)
    total = int(nrows_f.sum())
    r_b = nrows.sum(axis=1)
    r_pad = _next_pow2(max(int(r_b.max()) if b else 1, 1))
    row_idx = np.zeros((b, r_pad), dtype=np.int32)
    row_w = np.zeros((b, r_pad), dtype=np.float32)
    span_lo = np.zeros((b, r_pad), dtype=np.int32)
    span_hi = np.zeros((b, r_pad), dtype=np.int32)
    if total:
        j_of = np.repeat(np.arange(b * t, dtype=np.int64), nrows_f)
        seg_start = np.concatenate([[0], np.cumsum(nrows_f)[:-1]])
        off = np.arange(total, dtype=np.int64) - seg_start[j_of]
        b_of = j_of // t
        b_start = np.concatenate([[0], np.cumsum(r_b)[:-1]])
        dest = (seg_start[j_of] + off) - b_start[b_of]
        row_idx[b_of, dest] = (row_lo.reshape(-1)[j_of] + off).astype(np.int32)
        row_w[b_of, dest] = w.reshape(-1)[j_of]
        span_lo[b_of, dest] = lo.reshape(-1)[j_of].astype(np.int32)
        span_hi[b_of, dest] = hi.reshape(-1)[j_of].astype(np.int32)
    return row_idx, row_w, span_lo, span_hi


def _gather_span_tiles(tm_arrays, flat_rows: torch.Tensor, b: int, r: int, *, packed: bool):
    """Gather the plan's row tiles: (doc (b,r,128) i32, tf_side (b,r,128)
    f32). The packed layout decodes the doc planes and recomputes the
    tf-side score as bk[field]·tf / (tf + cache): the host build's f32
    op order, so the values equal the f32 layout's bit for bit."""
    if not packed:
        tm_doc, tm_tf = tm_arrays
        return tm_doc[flat_rows].reshape(b, r, 128), tm_tf[flat_rows].reshape(b, r, 128)
    tm_d0, tm_d1, tm_d2, tm_w, cache512, bk = tm_arrays
    d0 = tm_d0[flat_rows].to(torch.int32)
    d1 = tm_d1[flat_rows].to(torch.int32)
    d2 = tm_d2[flat_rows].to(torch.int32)
    d = (d0 | (d1 << 8) | (d2 << 16)).reshape(b, r, 128)
    w16 = tm_w[flat_rows].to(torch.int32) & 0xFFFF  # the u16 bits, unsigned
    fidx = (w16 & 0x1FF).to(torch.int64)
    tf = (w16 >> 9).to(torch.float32)
    c = cache512[fidx]
    bksel = bk[fidx >> 8]
    f = bksel * tf / (tf + c)
    return d, f.reshape(b, r, 128)


def gathered_runs_tm(
    tm_arrays,
    row_idx: torch.Tensor,  # (B, R) i32
    row_w: torch.Tensor,  # (B, R) f32
    span_lo: torch.Tensor,  # (B, R) i32
    span_hi: torch.Tensor,  # (B, R) i32
    t_run: int,
    *,
    packed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Span gather -> mask -> stable doc-key sort -> bounded-run sum.
    Returns (sd, score): ``sd`` (B, M) i32 doc keys ascending (_BIG_DOC on
    padding), ``score`` (B, M) f32 the doc's summed contribution at each
    run start and -inf elsewhere. Each doc's run holds at most one posting
    per active (term, field) pair, <= t_run entries, summed left to right
    in the plan's term order."""
    b, r = row_idx.shape
    dev = row_idx.device
    flat_rows = row_idx.reshape(-1).to(torch.int64)
    d, f = _gather_span_tiles(tm_arrays, flat_rows, b, r, packed=packed)
    pos = row_idx[..., None] * 128 + torch.arange(128, dtype=torch.int32, device=dev)
    valid = (pos >= span_lo[..., None]) & (pos < span_hi[..., None])
    contrib = torch.where(valid, f * row_w[..., None], 0.0)
    key = torch.where(valid, d, _BIG_DOC).reshape(b, r * 128)
    contrib = contrib.reshape(b, r * 128)

    sd, perm = torch.sort(key, dim=1, stable=True)
    sv = torch.gather(contrib, 1, perm)

    score = sv
    run_len = min(t_run, r * 128)
    for j in range(1, run_len):
        nd = torch.nn.functional.pad(sd[:, j:], (0, j), value=_BIG_DOC + 1)
        nv = torch.nn.functional.pad(sv[:, j:], (0, j), value=0.0)
        score = score + torch.where(nd == sd, nv, 0.0)

    prev = torch.nn.functional.pad(sd[:, :-1], (1, 0), value=-1)
    is_start = (sd != prev) & (sd < _BIG_DOC)
    return sd, torch.where(is_start, score, NEG_INF)


def daat_topk_tm(
    tm_arrays,
    row_idx: torch.Tensor,
    row_w: torch.Tensor,
    span_lo: torch.Tensor,
    span_hi: torch.Tensor,
    *,
    k: int,
    t_run: int,
    packed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Term-driven top-k over :func:`gathered_runs_tm`: ((B, k) f32
    scores, (B, k) i32 global doc rows, -1 invalid). Ties break (score
    desc, row asc): run starts ascend by doc."""
    b, r = row_idx.shape
    sd, score = gathered_runs_tm(
        tm_arrays, row_idx, row_w, span_lo, span_hi, t_run, packed=packed
    )
    kk = min(k, r * 128)
    top_s, top_pos = topk_desc_rowasc(score, kk)
    top_d = torch.gather(sd, 1, top_pos).to(torch.int64)
    top_d = torch.where(torch.isfinite(top_s), top_d, -1)
    top_s, top_d = _pad_topk(top_s, top_d, k)
    return top_s, top_d.to(torch.int32)


def query_plan_elements(ptr: np.ndarray, ids: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(B,) unpadded gathered elements per query (rows · 128): the
    per-query DAAT cost estimate, computed without building a plan."""
    ids64 = ids.astype(np.int64)
    lo = ptr[ids64]
    hi = ptr[ids64 + 1]
    active = (w > 0.0) & (hi > lo)
    nrows = np.where(active, ((hi + 127) >> 7) - (lo >> 7), 0)
    return nrows.sum(axis=1) * 128


def daat_eligible(
    ptr: np.ndarray, ids: np.ndarray, w: np.ndarray, *, total_postings: int
) -> np.ndarray:
    """(B,) bool: term-driven when a query's own estimated work beats the
    exhaustive scan. A pure per-query function, so a query's lane is the
    same solo and inside any batch."""
    est = query_plan_elements(ptr, ids, w)
    return (est < total_postings // DAAT_CROSSOVER_DIVISOR) & (est <= DAAT_PER_QUERY_CAP)
