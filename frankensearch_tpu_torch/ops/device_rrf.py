"""On-device RRF: the fused-phase-1 tail that merges both arms on the card.

Port of frankensearch_tpu/ops/device_rrf.py. The host vectorized
implementation (fusion/rrf_batch.py) stays the oracle; this module
reproduces its exact ordering contract on the device:

- contributions are computed on the host in f64 with the oracle's exact
  expressions and uploaded as they are;
- each doc gets at most one contribution per arm, so its fused score is
  one f64 add, lexical term first — the oracle's own sum, bit for bit, on
  any device (the H100 has f64; the reference's TPU has not, and orders by
  an f32 double-float (hi, lo) sum instead, which can break exact ties
  by its rounding: two docs with swapped lexical and vector ranks tie in
  f64 but not always in that sum);
- the 4-key order (rrf desc, in-both first, lexical score desc, row asc)
  is a chain of stable sorts, least-significant key first;
- the device returns only (row, lex_rank, fast_rank); :func:`finish_rrf`
  recomputes the winners' scores from the same f64 tables, so scores are
  bitwise the oracle's.
"""

from __future__ import annotations

import numpy as np
import torch

from frankensearch_tpu_torch.ops.topk_scan import float_order_key

#: sentinel row id sorting after every real row (rows < 2^30)
_BIG_ROW = 1 << 30


def make_contrib_tables(
    k_arr: np.ndarray, kl: int, kv: int, lex_w: float, sem_w: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(B, Kl) and (B, Kv) f64 rank-contribution tables — the exact
    expressions of fusion/rrf_batch.rrf_fuse_batch_rows (base = k+1)."""
    base = (np.asarray(k_arr, dtype=np.float64) + 1.0)[:, None]
    contrib_l = (1.0 / (base + np.arange(kl, dtype=np.float64)[None, :])) * lex_w
    contrib_v = (1.0 / (base + np.arange(kv, dtype=np.float64)[None, :])) * (
        np.asarray(sem_w, np.float64)[:, None]
    )
    return contrib_l, contrib_v


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """Float sort key with -0.0 == +0.0 (``lax.sort``'s comparison) and
    the same order on every device: canonicalize zeros, then order bits."""
    if x.dtype == torch.float64:
        bits = (x + 0.0).contiguous().view(torch.int64)
        return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFFFFFFFFFF)
    if x.dtype.is_floating_point:
        return float_order_key(x + 0.0)
    return x.to(torch.int64)


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Row-wise permutation sorting by ``keys`` ascending, keys[0] most
    significant: stable sorts from the least-significant key up."""
    perm = None
    for key in reversed(keys):
        k = _sort_key(key)
        if perm is not None:
            k = torch.gather(k, 1, perm)
        order = torch.sort(k, dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return perm


def rrf_tail(
    lex_i: torch.Tensor,  # (B, Kl) i32 lexical rows
    lex_s: torch.Tensor,  # (B, Kl) f32 BM25 scores (-inf/0 padding)
    vec_i: torch.Tensor,  # (B, Kv) i32 vector-slab rows (-1 padding)
    row_map: torch.Tensor,  # (Nv,) i32 vector row -> lexical row
    contrib_l: torch.Tensor,  # (B, Kl) f64 lexical rank contributions
    contrib_v: torch.Tensor,  # (B, Kv) f64 vector rank contributions
    *,
    limit: int,
):
    """Device RRF body. Returns ((B, limit) fused rows, lex_ranks,
    fast_ranks) int32 — rows -1 when fewer than ``limit`` docs exist;
    ranks -1 when that arm didn't contribute (rrf_fuse_batch_rows' tuple
    fields)."""
    b, kl = lex_i.shape
    kv = vec_i.shape[1]
    k = kl + kv
    dev = lex_i.device
    i32, f32 = torch.int32, torch.float32

    lid = torch.where(lex_s > 0.0, lex_i.to(i32), -1)
    vec_i = vec_i.to(i32)
    vid = torch.where(vec_i >= 0, row_map.to(i32)[vec_i.clamp(min=0).to(torch.int64)], -1)
    ids = torch.cat([lid, vid], dim=1)  # lex first: grouping order
    contrib = torch.cat([contrib_l, contrib_v], dim=1).to(torch.float64)
    ranks = torch.cat(
        [
            torch.arange(kl, dtype=i32, device=dev).expand(b, kl),
            torch.arange(kv, dtype=i32, device=dev).expand(b, kv),
        ],
        dim=1,
    )
    is_lex = torch.cat(
        [torch.ones((b, kl), dtype=i32, device=dev), torch.zeros((b, kv), dtype=i32, device=dev)],
        dim=1,
    )
    lexsc = torch.cat([lex_s.to(f32), torch.zeros((b, kv), dtype=f32, device=dev)], dim=1)

    key_id = torch.where(ids >= 0, ids, _BIG_ROW)
    order = torch.sort(key_id, dim=1, stable=True).indices
    sid, sc, srk, silex, slexsc = (
        torch.gather(x, 1, order) for x in (key_id, contrib, ranks, is_lex, lexsc)
    )

    same = sid[:, 1:] == sid[:, :-1]
    no = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    nxt_same = torch.cat([same, no], dim=1)
    prv_same = torch.cat([no, same], dim=1)
    is_first = (~prv_same) & (sid < _BIG_ROW)

    def shl(x):
        return torch.cat([x[:, 1:], torch.zeros((b, 1), dtype=x.dtype, device=dev)], dim=1)

    nrk = torch.where(nxt_same, shl(srk), 0)
    # a doc's group is (lexical entry, vector entry) or one of them: the
    # oracle's grouped f64 sum, lexical term first
    rrf = torch.where(nxt_same, sc + shl(sc), sc)

    in_both = is_first & nxt_same
    first_is_lex = silex == 1
    lr = torch.where(first_is_lex, srk, -1)
    fr = torch.where(in_both, nrk, torch.where(first_is_lex, -1, srk))
    t3 = torch.where(first_is_lex, -slexsc, float("inf"))

    inf = float("inf")
    k1 = torch.where(is_first, -rrf, inf)  # rrf desc
    k3 = torch.where(is_first, torch.where(in_both, 0, 1), 2).to(i32)  # in-both first
    k4 = torch.where(is_first, t3, inf)  # lexical score desc
    k5 = torch.where(is_first, sid, _BIG_ROW)  # row asc
    perm = _lexsort([k1, k3, k4, k5])

    lim = min(limit, k)
    perm = perm[:, :lim]
    out_id = torch.gather(k5, 1, perm)
    out_lr = torch.gather(lr, 1, perm)
    out_fr = torch.gather(fr, 1, perm)
    invalid = out_id >= _BIG_ROW
    return (
        torch.where(invalid, -1, out_id).to(i32),
        torch.where(invalid, -1, out_lr).to(i32),
        torch.where(invalid, -1, out_fr).to(i32),
    )


#: the reference's jitted entry point; eager PyTorch needs no separate one
device_rrf = rrf_tail


def finish_rrf(
    out_id: np.ndarray,  # (B, limit) fused rows (-1 invalid)
    out_lr: np.ndarray,
    out_fr: np.ndarray,
    contrib_l: np.ndarray,  # (B, Kl) f64 — the same table the device saw
    contrib_v: np.ndarray,  # (B, Kv) f64
) -> list[list[tuple[int, float, bool, int, int]]]:
    """Reconstruct rrf_fuse_batch_rows' exact per-query tuples from the
    device ranks: score = fl64(contrib_l[lr] + contrib_v[fr]), lex term
    first — bitwise np.add.reduceat's lex-first grouped sum."""
    b, lim = out_id.shape
    lr = np.asarray(out_lr, dtype=np.int64)
    fr = np.asarray(out_fr, dtype=np.int64)
    rows = np.arange(b, dtype=np.int64)[:, None]
    cl = np.where(lr >= 0, contrib_l[rows, np.maximum(lr, 0)], 0.0)
    cv = np.where(fr >= 0, contrib_v[rows, np.maximum(fr, 0)], 0.0)
    score = cl + cv
    ids = np.asarray(out_id, dtype=np.int64)
    out: list[list[tuple[int, float, bool, int, int]]] = []
    for qb in range(b):
        row_out = []
        for j in range(lim):
            rid = int(ids[qb, j])
            if rid < 0:
                break
            row_out.append(
                (
                    rid,
                    float(score[qb, j]),
                    bool(lr[qb, j] >= 0 and fr[qb, j] >= 0),
                    int(lr[qb, j]),
                    int(fr[qb, j]),
                )
            )
        out.append(row_out)
    return out
