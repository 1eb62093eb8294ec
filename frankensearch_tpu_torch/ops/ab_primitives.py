"""Measured-negative A/B lanes of the hierarchical scan (PyTorch) — tested,
NOT product-selectable.

Port of frankensearch_tpu/ops/ab_primitives.py. Every lane here lost an
A/B against the shipped lane on the reference's TPU and was moved out of
the product modules, so that ``ops/topk_scan.py`` exposes only lanes a
user should pick; no config, searcher or index reaches this module. The
lanes stay importable so that their parity tests keep running, and each
remains bit-equal to ``scan_topk_hierarchical``: they change only HOW the
top groups are found.

- :func:`iter_topk` — k argmax passes instead of one sorted top-k.
- :func:`topk_groups_two_stage` — chunked two-stage group selection.
- :func:`scan_topk_hierarchical_ab` — the hierarchical scan with the
  retired ``emit="tile_topk"`` (kernel K6: K1's maxima, then
  csrc/group_candidates.cu's selection gives each tile's top-t group
  candidates) and
  ``group_select="iter"`` axes.

Two retired lexical lanes stay beside them, each exact:

- :func:`grouped_blocked_dispatch` — the pruned BM25 lane run in
  selectivity-homogeneous sub-batches (the block skip is batch-AND);
- :func:`hot_daat_topk_ab` — the term-driven lane's hot combine over
  global-order dense hot columns.

The TPU measurements that retired them do not carry over to the H100; the
H100 times of K6 and of its K1 control are in PERF.md (``chip_smoke.py``
phase 6).
"""

from __future__ import annotations

import numpy as np
import torch

from frankensearch_tpu_torch.ops.topk_scan import (
    GROUP,
    NEG_INF,
    TopKResult,
    _pad_topk,
    _rescore_groups,
    argmax_passes,
    group_candidates,
    group_max,
    topk_desc_rowasc,
)


def iter_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (B, N) by k argmax passes (:func:`argmax_passes`: first
    index among ``==`` values, so -0.0 ties +0.0 and the pass records the
    maximum, +0.0 above -0.0, as the reference's ``jnp.max``/``argmax``
    passes do). Returns ((B, k) f32 values, (B, k) int32 columns)."""
    vals, cols = argmax_passes(x, k)
    return vals, cols.to(torch.int32)


#: chunk width for the two-stage group top-k
_GROUP_TOPK_CHUNK = 128


def topk_groups_two_stage(gmax: torch.Tensor, kk: int) -> torch.Tensor:
    """Exact top-kk group selection in two stages: a global top-kk element
    is a top-kk element of its own 128-wide chunk, so the top-kk of each
    chunk, then the top-kk of those, is the top-kk. Ties go to the lowest
    group id, as in one ``lax.top_k``. Returns (B, kk) int32 group ids in
    (value desc, id asc) order."""
    b, n_groups = gmax.shape
    chunk = _GROUP_TOPK_CHUNK
    if n_groups <= 2 * chunk or kk >= chunk:
        return topk_desc_rowasc(gmax, kk)[1].to(torch.int32)
    n_chunks = -(-n_groups // chunk)
    pad = n_chunks * chunk - n_groups
    if pad:
        gmax = torch.nn.functional.pad(gmax, (0, pad), value=NEG_INF)
    s1, i1 = topk_desc_rowasc(gmax.reshape(b * n_chunks, chunk), kk)
    base = (torch.arange(n_chunks, dtype=torch.int64, device=gmax.device) * chunk)[None, :, None]
    ids1 = (i1.view(b, n_chunks, kk) + base).reshape(b, n_chunks * kk)
    _, pos = topk_desc_rowasc(s1.reshape(b, n_chunks * kk), kk)
    return torch.gather(ids1, 1, pos).to(torch.int32)


def scan_topk_hierarchical_ab(
    slab: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
    *,
    tile_n: int = 8192,
    group: int = GROUP,
    rescore: str = "pallas",
    group_select: str = "sort",
    emit: str = "gmax",
) -> TopKResult:
    """The hierarchical scan with the retired A/B axes; the result is
    ``scan_topk_hierarchical``'s, bit for bit, whichever axis is taken.

    ``emit="tile_topk"``: K6 emits each tile's top ``t = min(kk, tile_n /
    128)`` (value, global group id) candidates, and one top-kk over the
    (B, num_tiles * t) candidates picks the groups — taken only where it
    narrows (``num_tiles * t < n_groups``), as the reference does.
    Exact: the global top-t groups restricted to one tile are at most t
    groups, each in that tile's own top-t, and the candidates lie
    tile-major with equal values in ascending group order, so the
    (value desc, position asc) top-k picks the groups the group-max route
    picks. Otherwise K1's (B, N/128) group maxima are ranked with one
    sorted top-k (``group_select="sort"``) or :func:`iter_topk`
    (``"iter"``). The chosen groups are rescored by K2 (``rescore=
    "pallas"``, the query rounded to the slab dtype, as the product lanes)
    or in f32 (``"xla"``, the reference's default). ``group`` is fixed at
    128, the kernels' group."""
    if group != GROUP:
        raise ValueError(f"the port's hierarchical scan runs {GROUP}-row groups, got {group}")
    if rescore not in ("pallas", "xla"):
        raise ValueError(f"rescore must be 'pallas' or 'xla', got {rescore!r}")
    if group_select not in ("sort", "iter"):
        raise ValueError(f"group_select must be 'sort' or 'iter', got {group_select!r}")
    if emit not in ("gmax", "tile_topk"):
        raise ValueError(f"emit must be 'gmax' or 'tile_topk', got {emit!r}")
    n = slab.shape[0]
    b = queries.shape[0]
    if n % tile_n != 0 or tile_n % group != 0:
        raise ValueError(f"need n % tile_n == 0 and tile_n % group == 0; got {n}, {tile_n}, {group}")
    num_tiles = n // tile_n
    n_groups = n // group
    kk_groups = min(k, n_groups)
    if mask is None:
        mask = torch.zeros(n, dtype=torch.float32, device=slab.device)

    t = min(kk_groups, tile_n // group)
    if emit == "tile_topk" and num_tiles * t < n_groups:
        cand_v, cand_g = group_candidates(slab, queries, mask, t, tile_n)  # (T, t, B)
        vals = cand_v.permute(2, 0, 1).reshape(b, num_tiles * t)
        gids = cand_g.permute(2, 0, 1).reshape(b, num_tiles * t)
        _, pos = topk_desc_rowasc(vals, kk_groups)
        top_groups = torch.gather(gids, 1, pos)
    else:
        gmax = group_max(slab, queries, mask)  # (B, N/128)
        if group_select == "iter":
            _, top_groups = iter_topk(gmax, kk_groups)
        else:
            _, top_groups = topk_desc_rowasc(gmax, kk_groups)
    return _rescore_groups(slab, queries, mask, top_groups.to(torch.int32), k=k, rescore=rescore)


#: selective sub-batch size of :func:`grouped_blocked_dispatch`
SELECTIVE_GROUP = 8


def grouped_blocked_dispatch(index, ids: np.ndarray, w: np.ndarray, bounds: np.ndarray, k: int):
    """Selectivity-grouped pruned BM25 over a ``DeviceBm25Index``'s unsplit
    blocked layout. The block-max skip is batch-AND, so one broad query
    pins every selective query's blocks: queries with at least half their
    block bounds zero run in sub-batches of ``SELECTIVE_GROUP``, the rest in
    one batch, each through the pruned lane (``_graded_scan_pruned``, the
    reference's ``_device_bm25_blocked`` at MERGE_GROUP = 1, SEQ_T_ACCUM).
    A query's scores do not depend on its batchmates and pruning is exact,
    so every row equals the single-batch call's bit for bit. Retired in the
    reference as a measured throughput loss on its TPU. Returns ((B, k)
    f32 scores, (B, k) i32 rows) as numpy arrays and sets
    ``index.last_blocks_skipped``."""
    from frankensearch_tpu_torch.lexical.device_bm25 import _graded_scan_pruned

    b = ids.shape[0]
    k = min(k, index.n_docs)
    zfrac = (bounds <= 0.0).mean(axis=0)  # (B,) zero-bound fraction
    selective = np.flatnonzero(zfrac >= 0.5)
    broad = np.flatnonzero(zfrac < 0.5)
    out_s = np.empty((b, k), dtype=np.float32)
    out_i = np.empty((b, k), dtype=np.int32)
    skipped = 0
    dev = index.device
    for sel in [selective[g : g + SELECTIVE_GROUP] for g in range(0, len(selective), SELECTIVE_GROUP)] + [broad]:
        if not len(sel):
            continue
        s, i, n_skip = _graded_scan_pruned(
            index._blocked.classes, index._blocked.split_bounds(bounds[:, sel], dev),
            torch.from_numpy(ids[sel]).to(dev), torch.from_numpy(w[sel]).to(dev), k=k,
        )
        out_s[sel] = s.cpu().numpy()
        out_i[sel] = i.cpu().numpy()
        skipped += n_skip
    index.last_blocks_skipped = skipped
    return out_s, out_i


def hot_daat_topk_ab(
    cols: torch.Tensor,  # (H_pad, N_pad) f32 hot columns, global doc order
    q_hot: torch.Tensor,  # (B, H_pad) f32
    tm_doc: torch.Tensor,  # (P_pad/128, 128) i32 tail term-major tiles
    tm_tf: torch.Tensor,  # (P_pad/128, 128) f32
    row_idx: torch.Tensor,  # (B, R) i32 tail gather plan
    row_w: torch.Tensor,  # (B, R) f32
    span_lo: torch.Tensor,  # (B, R) i32
    span_hi: torch.Tensor,  # (B, R) i32
    *,
    k: int,
    t_run: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The term-driven lane's retired hot combine: the dense hot partial
    gathered at the tail runs' doc keys, a dense top-k of the hot partial
    for docs with no tail run, the dense entries whose doc has a run
    dropped, and an exact merge. Retired in the reference (a row-wise
    gather from the (B, N) hot matrix and a dense top-k cost more than the
    split layout's in-scan add on its TPU); the product routes hot-term
    queries to the flat lane.

    Exact: a doc with a tail contribution appears in the runs with its
    full total (run sum, then the hot partial added). A doc with none
    reaches the top-k only through the dense top-k over the hot partial:
    if it is not there, k docs dominate it by (hot score, doc asc) and so
    by (total, doc asc). Dropping dense entries whose doc has a run un-
    dominates nothing. Returns ((B, k) f32 scores, (B, k) i32 doc rows,
    -1 on tail padding)."""
    from frankensearch_tpu_torch.lexical.daat import gathered_runs
    from frankensearch_tpu_torch.lexical.device_bm25 import _merge_topk_exact
    from frankensearch_tpu_torch.lexical.hot_arm import hot_partial

    n_pad = cols.shape[1]
    s_hot = hot_partial(cols, q_hot)  # (B, N_pad)
    sd, run_score = gathered_runs(tm_doc, tm_tf, row_idx, row_w, span_lo, span_hi, t_run)
    # run starts only: -inf elsewhere (padding keys read a clamped column)
    totals = run_score + torch.gather(s_hot, 1, torch.clamp(sd, max=n_pad - 1).to(torch.int64))
    tail_s, tail_pos = topk_desc_rowasc(totals, min(k, sd.shape[1]))
    fin = torch.isfinite(tail_s)
    tail_d = torch.where(fin, torch.gather(sd, 1, tail_pos), -1)
    tail_s, tail_d = _pad_topk(torch.where(fin, tail_s, NEG_INF), tail_d, k)

    dense_s, dense_d = topk_desc_rowasc(torch.where(s_hot > 0.0, s_hot, NEG_INF), min(k, n_pad))
    dense_d = dense_d.to(torch.int32)
    # drop dense entries whose doc holds a tail run (sd ascends per row)
    pos = torch.searchsorted(sd.contiguous(), dense_d.contiguous())
    member = torch.gather(sd, 1, torch.clamp(pos, max=sd.shape[1] - 1)) == dense_d
    dense_s, dense_d = _pad_topk(
        torch.where(member, NEG_INF, dense_s), torch.where(member, -1, dense_d), k
    )
    return _merge_topk_exact(tail_s, tail_d.to(torch.int32), dense_s, dense_d, k)
