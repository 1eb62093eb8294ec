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

The TPU measurements that retired them do not carry over to the H100; the
H100 times of K6 and of its K1 control are in PERF.md (``chip_smoke.py``
phase 6). ``grouped_blocked_dispatch`` and ``hot_daat_topk_ab`` are not
ported yet (ROADMAP).
"""

from __future__ import annotations

import torch

from frankensearch_tpu_torch.ops.topk_scan import (
    GROUP,
    NEG_INF,
    TopKResult,
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
