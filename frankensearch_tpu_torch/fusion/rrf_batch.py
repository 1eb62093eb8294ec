"""Vectorized batch RRF over integer row ids.

Per-query ``rrf_fuse`` costs ~0.5 ms of dict/object work; at B=256 the
host fusion is the hybrid pipeline's last non-transport cost
(PERF_LEDGER: ~0.13 s per batch). This fuses the whole batch in a few
numpy passes over LEX-ROW integer ids (the device arms already agree on
a row space via a vector-row -> lexical-row map).

Exactness contract: bitwise-identical scores and IDENTICAL ordering to
``rrf_fuse`` per query, including the 4-level tie order
(score desc, in-both preferred, lexical-score desc, id asc) — fuzzed
against the scalar implementation in tests. Doc-id-ascending ties map
to lex-row-ascending because the device lexical arms sort doc_ids.

Scope: LEXICAL_THEN_ID tiebreak, no graph arm, offset 0 (callers fall
back to the scalar path otherwise).
"""

from __future__ import annotations

import numpy as np

from frankensearch_tpu_torch.core.types import FusedHit, SearchSource


def rrf_fuse_batch_rows(
    lex_rows: np.ndarray,    # (B, Kl) int64 lex-row ids, -1 padding
    lex_scores: np.ndarray,  # (B, Kl) f32 BM25 scores (at the same slots)
    vec_rows: np.ndarray,    # (B, Kv) int64 ids in the SAME space, -1 padding
    limit: int,
    k_arr: np.ndarray,       # (B,) f64 per-query RRF k
    lex_w: float,
    sem_w: np.ndarray,       # (B,) per-query semantic weight
    n_ids: int,
) -> list[list[tuple[int, float, bool, int, int]]]:
    """Returns, per query, up to ``limit`` tuples
    (row_id, rrf_score, in_both, lexical_rank, fast_rank) in the exact
    fused order (ranks are -1 when the arm didn't contribute)."""
    b, kl = lex_rows.shape
    kv = vec_rows.shape[1]
    k = kl + kv

    base = (np.asarray(k_arr, dtype=np.float64) + 1.0)[:, None]  # (B, 1)
    ranks_l = np.arange(kl, dtype=np.float64)[None, :]
    ranks_v = np.arange(kv, dtype=np.float64)[None, :]
    # EXACT same expression order as rrf.py: (1.0 / (base + rank)) * w
    contrib_l = (1.0 / (base + ranks_l)) * lex_w
    contrib_v = (1.0 / (base + ranks_v)) * np.asarray(sem_w, np.float64)[:, None]

    ids = np.concatenate([lex_rows, vec_rows], axis=1).astype(np.int64)  # (B, K)
    contribs = np.concatenate([contrib_l, contrib_v], axis=1)
    ranks = np.concatenate(
        [np.broadcast_to(np.arange(kl), (b, kl)),
         np.broadcast_to(np.arange(kv), (b, kv))], axis=1,
    ).astype(np.int64)
    is_lex = np.concatenate(
        [np.ones((b, kl), bool), np.zeros((b, kv), bool)], axis=1
    )
    lexsc = np.concatenate(
        [lex_scores.astype(np.float64), np.zeros((b, kv))], axis=1
    )

    row_of = np.broadcast_to(np.arange(b, dtype=np.int64)[:, None], (b, k))
    valid = (ids >= 0).reshape(-1)
    flat_idx = np.flatnonzero(valid)
    gid = (row_of.reshape(-1)[flat_idx] * np.int64(n_ids)
           + ids.reshape(-1)[flat_idx])
    order = np.argsort(gid, kind="stable")  # stable: lex entry first in group
    gid_s = gid[order]
    sel = flat_idx[order]
    contribs_s = contribs.reshape(-1)[sel]
    ranks_s = ranks.reshape(-1)[sel]
    is_lex_s = is_lex.reshape(-1)[sel]
    lexsc_s = lexsc.reshape(-1)[sel]

    if len(gid_s) == 0:
        return [[] for _ in range(b)]
    starts = np.flatnonzero(np.concatenate([[True], gid_s[1:] != gid_s[:-1]]))
    sizes = np.diff(np.concatenate([starts, [len(gid_s)]]))
    rrf = np.add.reduceat(contribs_s, starts)  # lex-first order == scalar path
    in_both = sizes == 2
    first_is_lex = is_lex_s[starts]
    second = np.minimum(starts + 1, len(gid_s) - 1)
    g_row = gid_s[starts] // n_ids
    g_id = gid_s[starts] % n_ids
    lex_rank = np.where(first_is_lex, ranks_s[starts], -1)
    fast_rank = np.where(
        in_both, ranks_s[second], np.where(first_is_lex, -1, ranks_s[starts])
    )
    # tiebreak 3: lexical score desc when the lex arm contributed, +inf last
    t3 = np.where(first_is_lex, -lexsc_s[starts], np.inf)

    # final per-row ordering: (row, -rrf, not_in_both, t3, id)
    final = np.lexsort((g_id, t3, ~in_both, -rrf, g_row))
    rows_f = g_row[final]
    # per-row cumulative count -> top-limit mask
    row_change = np.concatenate([[True], rows_f[1:] != rows_f[:-1]])
    run_start_positions = np.flatnonzero(row_change)
    run_start_of = np.repeat(run_start_positions,
                             np.diff(np.concatenate([run_start_positions, [len(rows_f)]])))
    within = np.arange(len(rows_f)) - run_start_of
    keep = within < limit
    final = final[keep]

    out: list[list[tuple[int, float, bool, int, int]]] = [[] for _ in range(b)]
    for pos in final:
        out[int(g_row[pos])].append(
            (int(g_id[pos]), float(rrf[pos]), bool(in_both[pos]),
             int(lex_rank[pos]), int(fast_rank[pos]))
        )
    return out


def rows_to_fused_hits(entries, doc_ids) -> list[FusedHit]:
    """(row_id, rrf, in_both, lex_rank, fast_rank) -> FusedHit list."""
    out = []
    for rid, score, _both, lr, fr in entries:
        sources = SearchSource.NONE
        if lr >= 0:
            sources |= SearchSource.LEXICAL
        if fr >= 0:
            sources |= SearchSource.FAST_VECTOR
        out.append(FusedHit(
            doc_id=doc_ids[rid], score=score, sources=sources,
            lexical_rank=lr if lr >= 0 else None,
            fast_rank=fr if fr >= 0 else None,
        ))
    return out
