"""The plain reference: what the searcher should have answered, worked out
again from the run's seed with plain PyTorch and NumPy in float64.

It imports nothing of the program. It makes the inputs again itself
(harness/data.py: the doc vectors, the embedding table) and derives the
rest on its own: the pooled query vectors, the exact cosine of every doc
and reciprocal-rank fusion. It runs once the window has closed and the
program's state is freed, one chunk of rows at a time.
"""

from __future__ import annotations

import math
import re

import torch

from benchmark.harness import data

_WORD = re.compile(r"w(\d{6})")


def words_of(text: str) -> list[int]:
    """The word ids of a query text: its whitespace-separated words, each
    ``w`` and six digits (the only words the traffic sends)."""
    out = []
    for tok in text.split():
        m = _WORD.fullmatch(tok)
        if m is None:
            raise ValueError(f"unexpected query word {tok!r}")
        out.append(int(m.group(1)))
    return out


def query_vectors(seed: int, cfg: dict, texts: list[str], device) -> torch.Tensor:
    """(S, dim) f64 unit vectors: the mean of each query's table rows, one
    per word occurrence, divided by its length."""
    emb = cfg["embedder"]
    ids = [words_of(t) for t in texts]
    rows = torch.tensor(sorted({w for q in ids for w in q}), dtype=torch.int64, device=device)
    pos = {int(w): j for j, w in enumerate(rows.tolist())}
    picked = torch.empty((len(rows), emb["dim"]), dtype=torch.float64, device=device)
    for r0, chunk in data.unit_rows(seed, "embedding-table", emb["rows"], emb["dim"], device, _dtype(emb["dtype"])):
        sel = (rows >= r0) & (rows < r0 + chunk.shape[0])
        picked[sel] = chunk[rows[sel] - r0].double()
    out = torch.zeros((len(texts), emb["dim"]), dtype=torch.float64, device=device)
    for i, q in enumerate(ids):
        out[i] = picked[[pos[w] for w in q]].mean(dim=0)
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True)


def _dtype(name: str):
    return {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[name]


def vector_scores(seed: int, cfg: dict, qvecs: torch.Tensor, served_rows: list[list[int]], depth: int):
    """For each query: its ``depth`` best exact scores (descending, as a
    list), and the exact score of each row in ``served_rows[i]`` (None for
    a row outside the corpus). Doc vectors are made again chunk by chunk."""
    dev = qvecs.device
    n, dim = cfg["docs"], cfg["dim"]
    s = qvecs.shape[0]
    best = torch.full((s, 0), float("-inf"), dtype=torch.float64, device=dev)
    pairs_q = torch.tensor([i for i, rows in enumerate(served_rows) for _ in rows], dtype=torch.int64, device=dev)
    pairs_r = torch.tensor([r for rows in served_rows for r in rows], dtype=torch.int64, device=dev)
    pair_s = torch.full((len(pairs_r),), float("nan"), dtype=torch.float64, device=dev)
    for r0, chunk in data.unit_rows(seed, "doc-vectors", n, dim, dev, _dtype(cfg["slab_dtype"])):
        c = chunk.double()
        scores = c @ qvecs.T  # (rows, S)
        top = torch.topk(scores.T, min(depth, c.shape[0]), dim=1).values
        best = torch.topk(torch.cat([best, top], dim=1), min(depth, best.shape[1] + top.shape[1]), dim=1).values
        sel = (pairs_r >= r0) & (pairs_r < r0 + c.shape[0])
        if sel.any():
            pair_s[sel] = (c[pairs_r[sel] - r0] * qvecs[pairs_q[sel]]).sum(dim=1)
    pair_s = pair_s.cpu().tolist()
    out, j = [], 0
    for rows in served_rows:
        got = [None if math.isnan(v) else v for v in pair_s[j : j + len(rows)]]
        out.append(got)
        j += len(rows)
    return best.cpu().tolist(), out


def rrf_one_list(ranked, limit: int, rrf_k: float, weight: float):
    """Reciprocal-rank fusion of one ranked list of (doc id, score), as the
    searcher fuses a lone vector arm: each doc scores weight / (rrf_k + 1
    + rank) at its best rank, so the list keeps its order. Returns the
    first ``limit`` as (doc id, fused score, lexical score, vector score)."""
    out, seen = [], set()
    for rank, (doc, score) in enumerate(ranked):
        if doc not in seen:
            seen.add(doc)
            out.append((doc, 1.0 / (rrf_k + 1.0 + rank) * weight, None, score))
    return out[:limit]
