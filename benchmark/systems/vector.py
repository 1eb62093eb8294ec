"""A vector-only library deployment: the port's ``TwoTierSearcher`` over a
``TwoTierIndex`` of one fast tier (a ``DeviceVectorIndex`` built with
``from_padded``) and a Model2Vec fast embedder, with no lexical arm.

``build`` hands the program its inputs in the form it serves them; the
reference makes its own copy from the same seed after the window
(harness/reference.py). ``judge`` holds what the caller received against
that reference: nothing but each query's final results.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from benchmark.harness import data, reference

ROW_PAD = 8192  # the port pads the fast tier's rows to this


@dataclass
class System:
    searcher: object
    embedder: object  # the Model2VecEmbedder
    fast: object  # the fast tier's DeviceVectorIndex
    n_docs: int
    n_pad: int
    dim: int
    layout: dict = field(default_factory=dict)  # what was built, for the log


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fast_slab(seed: int, n_docs: int, dim: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The fast tier's padded bf16 slab of seeded unit rows and its
    additive mask (0 on live rows, -inf on padding)."""
    n_pad = round_up(max(n_docs, 1), ROW_PAD)
    slab = torch.zeros((n_pad, round_up(dim, 128)), dtype=torch.bfloat16, device=device)
    for r0, rows in data.unit_rows(seed, "doc-vectors", n_docs, dim, device):
        slab[r0 : r0 + rows.shape[0], :dim] = rows
    mask = torch.full((n_pad,), float("-inf"), dtype=torch.float32, device=device)
    mask[:n_docs] = 0.0
    return slab, mask


def embedding_table(seed: int, rows: int, dim: int, device) -> torch.Tensor:
    """The static embedding table: seeded unit rows in bf16, as served."""
    table = torch.empty((rows, dim), dtype=torch.bfloat16, device=device)
    for r0, chunk in data.unit_rows(seed, "embedding-table", rows, dim, device):
        table[r0 : r0 + chunk.shape[0]] = chunk
    return table


def build(cfg: dict, seed: int, device) -> System:
    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder, SimpleWordTokenizer
    from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex

    layout: dict = {}
    t0 = time.perf_counter()
    emb_cfg = cfg["embedder"]
    table = embedding_table(seed, emb_cfg["rows"], emb_cfg["dim"], device)
    vocab = data.vocabulary(emb_cfg["rows"])
    # the table goes in as the f32 values of its bf16 rows, so the
    # embedder's bf16 copy holds exactly these bits
    embedder = Model2VecEmbedder(
        table.float().cpu().numpy(), SimpleWordTokenizer({w: i for i, w in enumerate(vocab)}),
        device=device, embedder_id=emb_cfg["id"], revision=str(seed), param_dtype=emb_cfg["dtype"],
    )
    del table
    layout["table_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_docs, dim = cfg["docs"], cfg["dim"]
    slab, mask = fast_slab(seed, n_docs, dim, device)
    fast = DeviceVectorIndex.from_padded(slab, mask, data.doc_ids(n_docs), embedder.identity())
    layout["fast_tier_s"] = time.perf_counter() - t0
    layout["slab"] = list(slab.shape)

    s = cfg["searcher"]
    searcher = TwoTierSearcher(
        TwoTierIndex(fast), embedder,
        config=TwoTierConfig(
            fast_only=s["fast_only"], rrf_k=s["rrf_k"], candidate_multiplier=s["candidate_multiplier"],
            lexical_rrf_weight=s["lexical_rrf_weight"], fast_rrf_weight=s["fast_rrf_weight"],
            scan_mode=s.get("scan_mode", "auto"),
        ),
    )
    return System(searcher, embedder, fast, n_docs, slab.shape[0], dim, layout)


def _scan_shape(args):
    queries, k = args[0], args[1]
    return (len(queries) if queries.ndim > 1 else 1, k)


def traced(system) -> list:
    """(object, method, span, note) of each layer call a traced run times."""
    return [(system.fast, "search_batch", "index.search_batch", _scan_shape),
            (system.embedder, "embed_batch", "embed.embed_batch", None)]


def counters() -> dict:
    """The program's launch counters of the exact scan's kernels."""
    from frankensearch_tpu_torch.ops import topk_scan as ts

    return {"group_max": ts.group_max, "gather_rescore": ts.gather_rescore}


def _row(doc: str, n_docs: int) -> int | None:
    try:
        row = data.row_of_doc(doc)
    except (ValueError, IndexError):
        return None
    return row if 0 <= row < n_docs and doc == data.doc_id(row) else None


def judge(cfg: dict, seed: int, picked: list, k: int, device) -> dict:
    """{number: [value, limit]} for the sampled (query text, outcome)
    pairs of requests for the top ``k``. The vector arm is the only arm,
    so each final result carries its vector score (``fast_score``) and the
    results come in the arm's order:

    - ``malformed``: queries whose results cannot be right whatever the
      precision: fewer than ``k``, a doc id that names no doc, a doc twice,
      a result with no vector score or with a lexical one, vector scores
      that rise down the list (limit 0);
    - ``fusion_mismatch``: queries whose results differ from
      reciprocal-rank fusion of the list they came in, in doc ids, order
      or any score (limit 0: the same float64 arithmetic);
    - ``vec_score_err``: the widest gap between a served vector score and
      the doc's exact cosine;
    - ``vec_rank_gap``: the widest amount by which the j-th result's exact
      cosine lies below the reference's j-th best.
    """
    limits = cfg["checks"]
    s = cfg["searcher"]
    n_docs = cfg["docs"]
    texts = [t for t, _ in picked]
    malformed, served_rows, served = set(), [], []
    for i, (_, outcome) in enumerate(picked):
        results = list(outcome.results)
        rows = [_row(r.doc_id, n_docs) for r in results]
        fast = [r.fast_score for r in results]
        if (len(results) < min(k, n_docs) or None in rows or len(set(rows)) != len(rows) or None in fast
                or any(r.lexical_score is not None for r in results)
                or any(b > a for a, b in zip(fast, fast[1:]))):
            malformed.add(i)
        served_rows.append([] if i in malformed else rows)
        served.append(fast)
    qv = reference.query_vectors(seed, cfg, texts, device)
    best, exact = reference.vector_scores(seed, cfg, qv, served_rows, k)
    vec_err = vec_gap = 0.0
    for i in range(len(picked)):
        if i in malformed:
            continue
        for j, (got, ex) in enumerate(zip(served[i], exact[i])):
            vec_err = max(vec_err, abs(got - ex))
            vec_gap = max(vec_gap, best[i][j] - ex)

    mismatch = 0
    for i, (_, outcome) in enumerate(picked):
        arm = [(r.doc_id, r.fast_score) for r in outcome.results]
        want = reference.rrf_one_list(arm, k, float(s["rrf_k"]), s["fast_rrf_weight"])
        got = [(r.doc_id, r.score, r.lexical_score, r.fast_score) for r in outcome.results]
        if got != want:
            mismatch += 1
    return {"malformed": [len(malformed), 0], "fusion_mismatch": [mismatch, 0],
            "vec_score_err": [vec_err, limits["vec_score_err"]],
            "vec_rank_gap": [vec_gap, limits["vec_rank_gap"]]}
