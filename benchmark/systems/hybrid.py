"""A hybrid library deployment: the port's ``TwoTierSearcher`` over a
``TwoTierIndex`` of one fast tier (a ``DeviceVectorIndex`` built with
``from_padded``), a Model2Vec fast embedder, and a ``BulkDeviceBm25Index``
over the seeded docs as its lexical arm, built as the library's
``IndexBuilder`` builds one (with its fallback where the native postings
builder cannot serve the corpus).

``build`` hands the program its inputs in the form it serves them; the
reference makes its own copy from the same seed after the window
(harness/lexical_reference.py). ``judge`` holds what the caller received
against that reference: each query's final results alone.
"""

from __future__ import annotations

import collections
import itertools
import sys
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from benchmark.harness import data, lexical_reference as lexref, spec as specs

#: how many of each arm's best docs the reference keeps a query: past every
#: depth the searcher asks for, so each rank's tolerance can be counted
REF_DEPTH = 128
#: the most readings of one query's fused scores as arm ranks that the
#: fusion check tries
MAX_COMBOS = 64
#: the query-class budget multipliers of the searcher's published contract
#: (1-3 words: lexical 1, vector 1; 4 or more: lexical 0.5, vector 2); a
#: batch's budget is the largest over its queries, so a query's arm depth
#: lies between its own class's and the largest class's
SHORT_WORDS = 3
MULTIPLIERS = {"short": (1.0, 1.0), "natural": (0.5, 2.0)}


@dataclass
class System:
    searcher: object
    embedder: object  # the Model2VecEmbedder
    fast: object  # the fast tier's DeviceVectorIndex
    lexical: object  # the lexical arm
    n_docs: int
    n_pad: int
    dim: int
    layout: dict = field(default_factory=dict)  # what was built, for the log


def documents(seed: int, cfg: dict) -> list:
    """The corpus as the library ingests it: one ``IndexableDocument`` a
    doc, ids in row order, no title."""
    from frankensearch_tpu_torch import IndexableDocument

    texts = lexref.doc_texts(seed, cfg["corpus"], cfg["docs"]).strings()
    return [IndexableDocument(doc_id=d, content=t) for d, t in zip(data.doc_ids(cfg["docs"]), texts)]


def lexical_arm(docs: list, device, layout: dict):
    """``BulkDeviceBm25Index`` over the docs, or where the native postings
    builder cannot serve them, ``DeviceBm25Index`` over a bulk-built
    ``MemoryLexicalIndex`` (the library's own fallback)."""
    from frankensearch_tpu_torch.lexical.device_bm25 import (
        BulkDeviceBm25Index,
        DeviceBm25Index,
        NativePostingsUnavailable,
    )
    from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

    try:
        arm = BulkDeviceBm25Index(docs, device=device)
        layout["lexical"] = "bulk"
    except NativePostingsUnavailable as e:
        print(f"lexical arm: {e}; the memory index serves instead", file=sys.stderr)
        arm = DeviceBm25Index(MemoryLexicalIndex.bulk_build(docs), device=device)
        layout["lexical"] = "memory"
    return arm


def bf16_factors(arm, device):
    """The control's arm: the same postings, with BM25's two factors, each
    term's idf and each posting's tf-side value, rounded to bf16 (the
    precision below the f32 the configuration states); the products and
    sums stay f32."""
    from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()

    terms, docs, tf = arm._post_host
    arms = {name: replace(a, idf_host=bf16(a.idf_host)) for name, a in arm._arms.items()}
    return DeviceBm25Index.from_postings(terms, docs, bf16(tf), arms, arm.doc_ids, arm.vocab_size, device=device)


def _arm_layout(arm) -> dict:
    out = {"postings": int(arm.posting_count), "blocked": arm._blocked is not None}
    if arm._blocked is not None:
        out["classes"] = len(arm._blocked.classes)
        out["tail_postings"] = int(arm.cold_posting_count)
    if arm._hot is not None:
        out["hot_terms"] = int(arm._hot.n_hot)
        out["hot_bytes"] = int(arm._hot.hbm_bytes)
    return out


def build(cfg: dict, seed: int, device) -> System:
    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder, SimpleWordTokenizer
    from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex

    vector = specs.plugin("systems", "vector")
    layout: dict = {}
    t0 = time.perf_counter()
    emb_cfg = cfg["embedder"]
    table = vector.embedding_table(seed, emb_cfg["rows"], emb_cfg["dim"], device)
    vocab = data.vocabulary(emb_cfg["rows"])
    embedder = Model2VecEmbedder(
        table.float().cpu().numpy(), SimpleWordTokenizer({w: i for i, w in enumerate(vocab)}),
        device=device, embedder_id=emb_cfg["id"], revision=str(seed), param_dtype=emb_cfg["dtype"],
    )
    del table
    layout["table_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_docs, dim = cfg["docs"], cfg["dim"]
    slab, mask = vector.fast_slab(seed, n_docs, dim, device)
    fast = DeviceVectorIndex.from_padded(slab, mask, data.doc_ids(n_docs), embedder.identity())
    layout["fast_tier_s"] = time.perf_counter() - t0
    layout["slab"] = list(slab.shape)

    t0 = time.perf_counter()
    docs = documents(seed, cfg)
    layout["docs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arm = lexical_arm(docs, device, layout)
    del docs
    if cfg.get("control") == "bm25-bf16":
        arm = bf16_factors(arm, device)
    layout["lexical_s"] = time.perf_counter() - t0
    layout.update(_arm_layout(arm))

    s = cfg["searcher"]
    searcher = TwoTierSearcher(
        TwoTierIndex(fast), embedder, lexical=arm,
        config=TwoTierConfig(
            fast_only=s["fast_only"], rrf_k=s["rrf_k"], candidate_multiplier=s["candidate_multiplier"],
            lexical_rrf_weight=s["lexical_rrf_weight"], fast_rrf_weight=s["fast_rrf_weight"],
            scan_mode=s.get("scan_mode", "auto"),
        ),
    )
    serve = searcher.search_batch

    def search_batch(queries, k=10, **kwargs):
        """The searcher's own call, each outcome then tagged with the
        batch's lexical lane for the check's log (a few us a batch)."""
        out = serve(queries, k, **kwargs)
        for o in out:
            o.batch_lane = searcher.last_phase1_lex_lane
        return out

    searcher.search_batch = search_batch
    return System(searcher, embedder, fast, arm, n_docs, slab.shape[0], dim, layout)


def _k3_shapes(args):
    """What ``flat_class_fused`` is given by one ``_graded_scan_flat`` call:
    (n_c, l_c, d_pad, B, T, hot partial given) of each class it launches
    K3 on (a class of no block, or no query, launches nothing)."""
    classes, q_ids, _, s_phys = args[:4]
    b, t = q_ids.shape
    return [(c.term_t.shape[0], c.term_t.shape[1], c.term_t.shape[2], b, t, s_phys is not None)
            for c in classes if c.term_t.shape[0] and b]


def traced(system) -> list:
    """(object, function, span, note) of each layer call a traced run
    times: the flat lane's pass over the classes (its K3 launches, noted
    with their shapes for ``flat_roofline``)."""
    from frankensearch_tpu_torch.lexical import device_bm25

    return [(device_bm25, "_graded_scan_flat", "lexical.flat_scan", _k3_shapes)]


def counters() -> dict:
    """The program's launch counters of the pass's kernels: K1, K2, K3,
    and the term-driven lane's calls where the program counts them."""
    from frankensearch_tpu_torch.lexical import daat, device_bm25
    from frankensearch_tpu_torch.ops import topk_scan as ts

    out = {"group_max": ts.group_max, "gather_rescore": ts.gather_rescore,
           "flat_class_fused": device_bm25.flat_class_fused}
    if hasattr(daat.daat_topk_tm, "launches"):
        out["daat"] = daat.daat_topk_tm
    return out


def _row(doc: str, n_docs: int) -> int | None:
    try:
        row = data.row_of_doc(doc)
    except (ValueError, IndexError):
        return None
    return row if 0 <= row < n_docs and doc == data.doc_id(row) else None


def depths(text: str, k: int, multiplier: int) -> tuple[list[int], list[int]]:
    """The lexical and vector depths a query's arms may have been asked
    for: its own class's, up to the largest class's (a batch asks every
    query for its largest)."""
    own = MULTIPLIERS["short" if len(text.split()) <= SHORT_WORDS else "natural"]
    top = tuple(max(m[a] for m in MULTIPLIERS.values()) for a in (0, 1))
    base = k * multiplier
    return tuple(sorted({max(int(base * m), k) for m in (own[a], top[a])}) for a in (0, 1))


class _Arm:
    """One arm's exact best docs for one query, and the ranks its score
    tolerance admits: a doc of exact score x may stand anywhere from the
    count of docs above x + lim to the count of others at or above x - lim."""

    def __init__(self, top, lim: float) -> None:
        self.s, self.rows = np.asarray(top[0], np.float64), [int(r) for r in top[1]]
        self.lim = lim
        self.neg = -self.s  # ascending, for searchsorted
        self.exact = dict(zip(self.rows, self.s.tolist()))
        self.cut = len(self.rows) == REF_DEPTH  # docs lie past the list

    def lo(self, x: float) -> int:
        return int(np.searchsorted(self.neg, -(x + self.lim), side="left"))

    def hi(self, x: float, row: int) -> float:
        n = int(np.searchsorted(self.neg, -(x - self.lim), side="right"))
        if self.cut and n == len(self.rows):
            return float("inf")
        return n - (row in self.exact and self.exact[row] >= x - self.lim)


def _fill(arm: _Arm, pinned: dict, excluded: set, depth: int, exact: dict, positive: bool):
    """The arm's list as the port may have served it: the docs whose ranks
    the fused scores give at those ranks, the rest in exact order, none of
    ``excluded`` (served without this arm's score). None where no such
    list lies inside the tolerance."""
    slots = [None] * depth
    for r, row in pinned.items():
        slots[r] = row
    rest = (r for r in arm.rows if r not in pinned.values() and r not in excluded)
    for j in range(depth):
        if slots[j] is None:
            slots[j] = next(rest, None)
    n = next((j for j, r in enumerate(slots) if r is None), depth)
    if any(r is not None for r in slots[n:]):
        return None  # a hole above a pinned doc
    out = slots[:n]
    for j, row in enumerate(out):
        x = exact[row] if row in exact else arm.exact[row]
        if not (arm.lo(x) <= j <= arm.hi(x, row)):
            return None
    for row in itertools.chain(excluded, (r for r in arm.rows if r not in out and r not in excluded)):
        x = exact[row] if row in exact else arm.exact[row]
        if (not positive or x > 0.0) and (n < depth or arm.hi(x, row) < depth):
            return None  # a doc the list had to hold
    return out


def _decode(score: float, has_l: bool, has_v: bool, cl: np.ndarray, cv: np.ndarray) -> list:
    """Every (lexical rank, vector rank) whose contributions sum to the
    served fused score exactly (None for an arm that does not hold the doc)."""
    if has_l and has_v:
        i, j = np.nonzero(cl[:, None] + cv[None, :] == score)
        return list(zip(i.tolist(), j.tolist()))
    if has_l:
        return [(i, None) for i in np.flatnonzero(cl == score).tolist()]
    if has_v:
        return [(None, j) for j in np.flatnonzero(cv == score).tolist()]
    return []


def _fusion(served, lex: _Arm, vec: _Arm, lex_exact: dict, vec_exact: dict, lex_depths, vec_depths,
            k: int, s: dict):
    """Whether the served list is reciprocal-rank fusion of some lexical
    and vector lists inside their tolerance, and each served doc's (lexical
    rank, vector rank) in the first reading that fits (or, where none does,
    in the first reading of its fused score)."""
    cl = lexref.contributions(max(lex_depths), s["rrf_k"], s["lexical_rrf_weight"])
    cv = lexref.contributions(max(vec_depths), s["rrf_k"], s["fast_rrf_weight"])
    options = [_decode(f, ls is not None, vs is not None, cl, cv) for _, f, ls, vs in served]
    first = [o[0] if o else (None, None) for o in options]
    if not all(options):
        return False, first
    for d_l, d_v in itertools.product(lex_depths, vec_depths):
        for combo in itertools.islice(itertools.product(*options), MAX_COMBOS):
            ranks = list(combo)
            if _fits(served, ranks, lex, vec, lex_exact, vec_exact, d_l, d_v, k, s):
                return True, ranks
    return False, first


def _fits(served, ranks, lex, vec, lex_exact, vec_exact, d_l, d_v, k, s) -> bool:
    lists = []
    for a, (arm, exact, depth, positive) in enumerate(((lex, lex_exact, d_l, True), (vec, vec_exact, d_v, False))):
        pinned, excluded = {}, set()
        for (row, *_), rr in zip(served, ranks):
            if rr[a] is None:
                excluded.add(row)
            elif rr[a] >= depth or rr[a] in pinned:
                return False
            else:
                pinned[rr[a]] = row
        # the port ranks its own scores: rank order is served-score order
        order = sorted(pinned.items())
        got = {row: sc[a] for row, _, *sc in served}
        if any(got[r1] < got[r2] or (got[r1] == got[r2] and r1 > r2)
               for (_, r1), (_, r2) in zip(order, order[1:])):
            return False
        filled = _fill(arm, pinned, excluded, depth, exact, positive)
        if filled is None:
            return False
        lists.append([(row, got[row] if row in got else arm.exact[row]) for row in filled])
    want = lexref.rrf_two_arms(lists[0], lists[1], k, s["rrf_k"], s["lexical_rrf_weight"], s["fast_rrf_weight"])
    return [(r, f, ls is None, vs is None) for r, f, ls, vs in want] == \
        [(r, f, ls is None, vs is None) for r, f, ls, vs in served]


def judge(cfg: dict, seed: int, picked: list, k: int, device) -> dict:
    """{number: [value, limit]} for the sampled (query text, outcome)
    pairs of requests for the top ``k``. Each final result carries its
    fused score (``score``), its BM25 score (``lexical_score``) where the
    lexical arm held it and its vector score (``fast_score``) where the
    vector arm did:

    - ``unfused``: queries served off the fused phase-1 pass (limit 0:
      the deployment is the fused pass);
    - ``malformed``: queries whose results cannot be right whatever the
      precision: fewer than ``k``, a doc id that names no doc, a doc twice,
      a result with neither arm's score, fused scores that rise (limit 0);
    - ``fusion_mismatch``: queries whose results are not reciprocal-rank
      fusion (rrf_k, the arms' weights, each arm's depth from the query
      classes' budgets) of the two arms' exact lists, where the only order
      allowed to differ is among docs whose exact scores in one arm lie
      within that arm's score limit of each other (limit 0);
    - ``vec_score_err`` and ``lex_score_err``: the widest gap of a served
      vector score from the exact cosine, and of a served BM25 score from
      the exact float64 BM25;
    - ``vec_rank_gap`` and ``lex_rank_gap``: the widest amount by which the
      doc at an arm's rank j (as the fused score places it) lies below the
      reference's j-th best in that arm.
    """
    limits, s, n_docs = cfg["checks"], cfg["searcher"], cfg["docs"]
    texts = [t for t, _ in picked]
    malformed, served = set(), []
    for i, (_, outcome) in enumerate(picked):
        results = list(outcome.results)
        rows = [_row(r.doc_id, n_docs) for r in results]
        fused = [r.score for r in results]
        if (len(results) < min(k, n_docs) or None in rows or len(set(rows)) != len(rows)
                or any(r.lexical_score is None and r.fast_score is None for r in results)
                or any(b > a for a, b in zip(fused, fused[1:]))):
            malformed.add(i)
        served.append([] if i in malformed else
                      [(row, r.score, r.lexical_score, r.fast_score) for row, r in zip(rows, results)])
    served_rows = [[row for row, *_ in q] for q in served]
    lex_tops, lex_exact = lexref.lexical_arm(seed, cfg, texts, served_rows, REF_DEPTH)
    vec_tops, vec_exact = lexref.vector_arm(seed, cfg, texts, served_rows, REF_DEPTH, device)

    lex_err = vec_err = lex_gap = vec_gap = 0.0
    mismatch = 0
    for i, q in enumerate(served):
        if i in malformed:
            continue
        lx = dict(zip(served_rows[i], lex_exact[i]))
        vx = dict(zip(served_rows[i], vec_exact[i]))
        for row, _, ls, vs in q:
            if ls is not None:
                lex_err = max(lex_err, abs(ls - lx[row]))
            if vs is not None:
                vec_err = max(vec_err, abs(vs - vx[row]))
        lex, vec = _Arm(lex_tops[i], limits["lex_score_err"]), _Arm(vec_tops[i], limits["vec_score_err"])
        lex_depths, vec_depths = depths(texts[i], k, s["candidate_multiplier"])
        ok, ranks = _fusion(q, lex, vec, lx, vx, lex_depths, vec_depths, k, s)
        mismatch += not ok
        for (row, *_), (rl, rv) in zip(q, ranks):
            if rl is not None and rl < len(lex.s):
                lex_gap = max(lex_gap, lex.s[rl] - lx[row])
            if rv is not None and rv < len(vec.s):
                vec_gap = max(vec_gap, vec.s[rv] - vx[row])
    lanes = collections.Counter((getattr(o, "batch_lane", None), getattr(o.metrics, "lexical_lane", None))
                                for _, o in picked)
    print(f"judged queries by (batch lane, own lane): {dict(lanes)}", file=sys.stderr)
    unfused = sum(not o.metrics.phase1_fused for _, o in picked)
    return {"unfused": [unfused, 0], "malformed": [len(malformed), 0], "fusion_mismatch": [mismatch, 0],
            "vec_score_err": [vec_err, limits["vec_score_err"]],
            "vec_rank_gap": [float(vec_gap), limits["vec_rank_gap"]],
            "lex_score_err": [lex_err, limits["lex_score_err"]],
            "lex_rank_gap": [float(lex_gap), limits["lex_rank_gap"]]}
