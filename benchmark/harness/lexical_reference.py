"""The plain reference of a hybrid cell: the exact BM25 of every doc, the
exact cosine of every doc, and reciprocal-rank fusion of the two arms,
worked out again from the run's seed in float64.

It imports nothing of the program. It makes the corpus again itself
(:func:`doc_texts`, drawn from the seed as the system drew it), and
scores it with BM25 as Lucene and Tantivy publish it:

    idf(t)   = ln(1 + (N - df(t) + 0.5) / (df(t) + 0.5))
    norm(d)  = k1 * (1 - b + b * fieldnorm(|d|) / avgdl)
    score    = sum over the query's distinct terms, per field,
               boost * idf(t) * (k1 + 1) * tf / (tf + norm(d))

with k1 = 1.2 and b = 0.75 (Tantivy's defaults), ``fieldnorm`` Tantivy's
256-bucket length table (Lucene's SmallFloat byte4, written out below from
its definition), avgdl the field's tokens over N, and the content field at
boost 1 beside the title field at boost 2. The vector arm's exact cosine
reuses harness/reference.py's query vectors and the seeded doc rows.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import data, reference

K1 = 1.2
B = 0.75
BOOSTS = {"content": 1.0, "title": 2.0}
#: the stream the corpus's words are drawn from
TEXT_STREAM = "doc-texts"


def doc_texts(seed: int, corpus: dict, n: int) -> data.Texts:
    """The ``n`` docs' words: 1 + Poisson(``mean_words`` - 1) words a doc,
    zipf(``zipf``) over the first ``vocab`` words, from the seed."""
    rng = np.random.default_rng(data.sub_seed(seed, TEXT_STREAM))
    lengths = data.poisson_lengths(rng, corpus["mean_words"], n)
    return data.texts_of_lengths(rng, lengths, data.ZipfWords(corpus["zipf"], corpus["vocab"]))


def fieldnorm_table() -> np.ndarray:
    """(256,) the length each fieldnorm id stands for: ids 0-40 are the
    length itself; past them come 27 runs of 8 ids, the step doubling from
    2 at each run (42, 44, ..., 56, 60, ..., 88, 96, ...), to 2,013,265,944."""
    ids = np.arange(256, dtype=np.int64)
    run, j = (ids - 41) // 8, (ids - 41) % 8
    past = 40 + 16 * ((1 << np.maximum(run, 0)) - 1) + (j + 1) * (2 << np.maximum(run, 0))
    return np.where(ids <= 40, ids, past)


def fieldnorm(lengths: np.ndarray) -> np.ndarray:
    """The length each doc's field is scored at: the largest table entry
    not above its token count."""
    table = fieldnorm_table()
    return table[np.searchsorted(table, lengths, side="right") - 1]


class Bm25Field:
    """One field's postings in float64: term-major (doc, tf) runs, each
    doc's length norm, each term's idf."""

    def __init__(self, texts: data.Texts, n_docs: int, vocab: int, boost: float) -> None:
        lengths = texts.lengths()
        doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
        key, tf = np.unique(texts.words.astype(np.int64) * n_docs + doc_of, return_counts=True)
        self.term, self.doc, self.tf = key // n_docs, key % n_docs, tf.astype(np.float64)
        self.ptr = np.zeros(vocab + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.term, minlength=vocab), out=self.ptr[1:])
        df = np.diff(self.ptr).astype(np.float64)
        self.idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
        avgdl = lengths.sum() / n_docs if n_docs else 1.0
        self.norm = K1 * (1.0 - B + B * fieldnorm(lengths).astype(np.float64) / max(avgdl, 1e-300))
        self.boost = boost

    def add_scores(self, out: np.ndarray, terms) -> None:
        for t in terms:
            lo, hi = self.ptr[t], self.ptr[t + 1]
            if hi > lo:
                docs, tf = self.doc[lo:hi], self.tf[lo:hi]
                out[docs] += self.boost * self.idf[t] * (K1 + 1.0) * tf / (tf + self.norm[docs])


class Bm25:
    """The corpus of a run, every field of it, made again from the seed."""

    def __init__(self, seed: int, cfg: dict) -> None:
        corpus, n = cfg["corpus"], cfg["docs"]
        self.n_docs = n
        fields = {"content": doc_texts(seed, corpus, n)}
        if corpus.get("titles"):
            raise ValueError("the reference draws no titles: a corpus with titles needs their draw here")
        # a corpus with no titles: the title field holds no token
        fields["title"] = data.Texts(np.zeros(0, np.int32), np.zeros(n + 1, np.int64))
        self.fields = [Bm25Field(texts, n, corpus["vocab"], BOOSTS[name]) for name, texts in fields.items()]

    def scores(self, text: str) -> np.ndarray:
        """(N,) float64 BM25 of every doc for a query text."""
        terms = sorted(set(reference.words_of(text)))
        out = np.zeros(self.n_docs, dtype=np.float64)
        for f in self.fields:
            f.add_scores(out, terms)
        return out


def top_rows(scores: np.ndarray, m: int, *, positive: bool) -> tuple[np.ndarray, np.ndarray]:
    """The ``m`` best (scores, rows) of a score vector, score descending and
    row ascending among equals, only scores above 0 when ``positive``."""
    if len(scores) > m:
        cut = np.partition(scores, len(scores) - m)[len(scores) - m]
        rows = np.flatnonzero(scores >= cut)
    else:
        rows = np.arange(len(scores))
    if positive:
        rows = rows[scores[rows] > 0.0]
    rows = rows[np.lexsort((rows, -scores[rows]))][:m]
    return scores[rows], rows


def lexical_arm(seed: int, cfg: dict, texts: list[str], served_rows: list[list[int]], m: int):
    """For each query: its ``m`` best (scores, rows) with score above 0, and
    the exact BM25 of each row in ``served_rows[i]``."""
    bm25 = Bm25(seed, cfg)
    tops, exact = [], []
    for text, rows in zip(texts, served_rows):
        s = bm25.scores(text)
        tops.append(top_rows(s, m, positive=True))
        exact.append([float(s[r]) for r in rows])
    return tops, exact


def vector_arm(seed: int, cfg: dict, texts: list[str], served_rows: list[list[int]], m: int, device):
    """For each query: its ``m`` best exact cosines as (scores, rows),
    score descending and row ascending among equals, and the exact cosine
    of each row in ``served_rows[i]``. Doc rows are made again chunk by
    chunk (harness/data.py), the query vectors by harness/reference.py."""
    qv = reference.query_vectors(seed, cfg, texts, device)
    s = qv.shape[0]
    best_s = torch.full((s, 0), float("-inf"), dtype=torch.float64, device=device)
    best_r = torch.zeros((s, 0), dtype=torch.int64, device=device)
    pairs_q = torch.tensor([i for i, rows in enumerate(served_rows) for _ in rows], dtype=torch.int64, device=device)
    pairs_r = torch.tensor([r for rows in served_rows for r in rows], dtype=torch.int64, device=device)
    pair_s = torch.full((len(pairs_r),), float("nan"), dtype=torch.float64, device=device)
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[cfg["slab_dtype"]]
    for r0, chunk in data.unit_rows(seed, "doc-vectors", cfg["docs"], cfg["dim"], device, dtype):
        c = chunk.double()
        scores = (c @ qv.T).T  # (S, rows)
        rows = torch.arange(r0, r0 + c.shape[0], dtype=torch.int64, device=device).expand(s, -1)
        cat_s, cat_r = torch.cat([best_s, scores], dim=1), torch.cat([best_r, rows], dim=1)
        # rows ascend within the concatenation, so a stable sort keeps the
        # lower row first among equal scores
        order = torch.sort(cat_s, dim=1, descending=True, stable=True).indices[:, :m]
        best_s, best_r = torch.gather(cat_s, 1, order), torch.gather(cat_r, 1, order)
        sel = (pairs_r >= r0) & (pairs_r < r0 + c.shape[0])
        if sel.any():
            pair_s[sel] = (c[pairs_r[sel] - r0] * qv[pairs_q[sel]]).sum(dim=1)
    best_s, best_r, pair_s = best_s.cpu().numpy(), best_r.cpu().numpy(), pair_s.cpu().tolist()
    tops = [(best_s[i], best_r[i]) for i in range(s)]
    exact, j = [], 0
    for rows in served_rows:
        exact.append(pair_s[j : j + len(rows)])
        j += len(rows)
    return tops, exact


def contributions(depth: int, rrf_k: float, weight: float) -> np.ndarray:
    """(depth,) each rank's RRF contribution, weight / (rrf_k + 1 + rank)."""
    return (1.0 / ((float(rrf_k) + 1.0) + np.arange(depth, dtype=np.float64))) * float(weight)


def rrf_two_arms(lexical, vector, limit: int, rrf_k: float, w_lex: float, w_vec: float):
    """Reciprocal-rank fusion of a lexical and a vector list of (row,
    score), each best first: a doc scores the sum of weight / (rrf_k + 1 +
    rank) over the arms that hold it, the lexical term first, and docs come
    in order of that sum (descending), then in both arms before in one,
    then lexical score descending (none last), then row ascending. Returns
    the first ``limit`` as (row, fused score, lexical score or None, vector
    score or None)."""
    cl = contributions(len(lexical), rrf_k, w_lex)
    cv = contributions(len(vector), rrf_k, w_vec)
    docs: dict = {}
    for rank, (row, score) in enumerate(lexical):
        docs[row] = [cl[rank], score, None]
    for rank, (row, score) in enumerate(vector):
        if row in docs:
            docs[row][0] = docs[row][0] + cv[rank]
            docs[row][2] = score
        else:
            docs[row] = [cv[rank], None, score]
    order = sorted(docs.items(), key=lambda kv: (-kv[1][0], kv[1][1] is None or kv[1][2] is None,
                                                 -kv[1][1] if kv[1][1] is not None else float("inf"), kv[0]))
    return [(row, fused, lex, vec) for row, (fused, lex, vec) in order[:limit]]
