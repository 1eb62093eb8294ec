"""Device-side BM25 scoring, dense lane (PyTorch port).

Port of the dense small-corpus lane of frankensearch_tpu/lexical/device_bm25.py.
The postings live on the device as three flat arrays

    post_term (P,) i32   term id of posting p
    post_doc  (P,) i32   doc row of posting p
    post_tf   (P,) f32   precomputed tf-side score
                         boost * (k1+1) * tf / (tf + norm_cache[normid[doc]])

and a batch of queries is q_idf (B, V), the idf weights of its terms:

    contrib (P, B) = post_tf[p] * q_idf[b, post_term[p]]
    scores (N, B)  = per-doc sum of contrib
    top-k over docs, (score desc, row asc).

The per-doc sum must be deterministic (solo-vs-batch bit purity), so it is
not a float-atomic scatter: a doc-major plan built once at upload visits
each doc's postings in their posting order, one "step" per posting slot,
and adds them to a running f32 sum — the sequential order of the
reference's segment sum on the CPU, so the two agree bit for bit.

At or above ``BLOCKED_THRESHOLD_POSTINGS`` the reference switches to the
blocked/hot/DAAT lanes, which are not ported yet; building such a corpus
raises ``NotImplementedError``.

The host builders are copied from the reference (its module imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from frankensearch_tpu.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu.lexical.bm25 import BM25_K1, idf, tf_norm_cache
from frankensearch_tpu.lexical.memory_index import _BOOSTS, _FIELDS, MemoryLexicalIndex
from frankensearch_tpu.lexical.tokenizer import simple_tokenize
from frankensearch_tpu_torch.ops.topk_scan import topk_desc_rowasc

#: postings count from which the reference leaves the dense lane
BLOCKED_THRESHOLD_POSTINGS = 1 << 21


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class DocSteps(NamedTuple):
    """Doc-major plan of the postings for the deterministic per-doc sum.

    Docs are ranked by posting count, longest first; step j adds the j-th
    posting of every doc with more than j postings, and those docs are a
    prefix of the ranking. Postings with tf-side 0 (the upload padding) add
    exactly +0.0 and are left out."""

    posts: torch.Tensor  # (P',) int64 posting ids, step-major
    bounds: tuple[int, ...]  # step j = posts[bounds[j]:bounds[j+1]]
    doc_of_slot: torch.Tensor  # (n_docs,) int64: running-sum slot i -> doc row


def build_doc_steps(post_doc: np.ndarray, post_tf: np.ndarray, n_docs: int, device) -> DocSteps:
    live = np.flatnonzero(np.asarray(post_tf) != 0.0)
    docs = np.asarray(post_doc, dtype=np.int64)[live]
    order = live[np.argsort(docs, kind="stable")]  # doc asc, posting order kept
    counts = np.bincount(docs, minlength=n_docs)[:n_docs]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    doc_of_slot = np.argsort(-counts, kind="stable")
    neg_sorted = -counts[doc_of_slot]  # ascending
    pieces, bounds = [], [0]
    for j in range(int(counts.max()) if n_docs else 0):
        n_j = int(np.searchsorted(neg_sorted, -j, side="left"))  # docs with count > j
        pieces.append(order[starts[doc_of_slot[:n_j]] + j])
        bounds.append(bounds[-1] + n_j)
    posts = np.concatenate(pieces) if pieces else np.zeros(0, np.int64)
    return DocSteps(
        posts=torch.from_numpy(posts.astype(np.int64)).to(device),
        bounds=tuple(bounds),
        doc_of_slot=torch.from_numpy(doc_of_slot.astype(np.int64)).to(device),
    )


def _device_bm25(
    post_term: torch.Tensor,  # (P,) i32
    post_tf: torch.Tensor,  # (P,) f32
    steps: DocSteps,
    q_idf: torch.Tensor,  # (B, V) f32
    *,
    n_docs: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense BM25 top-k: ((B, k) f32 scores, (B, k) int64 doc rows)."""
    b = q_idf.shape[0]
    q_t = q_idf.T.contiguous()  # (V, B): one row gather per posting
    acc = torch.zeros((n_docs, b), dtype=torch.float32, device=q_idf.device)
    for j in range(len(steps.bounds) - 1):
        p = steps.posts[steps.bounds[j] : steps.bounds[j + 1]]
        acc[: p.shape[0]] += post_tf[p, None] * q_t[post_term[p].to(torch.int64)]
    scores = torch.empty_like(acc)
    scores[steps.doc_of_slot] = acc
    return topk_desc_rowasc(scores.T, min(k, n_docs))


@dataclass
class _FieldArm:
    term_ids: dict[str, int]
    idf_host: np.ndarray  # (V_field,) f32, indexed by (tid - base)
    boost: np.float32
    base: int = 0


class DeviceBm25Index(LexicalRead):
    """Immutable device-side snapshot of a committed lexical index."""

    def __init__(self, mem: MemoryLexicalIndex, *, device: torch.device) -> None:
        postings, field_stats, docs = mem.snapshot_postings()
        self._source = mem
        doc_ids = sorted(docs.keys())
        row_of = {d: i for i, d in enumerate(doc_ids)}
        n = len(doc_ids)

        arms: dict[str, _FieldArm] = {}
        terms_all: list[int] = []
        docs_all: list[int] = []
        tf_all: list[float] = []
        vocab_offset = 0
        for fname in _FIELDS:
            stats = field_stats[fname]
            field_postings = postings[fname]
            vocab = sorted(field_postings.keys())
            term_ids = {t: vocab_offset + i for i, t in enumerate(vocab)}
            cache = tf_norm_cache(stats.avgdl)
            boost = _BOOSTS[fname]
            idf_host = np.zeros(len(vocab), dtype=np.float32)
            for i, term in enumerate(vocab):
                plist = field_postings[term]
                idf_host[i] = idf(n, len(plist))
                for doc_id, tf in plist.items():
                    fid = docs[doc_id].fieldnorm_id.get(fname, 0)
                    tf32 = np.float32(tf)
                    tf_side = float(
                        np.float32(boost)
                        * (BM25_K1 + np.float32(1.0))
                        * tf32
                        / (tf32 + cache[fid])
                    )
                    terms_all.append(term_ids[term])
                    docs_all.append(row_of[doc_id])
                    tf_all.append(tf_side)
            arms[fname] = _FieldArm(
                term_ids=term_ids, idf_host=idf_host, boost=boost, base=vocab_offset
            )
            vocab_offset += len(vocab)
        self._init_state(
            doc_ids, arms, vocab_offset,
            np.asarray(terms_all, dtype=np.int64),
            np.asarray(docs_all, dtype=np.int64),
            np.asarray(tf_all, dtype=np.float32),
            device=device,
        )

    def _init_state(
        self, doc_ids, arms, vocab_size, terms_all, docs_all, tf_all, *, device
    ) -> None:
        """Doc table + query arms, then the postings upload (the dense
        branch of the reference's ``_upload_postings``)."""
        self.doc_ids = list(doc_ids)
        self._row_of = {d: i for i, d in enumerate(self.doc_ids)}
        self.n_docs = len(self.doc_ids)
        self._arms = arms
        self.vocab_size = int(vocab_size)
        p = len(terms_all)
        self.posting_count = p
        if p >= BLOCKED_THRESHOLD_POSTINGS:
            raise NotImplementedError(
                f"{p} postings >= {BLOCKED_THRESHOLD_POSTINGS}: the blocked, "
                "hot-arm and DAAT lexical lanes are not ported yet (ROADMAP: "
                "'Lexical at scale' and 'lexical/daat.py')"
            )
        p_pad = max(_round_up(max(p, 1), 128), 128)
        pt = np.zeros(p_pad, dtype=np.int32)
        pd = np.zeros(p_pad, dtype=np.int32)
        pf = np.zeros(p_pad, dtype=np.float32)  # padded postings score 0
        pt[:p] = terms_all
        pd[:p] = docs_all
        pf[:p] = tf_all
        self._post_term = torch.from_numpy(pt).to(device)
        self._post_tf = torch.from_numpy(pf).to(device)
        self.device = self._post_tf.device
        self._doc_steps = build_doc_steps(pd, pf, self.n_docs, device)

    # -- LexicalRead -------------------------------------------------------

    def doc_count(self) -> int:
        return self.n_docs

    def _query_terms(self, query: str) -> list[tuple[int, float]]:
        """Resolve a query's (term id, idf weight) pairs across all field
        arms (dedup per field)."""
        terms = simple_tokenize(query)
        out: list[tuple[int, float]] = []
        for arm in self._arms.values():
            seen: set[str] = set()
            for t in terms:
                if t in seen:
                    continue
                seen.add(t)
                tid = arm.term_ids.get(t)
                if tid is not None:
                    out.append((tid, float(arm.idf_host[tid - arm.base])))
        return out

    def _query_idf_rows(self, queries: list[str]) -> np.ndarray:
        v_pad = max(_round_up(max(self.vocab_size, 1), 128), 128)
        q = np.zeros((len(queries), v_pad), dtype=np.float32)
        for b, query in enumerate(queries):
            for tid, w in self._query_terms(query):
                q[b, tid] = w
        return q

    def search_candidates_batch(
        self, queries: list[str], budget: int
    ) -> list[list[LexicalCandidate]]:
        """Dense lane over the queries' idf rows. (The reference resolves
        sparse (B, T) query rows first, for the blocked/DAAT lanes, which
        are not ported yet.)"""
        if self.n_docs == 0 or not queries:
            return [[] for _ in queries]
        k = min(budget, self.n_docs)
        top_s, top_i = _device_bm25(
            self._post_term, self._post_tf, self._doc_steps,
            torch.from_numpy(self._query_idf_rows(queries)).to(self.device),
            n_docs=self.n_docs, k=k,
        )
        s, i = top_s.cpu().numpy(), top_i.to(torch.int32).cpu().numpy()
        return self._rows_to_candidates(s, i, len(queries))

    def _rows_to_candidates(
        self, s: np.ndarray, i: np.ndarray, n: int
    ) -> list[list[LexicalCandidate]]:
        out: list[list[LexicalCandidate]] = []
        for b in range(n):
            out.append([
                LexicalCandidate(doc_id=self.doc_ids[int(i[b, j])], score=float(s[b, j]))
                for j in range(s.shape[1])
                if s[b, j] > 0.0
            ])
        return out

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        return self.search_candidates_batch([query], budget)[0]

    def hydrate_candidates(self, doc_ids):
        if self._source is None:  # built from raw arrays: no stored fields
            return {}
        return self._source.hydrate_candidates(doc_ids)

    @classmethod
    def from_postings(
        cls, post_term, post_doc, post_tf, arms, doc_ids, vocab_size, *, device
    ) -> "DeviceBm25Index":
        """An index over given postings and query arms (no stored fields)."""
        index = cls.__new__(cls)
        index._source = None
        index._init_state(
            doc_ids, arms, vocab_size,
            np.asarray(post_term), np.asarray(post_doc), np.asarray(post_tf),
            device=device,
        )
        return index


class BulkDeviceBm25Index(DeviceBm25Index):
    """Device BM25 built straight from the native ingest kernel's flat
    arrays: tokenize+accumulate in C++, vectorized numpy for idf /
    fieldnorm / tf-side folding, then one upload."""

    def __init__(self, docs, *, device: torch.device, preview_chars: int = 240) -> None:
        from frankensearch_tpu import native
        from frankensearch_tpu.lexical.fieldnorm import field_norms_table

        # row order == doc_id order so the top-k's lower-row tiebreak
        # reproduces the oracle's (score desc, doc_id asc) contract
        docs = sorted(docs, key=lambda d: d.doc_id)
        self._source = None
        self._meta = {
            d.doc_id: {
                "title": d.title,
                "metadata": d.metadata,
                "preview": d.content[:preview_chars],
            }
            for d in docs
        }
        n_docs = len(docs)
        norm_table = np.asarray(field_norms_table(), dtype=np.int64)
        field_texts = {
            "content": [d.content for d in docs],
            "title": [(d.title or "") for d in docs],
        }
        arms: dict[str, _FieldArm] = {}
        parts_term, parts_doc, parts_tf = [], [], []
        vocab_offset = 0
        for fname in _FIELDS:
            bp = native.build_postings_native(field_texts[fname])
            if bp is None:
                raise RuntimeError(
                    "native kernel unavailable or non-ASCII corpus; use "
                    "DeviceBm25Index(MemoryLexicalIndex.bulk_build(docs)) instead"
                )
            counts = bp.doc_token_counts.astype(np.int64)
            n_field_docs = int((counts > 0).sum())
            if n_field_docs == 0:
                arms[fname] = _FieldArm({}, np.zeros(0, np.float32), _BOOSTS[fname], vocab_offset)
                continue
            avgdl = counts.sum() / n_field_docs
            fieldnorm_ids = np.searchsorted(norm_table, counts, side="right") - 1
            cache = tf_norm_cache(avgdl)
            n_terms = len(bp.terms)
            df = np.bincount(bp.post_term, minlength=n_terms).astype(np.float32)
            big_n = np.float32(n_docs)
            idf_host = np.log1p(
                (big_n - df + np.float32(0.5)) / (df + np.float32(0.5))
            ).astype(np.float32)
            boost = _BOOSTS[fname]
            tf32 = bp.post_tf.astype(np.float32)
            norms = cache[fieldnorm_ids[bp.post_doc]]
            tf_side = (
                np.float32(boost) * (BM25_K1 + np.float32(1.0)) * tf32 / (tf32 + norms)
            ).astype(np.float32)
            parts_term.append(bp.post_term.astype(np.int64) + vocab_offset)
            parts_doc.append(bp.post_doc.astype(np.int64))
            parts_tf.append(tf_side)
            arms[fname] = _FieldArm(
                term_ids={t: vocab_offset + i for i, t in enumerate(bp.terms)},
                idf_host=idf_host,
                boost=boost,
                base=vocab_offset,
            )
            vocab_offset += n_terms
        if parts_term:
            terms_all = np.concatenate(parts_term)
            docs_all = np.concatenate(parts_doc)
            tf_all = np.concatenate(parts_tf)
        else:
            terms_all = np.zeros(0, np.int64)
            docs_all = np.zeros(0, np.int64)
            tf_all = np.zeros(0, np.float32)
        self._init_state(
            [d.doc_id for d in docs], arms, vocab_offset,
            terms_all, docs_all, tf_all, device=device,
        )

    def hydrate_candidates(self, doc_ids):
        return {d: self._meta[d] for d in doc_ids if d in self._meta}
