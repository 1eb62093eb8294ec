"""Segmented device BM25: incremental seals without layout rebuilds.

Parity target: the reference's Quill keeper performs tiered
concat-merge compaction and its quiver blocks carry absolute first
doc-ids so merges copy bytes without rebasing
(crates/frankensearch-quill/src/keeper.rs:1-8, quiver.rs:1-8) —
appending a segment never rewrites the existing ones. The r4 TPU
layout instead rebuilt everything on every seal (the 1M term-major
lexsort alone is ~90 s host — VERDICT r4 next #3): this module is the
TPU recast of segment stacking.

Design:

- Every seal folds the unsealed window into a SMALL standalone device
  segment (its own row space, its own blocked/hot/term-major layouts at
  its own scale — usually the dense small-corpus kernel). The main
  segment's device arrays are untouched: update→searchable cost is the
  DELTA's build, not the corpus's.
- Reads fan out over the segments (each segment's own lane dispatch,
  unchanged purity: a query's lane within a segment depends only on the
  query and that segment's corpus constants) and merge per query by
  (score desc, doc_id asc) on the host — EXACT because segments hold
  DISJOINT doc sets, so no cross-segment score aggregation exists.
- IDF IS GLOBAL-FRESH: per-term df sums across segments and N is the
  total doc count, recomputed per query on the host (the reference
  recomputes idf at query time from searcher-level stats; Lucene-class
  engines do the same). A term whose frequency explodes in the delta
  immediately down-weights everywhere, including the old segment.
- AVGDL IS PER-SEGMENT (each segment's fieldnorm cache was folded into
  its tf-side values at ITS build): Lucene-semantics length norms that
  refresh at compaction. Documented divergence from the single-segment
  oracle: bounded by the avgdl drift between seals, zero after
  compaction (the delta lease bounds the window, and compaction folds
  every MAX_SEGMENTS seals).

Deletes/updates inside a window force the full republish path (a
tombstone in segment A cannot be expressed as an append in segment B
without cross-segment supersession — compaction semantics, out of the
append fast path by design).

The port's copy of frankensearch_tpu/lexical/segments.py: every segment
lives on one device, and ``append_segment`` builds the new segment there.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu_torch.lexical.bm25 import idf
from frankensearch_tpu_torch.lexical.tokenizer import simple_tokenize

#: seals per generation before compaction folds the stack (keeper.rs
#: tiered-merge role; also bounds the per-query fan-out)
MAX_SEGMENTS = 4


class SegmentedBm25(LexicalRead):
    """Disjoint-doc segment stack with global-idf fan-out reads."""

    def __init__(self, segments: Sequence[LexicalRead]) -> None:
        assert segments, "need at least one segment"
        self.segments = list(segments)
        self.n_docs = sum(s.n_docs for s in self.segments)
        # doc -> owning segment for hydration
        self._owner: dict[str, LexicalRead] = {}
        for seg in self.segments:
            for d in seg.doc_ids:
                self._owner[d] = seg

    @property
    def device(self):
        return self.segments[0].device

    # -- stats ---------------------------------------------------------------

    def doc_count(self) -> int:
        return self.n_docs

    @property
    def doc_ids(self) -> list[str]:
        out: list[str] = []
        for seg in self.segments:
            out.extend(seg.doc_ids)
        return out

    def _global_weights(self, terms: list[str]) -> dict[tuple[str, str], float]:
        """(field, term) -> global idf weight: df summed across segments,
        N = total docs. Segments without the term contribute df 0."""
        out: dict[tuple[str, str], float] = {}
        n = self.n_docs
        for seg in self.segments:
            for fname, arm in seg._arms.items():
                for t in terms:
                    key = (fname, t)
                    if key in out:
                        continue
                    df = 0
                    for s2 in self.segments:
                        arm2 = s2._arms.get(fname)
                        if arm2 is None:
                            continue
                        tid = arm2.term_ids.get(t)
                        if tid is None:
                            continue
                        if arm2.df_host is not None:
                            df += int(arm2.df_host[tid - arm2.base])
                        else:
                            # legacy segment without stored df: invert the
                            # idf (exact after integer rounding)
                            x = float(np.expm1(arm2.idf_host[tid - arm2.base]))
                            df += int(round(
                                (s2.n_docs + 0.5 - 0.5 * x) / (1.0 + x)
                            ))
                    if df > 0:
                        out[key] = float(idf(n, df))
        return out

    # -- reads ---------------------------------------------------------------

    def query_pairs(self, queries: Sequence[str]) -> list[list[list[tuple[int, float]]]]:
        """Per segment, per query: the (term id in THAT segment's id space,
        GLOBAL idf weight) pairs the segment scores the query with."""
        terms_per_q = [simple_tokenize(q) for q in queries]
        uniq = sorted({t for ts in terms_per_q for t in ts})
        weights = self._global_weights(uniq)
        out = []
        for seg in self.segments:
            per_q = []
            for ts in terms_per_q:
                pairs = []
                for fname, arm in seg._arms.items():
                    seen: set[str] = set()
                    for t in ts:
                        if t in seen:
                            continue
                        seen.add(t)
                        tid = arm.term_ids.get(t)
                        w = weights.get((fname, t))
                        if tid is not None and w:
                            pairs.append((tid, w))
                per_q.append(pairs)
            out.append(per_q)
        return out

    def search_candidates_batch(
        self, queries: Sequence[str], budget: int
    ) -> list[list[LexicalCandidate]]:
        queries = list(queries)
        if not queries or self.n_docs == 0:
            return [[] for _ in queries]
        per_seg: list[list[list[LexicalCandidate]]] = []
        for seg, pairs_per_q in zip(self.segments, self.query_pairs(queries)):
            k = min(budget, seg.n_docs)
            if k == 0:
                per_seg.append([[] for _ in queries])
                continue
            t_max = max(max((len(p) for p in pairs_per_q), default=1), 1)
            t_pad = max(-(-t_max // 8) * 8, 8)
            ids = np.zeros((len(queries), t_pad), dtype=np.int32)
            w = np.zeros((len(queries), t_pad), dtype=np.float32)
            for b, pairs in enumerate(pairs_per_q):
                for j, (tid, weight) in enumerate(pairs):
                    ids[b, j] = tid
                    w[b, j] = weight
            s, i = seg._dispatch_rows(ids, w, k)
            per_seg.append(seg.rows_to_candidates(s, i))
        # exact host merge: segments are doc-disjoint and each list is
        # already (score desc, doc_id asc)
        out: list[list[LexicalCandidate]] = []
        for b in range(len(queries)):
            cands = [c for seg_res in per_seg for c in seg_res[b]]
            cands.sort(key=lambda c: (-c.score, c.doc_id))
            out.append(cands[:budget])
        return out

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        return self.search_candidates_batch([query], budget)[0]

    def hydrate_candidates(self, doc_ids: Sequence[str]) -> dict[str, Mapping]:
        out: dict[str, Mapping] = {}
        by_seg: dict[int, list[str]] = {}
        for d in doc_ids:
            seg = self._owner.get(d)
            if seg is not None:
                by_seg.setdefault(id(seg), []).append(d)
        for seg in self.segments:
            ids = by_seg.get(id(seg))
            if ids:
                out.update(seg.hydrate_candidates(ids))
        return out


def append_segment(sealed: LexicalRead, delta_docs) -> SegmentedBm25 | None:
    """Stack a fresh device segment over ``sealed`` (itself a device arm
    or an existing stack). Returns None when the delta intersects the
    sealed doc-id space (supersession needs the full republish path)."""
    from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index
    from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

    if isinstance(sealed, SegmentedBm25):
        base_segments = sealed.segments
        existing = sealed._owner
    else:
        base_segments = [sealed]
        existing = {d: sealed for d in sealed.doc_ids}
    if len(base_segments) >= MAX_SEGMENTS:
        return None  # compaction due: caller takes the full republish
    if any(d.doc_id in existing for d in delta_docs):
        return None
    mem = MemoryLexicalIndex()
    for d in delta_docs:
        mem.add_document(d)
    mem.commit()
    device = base_segments[0].device
    return SegmentedBm25(list(base_segments) + [DeviceBm25Index(mem, device=device)])
