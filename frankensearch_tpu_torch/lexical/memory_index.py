"""In-memory BM25 inverted index — the CPU oracle lexical backend.

Parity target: the behavior of the reference's Quill engine
(crates/frankensearch-quill/src/index.rs QuillIndex + argus.rs scoring)
at the `LexicalRead`/`LexicalWrite` contract level: multi-field schema
(title boosted 2.0x, content 1.0x — frankensearch-lexical/src/lib.rs
schema), Tantivy-pinned BM25 arithmetic, deterministic (score desc,
doc_id asc) ordering, snapshot commit semantics.

This is the rank-parity oracle the device-side scorer
(:mod:`frankensearch_tpu_torch.lexical.device_bm25`) is differentially tested
against — the reference's quill-gauntlet idea (SURVEY.md §4.8).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead, LexicalWrite
from frankensearch_tpu_torch.lexical.bm25 import bm25_term_score, idf, tf_norm_cache
from frankensearch_tpu_torch.lexical.fieldnorm import fieldnorm_to_id
from frankensearch_tpu_torch.lexical.tokenizer import simple_tokenize

TITLE_BOOST = np.float32(2.0)
CONTENT_BOOST = np.float32(1.0)

_FIELDS = ("content", "title")
_BOOSTS = {"content": CONTENT_BOOST, "title": TITLE_BOOST}


@dataclass
class _FieldStats:
    total_tokens: int = 0
    doc_count: int = 0  # docs with at least one token in this field

    @property
    def avgdl(self) -> float:
        # Tantivy: avgdl = total_num_tokens / total_num_docs (raw, not
        # bucket-decoded) — contract.rs doc comment.
        return self.total_tokens / self.doc_count if self.doc_count else 1.0


@dataclass
class _DocEntry:
    doc_id: str
    title: str | None
    metadata: Mapping | None
    content_preview: str
    #: full content (string reference, zero-copy) — powers exact phrase
    #: verification in search_boolean; the oracle is the rank/match
    #: oracle, so it keeps what exactness needs
    content_full: str = ""
    fieldnorm_id: dict[str, int] = field(default_factory=dict)
    token_counts: dict[str, int] = field(default_factory=dict)


class MemoryLexicalIndex(LexicalRead, LexicalWrite):
    """Simple SoA-ish inverted index with commit snapshots."""

    def __init__(self, preview_chars: int = 240) -> None:
        self.preview_chars = preview_chars
        # staging state (visible after commit)
        self._staged: list[tuple[str, IndexableDocument | None]] = []
        # committed state
        self._docs: dict[str, _DocEntry] = {}
        # postings[field][term] -> dict[doc_id, tf]
        self._postings: dict[str, dict[str, dict[str, int]]] = {
            f: defaultdict(dict) for f in _FIELDS
        }
        self._field_stats: dict[str, _FieldStats] = {f: _FieldStats() for f in _FIELDS}
        self._generation = 0
        # lazy per-generation vectorized-scoring state (see _ensure_score_state)
        self._score_cache_gen = -1
        self._ids: list[str] = []
        self._row_of: dict[str, int] = {}
        self._doc_rank: np.ndarray | None = None
        self._fid: dict[str, np.ndarray] = {}
        self._norm_cache: dict[str, np.ndarray] = {}
        self._term_arrays: dict[tuple[str, str], tuple] = {}

    # -- LexicalWrite --------------------------------------------------------

    def add_document(self, doc: IndexableDocument) -> None:
        self._staged.append((doc.doc_id, doc))

    def delete_document(self, doc_id: str) -> None:
        self._staged.append((doc_id, None))

    def commit(self) -> None:
        for doc_id, doc in self._staged:
            if doc_id in self._docs:
                self._remove_committed(doc_id)
            if doc is not None:
                self._insert_committed(doc)
        self._staged.clear()
        self._generation += 1

    def _insert_committed(self, doc: IndexableDocument) -> None:
        entry = _DocEntry(
            doc_id=doc.doc_id,
            title=doc.title,
            metadata=doc.metadata,
            content_preview=doc.content[: self.preview_chars],
            content_full=doc.content,
        )
        for fname in _FIELDS:
            text = doc.content if fname == "content" else (doc.title or "")
            tokens = simple_tokenize(text)
            if not tokens:
                continue
            stats = self._field_stats[fname]
            stats.total_tokens += len(tokens)
            stats.doc_count += 1
            entry.fieldnorm_id[fname] = fieldnorm_to_id(len(tokens))
            entry.token_counts[fname] = len(tokens)
            tfs: dict[str, int] = {}
            for t in tokens:
                tfs[t] = tfs.get(t, 0) + 1
            field_postings, doc_id = self._postings[fname], doc.doc_id
            for term, tf in tfs.items():
                field_postings[term][doc_id] = tf
        self._docs[doc.doc_id] = entry

    def _remove_committed(self, doc_id: str) -> None:
        entry = self._docs.pop(doc_id)
        for fname in _FIELDS:
            if fname not in entry.fieldnorm_id:
                continue
            stats = self._field_stats[fname]
            stats.doc_count -= 1
            stats.total_tokens -= entry.token_counts.get(fname, 0)
            field_postings = self._postings[fname]
            # the doc's own terms, from its text: exact when their tfs sum
            # to its token count (an entry loaded without its full text
            # falls through to the scan of every term)
            text = entry.content_full if fname == "content" else (entry.title or "")
            own = [t for t in dict.fromkeys(simple_tokenize(text)) if t in field_postings]
            if sum(field_postings[t].get(doc_id, 0) for t in own) == entry.token_counts.get(fname, 0):
                terms = own
            else:
                terms = list(field_postings)
            for term in terms:
                plist = field_postings[term]
                plist.pop(doc_id, None)
                if not plist:
                    del field_postings[term]

    # -- LexicalRead -----------------------------------------------------------

    def doc_count(self) -> int:
        return len(self._docs)

    def _ensure_score_state(self) -> None:
        """(Re)build the vectorized scoring state for this generation:
        doc-row mapping, string-order rank per row (for the doc_id-asc
        tiebreak via lexsort), per-field fieldnorm-id arrays and norm
        caches. Posting arrays materialize lazily per queried term."""
        if self._score_cache_gen == self._generation:
            return
        ids = list(self._docs.keys())
        self._ids = ids
        self._row_of = {d: i for i, d in enumerate(ids)}
        order = sorted(range(len(ids)), key=lambda i: ids[i])
        rank = np.empty(len(ids), dtype=np.int64)
        rank[order] = np.arange(len(ids), dtype=np.int64)
        self._doc_rank = rank
        self._fid = {
            f: np.array(
                [self._docs[d].fieldnorm_id.get(f, 0) for d in ids], dtype=np.int64
            )
            for f in _FIELDS
        }
        self._norm_cache = {
            f: tf_norm_cache(self._field_stats[f].avgdl) for f in _FIELDS
        }
        self._term_arrays = {}
        self._score_cache_gen = self._generation

    def _posting_arrays(self, fname: str, term: str):
        key = (fname, term)
        cached = self._term_arrays.get(key)
        if cached is None:
            plist = self._postings[fname].get(term)
            if not plist:
                cached = (None, None)
            else:
                row_of = self._row_of
                rows = np.array([row_of[d] for d in plist], dtype=np.int64)
                tf = np.array(list(plist.values()), dtype=np.float32)
                cached = (rows, tf)
            self._term_arrays[key] = cached
        return cached

    def _bag_scores(self, terms: Sequence[str]) -> np.ndarray:
        """Per-doc BM25 Should-union scores for a term bag (row-aligned
        with ``self._ids``; requires ``_ensure_score_state()``)."""
        n_docs = len(self._docs)
        scores = np.zeros(n_docs, dtype=np.float32)
        for fname in _FIELDS:
            if self._field_stats[fname].doc_count == 0:
                continue
            cache = self._norm_cache[fname]
            boost = _BOOSTS[fname]
            fid = self._fid[fname]
            seen_terms: set[str] = set()
            for term in terms:
                if term in seen_terms:
                    continue  # Tantivy's Should union deduplicates terms
                seen_terms.add(term)
                rows, tf = self._posting_arrays(fname, term)
                if rows is None:
                    continue
                term_idf = idf(n_docs, len(rows))
                s = bm25_term_score(tf, fid[rows], term_idf, cache)
                scores[rows] += boost * s
        return scores

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        # Vectorized per term: each doc appears at most once in a posting
        # list, so the fancy-index `scores[rows] += boost*s` performs the
        # SAME f32 add sequence per doc as the scalar accumulation the
        # device scorer is differentially pinned against.
        terms = simple_tokenize(query)
        if not terms or not self._docs or budget <= 0:
            return []
        self._ensure_score_state()
        scores = self._bag_scores(terms)
        touched = np.nonzero(scores)[0]
        order = np.lexsort((self._doc_rank[touched], -scores[touched]))
        top = touched[order[: max(budget, 0)]]
        ids = self._ids
        return [LexicalCandidate(doc_id=ids[i], score=float(scores[i])) for i in top]

    # -- boolean/phrase (exact oracle lane) ------------------------------------

    def _term_docset(self, term: str) -> set[str]:
        out: set[str] = set()
        for fname in _FIELDS:
            plist = self._postings[fname].get(term)
            if plist:
                out.update(plist.keys())
        return out

    def _eval_docset(self, node) -> set[str]:
        """Exact boolean set evaluation over committed postings; phrases
        verify adjacency against full-content (and title) token streams.
        The scorer-tree role stays with BM25 (argus.rs split: trees decide
        MEMBERSHIP, Should-union scoring decides ORDER)."""
        from frankensearch_tpu_torch.lexical import query as q

        if isinstance(node, q.Term):
            return self._term_docset(node.text)
        if isinstance(node, q.Phrase):
            if not node.terms:
                return set(self._docs.keys())
            cands = self._term_docset(node.terms[0])
            for t in node.terms[1:]:
                cands &= self._term_docset(t)
                if not cands:
                    return set()
            out: set[str] = set()
            for d in cands:
                e = self._docs[d]
                # content_full may be "" on a pre-r3 snapshot reload:
                # fall back to the preview bound rather than verifying
                # adjacency against nothing (which silently failed every
                # phrase not present in a title — probed post-compact)
                body = e.content_full or e.content_preview
                if q.matches(node, q.field_tokens(e.title, body)):
                    out.add(d)
            return out
        if isinstance(node, q.And):
            sets = [self._eval_docset(c) for c in node.children]
            base = min(sets, key=len)
            for s in sets:
                base = base & s
            return base
        if isinstance(node, q.Or):
            out = set()
            for c in node.children:
                out |= self._eval_docset(c)
            return out
        if isinstance(node, q.Not):
            return set(self._docs.keys()) - self._eval_docset(node.child)
        return set()

    def search_boolean(self, query, limit: int):
        """Exact tree retrieval: boolean membership over postings (phrase
        adjacency verified on full content), BM25 positive-bag ordering.
        Docs matching only negative branches score 0 and are dropped —
        the must-match-something-positive contract."""
        from frankensearch_tpu_torch.core.types import ScoredResult

        if query.root is None or limit <= 0 or not self._docs:
            return []
        positive = query.positive_terms()
        if not positive:
            return []
        docset = self._eval_docset(query.root)
        if not docset:
            return []
        self._ensure_score_state()
        scores = self._bag_scores(positive)
        mask = np.zeros(len(self._ids), dtype=bool)
        row_of = self._row_of
        for d in docset:
            r = row_of.get(d)
            if r is not None:
                mask[r] = True
        scores = np.where(mask, scores, np.float32(0.0))
        touched = np.nonzero(scores)[0]
        order = np.lexsort((self._doc_rank[touched], -scores[touched]))
        top = touched[order[:limit]]
        ids = self._ids
        meta = self.hydrate_candidates([ids[i] for i in top])
        out = []
        for i in top:
            m = meta.get(ids[i]) or {}
            out.append(
                ScoredResult(
                    doc_id=ids[i], score=float(scores[i]),
                    lexical_score=float(scores[i]),
                    title=m.get("title"), metadata=m.get("metadata"),
                )
            )
        return out

    def hydrate_candidates(self, doc_ids: Sequence[str]) -> dict[str, Mapping]:
        out: dict[str, Mapping] = {}
        for d in doc_ids:
            e = self._docs.get(d)
            if e is not None:
                out[d] = {
                    "title": e.title,
                    "metadata": e.metadata,
                    "preview": e.content_preview,
                }
                # zero-copy reference: lets consumers (device-arm boolean
                # post-filter) verify phrase adjacency on the FULL text.
                # Emitted only when actually known — a pre-r3 snapshot
                # reload has content_full="" and advertising that as full
                # text would turn "unknown" into "provably absent"
                if e.content_full:
                    out[d]["content"] = e.content_full
        return out

    # -- bulk ingest (native fast path) -----------------------------------------

    @classmethod
    def bulk_build(
        cls, docs: Sequence[IndexableDocument], preview_chars: int = 240
    ) -> "MemoryLexicalIndex":
        """Build a committed index from a corpus in one pass.

        ASCII corpora run through the native C++ tokenizer/accumulator
        (native/fs_native.cc, the Quill scribe role); anything else falls
        back to the per-doc Python path. Both produce identical state —
        asserted by the differential tests.
        """
        from frankensearch_tpu_torch import native

        index = cls(preview_chars=preview_chars)
        docs = list(docs)
        field_texts = {
            "content": [d.content for d in docs],
            "title": [(d.title or "") for d in docs],
        }
        built: dict[str, "native.BulkPostings | None"] = {}
        for fname in _FIELDS:
            built[fname] = native.build_postings_native(field_texts[fname])
        if any(b is None for b in built.values()):
            # fallback: per-doc python path
            for d in docs:
                index.add_document(d)
            index.commit()
            return index

        for i, d in enumerate(docs):
            entry = _DocEntry(
                doc_id=d.doc_id,
                title=d.title,
                metadata=d.metadata,
                content_preview=d.content[:preview_chars],
                content_full=d.content,
            )
            index._docs[d.doc_id] = entry
        for fname in _FIELDS:
            bp = built[fname]
            stats = index._field_stats[fname]
            for i, d in enumerate(docs):
                count = int(bp.doc_token_counts[i])
                if count > 0:
                    stats.total_tokens += count
                    stats.doc_count += 1
                    index._docs[d.doc_id].fieldnorm_id[fname] = fieldnorm_to_id(count)
                    index._docs[d.doc_id].token_counts[fname] = count
            field_postings = index._postings[fname]
            for p in range(len(bp.post_term)):
                term = bp.terms[int(bp.post_term[p])]
                doc_id = docs[int(bp.post_doc[p])].doc_id
                field_postings[term][doc_id] = int(bp.post_tf[p])
        index._generation = 1
        return index

    # -- introspection (device scorer + gauntlet) ------------------------------

    @property
    def generation(self) -> int:
        return self._generation

    def snapshot_postings(self):
        """Expose committed postings for the device-scorer build."""
        return self._postings, self._field_stats, self._docs
