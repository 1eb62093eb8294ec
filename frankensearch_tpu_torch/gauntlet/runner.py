"""Differential campaign runner + metamorphic maintenance laws.

Parity target: reference gauntlet/src/runner.rs (campaign over generated
corpora comparing candidate vs oracle) + metamorphic_maintenance_laws.rs
(maintenance operations — merge, delete+compact, rebuild — must not
change search results).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.gauntlet.generator import (
    CorpusSpec,
    QuerySpec,
    generate_corpus,
    generate_queries,
)


@dataclass(frozen=True)
class CaseDivergence:
    query: str
    detail: str


@dataclass
class CampaignReport:
    corpus_fingerprint: str
    cases: int = 0
    exact_agreements: int = 0
    rank_swaps_within_tolerance: int = 0
    divergences: list[CaseDivergence] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergences

    @property
    def agreement_rate(self) -> float:
        return self.exact_agreements / self.cases if self.cases else 1.0


def run_differential_campaign(
    oracle_fn: Callable[[str, int], Sequence],
    candidate_fn: Callable[[str, int], Sequence],
    *,
    corpus_spec: CorpusSpec | None = None,
    query_spec: QuerySpec | None = None,
    corpus: list[IndexableDocument] | None = None,
    k: int = 10,
    score_rel_tolerance: float = 1e-3,
) -> CampaignReport:
    """Compare candidate vs oracle over generated queries.

    Both fns take (query, k) and return hits with .doc_id and .score.
    Equal doc sets with near-tie rank swaps count as within-tolerance;
    set differences or score drift are divergences.
    """
    spec = corpus_spec or CorpusSpec()
    corpus = corpus if corpus is not None else generate_corpus(spec)
    queries = generate_queries(query_spec or QuerySpec(), corpus)
    report = CampaignReport(corpus_fingerprint=spec.fingerprint())
    for query in queries:
        report.cases += 1
        oracle = list(oracle_fn(query, k))
        candidate = list(candidate_fn(query, k))
        o_ids = [h.doc_id for h in oracle]
        c_ids = [h.doc_id for h in candidate]
        if o_ids == c_ids:
            scores_ok = all(
                abs(o.score - c.score) <= score_rel_tolerance * max(abs(o.score), 1e-9)
                for o, c in zip(oracle, candidate)
            )
            if scores_ok:
                report.exact_agreements += 1
                continue
            report.divergences.append(CaseDivergence(query, "score drift at equal ranks"))
            continue
        if set(o_ids) == set(c_ids):
            # rank swap: admissible only between near-tied scores
            o_by = {h.doc_id: h.score for h in oracle}
            swaps_ok = True
            for o, c in zip(o_ids, c_ids):
                if o != c:
                    drift = abs(o_by[o] - o_by[c])
                    if drift > score_rel_tolerance * max(abs(o_by[o]), 1e-9):
                        swaps_ok = False
                        break
            if swaps_ok:
                report.rank_swaps_within_tolerance += 1
            else:
                report.divergences.append(
                    CaseDivergence(query, f"non-tie rank swap: {o_ids[:5]} vs {c_ids[:5]}")
                )
        else:
            missing = set(o_ids) - set(c_ids)
            extra = set(c_ids) - set(o_ids)
            report.divergences.append(
                CaseDivergence(query, f"set diff: missing={sorted(missing)[:3]} extra={sorted(extra)[:3]}")
            )
    return report


# --- metamorphic maintenance laws -------------------------------------------


@dataclass
class LawViolation:
    law: str
    query: str
    detail: str


def check_maintenance_laws(
    build_fn: Callable[[list[IndexableDocument]], object],
    search_fn: Callable[[object, str, int], Sequence],
    maintain_fn: Callable[[object], object],
    *,
    law: str,
    corpus_spec: CorpusSpec | None = None,
    k: int = 10,
) -> list[LawViolation]:
    """Law: maintenance must be search-invariant — search(maintain(I), q)
    == search(I, q) for all q (gauntlet metamorphic laws: merge/GC
    invariance)."""
    spec = corpus_spec or CorpusSpec(n_docs=60)
    corpus = generate_corpus(spec)
    queries = generate_queries(QuerySpec(n_queries=20), corpus)
    index = build_fn(corpus)
    before = {q: [(h.doc_id, round(h.score, 5)) for h in search_fn(index, q, k)] for q in queries}
    maintained = maintain_fn(index)
    violations = []
    for q in queries:
        after = [(h.doc_id, round(h.score, 5)) for h in search_fn(maintained, q, k)]
        if after != before[q]:
            violations.append(LawViolation(law=law, query=q, detail=f"{before[q][:3]} -> {after[:3]}"))
    return violations


def check_boolean_laws(
    arms: Mapping[str, object],
    *,
    corpus_spec: CorpusSpec | None = None,
    k: int = 20,
) -> list[LawViolation]:
    """Boolean-retrieval laws every lexical arm must satisfy (quill
    query.rs semantics, r3 product routing):

    - subset:   matches("a AND b") ⊆ matches("a b") per arm
    - phrase:   matches('"a b"') ⊆ matches("a b") per arm
    - negation: matches("a NOT b") ∩ matches(bag "b") = ∅ per arm
    - parity:   AND/phrase/NOT match SETS agree across all arms
    """
    from frankensearch_tpu_torch.lexical.query import parse_query

    spec = corpus_spec or CorpusSpec(n_docs=60)
    corpus = generate_corpus(spec)
    # derive term pairs from real doc contents so queries actually hit
    rng_terms: list[tuple[str, str]] = []
    for d in corpus[:8]:
        toks = d.content.split()
        if len(toks) >= 2:
            rng_terms.append((toks[0], toks[1]))
    violations: list[LawViolation] = []
    for a, b in rng_terms[:5]:
        bag = f"{a} {b}"
        cases = {
            "boolean-and-subset": f"{a} AND {b}",
            "boolean-phrase-subset": f'"{a} {b}"',
            "boolean-not-disjoint": f"{a} NOT {b}",
        }
        per_arm_sets: dict[str, dict[str, set]] = {}
        for name, arm in arms.items():
            bag_ids = {c.doc_id for c in arm.search_candidates(bag, k * 4)}
            b_ids = {c.doc_id for c in arm.search_candidates(b, k * 4)}
            got: dict[str, set] = {}
            for law, raw in cases.items():
                ids = {r.doc_id for r in arm.search_boolean(parse_query(raw), k * 4)}
                got[law] = ids
                if law in ("boolean-and-subset", "boolean-phrase-subset"):
                    if not ids <= bag_ids:
                        violations.append(LawViolation(
                            law=law, query=raw,
                            detail=f"{name}: extra={sorted(ids - bag_ids)[:3]}",
                        ))
                else:  # NOT-disjoint
                    if ids & b_ids:
                        violations.append(LawViolation(
                            law=law, query=raw,
                            detail=f"{name}: leaked={sorted(ids & b_ids)[:3]}",
                        ))
            per_arm_sets[name] = got
        names = list(per_arm_sets)
        for law in cases:
            base = per_arm_sets[names[0]][law]
            for other in names[1:]:
                if per_arm_sets[other][law] != base:
                    violations.append(LawViolation(
                        law="boolean-arm-parity", query=cases[law],
                        detail=f"{names[0]} vs {other}: "
                               f"{sorted(base ^ per_arm_sets[other][law])[:3]}",
                    ))
    return violations

def check_reload_law(
    *,
    corpus_spec: CorpusSpec | None = None,
    k: int = 20,
) -> list[LawViolation]:
    """Reload-invariance law: for every query class — bag, AND, phrase,
    NOT — search results over a PERSISTED-then-RELOADED oracle must be
    identical to the in-memory one. Guards the r3 regression class
    where the FLEX snapshot dropped full content and a reopened oracle
    silently failed every phrase not present in a title."""
    import tempfile

    from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex
    from frankensearch_tpu_torch.lexical.persist import load_lexical, save_lexical
    from frankensearch_tpu_torch.lexical.query import parse_query

    spec = corpus_spec or CorpusSpec(n_docs=60)
    corpus = generate_corpus(spec)
    mem = MemoryLexicalIndex()
    for d in corpus:
        mem.add_document(d)
    mem.commit()
    with tempfile.TemporaryDirectory() as root:
        save_lexical(mem, root)
        reloaded = load_lexical(root)
    violations: list[LawViolation] = []
    pairs = []
    for d in corpus[:6]:
        toks = d.content.split()
        if len(toks) >= 2:
            pairs.append((toks[0], toks[1]))
    for a, b in pairs[:4]:
        for law, raw in {
            "reload-bag": f"{a} {b}",
            "reload-and": f"{a} AND {b}",
            "reload-phrase": f'"{a} {b}"',
            "reload-not": f"{a} NOT {b}",
        }.items():
            if law == "reload-bag":
                before = [(c.doc_id, round(c.score, 5))
                          for c in mem.search_candidates(raw, k)]
                after = [(c.doc_id, round(c.score, 5))
                         for c in reloaded.search_candidates(raw, k)]
            else:
                q = parse_query(raw)
                before = [(r.doc_id, round(r.score, 5))
                          for r in mem.search_boolean(q, k)]
                after = [(r.doc_id, round(r.score, 5))
                         for r in reloaded.search_boolean(q, k)]
            if before != after:
                violations.append(LawViolation(
                    law=law, query=raw,
                    detail=f"{before[:3]} -> {after[:3]}",
                ))
    return violations
