"""Optional LLM multi-query expansion (behind --expand).

Parity target: reference crates/frankensearch-fsfs/src/query_expansion.rs
— an LLM (Claude/OpenAI) proposes query variants; each variant runs as a
separate search and the pools fuse with RRF. The LLM transport is
injected (zero-egress build); a deterministic rule-based expander is the
always-available fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from frankensearch_tpu_torch.core.types import ScoredResult
from frankensearch_tpu_torch.fusion.rrf import _rank_contribution, _sanitize_k

#: llm(prompt) -> list of variant strings
LlmTransport = Callable[[str], Sequence[str]]


def rule_based_variants(query: str, max_variants: int = 3) -> list[str]:
    """Deterministic fallback expansion: synonym-free but shape-diverse
    (quoted phrase, keyword subset, question form)."""
    q = query.strip()
    if not q:
        return []
    words = q.split()
    variants: list[str] = []
    if len(words) > 1:
        variants.append(f'"{q}"')  # exact phrase lane
        variants.append(" ".join(words[:3]))  # head keywords
    if not q.endswith("?") and len(words) >= 2:
        variants.append(f"how does {q} work")
    seen, out = {q.lower()}, []
    for v in variants:
        if v.lower() not in seen:
            out.append(v)
            seen.add(v.lower())
    return out[:max_variants]


@dataclass
class QueryExpander:
    llm: LlmTransport | None = None
    max_variants: int = 3
    #: weight of the original query's pool relative to variants
    original_weight: float = 2.0
    rrf_k: float = 60.0
    used_llm: bool = field(default=False, init=False)

    def variants(self, query: str) -> list[str]:
        if self.llm is not None:
            try:
                raw = list(self.llm(
                    "Propose up to {n} alternative search queries for: {q}".format(
                        n=self.max_variants, q=query
                    )
                ))
                self.used_llm = True
                seen, out = {query.lower()}, []
                for v in raw:
                    v = v.strip()
                    if v and v.lower() not in seen:
                        out.append(v)
                        seen.add(v.lower())
                return out[: self.max_variants]
            except Exception:
                self.used_llm = False
        return rule_based_variants(query, self.max_variants)

    def search_expanded(
        self,
        search_fn: Callable[[str, int], Sequence[ScoredResult]],
        query: str,
        k: int = 10,
    ) -> list[ScoredResult]:
        """Run original + variants, fuse pools with weighted RRF."""
        pools: list[tuple[float, Sequence[ScoredResult]]] = [
            (self.original_weight, search_fn(query, k))
        ]
        for v in self.variants(query):
            pools.append((1.0, search_fn(v, k)))
        kk = _sanitize_k(self.rrf_k)
        fused: dict[str, float] = {}
        best: dict[str, ScoredResult] = {}
        for weight, pool in pools:
            for rank, r in enumerate(pool):
                fused[r.doc_id] = fused.get(r.doc_id, 0.0) + weight * _rank_contribution(kk, rank)
                if r.doc_id not in best or r.score > best[r.doc_id].score:
                    best[r.doc_id] = r
        ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [
            ScoredResult(
                doc_id=d, score=s,
                lexical_score=best[d].lexical_score, fast_score=best[d].fast_score,
                quality_score=best[d].quality_score, title=best[d].title,
                metadata=best[d].metadata, sources=best[d].sources,
            )
            for d, s in ranked
        ]
