"""Query-biased PageRank over the DocumentGraph as a third fusion source.

Parity target: reference crates/frankensearch-fusion/src/graph_rank.rs
(:1-4) — personalized PageRank seeded by the Phase-1 pool; the resulting
ranking feeds RRF as the graph source (rrf_fuse_with_graph).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from frankensearch_tpu_torch.core.graph import DocumentGraph
from frankensearch_tpu_torch.core.types import ScoredResult


@dataclass
class GraphRanker:
    graph: DocumentGraph
    damping: float = 0.85
    iterations: int = 20
    tolerance: float = 1e-6

    def rank(
        self, seeds: Sequence[ScoredResult], limit: int = 50
    ) -> list[ScoredResult]:
        """Personalized PageRank: teleport distribution = normalized seed
        scores; returns graph-scored docs, descending."""
        if not seeds or self.graph.node_count() == 0:
            return []
        total = sum(max(s.score, 0.0) for s in seeds) or 1.0
        teleport = {
            s.doc_id: max(s.score, 0.0) / total
            for s in seeds
            if s.doc_id in self.graph.nodes
        }
        if not teleport:
            return []
        nodes = sorted(self.graph.nodes)
        rank = {n: teleport.get(n, 0.0) for n in nodes}
        for _ in range(self.iterations):
            nxt = {n: (1 - self.damping) * teleport.get(n, 0.0) for n in nodes}
            for n in nodes:
                r = rank[n]
                if r == 0.0:
                    continue
                edges = self.graph.out_edges(n)
                if not edges:
                    continue
                w_total = sum(e.weight for e in edges) or 1.0
                for e in edges:
                    nxt[e.dst] += self.damping * r * (e.weight / w_total)
            delta = sum(abs(nxt[n] - rank[n]) for n in nodes)
            rank = nxt
            if delta < self.tolerance:
                break
        ranked = sorted(
            ((n, s) for n, s in rank.items() if s > 0.0), key=lambda kv: (-kv[1], kv[0])
        )[:limit]
        return [
            ScoredResult(doc_id=n, score=s, graph_score=s) for n, s in ranked
        ]
