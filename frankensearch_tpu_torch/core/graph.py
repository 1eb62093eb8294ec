"""Document graph core types.

Parity target: reference crates/frankensearch-core/src/graph.rs —
``DocumentGraph`` with typed edges (Similar / Links) feeding the optional
graph ranking source.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from dataclasses import dataclass, field


class EdgeType(enum.Enum):
    SIMILAR = "similar"
    LINKS = "links"


@dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    weight: float = 1.0
    edge_type: EdgeType = EdgeType.LINKS


@dataclass
class DocumentGraph:
    _out: dict[str, list[Edge]] = field(default_factory=lambda: defaultdict(list))
    _nodes: set[str] = field(default_factory=set)

    def add_node(self, doc_id: str) -> None:
        self._nodes.add(doc_id)

    def add_edge(
        self, src: str, dst: str, weight: float = 1.0,
        edge_type: EdgeType = EdgeType.LINKS,
    ) -> None:
        self._nodes.add(src)
        self._nodes.add(dst)
        self._out[src].append(Edge(src, dst, weight, edge_type))

    def out_edges(self, doc_id: str) -> list[Edge]:
        return self._out.get(doc_id, [])

    @property
    def nodes(self) -> set[str]:
        return set(self._nodes)

    def node_count(self) -> int:
        return len(self._nodes)

    def edge_count(self) -> int:
        return sum(len(v) for v in self._out.values())
