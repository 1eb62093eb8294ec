"""Core result/document types.

Parity target: reference crates/frankensearch-core/src/types.rs —
IndexableDocument (:39), VectorHit (:88), ScoredResult (:3957),
SearchPhase (:4118), FusedHit (:3892).

Design note (TPU-first): device programs produce dense ``(scores, indices)``
arrays; these dataclasses are the *host-side* row types hydrated from those
arrays at the phase boundary, so nothing here is ever traced by JAX.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


@dataclass(frozen=True)
class IndexableDocument:
    """A document submitted for indexing.

    Parity: types.rs:39. ``doc_id`` is the stable external identifier;
    ``content`` is what gets canonicalized/embedded; ``title`` and
    ``metadata`` ride along for lexical boost and hydration.
    """

    doc_id: str
    content: str
    title: str | None = None
    metadata: Mapping[str, Any] | None = None

    def __post_init__(self) -> None:
        if not self.doc_id:
            raise ValueError("doc_id must be non-empty")


class SearchSource(enum.Flag):
    """Which arms contributed to a fused result."""

    NONE = 0
    LEXICAL = enum.auto()
    FAST_VECTOR = enum.auto()
    QUALITY_VECTOR = enum.auto()
    GRAPH = enum.auto()
    RERANKER = enum.auto()


@dataclass(frozen=True)
class VectorHit:
    """A single hit from a vector scan.

    Parity: types.rs:88. ``score`` is cosine similarity in [-1, 1]
    (f32 accumulated); ``row`` is the slab row (useful for aligned
    quality rescoring, two_tier.rs:1566).
    """

    doc_id: str
    score: float
    row: int = -1

    def is_valid(self) -> bool:
        return not math.isnan(self.score)


@dataclass(frozen=True)
class FusedHit:
    """Intermediate fusion row: doc id + fused score + per-source ranks.

    Parity: types.rs:3892.
    """

    doc_id: str
    score: float
    sources: SearchSource = SearchSource.NONE
    lexical_rank: int | None = None
    fast_rank: int | None = None
    quality_rank: int | None = None
    graph_rank: int | None = None


@dataclass
class HitExplanation:
    """Per-hit score decomposition + rank movement.

    Parity: core/src/explanation.rs.
    """

    doc_id: str
    fused_score: float
    components: dict[str, float] = field(default_factory=dict)
    ranks: dict[str, int] = field(default_factory=dict)
    rank_before: int | None = None
    rank_after: int | None = None
    notes: list[str] = field(default_factory=list)

    def rank_movement(self) -> int | None:
        if self.rank_before is None or self.rank_after is None:
            return None
        return self.rank_before - self.rank_after

    def to_dict(self) -> dict[str, Any]:
        return {
            "doc_id": self.doc_id,
            "fused_score": self.fused_score,
            "components": dict(self.components),
            "ranks": dict(self.ranks),
            "rank_before": self.rank_before,
            "rank_after": self.rank_after,
            "rank_movement": self.rank_movement(),
            "notes": list(self.notes),
        }


@dataclass
class ScoredResult:
    """A final (or phase-final) search result.

    Parity: types.rs:3957 — per-source score fields + boxed explanation +
    shared metadata. Scores that did not contribute are ``None``.
    """

    doc_id: str
    score: float
    lexical_score: float | None = None
    fast_score: float | None = None
    quality_score: float | None = None
    rerank_score: float | None = None
    graph_score: float | None = None
    sources: SearchSource = SearchSource.NONE
    title: str | None = None
    snippet: str | None = None
    metadata: Mapping[str, Any] | None = None
    explanation: HitExplanation | None = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"doc_id": self.doc_id, "score": self.score}
        for k in (
            "lexical_score",
            "fast_score",
            "quality_score",
            "rerank_score",
            "graph_score",
            "title",
            "snippet",
        ):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.metadata:
            out["metadata"] = dict(self.metadata)
        if self.explanation is not None:
            out["explanation"] = self.explanation.to_dict()
        return out


class PhaseKind(enum.Enum):
    """Progressive delivery phases.

    Parity: types.rs:4118 (SearchPhase enum Initial/Refined/Reranked/
    RefinementFailed). ``REFINEMENT_FAILED`` is NOT an error: Phase-1
    results stand (types.rs:4161-4172).
    """

    INITIAL = "initial"
    REFINED = "refined"
    RERANKED = "reranked"
    REFINEMENT_FAILED = "refinement_failed"


@dataclass
class SearchPhase:
    """A phase callback payload: results as of this phase + timings."""

    kind: PhaseKind
    results: list[ScoredResult]
    latency_ms: float
    #: populated on REFINEMENT_FAILED: "timeout" | "error" | "circuit_open"
    #: | "phase_gate" | "no_quality_tier"
    reason: str | None = None
    metrics: "Any | None" = None  # TwoTierMetrics; avoid import cycle

    @property
    def is_terminal_failure(self) -> bool:
        return self.kind is PhaseKind.REFINEMENT_FAILED

    def to_dict(self) -> dict[str, Any]:
        return {
            "phase": self.kind.value,
            "latency_ms": self.latency_ms,
            "reason": self.reason,
            "results": [r.to_dict() for r in self.results],
        }


class ZeroSignalReason(enum.Enum):
    """Typed classification of an empty vector-scan result: separates
    "legitimately empty" from "semantic lane unusable".

    Parity: index/src/search.rs:66-80.
    """

    NO_RECORDS = "no_records"
    ALL_TOMBSTONED = "all_tombstoned"
    ALL_FILTERED = "all_filtered"
    DEGENERATE_QUERY = "degenerate_query"  # zero-norm / NaN query vector
    IDENTITY_REJECTED = "identity_rejected"


@dataclass(frozen=True)
class ClassifiedHits:
    """Vector-scan result + typed zero-signal classification.

    Parity: search_top_k_classified (index/src/search.rs:227).
    """

    hits: tuple[VectorHit, ...]
    zero_signal: ZeroSignalReason | None = None

    @property
    def is_empty(self) -> bool:
        return len(self.hits) == 0


def l2_normalize(vec: Sequence[float]) -> list[float]:
    """Host-side L2 normalization helper (parity: core traits.rs helper).

    Device-side normalization lives in ops/vector_math; this is for small
    host vectors (query embeddings crossing the host boundary in tests).
    """
    norm = math.sqrt(sum(x * x for x in vec))
    if norm == 0.0 or math.isnan(norm):
        return list(vec)
    return [x / norm for x in vec]


def cosine_similarity(a: Sequence[float], b: Sequence[float]) -> float:
    """Host-side cosine similarity (parity: core traits.rs helper)."""
    if len(a) != len(b):
        raise ValueError(f"length mismatch {len(a)} vs {len(b)}")
    dot = sum(x * y for x, y in zip(a, b))
    na = math.sqrt(sum(x * x for x in a))
    nb = math.sqrt(sum(x * x for x in b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return dot / (na * nb)


def truncate_embedding(vec: Sequence[float], dims: int) -> list[float]:
    """MRL-style dimension truncation + renormalize (parity: traits.rs
    truncate_embedding; index/src/mrl.rs)."""
    if dims <= 0:
        raise ValueError("dims must be positive")
    return l2_normalize(list(vec)[:dims])
