"""IR evaluation metrics + bootstrap statistics.

Parity target: reference crates/frankensearch-core/src/metrics_eval.rs —
ndcg_at_k, mrr, map_at_k, recall_at_k, bootstrap_ci, bootstrap_compare,
IQR outlier trim, CV run-stability verdicts. These gate the quality
harness and the statistical benchmark-regression lane (SURVEY.md §4.5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np


def dcg_at_k(relevances: Sequence[float], k: int) -> float:
    """DCG with the standard log2(rank+1) discount."""
    total = 0.0
    for i, rel in enumerate(relevances[:k]):
        total += rel / math.log2(i + 2)
    return total


def ndcg_at_k(
    ranked_ids: Sequence[str], qrels: Mapping[str, float], k: int
) -> float:
    """nDCG@k against graded relevance judgments."""
    gains = [qrels.get(doc_id, 0.0) for doc_id in ranked_ids]
    ideal = sorted(qrels.values(), reverse=True)
    idcg = dcg_at_k(ideal, k)
    if idcg == 0.0:
        return 0.0
    return dcg_at_k(gains, k) / idcg


def mrr(ranked_ids: Sequence[str], qrels: Mapping[str, float]) -> float:
    """Mean reciprocal rank of the first relevant (rel>0) result."""
    for i, doc_id in enumerate(ranked_ids):
        if qrels.get(doc_id, 0.0) > 0.0:
            return 1.0 / (i + 1)
    return 0.0


def map_at_k(ranked_ids: Sequence[str], qrels: Mapping[str, float], k: int) -> float:
    """Average precision@k (binary relevance: rel>0)."""
    n_rel = sum(1 for v in qrels.values() if v > 0.0)
    if n_rel == 0:
        return 0.0
    hits = 0
    precision_sum = 0.0
    for i, doc_id in enumerate(ranked_ids[:k]):
        if qrels.get(doc_id, 0.0) > 0.0:
            hits += 1
            precision_sum += hits / (i + 1)
    return precision_sum / min(n_rel, k)


def recall_at_k(ranked_ids: Sequence[str], qrels: Mapping[str, float], k: int) -> float:
    """Fraction of relevant docs retrieved in the top k."""
    relevant = {d for d, v in qrels.items() if v > 0.0}
    if not relevant:
        return 0.0
    found = sum(1 for doc_id in ranked_ids[:k] if doc_id in relevant)
    return found / len(relevant)


@dataclass(frozen=True)
class BootstrapCI:
    mean: float
    lo: float
    hi: float
    n_resamples: int
    confidence: float

    def contains(self, value: float) -> bool:
        return self.lo <= value <= self.hi


def bootstrap_ci(
    samples: Sequence[float],
    n_resamples: int = 2000,
    confidence: float = 0.95,
    seed: int = 0,
) -> BootstrapCI:
    """Percentile bootstrap CI of the mean (metrics_eval.rs bootstrap_ci)."""
    arr = np.asarray(samples, dtype=np.float64)
    if arr.size == 0:
        return BootstrapCI(float("nan"), float("nan"), float("nan"), n_resamples, confidence)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, arr.size, size=(n_resamples, arr.size))
    means = arr[idx].mean(axis=1)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(means, [alpha, 1.0 - alpha])
    return BootstrapCI(float(arr.mean()), float(lo), float(hi), n_resamples, confidence)


@dataclass(frozen=True)
class BootstrapComparison:
    """Paired bootstrap comparison of two metric sample sets."""

    mean_delta: float  # mean(b) - mean(a)
    lo: float
    hi: float
    significant: bool  # CI excludes zero
    p_improved: float  # fraction of resamples where b > a


def bootstrap_compare(
    a: Sequence[float],
    b: Sequence[float],
    n_resamples: int = 2000,
    confidence: float = 0.95,
    seed: int = 0,
) -> BootstrapComparison:
    """Paired bootstrap of mean(b)-mean(a); inputs must be paired per-query
    samples of equal length (metrics_eval.rs bootstrap_compare)."""
    xa = np.asarray(a, dtype=np.float64)
    xb = np.asarray(b, dtype=np.float64)
    if xa.shape != xb.shape or xa.size == 0:
        raise ValueError("bootstrap_compare needs equal-length non-empty samples")
    deltas = xb - xa
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, deltas.size, size=(n_resamples, deltas.size))
    means = deltas[idx].mean(axis=1)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(means, [alpha, 1.0 - alpha])
    return BootstrapComparison(
        mean_delta=float(deltas.mean()),
        lo=float(lo),
        hi=float(hi),
        significant=bool(lo > 0.0 or hi < 0.0),
        p_improved=float((means > 0.0).mean()),
    )


def iqr_trim(samples: Sequence[float], k: float = 1.5) -> list[float]:
    """Drop samples outside [Q1 - k*IQR, Q3 + k*IQR] (outlier trim)."""
    arr = np.asarray(samples, dtype=np.float64)
    if arr.size < 4:
        return list(map(float, arr))
    q1, q3 = np.quantile(arr, [0.25, 0.75])
    iqr = q3 - q1
    lo, hi = q1 - k * iqr, q3 + k * iqr
    return [float(x) for x in arr if lo <= x <= hi]


@dataclass(frozen=True)
class StabilityVerdict:
    """Coefficient-of-variation run-stability verdict (metrics_eval.rs).

    The benchmark regression lane requires cv <= max_cv and
    n >= min_samples after IQR trim before a comparison is admissible
    (reference benchmark_baseline_matrix.rs:21-43)."""

    stable: bool
    cv: float
    n: int
    reason: str


def stability_verdict(
    samples: Sequence[float], max_cv: float = 0.15, min_samples: int = 5
) -> StabilityVerdict:
    trimmed = iqr_trim(samples)
    n = len(trimmed)
    if n < min_samples:
        return StabilityVerdict(False, float("nan"), n, f"need >= {min_samples} samples post-trim, have {n}")
    arr = np.asarray(trimmed)
    mean = float(arr.mean())
    if mean == 0.0:
        return StabilityVerdict(False, float("inf"), n, "zero mean")
    cv = float(arr.std(ddof=1) / abs(mean))
    if cv > max_cv:
        return StabilityVerdict(False, cv, n, f"cv {cv:.3f} > {max_cv}")
    return StabilityVerdict(True, cv, n, "stable")


def kendall_tau(rank_a: Sequence[str], rank_b: Sequence[str]) -> float:
    """Kendall tau-a between two orderings of (a shared subset of) ids.

    Parity: fusion/src/blend.rs:417 rank-stability metric between Phase 1
    and Phase 2 orderings. Items missing from either list are ignored.
    """
    common = [x for x in rank_a if x in set(rank_b)]
    if len(common) < 2:
        return 1.0
    pos_b = {doc: i for i, doc in enumerate(rank_b)}
    concordant = 0
    discordant = 0
    for i in range(len(common)):
        for j in range(i + 1, len(common)):
            d = pos_b[common[i]] - pos_b[common[j]]
            if d < 0:
                concordant += 1
            elif d > 0:
                discordant += 1
    total = concordant + discordant
    if total == 0:
        return 1.0
    return (concordant - discordant) / total
