"""Retrieval quality harness: nDCG/MRR/recall with bootstrap CIs.

Parity target: reference docs/quality_harness/beir_eval.py (dense /
lexical / hybrid eval) + crates/frankensearch-fsfs/tests/
search_quality_harness.rs (nDCG@10 / MRR / Recall@10 + 2000-resample
bootstrap CIs, per-query-class slices, machine-readable report v2).

:func:`evaluate` times each ``search_fn`` call on the host clock with no
device synchronisation, as the reference does; ``search_batch`` and
``search()`` return hydrated host results, so a search on the card has
ended when its call returns.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

from frankensearch_tpu_torch.core.metrics_eval import (
    BootstrapCI,
    bootstrap_ci,
    bootstrap_compare,
    mrr,
    ndcg_at_k,
    recall_at_k,
)
from frankensearch_tpu_torch.core.query_class import QueryClass

REPORT_VERSION = 2


@dataclass(frozen=True)
class EvalQuery:
    query_id: str
    text: str
    qrels: Mapping[str, float]  # doc_id -> graded relevance


@dataclass
class QualityReport:
    system: str
    k: int
    n_queries: int
    ndcg: BootstrapCI
    mrr: BootstrapCI
    recall: BootstrapCI
    per_class: dict[str, dict[str, float]] = field(default_factory=dict)
    per_query: dict[str, dict[str, float]] = field(default_factory=dict)
    mean_latency_ms: float = 0.0

    def to_dict(self) -> dict:
        def ci(c: BootstrapCI) -> dict:
            return {"mean": c.mean, "lo": c.lo, "hi": c.hi}

        return {
            "v": REPORT_VERSION,
            "system": self.system,
            "k": self.k,
            "n_queries": self.n_queries,
            "ndcg_at_k": ci(self.ndcg),
            "mrr": ci(self.mrr),
            "recall_at_k": ci(self.recall),
            "per_class": self.per_class,
            "mean_latency_ms": self.mean_latency_ms,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def evaluate(
    search_fn: Callable[[str, int], Sequence],
    queries: Sequence[EvalQuery],
    *,
    k: int = 10,
    system: str = "frankensearch-tpu",
    n_resamples: int = 2000,
    seed: int = 0,
) -> QualityReport:
    """search_fn(query_text, k) -> ranked results with .doc_id."""
    ndcgs, mrrs, recalls, latencies = [], [], [], []
    per_query: dict[str, dict[str, float]] = {}
    by_class: dict[str, list[dict[str, float]]] = {}
    for q in queries:
        t0 = time.monotonic()
        results = search_fn(q.text, k)
        latencies.append((time.monotonic() - t0) * 1000.0)
        ranked = [r.doc_id for r in results]
        row = {
            "ndcg": ndcg_at_k(ranked, q.qrels, k),
            "mrr": mrr(ranked, q.qrels),
            "recall": recall_at_k(ranked, q.qrels, k),
        }
        per_query[q.query_id] = row
        ndcgs.append(row["ndcg"])
        mrrs.append(row["mrr"])
        recalls.append(row["recall"])
        qc = QueryClass.classify(q.text).value
        by_class.setdefault(qc, []).append(row)

    per_class = {
        qc: {
            "n": len(rows),
            "ndcg": sum(r["ndcg"] for r in rows) / len(rows),
            "mrr": sum(r["mrr"] for r in rows) / len(rows),
            "recall": sum(r["recall"] for r in rows) / len(rows),
        }
        for qc, rows in by_class.items()
    }
    return QualityReport(
        system=system,
        k=k,
        n_queries=len(queries),
        ndcg=bootstrap_ci(ndcgs, n_resamples, seed=seed),
        mrr=bootstrap_ci(mrrs, n_resamples, seed=seed),
        recall=bootstrap_ci(recalls, n_resamples, seed=seed),
        per_class=per_class,
        per_query=per_query,
        mean_latency_ms=sum(latencies) / len(latencies) if latencies else 0.0,
    )


@dataclass(frozen=True)
class SystemComparison:
    metric: str
    mean_delta: float
    lo: float
    hi: float
    significant: bool
    better: str  # "a" | "b" | "tie"


def compare_systems(
    report_a: QualityReport, report_b: QualityReport, metric: str = "ndcg",
    n_resamples: int = 2000, seed: int = 0,
) -> SystemComparison:
    """Paired bootstrap over shared query ids (benchmark regression lane)."""
    shared = sorted(set(report_a.per_query) & set(report_b.per_query))
    a = [report_a.per_query[q][metric] for q in shared]
    b = [report_b.per_query[q][metric] for q in shared]
    cmp = bootstrap_compare(a, b, n_resamples=n_resamples, seed=seed)
    better = "tie"
    if cmp.significant:
        better = "b" if cmp.mean_delta > 0 else "a"
    return SystemComparison(
        metric=metric, mean_delta=cmp.mean_delta, lo=cmp.lo, hi=cmp.hi,
        significant=cmp.significant, better=better,
    )
