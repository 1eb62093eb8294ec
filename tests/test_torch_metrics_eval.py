"""The port's evaluation statistics (``core/metrics_eval.py``,
``utils/quality_harness.py``, ``utils/bench_regression.py``,
``gauntlet/perf_ratchet.py``) against the JAX package's on the CPU.

Oracles: tests/test_metrics_eval.py, tests/test_quality_harness.py,
tests/test_bench_regression.py, tests/test_schemas.py (the golden
profile) and tests/test_gauntlet.py (the ratchet). Every module is host
Python over numpy, so each function is held to the reference bitwise on
the same seeded inputs: floats by ``==`` (NaN with NaN), bootstrap CIs
for the same seed, report dicts, and the files both packages write byte
for byte.
"""

import dataclasses
import math

import numpy as np
import pytest

import frankensearch_tpu.core.metrics_eval as ref_me
import frankensearch_tpu.gauntlet.perf_ratchet as ref_pr
import frankensearch_tpu.utils.bench_regression as ref_br
import frankensearch_tpu.utils.quality_harness as ref_qh
import frankensearch_tpu_torch.core.metrics_eval as port_me
import frankensearch_tpu_torch.gauntlet.perf_ratchet as port_pr
import frankensearch_tpu_torch.utils.bench_regression as port_br
import frankensearch_tpu_torch.utils.quality_harness as port_qh

SEEDS = (0, 7, 2024)


def same(a, b) -> bool:
    """Bitwise equality of nested results: floats by their bits (NaN
    equals NaN), dataclasses by their fields."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a).__name__ == type(b).__name__ and same(dataclasses.asdict(a), dataclasses.asdict(b))
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def ranked_world(seed: int, n_queries: int = 24, n_docs: int = 60):
    """Seeded ranked lists and graded judgments: (ranked ids per query,
    qrels per query)."""
    rng = np.random.default_rng(seed)
    ranked, qrels = [], []
    for _ in range(n_queries):
        order = rng.permutation(n_docs)[: int(rng.integers(0, 30))]
        ranked.append([f"d{i}" for i in order])
        judged = rng.choice(n_docs, size=int(rng.integers(0, 8)), replace=False)
        qrels.append({f"d{i}": float(rng.integers(0, 4)) for i in judged})
    return ranked, qrels


@pytest.mark.parametrize("seed", SEEDS)
def test_ranking_metrics_equal_reference(seed):
    ranked, qrels = ranked_world(seed)
    for ids, rel in zip(ranked, qrels):
        for k in (1, 5, 10, 100):
            assert same(port_me.ndcg_at_k(ids, rel, k), ref_me.ndcg_at_k(ids, rel, k))
            assert same(port_me.map_at_k(ids, rel, k), ref_me.map_at_k(ids, rel, k))
            assert same(port_me.recall_at_k(ids, rel, k), ref_me.recall_at_k(ids, rel, k))
            gains = [rel.get(d, 0.0) for d in ids]
            assert same(port_me.dcg_at_k(gains, k), ref_me.dcg_at_k(gains, k))
        assert same(port_me.mrr(ids, rel), ref_me.mrr(ids, rel))
        assert same(port_me.kendall_tau(ids, ids[::-1][:20]), ref_me.kendall_tau(ids, ids[::-1][:20]))


def test_dcg_adds_in_rank_order():
    """The discount is added gain by gain in rank order: not a compensated
    ``sum()``, whose bits differ on these gains."""
    gains = [3.0, 1e-17, 2.0, 1e-17, 1.0, 0.5, 1e-16, 2.5]
    want = 0.0
    for i, g in enumerate(gains):
        want += g / math.log2(i + 2)
    assert same(port_me.dcg_at_k(gains, 8), want) and same(port_me.dcg_at_k(gains, 8), ref_me.dcg_at_k(gains, 8))


@pytest.mark.parametrize("seed", SEEDS)
def test_bootstrap_statistics_equal_reference(seed):
    rng = np.random.default_rng(seed)
    a = list(rng.random(30))
    b = list(np.asarray(a) + rng.normal(0.02, 0.05, 30))
    for conf in (0.9, 0.95):
        assert same(port_me.bootstrap_ci(a, 500, conf, seed=seed), ref_me.bootstrap_ci(a, 500, conf, seed=seed))
        assert same(port_me.bootstrap_compare(a, b, 500, conf, seed=seed),
                    ref_me.bootstrap_compare(a, b, 500, conf, seed=seed))
    assert same(port_me.bootstrap_ci([]), ref_me.bootstrap_ci([]))
    samples = list(rng.normal(10.0, 1.0, 12)) + [40.0, -5.0]
    assert same(port_me.iqr_trim(samples), ref_me.iqr_trim(samples))
    assert same(port_me.iqr_trim(samples[:3]), ref_me.iqr_trim(samples[:3]))
    for xs in (samples, samples[:4], [0.0] * 6, list(rng.random(9) * 5)):
        assert same(port_me.stability_verdict(xs), ref_me.stability_verdict(xs))
    with pytest.raises(ValueError):
        port_me.bootstrap_compare([1.0], [1.0, 2.0])


class Hit:
    def __init__(self, doc_id):
        self.doc_id = doc_id


def eval_world(pkg_qh, seed: int):
    ranked, qrels = ranked_world(seed, n_queries=16)
    texts = ["rust async", "TwoTierSearcher", "how does the fused scan work", "src/main.rs", "bd-123", "vector"]
    queries = [pkg_qh.EvalQuery(query_id=f"q{i}", text=texts[i % len(texts)], qrels=rel)
               for i, rel in enumerate(qrels)]
    results = {q.text + q.query_id: ranked[i] for i, q in enumerate(queries)}
    by_text = {}
    for q in queries:
        by_text.setdefault(q.text, []).append(results[q.text + q.query_id])

    def search_fn(text, k):  # host hit lists, in the queries' order
        return [Hit(d) for d in by_text[text].pop(0)][:k]

    return queries, search_fn


@pytest.mark.parametrize("seed", SEEDS)
def test_quality_report_and_comparison_equal_reference(seed):
    reports = {}
    for name, qh in (("port", port_qh), ("ref", ref_qh)):
        out = []
        for shift in (0, 1):
            queries, search_fn = eval_world(qh, seed + shift)
            queries = [dataclasses.replace(q, query_id=f"q{i}") for i, q in enumerate(queries)]
            out.append(qh.evaluate(search_fn, queries, k=10, system=f"s{shift}", n_resamples=400, seed=seed))
        reports[name] = out
    for got, want in zip(reports["port"], reports["ref"]):
        a, b = got.to_dict(), want.to_dict()
        a.pop("mean_latency_ms"), b.pop("mean_latency_ms")  # the host clock
        assert same(a, b) and same(got.per_query, want.per_query)
    for metric in ("ndcg", "mrr", "recall"):
        assert same(port_qh.compare_systems(*reports["port"], metric=metric, n_resamples=400, seed=seed),
                    ref_qh.compare_systems(*reports["ref"], metric=metric, n_resamples=400, seed=seed))


def test_golden_profile_files_are_byte_equal(tmp_path):
    files = {}
    for name, br in (("port", port_br), ("ref", ref_br)):
        prof = br.GoldenProfile(name="tiny", n_docs=1000, metrics={"search_p50_ms": 2.5, "index_docs_per_s": 900.0},
                                replay_command="python bench.py --profile tiny")
        path = tmp_path / name / "golden" / "tiny.json"
        br.save_golden(str(path), prof)
        files[name] = path.read_bytes()
        assert br.load_golden(str(path)) == prof
    assert files["port"] == files["ref"]


@pytest.mark.parametrize("case", ["within", "regressed", "unstable", "missing", "higher_better"])
def test_check_regression_equals_reference(case):
    rng = np.random.default_rng(5)
    samples = {
        "within": {"search_p50_ms": list(2.5 + rng.normal(0, 0.05, 9))},
        "regressed": {"search_p50_ms": list(4.0 + rng.normal(0, 0.05, 9))},
        "unstable": {"search_p50_ms": [1.0, 9.0, 0.2, 5.0, 7.0, 0.1, 3.0]},
        "missing": {},
        "higher_better": {"index_docs_per_s": list(500.0 + rng.normal(0, 5, 9))},
    }[case]
    reports = []
    for br in (port_br, ref_br):
        golden = br.GoldenProfile("tiny", 100, {"search_p50_ms": 2.5, "index_docs_per_s": 900.0}, "replay")
        reports.append(br.check_regression(golden, samples).to_dict())
    assert same(reports[0], reports[1])


def test_measure_profile_equals_reference():
    outs = []
    for br in (port_br, ref_br):
        calls = iter(range(100))
        outs.append(br.measure_profile(lambda: {"a_ms": float(next(calls)), "b": 2.0}, samples=5, warmup=2))
    assert same(outs[0], outs[1]) and outs[0]["a_ms"] == [2.0, 3.0, 4.0, 5.0, 6.0]


RATCHET_CASES = {
    "pass": ([1.0 + 0.01 * i for i in range(7)], [1.05 + 0.01 * i for i in range(7)], "same"),
    "regression": ([1.0, 1.01, 0.99, 1.0, 1.02, 1.0, 0.98], [1.5, 1.52, 1.49, 1.51, 1.5, 1.48, 1.53], "same"),
    "unstable": ([1.0, 5.0, 0.1, 9.0, 2.0, 7.0, 0.5], [1.0, 5.0, 0.1, 9.0, 2.0, 7.0, 0.5], None),
    "aa_null": ([1.0] * 7, [1.0] * 7, [2.0] * 7),
    "slower_not_significant": ([1.0, 1.1, 0.95, 1.05, 1.0, 1.02, 0.98], [1.3, 1.1, 1.35, 1.0, 1.4, 1.2, 1.1], "same"),
}


@pytest.mark.parametrize("case", sorted(RATCHET_CASES))
def test_run_ratchet_equals_reference(case):
    incumbent, candidate, null = RATCHET_CASES[case]
    null = incumbent if null == "same" else null
    got = port_pr.run_ratchet(port_pr.RatchetGate("QG-test"), incumbent, candidate, null)
    want = ref_pr.run_ratchet(ref_pr.RatchetGate("QG-test"), incumbent, candidate, null)
    assert same(got.to_dict(), want.to_dict())


def test_measure_times_each_call():
    calls = []
    samples = port_pr.measure(lambda: calls.append(1), samples=4, warmup=3)
    assert len(calls) == 7 and len(samples) == 4 and all(s >= 0.0 for s in samples)


def test_bench_ledger_files_are_byte_equal(tmp_path, monkeypatch):
    files = {}
    for name, pr in (("port", port_pr), ("ref", ref_pr)):
        monkeypatch.setattr(pr.time, "time", lambda: 1_700_000_000.25)
        ledger = pr.BenchLedger(str(tmp_path / name / ".bench-history"))
        for ratio in (0.9, 1.1):
            out = pr.RatchetOutcome(gate="QG-1", passed=True, reason="ok", ratio=ratio)
            path = ledger.record(out, context={"machine": "h100"})
        files[name] = ((tmp_path / name / ".bench-history" / "QG-1.history.jsonl").read_bytes(),
                       open(path, "rb").read())
        assert ledger.latest("QG-1")["ratio"] == 1.1 and ledger.latest("QG-2") is None
    assert files["port"] == files["ref"]
