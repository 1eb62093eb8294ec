"""Whole runs of each cell at a tiny size on the CPU: the port's answers
against the plain reference, the faults a search can have and the
control, each coming out as it should."""

import dataclasses

import pytest

from benchmark.harness import cell, control, spec
from conftest import SEED, tiny_config

CELLS = ["msmarco-dense-interactive", "msmarco-dense-batch"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_agrees_with_the_reference(run_tiny, bench, workload):
    result, log, lines = run_tiny(workload)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    want = {m["name"] for m in spec.metrics_of(bench, "end_to_end", workload)}
    assert set(result["metrics"]) == want
    assert result["metrics"]["setup_s"]["value"] > 0 and result["metrics"]["qps"]["value"] >= 0
    assert set(result["checks"]) == {"failed", "malformed", "fusion_mismatch", "vec_score_err", "vec_rank_gap"}
    assert list(result)[-1] == "checks" and lines[-1] == "correct: True"


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reports_its_layers(run_tiny, bench, workload):
    result, log, lines = run_tiny(workload, traced=True)
    assert result["correct"], lines
    assert {"busy_s", "window_s"} <= set(result["device"]) and result["device"]["window_s"] > 0
    # the CPU launches no scan kernels, so scan_roofline reads nothing there
    want = {m["name"] for m in spec.metrics_of(bench, "per_layer", workload)} - {"scan_roofline"}
    assert set(result["metrics"]) == want
    assert "qps" not in result["metrics"] and set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _first_up(hits):
    return [dataclasses.replace(h, score=h.score + 0.01) if j == 0 else h for j, h in enumerate(hits)]


def vector_score(system):
    """The first vector hit of every query scored 0.01 too high where the arm produces it."""
    fast = system.fast
    hydrate = fast.hydrate
    fast.hydrate = lambda res: [_first_up(h) for h in hydrate(res)]


def query_vector(system):
    """Every query's embedding turned a little where the embedder produces it."""
    emb = system.embedder
    embed_batch = emb.embed_batch

    def turned(*a, **kw):
        out = embed_batch(*a, **kw)  # (B, dim) float32 rows
        return (out + 0.05 * out[..., ::-1]).astype(out.dtype)

    emb.embed_batch = turned


def final_doc(system):
    """The top final result of every query names another doc."""
    searcher = system.searcher
    search, batch = searcher.search, searcher.search_batch

    def swap(outcome):
        if outcome.results:
            outcome.results[0] = dataclasses.replace(outcome.results[0], doc_id="d0000003")
        return outcome

    searcher.search = lambda *a, **kw: swap(search(*a, **kw))
    searcher.search_batch = lambda *a, **kw: [swap(o) for o in batch(*a, **kw)]


def half_answered(system):
    """Every other query answered with nothing."""
    searcher = system.searcher
    search, batch = searcher.search, searcher.search_batch
    count = iter(range(1 << 30))

    def one(*a, **kw):
        out = search(*a, **kw)
        if next(count) % 2:
            out.results = []
        return out

    def halve(*a, **kw):
        out = batch(*a, **kw)
        for o in out[1::2]:
            o.results = []
        return out

    searcher.search, searcher.search_batch = one, halve


FAULTS = [vector_score, query_vector, final_doc, half_answered]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_faulty_answer_is_not_correct(run_tiny, workload, fault):
    result, log, lines = run_tiny(workload, system_hook=fault)
    assert not result["correct"], lines
    assert lines[-1] == "correct: False"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_int8_lane_control_is_not_correct(bench, cuda_device, workload):
    import time

    cfg = control.int8_lane(tiny_config(bench, spec.cell(bench, workload)["config"], docs=262_144))
    t0 = time.perf_counter()
    result, log, lines = cell.run(workload, SEED, 1.0, False, cuda_device, bench=bench, config=cfg,
                                  setup_clock=lambda: time.perf_counter() - t0)
    assert not result["correct"], lines


@pytest.mark.parametrize("traffic", ["interactive", "batch"])
def test_warm_up_sends_the_mix_s_requests_and_the_long_bucket(bench, traffic):
    cfg = tiny_config(bench, "msmarco-dense")
    mix = spec.mix(traffic)
    requests = cell.warmup_requests(cfg, mix, SEED)
    assert len(requests) == 1 + mix["warmup_calls"]
    assert all(len(r) == mix["batch"] for r in requests)
    assert len(requests[0][0].split()) == cell.LONG_QUERY_WORDS
    assert requests == cell.warmup_requests(cfg, mix, SEED)
