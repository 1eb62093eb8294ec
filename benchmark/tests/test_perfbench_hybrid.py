"""The hybrid cell at a tiny size on the CPU: the port's fused phase-1 pass
against the plain BM25 + cosine + RRF reference, the faults a hybrid
search can have, the bf16 control on the card, and the cell's new metric
readers on a trace without their spans."""

import dataclasses

import pytest

from benchmark.harness import cell, lexical_reference as lexref, spec, trace
from benchmark.harness.cell import Run
from conftest import SEED, tiny_config

WORKLOAD = "quora-hybrid-batch"
READERS = ["lex_plan_ms_per_query", "fused_finish_ms_per_query", "fused_device_ms_per_query", "flat_roofline"]


def tiny(bench, **overrides) -> dict:
    cfg = tiny_config(bench, "quora-hybrid")
    cfg["corpus"]["vocab"] = cfg["queries"]["vocab"]
    cfg.update(overrides)
    return cfg


def test_the_port_agrees_with_the_reference(run_tiny, bench):
    result, log, lines = run_tiny(WORKLOAD, config=tiny(bench))
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics_of(bench, "end_to_end", WORKLOAD)}
    assert set(result["checks"]) == {"failed", "unfused", "malformed", "fusion_mismatch", "vec_score_err",
                                     "vec_rank_gap", "lex_score_err", "lex_rank_gap"}
    assert lines[-1] == "correct: True"


def test_a_traced_run_reports_the_host_spans_of_the_fused_pass(run_tiny, bench):
    result, log, lines = run_tiny(WORKLOAD, config=tiny(bench), traced=True)
    assert result["correct"], lines
    # the CPU launches no kernel: the two device readers read nothing there
    want = {m["name"] for m in spec.metrics_of(bench, "per_layer", WORKLOAD)}
    assert want == set(READERS)
    assert set(result["metrics"]) == want - {"fused_device_ms_per_query", "flat_roofline"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


def lexical_score(system):
    """The first result with a BM25 score scored 0.01 too high."""
    serve = system.searcher.search_batch

    def altered(*a, **kw):
        out = serve(*a, **kw)
        for o in out:
            j = next(j for j, r in enumerate(o.results) if r.lexical_score is not None)
            o.results[j] = dataclasses.replace(o.results[j], lexical_score=o.results[j].lexical_score + 0.01)
        return out

    system.searcher.search_batch = altered


def lexical_dropped(system):
    """The searcher serves without its lexical arm."""
    system.searcher.lexical = None


def fused_rank(system):
    """Every one-arm result's fused score as if it stood one rank lower."""
    serve = system.searcher.search_batch

    def lowered(*a, **kw):
        out = serve(*a, **kw)
        for o in out:
            o.results = [dataclasses.replace(r, score=1.0 / (1.0 / r.score + 1.0))
                         if (r.lexical_score is None) != (r.fast_score is None) else r for r in o.results]
        return out

    system.searcher.search_batch = lowered


@pytest.mark.parametrize("fault,flags", [(lexical_score, "lex_score_err"), (lexical_dropped, "fusion_mismatch"),
                                         (fused_rank, "fusion_mismatch")],
                         ids=["lexical_score", "lexical_dropped", "fused_rank"])
def test_a_faulty_answer_is_not_correct(run_tiny, bench, fault, flags):
    result, log, lines = run_tiny(WORKLOAD, config=tiny(bench), system_hook=fault)
    assert not result["correct"], lines
    got = result["checks"][flags]
    assert got["value"] > got["limit"], lines


def test_two_lexical_docs_swapped_are_not_correct(run_tiny, bench, monkeypatch):
    """Each query's two best lexical docs swap ranks in the fused pass's
    lexical arm, before the RRF tail sees them."""
    from frankensearch_tpu_torch.ops import hybrid_phase1 as hp

    def swapped(body):
        def lane(*a, **kw):
            vec_s, vec_i, lex_s, lex_i = body(*a, **kw)
            cols = [1, 0] + list(range(2, lex_s.shape[1]))
            return vec_s, vec_i, lex_s[:, cols], lex_i[:, cols]
        return lane

    # the bodies the searcher calls with a Model2Vec fast tier (each calls
    # its vector-given body, which is left as it is)
    for name in [n for n in dir(hp) if n.startswith("fused_phase1_embed_")]:
        monkeypatch.setattr(hp, name, swapped(getattr(hp, name)))
    result, log, lines = run_tiny(WORKLOAD, config=tiny(bench))
    assert not result["correct"], lines
    assert result["checks"]["fusion_mismatch"]["value"] > 0, lines


@pytest.mark.cuda
def test_the_bf16_bm25_control_is_not_correct(bench, cuda_device):
    import time

    cfg = tiny(bench, docs=262_144, control="bm25-bf16")
    t0 = time.perf_counter()
    result, log, lines = cell.run(WORKLOAD, SEED, 1.0, False, cuda_device, bench=bench, config=cfg,
                                  setup_clock=lambda: time.perf_counter() - t0)
    assert not result["correct"], lines
    assert result["checks"]["lex_score_err"]["value"] > result["checks"]["lex_score_err"]["limit"], lines


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_on_a_trace_without_its_spans(bench, name):
    tr = trace.parse([
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0.0, "dur": 1000.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "fs.search_batch", "ts": 10.0, "dur": 500.0, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "flat_fused_kernel(int const*)", "ts": 20.0, "dur": 5.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 7}},
    ])
    cfg = tiny(bench)
    run = Run(spec.cell(bench, WORKLOAD), cfg, spec.mix("batch"), None, [], [], 0.0, 1.0, 1.0, 64, tr,
              launches={"flat_class_fused": 1})
    assert spec.reader(name)(run) is None


def test_the_fieldnorm_table_is_tantivy_s():
    table = lexref.fieldnorm_table()
    assert list(table[:41]) == list(range(41))
    assert list(table[41:50]) == [42, 44, 46, 48, 50, 52, 54, 56, 60]
    assert table[-1] == 2_013_265_944 and (table[1:] > table[:-1]).all()
    assert list(lexref.fieldnorm([0, 40, 41, 43, 59, 60, 3_000_000_000])) == [0, 40, 40, 42, 56, 60, 2_013_265_944]


def test_rrf_orders_by_sum_then_both_arms_then_lexical_score_then_row():
    lexical = [(5, 9.0), (3, 8.0)]
    vector = [(7, 0.9), (3, 0.8), (1, 0.7)]
    got = lexref.rrf_two_arms(lexical, vector, 10, 60, 1.0, 1.0)
    assert [r for r, *_ in got] == [3, 5, 7, 1]
    assert got[0][1] == 1.0 / 62 + 1.0 / 62 and got[1][1] == got[2][1] == 1.0 / 61
    assert got[1][2:] == (9.0, None) and got[2][2:] == (None, 0.9)


def test_the_query_classes_set_each_arm_s_depth():
    hybrid = spec.plugin("systems", "hybrid")
    assert hybrid.depths("w000001 w000002 w000003", 10, 3) == ([30], [30, 60])
    assert hybrid.depths("w000001 w000002 w000003 w000004", 10, 3) == ([15, 30], [60])

