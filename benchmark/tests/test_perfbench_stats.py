"""The end-to-end statistics and the trace's interval arithmetic."""

import math

import pytest

from benchmark.harness import roofline, stats, trace
from benchmark.harness.window import Request, Spans


def req(start, end, size=1, error=None):
    return Request(client=0, first=0, size=size, start=start, end=end, error=error)


def test_percentile_is_over_every_query():
    # 100 queries: 94 fast ones and 6 slow ones; the 95th is a slow one
    requests = [req(0.0, 0.001) for _ in range(94)] + [req(0.0, 0.5) for _ in range(6)]
    lat = stats.latencies_ms(requests)
    assert len(lat) == 100
    assert stats.percentile(lat, 95.0) == pytest.approx(500.0)
    assert stats.percentile(lat, 94.0) == pytest.approx(1.0)
    assert stats.percentile([3.0], 95.0) == 3.0


def test_batch_queries_each_count_and_failures_never_answer():
    lat = stats.latencies_ms([req(0.0, 0.01, size=64), req(0.0, 0.02, error="boom")])
    assert len(lat) == 65 and lat.count(math.inf) == 1
    assert stats.percentile(lat, 100.0) == math.inf


def test_rate_is_over_the_whole_window():
    # answers inside [10, 20]: 3 requests of 64; one ends after the window, one failed
    requests = [req(10.0, 12.0, 64), req(12.0, 15.0, 64), req(15.0, 19.5, 64),
                req(19.5, 21.0, 64), req(11.0, 13.0, 64, error="x")]
    assert stats.completed(requests, 20.0) == 192
    assert stats.rate(requests, 10.0, 20.0) == pytest.approx(19.2)


def test_union_counts_overlapping_kernels_once():
    ivs = [(0.0, 10.0, "a", 1), (5.0, 12.0, "b", 2), (20.0, 25.0, "c", 3), (24.0, 24.5, "d", 4)]
    assert trace.merged(ivs, 0.0, 100.0) == [(0.0, 12.0), (20.0, 25.0)]
    assert trace.union_length(ivs, 0.0, 100.0) == 17.0
    assert trace.union_length(ivs, 6.0, 22.0) == 8.0  # clipped to the window
    assert trace.gaps([(0.0, 12.0), (20.0, 25.0)], -5.0, 30.0) == [(-5.0, 0.0), (12.0, 20.0), (25.0, 30.0)]


def chrome(events):
    return trace.parse([{"ph": "X", **e} for e in events])


def test_idle_share_and_ranges_from_a_trace():
    tr = chrome([
        {"cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0, "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "index.search_batch", "ts": 10, "dur": 20, "tid": 7},
        {"cat": "user_annotation", "name": "embed.embed_batch", "ts": 40, "dur": 10, "tid": 7},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1, "tid": 7, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 25, "dur": 1, "tid": 7, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41, "dur": 1, "tid": 7, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "void group_max_kernel<1>()", "ts": 14, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "void gather_rescore_kernel<1>()", "ts": 44, "dur": 6, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "elementwise", "ts": 50, "dur": 10, "args": {"correlation": 3}},
        {"cat": "cpu_op", "name": "aten::item", "ts": 60, "dur": 30, "tid": 7},
    ])
    assert trace.busy_s(tr) == pytest.approx(46e-6)
    assert tr.window_s == pytest.approx(100e-6)
    ops, n = trace.launched_in(tr, "index.search_batch")
    assert n == 1 and [o[2] for o in ops] == ["void group_max_kernel<1>()", "void gather_rescore_kernel<1>()"]
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["group_max_kernel<1>", pytest.approx(30e-6)]  # names without their signature
    labels = dict(b["idle_gaps"])
    # idle 0..14 and 60..100: each instant goes to the innermost host span over it
    assert labels["aten::item"] == pytest.approx(30e-6)
    assert labels["index.search_batch"] == pytest.approx(4e-6)
    assert labels["no traced host work"] == pytest.approx(20e-6)
    assert sum(labels.values()) == pytest.approx(54e-6)


def test_exact_scan_bytes_and_operations_from_shapes():
    moved, ops = roofline.exact_scan(1, 8_841_823, 8_847_360, 256, 30)
    assert moved == 8_841_823 * 256 * 2 + 8_847_360 * 4 + 256 * 4 + 30 * 8
    assert ops == 2 * 8_841_823 * 256
    ms, by = roofline.bound(moved, ops, "bf16")
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    moved64, ops64 = roofline.exact_scan(64, 1 << 20, 1 << 20, 256, 60)
    assert roofline.bound(moved64, ops64, "bf16")[1] == "bytes"
    assert roofline.bound(1.0, 1e12, "bf16") == (pytest.approx(1e12 / 989e12 * 1e3), "operations")


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::group_max_kernel<0, 8>(CUtensorMap_st, float const*, int)", "group_max_kernel<0, 8>"),
    ("(anonymous namespace)::gather_plan_scan(int*, int*, int, int)", "gather_plan_scan"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8", "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8"),
])
def test_kernel_names_lose_their_signature(name, short):
    assert trace.short_name(name) == short


def test_readers_of_the_window_and_its_spans():
    from types import SimpleNamespace

    from benchmark.harness import spec

    requests = [req(10.0, 10.05, 64), req(10.05, 10.12, 64), req(10.12, 10.2, 64, error="x"),
                req(10.2, 10.4, 64)]
    spans = Spans()
    spans.add("embed.embed_batch", 0.064)
    run = SimpleNamespace(requests=requests, plain=requests, start=10.0, end=10.3, setup_s=21.5, answered=128,
                          spans=spans, trace=None)
    assert spec.reader("qps")(run) == pytest.approx(128 / 0.3)  # the request past the window's end is out
    assert spec.reader("setup_s")(run) == 21.5
    assert spec.reader("embed_ms_per_query")(run) == pytest.approx(0.5)
    assert spec.reader("call_p95_ms")(run) == math.inf  # a failed request never answers
    run.plain = requests[:2] + requests[3:]
    assert spec.reader("call_p95_ms")(run) == pytest.approx(200.0)
    assert spec.reader("idle_share")(run) is None and spec.reader("scan_roofline")(run) is None
    assert spec.reader("device_ms_per_query")(run) is None
