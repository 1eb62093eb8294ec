"""The readers of the program's own spans (harness/spans.py and the five
metrics on it) on hand-built traces: self time under nested children and
collector passes, the union of overlapping passes, launches counted on the
span's thread, and nothing read where the program opened no span."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spans, spec, trace

READERS = ["fusion_ms_per_query", "hydrate_ms_per_query", "fetch_wait_ms_per_query", "gc_share",
           "embed_launches_per_query"]


def run_of(ranges, answered=4, device=(), launches=None, window=(0.0, 10_000.0)):
    tr = trace.Trace(device=list(device), launches=dict(launches or {}), ranges=list(ranges), window=window)
    return SimpleNamespace(trace=tr, answered=answered)


def read(name, run):
    return spec.reader(name)(run)


def test_self_time_takes_out_nested_children_and_collector_passes():
    # a fuse span of 1000 us holding a child of 300 and a collector pass of 200
    # (100 of it inside the child), and a second fuse span of 500 us
    ranges = [(1000.0, 2000.0, "fs.search.fuse", 1), (1100.0, 1400.0, "fs.index.hydrate", 1),
              (1300.0, 1500.0, "fs.gc", 1), (3000.0, 3500.0, "fs.search.fuse", 1),
              (1200.0, 1900.0, "fs.index.hydrate", 2)]  # another thread: not nested
    assert spans.self_us(run_of(ranges).trace, "fs.search.fuse") == pytest.approx(600.0 + 500.0)
    assert read("fusion_ms_per_query", run_of(ranges, answered=4)) == pytest.approx(1.1 / 4)


def test_hydrate_self_time_leaves_out_its_fetch():
    ranges = [(0.0, 1000.0, "fs.search", 1), (100.0, 600.0, "fs.index.hydrate", 1),
              (150.0, 450.0, "fs.index.fetch", 1)]
    assert read("hydrate_ms_per_query", run_of(ranges, answered=2)) == pytest.approx(0.2 / 2)


def test_fetch_wait_sums_both_fetches_less_their_collector_passes():
    ranges = [(100.0, 600.0, "fs.index.hydrate", 1), (150.0, 450.0, "fs.index.fetch", 1),
              (200.0, 250.0, "fs.gc", 1),
              (700.0, 1700.0, "fs.embed.fetch", 7)]  # on the pool thread
    assert read("fetch_wait_ms_per_query", run_of(ranges, answered=1)) == pytest.approx(0.25 + 1.0)


def test_gc_share_is_the_union_of_passes_over_the_window():
    ranges = [(0.0, 5000.0, "fs.search_batch", 1), (1000.0, 2000.0, "fs.gc", 1),
              (1500.0, 2500.0, "fs.gc", 2),  # overlaps the first on another thread
              (9500.0, 10_500.0, "fs.gc", 1)]  # half outside the window
    assert read("gc_share", run_of(ranges)) == pytest.approx(100.0 * (1500.0 + 500.0) / 10_000.0)
    # the program's spans are there and no pass ran: a share of 0
    assert read("gc_share", run_of(ranges[:1])) == 0.0


def test_spans_are_clipped_to_the_window():
    ranges = [(-500.0, 500.0, "fs.search.fuse", 1), (9800.0, 10_400.0, "fs.search.fuse", 1)]
    assert read("fusion_ms_per_query", run_of(ranges, answered=1)) == pytest.approx(0.7)


def test_embed_launches_count_on_the_span_thread_only():
    ranges = [(100.0, 200.0, "fs.embed.pool", 1), (300.0, 400.0, "fs.embed.pool", 1)]
    # correlation -> (thread, launch time): 3 inside the spans on thread 1, one on
    # thread 2 at the same time, one on thread 1 between the spans
    launches = {1: (1, 110.0), 2: (1, 150.0), 3: (1, 350.0), 4: (2, 150.0), 5: (1, 250.0)}
    device = [(500.0 + 10 * c, 505.0 + 10 * c, "k", c) for c in launches]
    run = run_of(ranges, answered=2, device=device, launches=launches)
    assert read("embed_launches_per_query", run) == pytest.approx(3 / 2)
    # spans and no launch (the CPU): a count of 0
    assert read("embed_launches_per_query", run_of(ranges, answered=2)) == 0.0


def test_nothing_is_read_without_the_programs_spans():
    # what a program with no spans of its own leaves: the benchmark's ranges alone
    ranges = [(0.0, 900.0, "searcher.search", 1), (100.0, 300.0, "embed.embed_batch", 7),
              (400.0, 600.0, "index.search_batch", 1)]
    for name in READERS:
        assert read(name, run_of(ranges)) is None, name
    no_trace = SimpleNamespace(trace=None, answered=3)
    for name in READERS:
        assert read(name, no_trace) is None, name


def test_every_new_metric_is_declared_where_it_reads(bench):
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = declared[name]
        assert m["source"] == "program_span" and m["moves"] == "qps"
        # the fetch wait reads low under the profiler at B=1 (its docstring)
        cells = (["msmarco-dense-batch"] if name == "fetch_wait_ms_per_query"
                 else ["msmarco-dense-interactive", "msmarco-dense-batch"])
        assert m["workloads"] == cells
