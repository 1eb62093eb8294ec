"""The serving path's spans (utils/tracing.py) on a tiny CPU searcher.

Under ``torch.profiler`` every phase timer of ``TwoTierSearcher.search`` and
``search_batch`` is a ``record_function`` range named ``fs.*``, nested as
an operator reading a profile expects, and each collector pass is an
``fs.gc`` range. With no profiler recording, the path opens no range at
all, and the results are the same bits either way.
"""

import gc
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch.autograd.profiler as autograd_profiler
import torch.profiler as torch_profiler
from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
from frankensearch_tpu_torch.core.config import CollectingExporter
from frankensearch_tpu_torch.embed.model2vec import random_model2vec
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.utils import tracing

CPU = torch.device("cpu")
VOCAB = [f"w{i}" for i in range(300)]
N_DOCS, DIM = 384, 64
QUERIES = ["w1 w2 w3", "w4 w5", "w7 w8 w9 w10", "w11", "w12 w13 w14", "w20 w21"]
#: the range names the repo's benchmark opens around the program's calls
#: (benchmark/harness/trace.py, cell.py, systems/vector.py and hybrid.py)
BENCHMARK_RANGES = {"bench.window", "searcher.search", "searcher.search_batch",
                    "index.search_batch", "embed.embed_batch", "lexical.flat_scan"}
PORT = Path(__file__).resolve().parents[1] / "frankensearch_tpu_torch"


def make_searcher(**kwargs) -> TwoTierSearcher:
    emb = random_model2vec(VOCAB, dim=DIM, seed=0, device=CPU)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    slab = torch.zeros((N_DOCS, 128), dtype=torch.float32)
    slab[:, :DIM] = torch.from_numpy(v)
    fast = DeviceVectorIndex.from_padded(slab, torch.zeros(N_DOCS), [f"d{i}" for i in range(N_DOCS)],
                                         emb.identity())
    return TwoTierSearcher(TwoTierIndex(fast), emb, config=TwoTierConfig(fast_only=True), **kwargs)


@pytest.fixture(scope="module")
def searcher():
    s = make_searcher()
    yield s
    s.close()


def profiler():
    """A CPU profiler that records every thread (the searcher's pool thread)."""
    try:
        from torch.profiler import _ExperimentalConfig

        return torch_profiler.profile(activities=[torch_profiler.ProfilerActivity.CPU],
                                      experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return torch_profiler.profile(activities=[torch_profiler.ProfilerActivity.CPU])


def fs_ranges(prof) -> list[tuple[str, int, float, float]]:
    """(name, thread, start, end) of every ``fs.*`` range of a profile."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("fs.")]


def parents(ranges, skip=("fs.gc",)) -> dict[str, set]:
    """name -> the names of its innermost enclosing ``fs.*`` range on the
    same thread (``None`` for a root), for names not in ``skip`` (a
    collector pass may fall anywhere)."""
    out: dict[str, set] = {}
    for name, tid, s, e in ranges:
        if name in skip:
            continue
        around = [(rs, -re, rn) for rn, rt, rs, re in ranges
                  if rt == tid and rs <= s and e <= re and (rs, re, rn) != (s, e, name)]
        out.setdefault(name, set()).add(max(around)[2] if around else None)
    return out


def test_search_spans_nest_as_documented(searcher):
    with profiler() as prof:
        searcher.search("w30 w31 w32", 5)
    ranges = fs_ranges(prof)
    assert parents(ranges) == {
        "fs.search": {None},
        "fs.search.parse": {"fs.search"},
        "fs.search.vector": {"fs.search"},
        "fs.index.scan": {"fs.search.vector"},
        "fs.index.hydrate": {"fs.search.vector"},
        "fs.index.fetch": {"fs.index.hydrate"},
        "fs.search.fuse": {"fs.search"},
        # no lexical arm to overlap with: the embed runs on the caller's
        # thread, so no range waits for a pool thread
        "fs.embed": {"fs.search"},
        "fs.embed.tokenize": {"fs.embed"},
        "fs.embed.pool": {"fs.embed"},
        "fs.embed.fetch": {"fs.embed"},
    }
    by_name = {name: (tid, s, e) for name, tid, s, e in ranges}
    assert by_name["fs.search"][0] == by_name["fs.embed"][0]
    # the embed ends before the vector arm starts
    assert by_name["fs.embed"][2] <= by_name["fs.search.vector"][1]


def test_with_a_lexical_arm_the_lexical_search_runs_on_the_pool_thread_beside_the_embed():
    from frankensearch_tpu_torch.core.types import IndexableDocument
    from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

    lex = MemoryLexicalIndex()
    for i in range(40):
        lex.add_document(IndexableDocument(f"d{i}", f"w{30 + i % 7} w{31 + i % 5} w{i}"))
    lex.commit()
    s = make_searcher(lexical=lex)
    try:
        with profiler() as prof:
            out = s.search("w30 w31 w32", 5)
    finally:
        s.close()
    assert out.results and out.metrics.lexical_candidates > 0 and out.metrics.lexical_ms > 0
    ranges = fs_ranges(prof)
    got = parents(ranges)
    assert got["fs.embed"] == got["fs.search.wait_lexical"] == got["fs.search.vector"] == {"fs.search"}
    # the lexical arm runs on the searcher's pool thread while the caller embeds, then waits for it
    assert got["fs.lexical"] == {None}
    by_name = {name: (tid, s, e) for name, tid, s, e in ranges}
    assert by_name["fs.search"][0] == by_name["fs.embed"][0] != by_name["fs.lexical"][0]
    assert by_name["fs.search"][1] <= by_name["fs.lexical"][1]
    assert by_name["fs.lexical"][2] <= by_name["fs.search.wait_lexical"][2]


def test_search_batch_spans_nest_as_documented_once_per_batch(searcher):
    queries = [f"w{40 + i} w{41 + i}" for i in range(16)]
    with profiler() as prof:
        searcher.search_batch(queries, 5)
    ranges = fs_ranges(prof)
    assert parents(ranges) == {
        "fs.search_batch": {None},
        "fs.search.parse": {"fs.search_batch"},
        "fs.embed": {"fs.search_batch"},
        "fs.embed.tokenize": {"fs.embed"},
        "fs.embed.pool": {"fs.embed"},
        "fs.embed.fetch": {"fs.embed"},
        "fs.search.vector": {"fs.search_batch"},
        "fs.index.scan": {"fs.search.vector"},
        "fs.index.hydrate": {"fs.search.vector"},
        "fs.index.fetch": {"fs.index.hydrate"},
        "fs.search.fuse": {"fs.search_batch"},
    }
    # one range of each name a batch, whatever its size: none opens per query
    names = [name for name, *_ in ranges if name != "fs.gc"]
    assert len(names) == len(set(names))
    assert len({tid for name, tid, _, _ in ranges if name != "fs.gc"}) == 1


def test_a_collector_pass_inside_a_profiled_call_is_an_fs_gc_range(searcher, monkeypatch):
    to_results = searcher._fused_to_results

    def collecting(*args, **kwargs):
        gc.collect()
        return to_results(*args, **kwargs)

    monkeypatch.setattr(searcher, "_fused_to_results", collecting)
    with profiler() as prof:
        searcher.search("w50 w51", 5)
    ranges = fs_ranges(prof)
    assert "fs.search.fuse" in parents(ranges, skip=()).get("fs.gc", set())


def test_the_collector_hook_is_installed_once(searcher):
    make_searcher().close()
    assert gc.callbacks.count(tracing._collector_hook) == 1


def test_no_span_takes_a_name_the_benchmark_opens(searcher):
    with profiler() as prof:
        searcher.search("w60 w61", 5)
        searcher.search_batch(["w62", "w63 w64"], 5)
        gc.collect()
    seen = {name for name, *_ in fs_ranges(prof)}
    written = set()
    for path in PORT.rglob("*.py"):
        written |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert seen <= written | {"fs.gc"} and "fs.gc" in seen
    assert all(name.startswith("fs.") for name in written)
    assert not (written | seen) & BENCHMARK_RANGES


def test_without_a_profiler_the_path_opens_no_range(searcher, monkeypatch):
    opened = []

    class Counting(autograd_profiler.record_function):
        def __init__(self, name, args=None):
            opened.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    monkeypatch.setattr(torch_profiler, "record_function", Counting)
    assert not autograd_profiler._is_profiler_enabled
    searcher.search("w70 w71", 5)
    searcher.search_batch(["w72 w73", "w74"], 5)
    gc.collect()
    assert opened == []
    # the same calls under a profiler open their ranges through the patched class
    with profiler():
        searcher.search("w75", 5)
        gc.collect()
    assert "fs.search" in opened and "fs.gc" in opened


@pytest.mark.parametrize("call", ["search", "search_batch"])
def test_results_are_bit_equal_with_tracing_on_and_off(call):
    def run():
        s = make_searcher()
        try:
            if call == "search":
                outs = [s.search(q, 5) for q in QUERIES]
            else:
                outs = s.search_batch(QUERIES, 5)
        finally:
            s.close()
        return [[(r.doc_id, r.score, r.fast_score, r.lexical_score) for r in o.results] for o in outs]

    off = run()
    with profiler():
        on = run()
    assert on == off and all(off)


def test_search_batch_outcomes_carry_the_batch_times_and_reach_the_exporter():
    exporter = CollectingExporter()
    s = make_searcher(metrics_exporter=exporter)
    try:
        outcomes = s.search_batch(QUERIES + [""], 5)
    finally:
        s.close()
    assert len(exporter.collected) == len(QUERIES) + 1
    assert [o.metrics for o in outcomes] == exporter.collected
    for m in exporter.collected:
        assert m.fast_embed_ms > 0 and m.vector_scan_ms > 0 and m.fusion_ms > 0
        assert m.total_ms >= m.phase1_ms > 0 and m.canonicalize_us > 0
        assert m.device_kind == "cpu"
    assert len({m.total_ms for m in exporter.collected}) == 1


def test_search_metrics_come_from_the_phase_spans():
    exporter = CollectingExporter()
    s = make_searcher(metrics_exporter=exporter)
    try:
        s.search("w80 w81", 5)
    finally:
        s.close()
    (m,) = exporter.collected
    assert m.fast_embed_ms > 0 and m.vector_scan_ms > 0 and m.fusion_ms > 0
    assert m.total_ms >= m.phase1_ms >= m.vector_scan_ms + m.fusion_ms


def test_span_times_its_block_and_keeps_the_time():
    with tracing.span("fs.test") as sp:
        during = sp.ms
        sum(range(10000))
    after = sp.ms
    assert 0 <= during <= after and sp.ms == after
    # the one flag the span and the collector hook read flips with the profiler
    assert not autograd_profiler._is_profiler_enabled
    with profiler():
        assert autograd_profiler._is_profiler_enabled
    assert not autograd_profiler._is_profiler_enabled


def test_before_torch_is_loaded_a_span_times_and_opens_no_range(monkeypatch):
    monkeypatch.setattr(tracing, "_prof", None)
    monkeypatch.delitem(sys.modules, "torch.autograd.profiler")
    with tracing.span("fs.test") as sp:
        gc.collect()
    assert sp._range is None and sp.ms >= 0 and tracing._prof is None
    monkeypatch.undo()
    with profiler():
        with tracing.span("fs.test") as sp:
            pass
    assert sp._range is not None and tracing._prof is autograd_profiler
