"""The port's hybrid ``search_batch`` (the fused phase-1 pass: Model2Vec
embed, the exact vector scan, device BM25 and the RRF tail on the device)
held to the benchmark's plain reference (benchmark/harness/
lexical_reference.py: float64 BM25 of every doc, the exact cosine, RRF) by
the benchmark's own judge, on the CPU at a small size, in each lexical
lane the pass dispatches to. The lanes' thresholds are lowered as the
lexical tests lower them, so a few thousand docs reach the blocked layout,
its hot arm and the term-driven lane. Also: each outcome's lane, the
term-driven lane's call counter, and the pass's spans."""

import collections
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch.profiler as torch_profiler  # noqa: E402

from benchmark.harness import check, data, spec  # noqa: E402
from frankensearch_tpu_torch.lexical import daat, device_bm25, hot_arm  # noqa: E402

SEED = 2**31 + 4021
CPU = torch.device("cpu")
N_DOCS, VOCAB, BATCH = 3000, 2000, 64
#: each case: (blocked threshold, hot arm's least postings, DAAT's crossover
#: divisor), None keeping the module's own values; the batch's lane; the
#: lanes its queries take ("flat": K3 over the split layout with the hot
#: columns, "pruned": the unsplit layout's block-max scan)
LANES = {
    "dense": ((None, None, None), "dense", {"dense"}),
    "blocked": ((1, 1, 1 << 40), "blocked", {"flat"}),
    "pruned": ((1, 1 << 60, 1 << 40), "blocked", {"pruned"}),
    "daat": ((1, 1 << 60, 1), "daat", {"daat"}),
    "mixed": ((1, 1, 1), "mixed", {"daat", "flat"}),
}
PASS_SPANS = ["fs.fused_pass.plan", "fs.fused_pass.enqueue", "fs.fused_pass.fetch", "fs.fused_pass.finish"]


def config() -> dict:
    cfg = spec.config(spec.load(), "quora-hybrid")
    cfg["docs"] = N_DOCS
    cfg["embedder"]["rows"] = cfg["queries"]["vocab"] = cfg["corpus"]["vocab"] = VOCAB
    return cfg


def profiler():
    return torch_profiler.profile(activities=[torch_profiler.ProfilerActivity.CPU])


def parents(prof) -> dict:
    """name -> the names of its innermost enclosing ``fs.*`` range on its
    thread, for every ``fs.*`` range but collector passes."""
    ranges = [(e.name, e.thread, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("fs.") and e.name != "fs.gc"]
    out: dict = {}
    for name, tid, s, e in ranges:
        around = [(rs, -re, rn) for rn, rt, rs, re in ranges
                  if rt == tid and rs <= s and e <= re and (rs, re, rn) != (s, e, name)]
        out.setdefault(name, set()).add(max(around)[2] if around else None)
    return out


@pytest.mark.parametrize("lane", list(LANES))
def test_hybrid_search_batch_agrees_with_the_plain_reference(monkeypatch, lane):
    (blocked, hot_min, divisor), want_batch, want_queries = LANES[lane]
    if blocked is not None:
        monkeypatch.setattr(device_bm25, "BLOCKED_THRESHOLD_POSTINGS", blocked)
        monkeypatch.setattr(hot_arm, "HOT_MIN_POSTINGS", hot_min)
        monkeypatch.setattr(hot_arm, "HOT_MAX_TERMS", 6)
        monkeypatch.setattr(daat, "DAAT_CROSSOVER_DIVISOR", divisor)
    cfg = config()
    hybrid = spec.plugin("systems", "hybrid")
    system = hybrid.build(cfg, SEED, CPU)
    try:
        queries = data.queries(SEED, "window", cfg["queries"], 2 * BATCH).strings()
        daat_before = daat.daat_topk_tm.launches
        with profiler() as prof:
            outcomes = system.searcher.search_batch(queries[:BATCH], 10)
        outcomes += system.searcher.search_batch(queries[BATCH:], 10)
        daat_calls = daat.daat_topk_tm.launches - daat_before
        batch_lane = system.searcher.last_phase1_lex_lane
    finally:
        system.searcher.close()
    del system

    assert batch_lane == want_batch
    assert all(o.metrics.phase1_fused for o in outcomes)
    lanes = collections.Counter(o.metrics.lexical_lane for o in outcomes)
    assert set(lanes) == want_queries, lanes
    assert (daat_calls > 0) == ("daat" in lanes)
    # each outcome counts its own arms' candidates: 60 vector, at most 30 lexical
    assert all(o.metrics.fast_candidates == 60 and 0 < o.metrics.lexical_candidates <= 30 for o in outcomes)

    numbers = {"failed": [0, 0], **hybrid.judge(cfg, SEED, list(zip(queries, outcomes)), 10, CPU)}
    assert check.correct(numbers), numbers
    assert numbers["fusion_mismatch"][0] == numbers["malformed"][0] == numbers["unfused"][0] == 0
    assert 0 < numbers["lex_score_err"][0] <= 1e-5 and numbers["vec_score_err"][0] > 0

    nest = parents(prof)
    assert nest["fs.fused_pass"] == {"fs.search_batch"}
    for name in PASS_SPANS:
        assert nest[name] == {"fs.fused_pass"}, (name, nest)
    assert nest["fs.index.hydrate"] == {"fs.fused_pass.finish"}
    assert "fs.embed" not in nest and "fs.search.vector" not in nest  # the embed and scan run in the pass
