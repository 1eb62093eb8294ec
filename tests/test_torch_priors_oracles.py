"""The port's ranking priors, off-policy estimates and interaction oracles
(``fusion/priors.py``, ``fusion/ope.py``, ``fusion/interaction_oracles.py``)
against the JAX package's on the CPU.

Oracles: tests/test_priors_planner.py, tests/test_fusion_extras.py and
tests/test_interaction_matrix.py. ``RankingPriors.apply`` with a fixed
clock gives the reference's order and score bits; IPS and DR give its
estimates bitwise. The interaction matrix runs over the port's CPU stack
(a two-tier index, the oracle lexical arm, both embedders) as the
reference's runs over its own: every lane x query x oracle checked, no
violation, and the two packages' reports equal. Outcomes are never fed
across packages: each package's oracles compare against its own
``PhaseKind``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import frankensearch_tpu.core.types as ref_types
import frankensearch_tpu.fusion.interaction_oracles as ref_io
import frankensearch_tpu.fusion.ope as ref_ope
import frankensearch_tpu.fusion.priors as ref_priors
import frankensearch_tpu_torch.core.types as port_types
import frankensearch_tpu_torch.fusion.interaction_oracles as port_io
import frankensearch_tpu_torch.fusion.ope as port_ope
import frankensearch_tpu_torch.fusion.priors as port_priors
from frankensearch_tpu_torch.core.config import TwoTierConfig, TwoTierMetrics
from frankensearch_tpu_torch.ops.pressure import PressureSignals, ResourcePressureGovernor

CPU = torch.device("cpu")
NOW = 1_000_000.0


def results_of(types, seed: int):
    """Seeded results: paths, near-tied scores, mtimes (some unparsable)."""
    rng = np.random.default_rng(seed)
    paths = ["src/fusion/rrf.py", "src/fusion/searcher.py", "src/index/two_tier.py", "docs/readme.md",
             "TwoTierSearcher.md", "src/main.rs", "tests/test_a.py", "notes.txt"]
    mtimes = [NOW - 3600, NOW - 40 * 86400, "yesterday", None, NOW + 50, NOW - 365 * 86400, 0, NOW - 7 * 86400]
    out = []
    for i in rng.permutation(len(paths)):
        meta = None if mtimes[i] is None else {"mtime": mtimes[i]}
        out.append(types.ScoredResult(doc_id=paths[i], score=float(0.5 + rng.normal(0, 0.01)), metadata=meta,
                                      lexical_score=float(rng.random()), title=f"t{i}"))
    return out


def rows(results):
    return [(r.doc_id, np.float64(r.score).tobytes(), r.lexical_score, r.title, r.metadata) for r in results]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("query", ["TwoTierSearcher", "twotier", "how does fusion work", "src/main.rs"])
def test_priors_apply_equals_reference(seed, query):
    kw = dict(working_path="src/fusion", symbols={"src/fusion/searcher.py": ["TwoTierSearcher", "search"],
                                                  "TwoTierSearcher.md": ["TwoTierSearcherDoc"]})
    got = port_priors.RankingPriors(clock=lambda: NOW, **kw).apply(results_of(port_types, seed), query)
    want = ref_priors.RankingPriors(clock=lambda: NOW, **kw).apply(results_of(ref_types, seed), query)
    assert rows(got) == rows(want)
    assert all(type(r) is port_types.ScoredResult for r in got)


def test_priors_follow_the_ports_governor():
    """The port's governor gates the priors as the reference's does: on
    under NORMAL pressure, off from DEGRADED (the card's memory share is
    one of its signals)."""
    gov = ResourcePressureGovernor()
    priors = port_priors.RankingPriors(governor=gov, clock=lambda: NOW)
    stale = port_types.ScoredResult("stale.md", 0.505, metadata={"mtime": 0})
    fresh = port_types.ScoredResult("fresh.md", 0.50, metadata={"mtime": NOW})
    assert priors.apply([stale, fresh], "query")[0].doc_id == "fresh.md"
    gov.observe(PressureSignals(device_hbm_used_frac=0.9))
    assert not gov.allow_ranking_priors
    assert priors.apply([stale, fresh], "query")[0].doc_id == "stale.md"


def logs_of(ope, seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    return [ope.LoggedInteraction(f"q{i % 7}", f"d{i % 11}", float(rng.uniform(0.0, 1.0)),
                                  float(rng.integers(0, 2))) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("clip", [10.0, 1.5])
def test_ope_estimates_equal_reference(seed, clip):
    def target(q, d):
        return (int(q[1:]) + int(d[1:])) % 10 / 10.0

    def model(q, d):
        return int(d[1:]) / 11.0

    for fn, args in (("ips_estimate", (target,)), ("doubly_robust_estimate", (target, model))):
        got = getattr(port_ope, fn)(logs_of(port_ope, seed), *args, clip=clip)
        want = getattr(ref_ope, fn)(logs_of(ref_ope, seed), *args, clip=clip)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert port_ope.ips_estimate([], target) == port_ope.OpeEstimate(0.0, 0.0, 0)


CORPUS = [
    ("d1", "rust async futures and executors"),
    ("d2", "jax tpu jit compilation pipeline"),
    ("d3", "bm25 lexical ranking basics"),
    ("d4", "vector cosine similarity search"),
    ("d5", "sqlite write ahead logging"),
    ("d6", "gradient descent model training"),
]
QUERIES = ["vector search", "rust futures", "tpu jit", "x_y_z_missing", "sqlite"]


def port_stack(root):
    from frankensearch_tpu_torch import HashEmbedder, IndexableDocument, MemoryLexicalIndex, TwoTierIndex

    fe, qe = HashEmbedder(dim=64), HashEmbedder(dim=96)
    texts = [b for _, b in CORPUS]
    index = TwoTierIndex.create(root, fe.embed_batch(texts), [d for d, _ in CORPUS], fe.identity(), device=CPU,
                                quality_vectors=qe.embed_batch(texts), quality_identity=qe.identity())
    lexical = MemoryLexicalIndex()
    for d, b in CORPUS:
        lexical.add_document(IndexableDocument(doc_id=d, content=b))
    lexical.commit()
    return index, lexical, fe, qe


def ref_stack(root):
    from frankensearch_tpu.core.types import IndexableDocument
    from frankensearch_tpu.embed.hash_embedder import HashEmbedder
    from frankensearch_tpu.index.two_tier import TwoTierIndex
    from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex

    fe, qe = HashEmbedder(dim=64), HashEmbedder(dim=96)
    texts = [b for _, b in CORPUS]
    index = TwoTierIndex.create(root, fe.embed_batch(texts), [d for d, _ in CORPUS], fe.identity(),
                                quality_vectors=qe.embed_batch(texts), quality_identity=qe.identity(),
                                use_pallas=False)
    lexical = MemoryLexicalIndex()
    for d, b in CORPUS:
        lexical.add_document(IndexableDocument(doc_id=d, content=b))
    lexical.commit()
    return index, lexical, fe, qe


def report_rows(report):
    return report.checked, [(v.oracle, v.lane, v.detail) for v in report.violations]


@pytest.mark.parametrize("rescan", [False, True])
def test_interaction_matrix_equals_reference(tmp_path, rescan):
    from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
    from frankensearch_tpu_torch import TwoTierSearcher

    reports, kinds = [], []
    for name, io, stack, searcher_cls in (("port", port_io, port_stack, TwoTierSearcher),
                                          ("ref", ref_io, ref_stack, RefSearcher)):
        index, lexical, fe, qe = stack(str(tmp_path / name))
        seen: list = []

        def make_searcher(cfg, index=index, lexical=lexical, fe=fe, qe=qe, cls=searcher_cls):
            cfg = dataclasses.replace(cfg, quality_rescan=rescan, quality_timeout_ms=0)
            s = cls(index, fe, lexical=lexical, quality_embedder=qe, config=cfg, cache_query_embeddings=False)
            search = s.search

            def noted(query, k):
                out = search(query, k=k)
                seen.append([p.kind.value for p in out.phases])
                return out

            s.search = noted
            return s

        reports.append(report_rows(io.run_interaction_matrix(make_searcher, QUERIES, lanes=io.LANE_CATALOG)))
        kinds.append(seen)
    assert reports[0] == reports[1] == (len(port_io.LANE_CATALOG) * len(QUERIES) * 5, [])
    assert kinds[0] == kinds[1] and ["initial", "refined"] in kinds[0]
    assert [lane.name for lane in port_io.LANE_CATALOG] == [lane.name for lane in ref_io.LANE_CATALOG]


def test_lanes_set_the_ports_config():
    for lane in port_io.LANE_CATALOG:
        cfg = lane.apply(TwoTierConfig())
        assert type(cfg) is TwoTierConfig
    cfgs = {lane.name: lane.apply(TwoTierConfig()) for lane in port_io.LANE_CATALOG}
    assert cfgs["fast_only"].fast_only and cfgs["explain"].explain and cfgs["mrl"].mrl_search_dims == 32
    assert cfgs["low_rrf_k"].rrf_k == 20 and cfgs["nqc"].nqc_downweight and cfgs["plan"].query_planning


def outcome(kinds, scores, ids=None, skip=None, fused=None):
    from frankensearch_tpu_torch.fusion.searcher import SearchOutcome

    ids = ids or [f"d{i}" for i in range(len(scores))]
    results = [port_types.ScoredResult(d, s) for d, s in zip(ids, scores)]
    metrics = TwoTierMetrics()
    metrics.phase2_skip_reason = skip
    metrics.fused_candidates = len(results) if fused is None else fused
    phases = [port_types.SearchPhase(port_types.PhaseKind(k), results, 1.0) for k in kinds]
    return SearchOutcome(results=results, phases=phases, metrics=metrics)


@pytest.mark.parametrize("case,oracle", [
    (dict(kinds=["initial", "refined"], scores=[0.5, 0.9]), "results_sorted"),
    (dict(kinds=["initial"], scores=[0.9, 0.5], ids=["a", "a"]), "no_duplicate_docs"),
    (dict(kinds=["refined", "initial"], scores=[0.9]), "phases_ordered"),
    (dict(kinds=["initial"], scores=[0.9, 0.5], fused=1), "metrics_consistent"),
    (dict(kinds=["initial", "refined"], scores=[0.9], skip="fast_only"), "skip_reason_excludes_refined"),
])
def test_oracles_flag_the_ports_outcomes(case, oracle):
    bad = outcome(**case)
    assert [name for name, fn in port_io.ORACLES.items() if fn(bad) is not None] == [oracle]
    good = outcome(kinds=["initial", "refinement_failed"], scores=[0.9, 0.5], skip="timeout")
    assert [fn(good) for fn in port_io.ORACLES.values()] == [None] * 5
