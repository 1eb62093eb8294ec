"""The port's copies of the phase-2 fusion controls, held to the reference.

The blend, the adaptive / conformal / feedback controls with their
control plane, the query planner and the embedder stack are host code
copied from the reference (PRF and MMR, which read the index, are held in
tests/test_torch_searcher_phase2.py): on the same inputs each must give the
reference's output exactly (ranked lists, sampled arms, required k, boost
factors, plans, persisted state).
"""

import json

import numpy as np
import pytest
import torch

from frankensearch_tpu.core import query_class as r_qc
from frankensearch_tpu.core import types as r_types
from frankensearch_tpu.fusion import adaptive as r_adaptive
from frankensearch_tpu.fusion import blend as r_blend
from frankensearch_tpu.fusion import conformal as r_conformal
from frankensearch_tpu.fusion import control_plane as r_cp
from frankensearch_tpu.fusion import feedback as r_feedback
from frankensearch_tpu.runtime import query_planner as r_planner
from frankensearch_tpu_torch.core import query_class as p_qc
from frankensearch_tpu_torch.core import types as p_types
from frankensearch_tpu_torch.embed.stack import EmbedderStack
from frankensearch_tpu_torch.fusion import adaptive as p_adaptive
from frankensearch_tpu_torch.fusion import blend as p_blend
from frankensearch_tpu_torch.fusion import conformal as p_conformal
from frankensearch_tpu_torch.fusion import control_plane as p_cp
from frankensearch_tpu_torch.fusion import feedback as p_feedback
from frankensearch_tpu_torch.runtime import query_planner as p_planner


def _hits(types, seed, n=12, nan=False):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal(n).astype(float)
    if nan:
        scores[3] = float("nan")
    ids = [f"d{int(i)}" for i in rng.choice(20, size=n, replace=False)]
    return [types.VectorHit(doc_id=d, score=float(s), row=i) for i, (d, s) in enumerate(zip(ids, scores))]


def _rows(hits):
    return [(h.doc_id, h.score, h.row) for h in hits]


@pytest.mark.parametrize("alpha", [0.0, 0.7, 1.0, float("nan")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_matches_reference(seed, alpha):
    rf, rq = _hits(r_types, seed), _hits(r_types, seed + 10, nan=seed == 2)
    pf, pq = _hits(p_types, seed), _hits(p_types, seed + 10, nan=seed == 2)
    assert _rows(p_blend.blend_two_tier(pf, pq, alpha)) == _rows(r_blend.blend_two_tier(rf, rq, alpha))
    aligned = [h.score if i % 3 else None for i, h in enumerate(rq)]
    assert _rows(p_blend.blend_two_tier_aligned(pf, aligned, alpha)) == _rows(
        r_blend.blend_two_tier_aligned(rf, aligned, alpha))
    assert p_blend.kendall_tau(pf, pq) == r_blend.kendall_tau(rf, rq)
    assert p_blend.rank_changes(pf, pq).__dict__ == r_blend.rank_changes(rf, rq).__dict__


def test_adaptive_arms_match_reference():
    ref, port = r_adaptive.AdaptiveFusion(seed=5), p_adaptive.AdaptiveFusion(seed=5)
    for i in range(40):
        cls = list(r_qc.QueryClass)[i % len(r_qc.QueryClass)]
        pcls = p_qc.QueryClass(cls.value)
        assert port.choose_rrf_k(pcls) == ref.choose_rrf_k(cls)
        assert port.choose_blend(pcls) == ref.choose_blend(cls)
        port.update(pcls, i % 3 == 0)
        ref.update(cls, i % 3 == 0)
    assert port.to_state() == ref.to_state()


def test_conformal_and_feedback_match_reference():
    rc, pc = r_conformal.ConformalK(alpha=0.2), p_conformal.ConformalK(alpha=0.2)
    for r in [1, 3, 2, 9, 101, 4, 1, 7]:
        rc.add_rank(r)
        pc.add_rank(r)
        rc.observe(r <= 5)
        pc.observe(r <= 5)
        assert pc.required_k() == rc.required_k()
    assert pc.to_state() == rc.to_state()
    clock = iter(range(0, 10_000, 60))
    now = [0.0]

    def tick():
        return now[0]

    rf, pf = r_feedback.FeedbackBooster(clock=tick), p_feedback.FeedbackBooster(clock=tick)
    for d in ["a", "b", "a", "c"]:
        now[0] = float(next(clock))
        rf.record_click(d)
        pf.record_click(d)
    rr = [r_types.ScoredResult(doc_id=d, score=s) for d, s in (("a", 0.1), ("b", 0.3), ("z", 0.2))]
    pr = [p_types.ScoredResult(doc_id=d, score=s) for d, s in (("a", 0.1), ("b", 0.3), ("z", 0.2))]
    assert [(r.doc_id, r.score) for r in pf.apply(pr)] == [(r.doc_id, r.score) for r in rf.apply(rr)]


def test_control_plane_state_round_trip(tmp_path):
    from frankensearch_tpu.core.config import TwoTierConfig as RConfig
    from frankensearch_tpu_torch.core.config import TwoTierConfig as PConfig

    kw = {"adaptive_fusion": True, "conformal_alpha": 0.1, "calibration": "temperature:2"}
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = r_cp.build_control_plane(RConfig(**kw), str(tmp_path / "r"))
    port = p_cp.build_control_plane(PConfig(**kw), str(tmp_path / "p"))
    for cp in (ref, port):
        cp.record("w1 w2", "d1", success=True, rank=2, requested_k=10)
        cp.record("w3", None, success=False, requested_k=10)
    state_r = json.loads((tmp_path / "r" / r_cp.STATE_FILE).read_text())
    state_p = json.loads((tmp_path / "p" / p_cp.STATE_FILE).read_text())
    state_r["feedback"] = state_p["feedback"] = None  # wall-clock anchored
    assert state_p == state_r
    again = p_cp.build_control_plane(PConfig(**kw), str(tmp_path / "p"))
    assert again.conformal.to_state() == port.conformal.to_state()
    assert again.calibrator(0.5) == ref.calibrator(0.5)


@pytest.mark.parametrize("query", ["w1 w2", "how do I rebuild the index", "ERR_404", "Foo::bar", ""])
def test_query_plans_match_reference(query):
    from frankensearch_tpu.core.decision_plane import ResourceBudget as RBudget
    from frankensearch_tpu_torch.core.decision_plane import ResourceBudget as PBudget

    for has_quality, has_reranker in ((True, True), (False, True), (True, False)):
        want = r_planner.plan_query(query, budget=RBudget(wall_ms=200.0), has_quality=has_quality,
                                    has_reranker=has_reranker)
        got = p_planner.plan_query(query, budget=PBudget(wall_ms=200.0), has_quality=has_quality,
                                   has_reranker=has_reranker)
        assert got.intent.value == want.intent.value
        for name in ("lexical", "fast_vector", "quality", "rerank"):
            g, w = got.stage(name), want.stage(name)
            assert (g is None) == (w is None)
            if g is not None:
                assert (g.enabled, g.budget_ms, g.reason) == (w.enabled, w.budget_ms, w.reason)


def test_embedder_stack_degrades_to_hash(tmp_path):
    stack = EmbedderStack.auto_detect(str(tmp_path), device=torch.device("cpu"), fast_dim=64)
    assert stack.availability.fast_source == "hash" and not stack.has_quality
    assert stack.fast.dim == 64 and stack.availability.warnings
