"""TwoTierSearcher, batched hybrid search through the Initial phase (PyTorch).

Port of ``TwoTierSearcher.search_batch`` from
frankensearch_tpu/fusion/searcher.py, up to the Initial phase: fast vector
tier + device BM25 (the dense lane, or at blocked scale the flat hot-arm,
pruned and DAAT lanes) in one fused device pass (ops/hybrid_phase1.py),
the on-device RRF tail (ops/device_rrf.py), then host ``finish_rrf`` and
hydration. With a Model2Vec fast tier the pass starts from token ids: the
gather + mean-pool embed runs in it too (the fully fused lane, tried
first); other embedders embed on the host first. A ``scan_mode`` other
than ``"auto"`` (the int8 capacity lane, the per-tile top-k scan) takes
the unfused path: a separate vector scan, ``search_candidates_batch`` for
the lexical arm, and per-query host RRF; approximate modes pass the
recall-certificate gate first. The statements
keep the reference's order so later slices (phase 2 quality tier, phase 3
rerank, the scalar ``search()``) can slot in where the reference has them.

Unlike the reference, a failure on the device path propagates: a lane that
does not apply returns ``None`` and the caller takes the next lane, but an
exception is never turned into a silent fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.canonicalize import DefaultCanonicalizer
from frankensearch_tpu_torch.core.config import (
    FusionStrategy,
    MetricsExporter,
    TiebreakStrategy,
    TwoTierConfig,
    TwoTierMetrics,
)
from frankensearch_tpu_torch.core.errors import InvalidConfig, UncertifiedScanMode
from frankensearch_tpu_torch.core.parsed_query import ParsedQuery
from frankensearch_tpu_torch.core.query_class import QueryClass
from frankensearch_tpu_torch.core.types import (
    FusedHit,
    ScoredResult,
    SearchPhase,
    VectorHit,
)
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.embed.cached import CachedEmbedder
from frankensearch_tpu_torch.fusion.circuit_breaker import CircuitBreaker
from frankensearch_tpu_torch.fusion.phase_gate import PhaseGate
from frankensearch_tpu_torch.fusion.rrf import RrfConfig, candidate_count, fuse_by_strategy
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex

TextFn = Callable[[str], str | None]


@dataclass
class SearchOutcome:
    """Final results + per-phase record + metrics."""

    results: list[ScoredResult]
    phases: list[SearchPhase] = field(default_factory=list)
    metrics: TwoTierMetrics = field(default_factory=TwoTierMetrics)


class TwoTierSearcher:
    def __init__(
        self,
        index: TwoTierIndex,
        fast_embedder: Embedder,
        *,
        lexical: LexicalRead | None = None,
        quality_embedder: Embedder | None = None,
        reranker=None,
        config: TwoTierConfig | None = None,
        metrics_exporter: MetricsExporter | None = None,
        circuit_breaker: CircuitBreaker | None = None,
        phase_gate: PhaseGate | None = None,
        calibrator: Callable[[float], float] | None = None,
        prf=None,
        mmr=None,
        feedback=None,
        hubness=None,
        smoother=None,
        nqc=None,
        governor=None,
        graph_ranker=None,
        adaptive=None,
        conformal=None,
        control_plane=None,
        cache_query_embeddings: bool = True,
        text_fn: TextFn | None = None,
    ) -> None:
        if quality_embedder is not None or reranker is not None:
            raise NotImplementedError(
                "the quality tier (phase 2) and the reranker (phase 3) are not "
                "ported yet (ROADMAP: phases 2-3)"
            )
        self.control_plane = control_plane
        if control_plane is not None:
            adaptive = adaptive if adaptive is not None else control_plane.adaptive
            conformal = conformal if conformal is not None else control_plane.conformal
            feedback = feedback if feedback is not None else control_plane.feedback
            calibrator = calibrator if calibrator is not None else control_plane.calibrator
        self.adaptive = adaptive
        self.conformal = conformal
        self.default_text_fn = text_fn
        self.index = index
        self.config = (config or TwoTierConfig()).validate()
        self.fast_embedder = (
            CachedEmbedder(fast_embedder) if cache_query_embeddings else fast_embedder
        )
        self.quality_embedder = None
        self.lexical = lexical
        self.reranker = None
        self.metrics_exporter = metrics_exporter
        self.circuit_breaker = circuit_breaker
        self.phase_gate = phase_gate
        self.calibrator = calibrator
        self.prf = prf
        self.mmr = mmr
        self.feedback = feedback
        self.hubness = hubness
        self.smoother = smoother
        if nqc is None and self.config.nqc_downweight:
            from frankensearch_tpu_torch.fusion.normalize import NqcDownweight

            nqc = NqcDownweight()
        self.nqc = nqc
        self.governor = governor
        self.graph_ranker = graph_ranker
        self.canonicalizer = DefaultCanonicalizer()
        # fail-closed semantic admission, decided once (searcher.rs:780-792)
        self._semantic_admitted = self._admit_semantic()
        self.last_fusion_path: str | None = None
        self.last_phase1_lex_lane: str | None = None
        #: True when the last batch's fused phase-1 pass embedded the
        #: queries itself (Model2Vec gather + mean-pool on the device)
        self.last_phase1_embed_fused = False

    def _admit_semantic(self) -> bool:
        mine = self.fast_embedder.identity()
        idx = self.index.fast.identity
        if idx.embedder_id and mine.embedder_id != idx.embedder_id:
            return False
        if (
            idx.embedder_revision
            and mine.embedder_revision
            and mine.embedder_revision != idx.embedder_revision
        ):
            return False
        if idx.dim and mine.dim and idx.dim != mine.dim:
            return False
        return True

    def _enforce_recall_certificate(self, k: int) -> None:
        """Fail-closed gate for approximate scan lanes: with
        require_recall_certificate on, an int8/ivf/mrl scan refuses to
        serve unless the fast index holds a certificate for that mode whose
        certified recall meets min_certified_recall and whose k covers the
        request."""
        cfg = self.config
        if not cfg.require_recall_certificate:
            return
        mode = "mrl" if cfg.mrl_search_dims else cfg.scan_mode
        if mode not in ("int8", "ivf", "mrl"):
            return
        cert = self.index.fast.recall_certificate(mode)
        if cert is None:
            raise UncertifiedScanMode(
                f"scan_mode {mode!r} has no recall certificate; run "
                "DeviceVectorIndex.certify_scan_mode or disable "
                "require_recall_certificate"
            )
        if cert.certified_recall < cfg.min_certified_recall:
            raise UncertifiedScanMode(
                f"scan_mode {mode!r} certificate ({cert.certified_recall:.3f} "
                f"@ conf {cert.confidence}) is below the configured floor "
                f"{cfg.min_certified_recall}"
            )
        if k > cert.k:
            raise UncertifiedScanMode(
                f"requested k={k} exceeds the certified k={cert.k} for "
                f"scan_mode {mode!r}; re-certify at the larger k"
            )

    def _rrf_ctx(self, classes, live, k):
        """Pre-dispatch context for the on-device RRF tail: per-query
        class-adjusted k and the fused limit, or None when the exactness
        gates that _vectorized_batch_fuse checks can't hold."""
        cfg = self.config
        if (
            cfg.fusion_strategy is not FusionStrategy.RRF
            or cfg.tiebreak is not TiebreakStrategy.LEXICAL_THEN_ID
            or self.nqc is not None
            or self.graph_ranker is not None
        ):
            return None
        return {
            "k_arr": np.array(
                [self._effective_rrf_k(classes[i]) for i in live], dtype=np.float64
            ),
            "limit": int(k),
        }

    def _device_rrf_tail(self, fast, arm, vec_i, lex_s, lex_i, rrf_ctx, b_padded):
        """Enqueue the on-device RRF merge behind the phase-1 tensors (no
        host sync). Returns ((out_id, out_lr, out_fr) device tensors,
        (contrib_l, contrib_v) f64 host tables) or (None, None) when the
        gates don't hold."""
        if rrf_ctx is None:
            return None, None
        if fast.tombstoned_ids():
            return None, None
        row_map = self._vecrow_to_lexrow(fast, arm)
        if row_map is None:
            return None, None
        from frankensearch_tpu_torch.ops import device_rrf as drrf

        key = (id(fast), id(arm))
        cached = getattr(self, "_row_map_dev", None)
        if cached is None or cached[0] != key:
            cached = (key, torch.from_numpy(row_map.astype(np.int32)).to(fast.device))
            self._row_map_dev = cached
        k_arr = rrf_ctx["k_arr"]
        if len(k_arr) != b_padded:
            k_arr = np.concatenate([k_arr, np.repeat(k_arr[:1], b_padded - len(k_arr))])
        sem_w = np.full(b_padded, self.config.fast_rrf_weight, np.float64)
        contrib_l, contrib_v = drrf.make_contrib_tables(
            k_arr, int(lex_i.shape[1]), int(vec_i.shape[1]),
            self.config.lexical_rrf_weight, sem_w,
        )

        def dev(x):
            return torch.from_numpy(x).to(fast.device)

        rrf_dev = drrf.device_rrf(
            lex_i, lex_s, vec_i, cached[1], dev(contrib_l), dev(contrib_v), limit=rrf_ctx["limit"],
        )
        return rrf_dev, (contrib_l, contrib_v)

    def _fused_phase1_batch(
        self, fast_vecs, queries, sem_budget: int, lex_budget: int, rrf_ctx=None
    ):
        """Run phase 1's (embed +) vector scan + device BM25 as one device
        pass (ops/hybrid_phase1.py) and, with ``rrf_ctx``, the RRF merge on
        the device too; all results come back in one fetch. With
        ``fast_vecs=None`` the fast embedder must be a Model2Vec one of the
        index's width (``CachedEmbedder`` unwrapped): the queries go in as
        token ids and the gather + mean-pool embed runs in the pass.
        Returns (hydrated vector hits per query, lexical candidate lists per
        query, raw) or None when a lane does not apply (non-device arms,
        filters, non-auto scan modes, an empty lexical arm, no query vectors
        and no Model2Vec embedder)."""
        from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
        from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index
        from frankensearch_tpu_torch.ops import hybrid_phase1 as hp

        if self.config.mrl_search_dims or self.config.scan_mode != "auto":
            return None
        fast = self.index.fast
        arm = self.lexical
        if type(fast) is not DeviceVectorIndex or not isinstance(arm, DeviceBm25Index):
            return None
        if arm.n_docs == 0:
            return None
        if arm.device != fast.device:
            raise ValueError(f"lexical arm on {arm.device}, vector index on {fast.device}")

        inner = None
        if fast_vecs is None:
            from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder

            inner = getattr(self.fast_embedder, "inner", self.fast_embedder)  # unwrap CachedEmbedder
            if not isinstance(inner, Model2VecEmbedder) or inner.dim != fast.dim:
                return None
            if inner.device != fast.device:
                raise ValueError(f"Model2Vec table on {inner.device}, vector index on {fast.device}")

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(fast.device)

        # pad the batch to a multiple of 8 by repeating query 0 (the
        # padding results are sliced off below), as the reference does
        b_real = len(queries)
        b_padded = max(-(-b_real // 8) * 8, 8)
        queries = list(queries) + [queries[0]] * (b_padded - b_real)
        mask = fast._effective_mask(None, None)
        if inner is not None:
            # the embed-fused bodies take (table, token ids, mask) in place
            # of the query vectors, and the index's padded width
            tok_ids, tok_mask = inner.tokenize_batch(queries)
            lead = (inner._emb, dev(tok_ids), dev(tok_mask), fast.slab, mask)
            extra = {"d_pad": fast.d_pad}
        else:
            q = np.asarray(fast_vecs, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
            if q.shape[1] != fast.dim:
                return None
            if q.shape[0] != b_padded:
                q = np.concatenate([q, np.repeat(q[:1], b_padded - q.shape[0], axis=0)])
            lead = (fast.slab, mask, hp._pad_q(dev(q), fast.d_pad))
            extra = {}
        embed_fused = inner is not None

        def lane(name: str):
            return getattr(hp, f"fused_phase1_embed_{name}" if embed_fused else f"fused_phase1_{name}")

        scan_mode = "hierarchical" if fast.device.type == "cuda" else "xla"
        k_vec = min(sem_budget, fast.n_rows) or 1
        k_lex = min(lex_budget, arm.n_docs)
        common = {"k_vec": k_vec, "k_lex": k_lex, "scan_mode": scan_mode, **extra}

        if arm._blocked is not None:
            vec_s, vec_i, lex_s, lex_i = self._fused_blocked_lanes(arm, queries, lead, lane, dev, common)
        else:
            self.last_phase1_lex_lane = "dense"
            q_idf = dev(arm._query_idf_rows(list(queries)))
            vec_s, vec_i, lex_s, lex_i = lane("dense")(
                *lead, arm._post_term, arm._post_tf, arm._doc_steps, q_idf,
                n_docs_lex=arm.n_docs, **common,
            )
        self.last_phase1_embed_fused = embed_fused
        # on-device RRF tail: the fused entries ride the same fetch; the
        # host keeps hydration and result construction only
        rrf_dev, contribs = self._device_rrf_tail(
            fast, arm, vec_i, lex_s, lex_i, rrf_ctx, b_padded
        )

        # one fetch for all result tensors (the first copy waits for the
        # stream; the rest are ready)
        fetched = [
            t.cpu().numpy()
            for t in (vec_s, vec_i, lex_s, lex_i) + (rrf_dev if rrf_dev is not None else ())
        ]
        vec_s, vec_i, lex_s, lex_i = fetched[:4]
        from frankensearch_tpu_torch.ops.topk_scan import TopKResult

        hydrated = fast.hydrate(
            TopKResult(torch.from_numpy(vec_s[:b_real]), torch.from_numpy(vec_i[:b_real]))
        )
        s_np = lex_s[:b_real]
        i_np = lex_i[:b_real]
        lex_lists = []
        for b in range(b_real):
            lex_lists.append([
                LexicalCandidate(doc_id=arm.doc_ids[int(i_np[b, j])], score=float(s_np[b, j]))
                for j in range(s_np.shape[1])
                if s_np[b, j] > 0.0
            ])
        raw = {
            "vec_rows": vec_i[:b_real], "lex_rows": i_np,
            "lex_scores": s_np, "arm": arm,
        }
        if rrf_dev is not None:
            from frankensearch_tpu_torch.ops.device_rrf import finish_rrf

            raw["fused_entries"] = finish_rrf(
                fetched[4][:b_real], fetched[5][:b_real], fetched[6][:b_real],
                contribs[0][:b_real], contribs[1][:b_real],
            )
            raw["fused_limit"] = rrf_ctx["limit"]
        return hydrated, lex_lists, raw

    def _fused_blocked_lanes(self, arm, queries, lead, lane, dev, common):
        """Phase 1 over the blocked lexical layout, the reference's
        dispatch. ``lead`` are the lane body's leading arguments (slab, mask
        and query vectors, or the Model2Vec table and token ids first),
        ``lane(name)`` picks the body and ``common`` holds its keyword
        arguments. On a split corpus each query's hot terms become a dense
        hot row and its sparse row keeps only tail terms; with
        ``daat_mode == "auto"`` the pure-tail queries whose own postings
        are few (``daat_eligible``) take the term-driven lane. All of them
        eligible: the ``daat`` lane; some: ``mixed`` (both lanes, each
        query keeps its own); none, or a plan past
        DAAT_MAX_FUSED_ELEMENTS: ``blocked``. Eligibility is a pure
        per-query test, so a query's lane never depends on its batchmates."""
        from frankensearch_tpu_torch.lexical import daat as _daat
        from frankensearch_tpu_torch.lexical import hot_arm as _hot_arm

        ids, w = arm._query_sparse_rows(list(queries))
        hot = None
        has_hot = np.zeros(len(queries), dtype=bool)
        hot_struct = arm._hot
        if hot_struct is not None:
            q_hot = _hot_arm.split_hot_rows(hot_struct.hot_row_of, ids, w, hot_struct.h_pad)
            has_hot = (q_hot > 0.0).any(axis=1)
            ids, w = _hot_arm.compact_tail_rows(hot_struct.hot_row_of, ids, w)
            # always the flat lane on split corpora (a corpus constant);
            # a zero hot row adds exactly +0.0
            hot = (
                hot_struct.cols_phys, dev(q_hot), hot_struct.cold_cols,
                hot_struct.cold_rows, hot_struct.dmap_groups,
            )
        daat_plan = None
        elig = None
        tm = None
        if arm.daat_mode == "auto":
            tm = arm._term_major()
            if tm is not None:
                elig = _daat.daat_eligible(
                    tm.ptr, ids, w, total_postings=arm.cold_posting_count
                ) & ~has_hot
                if elig.any():
                    # ineligible queries gather nothing: their lane is the
                    # exhaustive one
                    w_plan = np.where(elig[:, None], w, np.float32(0.0))
                    plan = _daat.build_gather_plan(tm.ptr, ids, w_plan)
                    if plan[0].size * 128 <= _daat.DAAT_MAX_FUSED_ELEMENTS:
                        daat_plan = tuple(dev(x) for x in plan)
        if daat_plan is not None and bool(elig.all()):
            self.last_phase1_lex_lane = "daat"
            return lane("daat")(
                *lead, tm.device_arrays(), *daat_plan,
                t_run=ids.shape[1], tm_packed=tm.packed, **common,
            )
        # the flat lane consumes no block-max bounds
        bounds_list = (
            arm._blocked.split_bounds(arm._blocked.query_bounds(ids, w), arm.device)
            if hot is None
            else None
        )
        lex_args = (arm._blocked.classes, bounds_list, dev(ids), dev(w), hot)
        if daat_plan is not None:
            self.last_phase1_lex_lane = "mixed"
            return lane("daat_mixed")(
                *lead, tm.device_arrays(), *daat_plan, dev(elig), *lex_args,
                t_run=ids.shape[1], tm_packed=tm.packed, **common,
            )
        self.last_phase1_lex_lane = "blocked"
        return lane("blocked")(*lead, *lex_args, **common)

    @staticmethod
    def _apply_filter_to_pool(pool, search_filter):
        """Search-time filters admit results from every arm, not just the
        vector scan (filter.rs contract)."""
        if search_filter is None or not pool:
            return pool
        return [r for r in pool if search_filter.admit(r.doc_id, r.metadata)]

    def _vectorized_batch_fuse(self, raw, live, classes, k):
        """Batch RRF over row ids (fusion/rrf_batch.py). Returns
        {outcome index -> FusedHit list} or None when the row space can't
        be joined (docs missing from an arm, tombstones)."""
        from frankensearch_tpu_torch.fusion.rrf_batch import rows_to_fused_hits, rrf_fuse_batch_rows

        arm = raw["arm"]
        # on-device fused entries — exact; reusable only when the fuse-time
        # limit matches the dispatch-time one
        ent = raw.get("fused_entries")
        if ent is not None and raw.get("fused_limit") == k:
            self.last_fusion_path = "device"
            return {i: rows_to_fused_hits(ent[j], arm.doc_ids) for j, i in enumerate(live)}
        fast = self.index.fast
        if fast.tombstoned_ids():
            return None  # supersession pruning is per-doc: scalar path
        row_map = self._vecrow_to_lexrow(fast, arm)
        if row_map is None:
            return None
        cfg = self.config
        vec_rows = np.asarray(raw["vec_rows"], dtype=np.int64)
        vec_lexrows = np.where(vec_rows >= 0, row_map[np.maximum(vec_rows, 0)], -1)
        lex_rows = np.asarray(raw["lex_rows"], dtype=np.int64)
        lex_scores = np.asarray(raw["lex_scores"], dtype=np.float32)
        lex_rows = np.where(lex_scores > 0.0, lex_rows, -1)
        k_arr = np.array([self._effective_rrf_k(classes[i]) for i in live], dtype=np.float64)
        sem_w = np.full(len(live), cfg.fast_rrf_weight, dtype=np.float64)
        entries = rrf_fuse_batch_rows(
            lex_rows, lex_scores, vec_lexrows, k, k_arr,
            cfg.lexical_rrf_weight, sem_w, arm.n_docs,
        )
        self.last_fusion_path = "host_vectorized"
        return {i: rows_to_fused_hits(entries[j], arm.doc_ids) for j, i in enumerate(live)}

    def _vecrow_to_lexrow(self, fast, arm):
        """Vector-slab row -> lexical-arm row (cached per index pair); None
        when any doc is missing from the lexical arm."""
        key = (id(fast), id(arm))
        cached = getattr(self, "_row_map_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        lex_row_of = {d: i for i, d in enumerate(arm.doc_ids)}
        out = np.empty(len(fast.doc_ids), dtype=np.int64)
        for i, d in enumerate(fast.doc_ids):
            r = lex_row_of.get(d)
            if r is None:
                self._row_map_cache = (key, None)
                return None
            out[i] = r
        self._row_map_cache = (key, out)
        return out

    def _fill_fused(self, fused, live, hits_per_query, lexical_pools) -> None:
        vec_hydrated, lex_lists, _raw = fused
        for j, i in enumerate(live):
            hits_per_query[i] = vec_hydrated[j]
            cands = lex_lists[j]
            meta = self.lexical.hydrate_candidates([c.doc_id for c in cands])
            lexical_pools[i] = self._drop_superseded([
                ScoredResult(
                    doc_id=c.doc_id, score=c.score, lexical_score=c.score,
                    title=(meta.get(c.doc_id) or {}).get("title"),
                    metadata=(meta.get(c.doc_id) or {}).get("metadata"),
                )
                for c in cands
            ])

    def _drop_superseded(self, pool):
        """Cross-arm supersession (search.rs:276-300): a doc tombstoned in
        the vector index must not resurface through the lexical arm."""
        dead = self.index.fast.tombstoned_ids()
        if not dead:
            return pool
        return [r for r in pool if r.doc_id not in dead]

    # ------------------------------------------------------------------ batch

    def search_batch(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        search_filter=None,
    ) -> list[SearchOutcome]:
        """Batched multi-query search through the Initial phase: all query
        vectors embed in one call, both arms run as one device pass, the
        RRF merge runs on the device, and per-query hydration stays on the
        host."""
        if k < 0:
            raise InvalidConfig(f"k must be >= 0, got {k}")
        self._enforce_recall_certificate(k)
        queries = list(queries)
        outcomes: list[SearchOutcome] = [SearchOutcome(results=[]) for _ in queries]
        if not queries:
            return outcomes
        cfg = self.config
        if self.conformal is not None:
            k = max(k, self.conformal.required_k())

        # boolean/phrase queries take the scalar search() lane in the
        # reference (tree retrieval + per-hit constraint filtering)
        if self.lexical is not None:
            from frankensearch_tpu_torch.lexical.query import is_boolean_syntax

            structured = [
                q for q in queries
                if is_boolean_syntax(self.canonicalizer.canonicalize_query(q))
            ]
            if structured:
                raise NotImplementedError(
                    f"boolean/phrase queries ({structured[0]!r}) take the scalar "
                    "search() lane, which is not ported yet (ROADMAP: phases 2-3 and "
                    "the scalar search())"
                )

        parsed_list = [ParsedQuery.parse(self.canonicalizer.canonicalize_query(q)) for q in queries]
        classes = [QueryClass.classify(p.positive or q) for p, q in zip(parsed_list, queries)]
        live = [i for i, qc in enumerate(classes) if qc is not QueryClass.EMPTY]
        for i, qc in enumerate(classes):
            outcomes[i].metrics.query_class = qc.value
        if not live:
            return outcomes

        hits_per_query: dict[int, list[VectorHit]] = {}
        lexical_pools: dict[int, list[ScoredResult]] = {}
        fused_done = False
        fused_raw = None
        self.last_phase1_embed_fused = False
        sem_budget_f = max(
            int(candidate_count(k, 0, cfg.candidate_multiplier)
                * max(classes[i].semantic_budget_multiplier() for i in live)),
            k,
        )
        lex_budget_f = max(
            int(candidate_count(k, 0, cfg.candidate_multiplier)
                * max(classes[i].lexical_budget_multiplier() for i in live)),
            k,
        )

        def fused_lane(fast_vecs) -> bool:
            nonlocal fused_raw
            fused = self._fused_phase1_batch(
                fast_vecs, [parsed_list[i].positive for i in live],
                sem_budget_f, lex_budget_f,
                rrf_ctx=self._rrf_ctx(classes, live, k),
            )
            if fused is None:
                return False
            self._fill_fused(fused, live, hits_per_query, lexical_pools)
            for i in live:
                outcomes[i].metrics.phase1_fused = True
            fused_raw = fused[2]
            return True

        # the fully fused lane first: Model2Vec embed + scan + BM25 as one
        # device pass (None for any other embedder)
        if self._semantic_admitted and self.lexical is not None and search_filter is None:
            fused_done = fused_lane(None)

        # one call for all fast embeddings
        fast_vecs = None
        if self._semantic_admitted and not fused_done:
            fast_vecs = self.fast_embedder.embed_batch([parsed_list[i].positive for i in live])

        # scan + BM25 fused lane (query vectors already computed)
        if fast_vecs is not None and self.lexical is not None and search_filter is None:
            fused_done = fused_lane(fast_vecs)
        if fast_vecs is not None and not fused_done:
            sem_budget = max(
                int(candidate_count(k, 0, cfg.candidate_multiplier)
                    * max(classes[i].semantic_budget_multiplier() for i in live)),
                k,
            )
            res = self.index.fast.search_batch(
                fast_vecs, sem_budget, search_filter=search_filter,
                mode="mrl" if cfg.mrl_search_dims else cfg.scan_mode,
            )
            hydrated = self.index.fast.hydrate(res)
            for j, i in enumerate(live):
                hits_per_query[i] = hydrated[j]

        # (phase-2 quality rescoring goes here in the reference; the
        # quality tier is refused at construction until it is ported)

        # lexical pools: one batched device call when the backend has it
        if self.lexical is not None and not fused_done:
            lex_budget_all = max(
                int(candidate_count(k, 0, cfg.candidate_multiplier)
                    * max(classes[i].lexical_budget_multiplier() for i in live)),
                k,
            )
            batch_api = getattr(self.lexical, "search_candidates_batch", None)
            if callable(batch_api):
                cand_lists = batch_api([parsed_list[i].positive for i in live], lex_budget_all)
                for j, i in enumerate(live):
                    cands = cand_lists[j]
                    meta = self.lexical.hydrate_candidates([c.doc_id for c in cands])
                    lexical_pools[i] = self._apply_filter_to_pool(
                        self._drop_superseded([
                            ScoredResult(
                                doc_id=c.doc_id, score=c.score, lexical_score=c.score,
                                title=(meta.get(c.doc_id) or {}).get("title"),
                                metadata=(meta.get(c.doc_id) or {}).get("metadata"),
                            )
                            for c in cands
                        ]),
                        search_filter,
                    )

        # vectorized batch RRF: replaces the per-query dict fusion when the
        # exactness gates hold — bitwise identical
        batch_fused = None
        if (
            fused_raw is not None
            and cfg.fusion_strategy is FusionStrategy.RRF
            and cfg.tiebreak is TiebreakStrategy.LEXICAL_THEN_ID
            and self.nqc is None
            and self.graph_ranker is None
        ):
            batch_fused = self._vectorized_batch_fuse(fused_raw, live, classes, k)

        # per-query host-side fusion (the scalar search() contract)
        for i in live:
            parsed, qclass = parsed_list[i], classes[i]
            lexical_pool: list[ScoredResult] = lexical_pools.get(i, [])
            if self.lexical is not None and i not in lexical_pools:
                lex_budget = max(
                    int(candidate_count(k, 0, cfg.candidate_multiplier)
                        * qclass.lexical_budget_multiplier()),
                    k,
                )
                lexical_pool = self._apply_filter_to_pool(
                    self._drop_superseded(self.lexical.search(parsed.positive, lex_budget)),
                    search_filter,
                )
            fast_hits = hits_per_query.get(i, [])
            if (
                qclass is QueryClass.IDENTIFIER
                and not self.fast_embedder.is_semantic
                and len(lexical_pool) >= k
            ):
                # identifier short-circuit (searcher.rs:1451,1641)
                fast_hits = []
            if self.calibrator is not None and fast_hits:
                fast_hits = [
                    VectorHit(h.doc_id, self.calibrator(h.score), h.row) for h in fast_hits
                ]
            if self.hubness is not None and fast_hits:
                fast_hits = self.hubness.apply(fast_hits)
            if self.smoother is not None and fast_hits:
                fast_hits = self.smoother.apply(fast_hits)
            rrf_cfg = RrfConfig(
                k=self._effective_rrf_k(qclass),
                lexical_weight=cfg.lexical_rrf_weight,
                semantic_weight=self._effective_semantic_weight(lexical_pool, parsed),
                tiebreak=cfg.tiebreak,
            )
            if batch_fused is not None and i in batch_fused and fast_hits:
                fused = batch_fused[i]
            elif self.graph_ranker is not None and cfg.graph_rrf_weight > 0.0:
                from frankensearch_tpu_torch.fusion.rrf import rrf_fuse_with_graph

                seeds = lexical_pool or [
                    ScoredResult(doc_id=h.doc_id, score=h.score) for h in fast_hits
                ]
                graph_pool = self.graph_ranker.rank(seeds, limit=k * cfg.candidate_multiplier)
                fused = rrf_fuse_with_graph(
                    lexical_pool, fast_hits, graph_pool, cfg.graph_rrf_weight, k, 0, rrf_cfg,
                )
            else:
                fused = fuse_by_strategy(cfg.fusion_strategy, lexical_pool, fast_hits, k, 0, rrf_cfg)
            results = self._fused_to_results(
                fused, lexical_pool, fast_hits, self.default_text_fn, parsed
            )
            if self.feedback is not None and results:
                results = self.feedback.apply(results)
            outcomes[i].results = results[:k]
            outcomes[i].metrics.fast_candidates = len(fast_hits)
            outcomes[i].metrics.lexical_candidates = len(lexical_pool)
            outcomes[i].metrics.quality_candidates = 0
        return outcomes

    # ------------------------------------------------------------------ fusion helpers

    def _effective_rrf_k(self, qclass: QueryClass) -> float:
        if self.adaptive is not None:
            return float(self.adaptive.choose_rrf_k(qclass))
        return float(qclass.rrf_k_adjustment(self.config.rrf_k))

    def _effective_semantic_weight(
        self, lexical_pool: list[ScoredResult], parsed: ParsedQuery
    ) -> float:
        w = self.config.fast_rrf_weight
        if self.nqc is not None and lexical_pool:
            w *= self.nqc.semantic_weight_multiplier(lexical_pool)
        return w

    def _constraint_meta_cache(self, parsed, fused) -> "dict | None":
        """One batched hydration for the constraint filter."""
        if self.lexical is None or not self._constraint_filtering(parsed):
            return None
        return self.lexical.hydrate_candidates([h.doc_id for h in fused])

    def _fused_to_results(
        self,
        fused: Sequence[FusedHit],
        lexical_pool: Sequence[ScoredResult],
        fast_hits: Sequence[VectorHit],
        text_fn: TextFn | None,
        parsed: ParsedQuery,
    ) -> list[ScoredResult]:
        lex_by_doc = {r.doc_id: r for r in lexical_pool}
        fast_by_doc = {h.doc_id: h for h in fast_hits}
        meta_cache = self._constraint_meta_cache(parsed, fused)
        out: list[ScoredResult] = []
        for rank, h in enumerate(fused):
            lex = lex_by_doc.get(h.doc_id)
            fast = fast_by_doc.get(h.doc_id)
            if self._constraint_filtering(parsed) and self._negation_excludes(
                h.doc_id, lex, text_fn, parsed, meta_cache
            ):
                continue
            result = ScoredResult(
                doc_id=h.doc_id,
                score=h.score,
                lexical_score=lex.score if lex else None,
                fast_score=fast.score if fast else None,
                sources=h.sources,
                title=lex.title if lex else None,
                metadata=lex.metadata if lex else None,
            )
            if self.config.explain:
                result.explanation = self._build_explanation(h, rank, result)
            out.append(result)
        return out

    def _build_explanation(self, fused: FusedHit, rank: int, result: ScoredResult):
        """Per-hit score decomposition (emitted only when config.explain)."""
        from frankensearch_tpu_torch.core.types import HitExplanation

        components: dict[str, float] = {"rrf_fused": fused.score}
        ranks: dict[str, int] = {"fused": rank}
        if result.lexical_score is not None:
            components["lexical_bm25"] = result.lexical_score
        if fused.lexical_rank is not None:
            ranks["lexical"] = fused.lexical_rank
        if result.fast_score is not None:
            components["fast_cosine"] = result.fast_score
        if fused.fast_rank is not None:
            ranks["fast_vector"] = fused.fast_rank
        notes = [f"fusion={self.config.fusion_strategy.value}", f"rrf_k={self.config.rrf_k}"]
        return HitExplanation(
            doc_id=result.doc_id,
            fused_score=fused.score,
            components=components,
            ranks=ranks,
            rank_after=rank,
            notes=notes,
        )

    def _negation_excludes(
        self,
        doc_id: str,
        lex: ScoredResult | None,
        text_fn: TextFn | None,
        parsed: ParsedQuery,
        meta_cache: "dict | None" = None,
    ) -> bool:
        """Post-retrieval negative-term filter over the available text
        (parsed_query.rs contract): a hit whose text contains an excluded
        term is dropped; docs with no available text are kept. Batched
        queries carry no boolean tree (those take the scalar lane)."""
        text = None
        hydrated = None
        if self.lexical is not None and parsed.has_negations:
            if meta_cache is not None:
                hydrated = meta_cache.get(doc_id)
            else:
                hydrated = self.lexical.hydrate_candidates([doc_id]).get(doc_id)
            if hydrated:
                full = hydrated.get("content") or None
                if full is not None:
                    text = " ".join(p for p in (hydrated.get("title"), str(full)) if p) or None
        if text is None and text_fn is not None:
            text = text_fn(doc_id)
        if text is None and lex is not None and lex.metadata:
            text = str(lex.metadata.get("preview", "")) or None
        if text is None and lex is not None and lex.title:
            text = lex.title
        if text is None and hydrated:
            parts = (hydrated.get("title"), str(hydrated.get("preview", "")))
            text = " ".join(p for p in parts if p) or None
        if text is None:
            return False
        return parsed.excludes(text)

    def _constraint_filtering(self, parsed: ParsedQuery) -> bool:
        """True when fused results need the per-hit text filter."""
        return parsed.has_negations or parsed.boolean_query is not None
