"""TwoTierSearcher: the progressive two-tier hybrid search (PyTorch).

Port of frankensearch_tpu/fusion/searcher.py. The scalar ``search()``
streams the phases: canonicalize -> parse -> classify -> admit (fail
closed, before any embed) -> Phase 1 [fast embed + lexical, vector scan,
fuse, hydrate; with a Model2Vec fast tier and a device lexical arm the
fully fused singleton lane] -> Initial -> circuit-breaker / phase-gate
checks -> Phase 2 on a worker thread under the quality timeout [quality
embed (prefetched before phase 1), PRF, the aligned rescore or the
quality-tier rescan, blend alpha=0.7, lexical re-fusion] -> Refined /
RefinementFailed -> Phase 3 [cross-encoder rerank + MMR] -> Reranked.
Boolean and phrase queries retrieve through the lexical arm's
``search_boolean`` and are filtered per hit.

``search_batch`` is the batched lane: phase 1 for all queries as one
fused device pass (ops/hybrid_phase1.py: fast vector tier + device BM25,
the on-device RRF tail), then the batched quality rescore (one encoder
forward for all live queries, and with ``quality_rescan`` one quality-tier
scan), the blend and the lexical re-fusion per query. A ``scan_mode``
other than ``"auto"`` takes the unfused path. Structured queries go to
``search()``.

Unlike the reference, a failure on the device path propagates: a lane that
does not apply returns ``None`` and the caller takes the next lane, but an
exception is never turned into a silent fallback (phase 1's lanes,
``search_batch``'s quality rescore). Phase 2 under ``search()`` keeps the
reference's protocol: a timeout or an error there is the visible
RefinementFailed outcome, counted by the circuit breaker; phase 3 keeps
the rerank pipeline's typed skip reasons for a ``SearchError``, and any
other fault of the cross-encoder propagates.
"""

from __future__ import annotations

import concurrent.futures
import time
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
from frankensearch_tpu_torch.core.errors import InvalidConfig, SearchError, UncertifiedScanMode
from frankensearch_tpu_torch.core.parsed_query import ParsedQuery
from frankensearch_tpu_torch.core.query_class import QueryClass
from frankensearch_tpu_torch.core.types import (
    ClassifiedHits,
    FusedHit,
    PhaseKind,
    ScoredResult,
    SearchPhase,
    SearchSource,
    VectorHit,
)
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.embed.cached import CachedEmbedder
from frankensearch_tpu_torch.fusion.blend import blend_two_tier, blend_two_tier_aligned, kendall_tau
from frankensearch_tpu_torch.fusion.circuit_breaker import CircuitBreaker, Phase2Outcome
from frankensearch_tpu_torch.fusion.phase_gate import PhaseGate
from frankensearch_tpu_torch.fusion.rrf import RrfConfig, candidate_count, fuse_by_strategy
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex

PhaseCallback = Callable[[SearchPhase], None]
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
        self.quality_embedder = (
            CachedEmbedder(quality_embedder)
            if (quality_embedder is not None and cache_query_embeddings)
            else quality_embedder
        )
        self.lexical = lexical
        self.reranker = reranker
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
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="fs-searcher"
        )
        # fail-closed admission, decided once (searcher.rs:780-792): the
        # fast embedder's identity must match the fast tier's, the quality
        # embedder's the quality tier's (refused before any embedding runs)
        self._semantic_admitted = self._admit_semantic()
        self._quality_admitted = self._admit_quality()
        self.last_fusion_path: str | None = None
        self.last_phase1_lex_lane: str | None = None
        #: True when the last batch's fused phase-1 pass embedded the
        #: queries itself (Model2Vec gather + mean-pool on the device)
        self.last_phase1_embed_fused = False

    def close(self) -> None:
        """Release the phase-2 worker pool (embedders and indexes are owned
        by the caller)."""
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _admit_semantic(self) -> bool:
        return self._identity_matches(self.fast_embedder, self.index.fast)

    def _admit_quality(self) -> bool:
        if self.quality_embedder is None or self.index.quality is None:
            return False
        return self._identity_matches(self.quality_embedder, self.index.quality)

    @staticmethod
    def _identity_matches(embedder: Embedder, tier) -> bool:
        mine = embedder.identity()
        idx = tier.identity
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
        if self.index.tombstoned_ids():
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
        A mesh-sharded fast tier with a block-sharded lexical arm takes the
        sharded lane (``fused_phase1_sharded``: both arms over the shards,
        merged on the lead device, then the same RRF tail); it needs query
        vectors. Returns (hydrated vector hits per query, lexical candidate
        lists per query, raw) or None when a lane does not apply (non-device
        arms, one arm sharded and not the other, filters, non-auto scan
        modes, an empty lexical arm, no query vectors and no Model2Vec
        embedder)."""
        from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
        from frankensearch_tpu_torch.lexical.delta import DeltaLexicalIndex
        from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index
        from frankensearch_tpu_torch.ops import hybrid_phase1 as hp
        from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
        from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

        if self.config.mrl_search_dims or self.config.scan_mode != "auto":
            return None
        fast = self.index.fast
        arm = self.lexical
        if isinstance(arm, DeltaLexicalIndex):
            # the sealed device arm, or the host oracle while writes are unsealed
            arm = arm._read_arm()
        sharded = isinstance(fast, ShardedDeviceVectorIndex) and isinstance(arm, ShardedBulkDeviceBm25Index)
        if not sharded and (type(fast) is not DeviceVectorIndex or not isinstance(arm, DeviceBm25Index)):
            return None
        if arm.n_docs == 0:
            return None
        if arm.device != fast.device:
            raise ValueError(f"lexical arm on {arm.device}, vector index on {fast.device}")

        inner = None
        if fast_vecs is None:
            if sharded:
                return None  # the sharded lane takes query vectors
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
            q_dev = hp._pad_q(dev(q), fast.d_pad)
            lead = (fast.slab, mask, q_dev)
            extra = {}
        embed_fused = inner is not None

        def lane(name: str):
            return getattr(hp, f"fused_phase1_embed_{name}" if embed_fused else f"fused_phase1_{name}")

        scan_mode = "hierarchical" if fast.device.type == "cuda" else "xla"
        k_vec = min(sem_budget, fast.n_rows) or 1
        k_lex = min(lex_budget, arm.n_docs)
        common = {"k_vec": k_vec, "k_lex": k_lex, "scan_mode": scan_mode, **extra}

        if sharded:
            self.last_phase1_lex_lane = "sharded"
            ids, w = arm.inner._query_sparse_rows(list(queries))
            vec_s, vec_i, lex_s, lex_i = hp.fused_phase1_sharded(
                fast._slab_shards, fast._mask_shards, q_dev,
                arm._sharded, arm.place_bounds(arm._blocked_host.query_bounds(ids, w)), dev(ids), dev(w),
                k_vec=k_vec, k_lex=k_lex, scan_mode="hier" if scan_mode == "hierarchical" else "xla",
            )
        elif arm._blocked is not None:
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
        if self.index.tombstoned_ids():
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
        dead = self.index.tombstoned_ids()
        if not dead:
            return pool
        return [r for r in pool if r.doc_id not in dead]

    # ------------------------------------------------------------------ search

    def search(
        self,
        query: str,
        k: int = 10,
        *,
        on_phase: PhaseCallback | None = None,
        text_fn: TextFn | None = None,
        search_filter=None,
    ) -> SearchOutcome:
        """One query through the progressive phases; ``on_phase`` sees each
        phase as it is emitted (Initial, then Refined or RefinementFailed,
        then Reranked)."""
        t_start = time.monotonic()
        if k < 0:
            raise InvalidConfig(f"k must be >= 0, got {k}")
        self._enforce_recall_certificate(k)
        if text_fn is None:
            # the handle's default text source keeps negation filters and
            # phase 3 live when the caller passes none
            text_fn = self.default_text_fn
        metrics = TwoTierMetrics()
        phases: list[SearchPhase] = []

        def emit(phase: SearchPhase) -> None:
            phases.append(phase)
            if on_phase is not None:
                on_phase(phase)

        # 1. canonicalize + parse + classify (searcher.rs:929-963)
        t0 = time.monotonic()
        canonical = self.canonicalizer.canonicalize_query(query)
        parsed = ParsedQuery.parse(canonical)
        parsed = self._attach_boolean_tree(parsed, canonical)
        qclass = QueryClass.classify(parsed.positive or canonical)
        metrics.canonicalize_us = (time.monotonic() - t0) * 1e6
        metrics.query_class = qclass.value

        if qclass is QueryClass.EMPTY:
            outcome = SearchOutcome(results=[], phases=phases, metrics=metrics)
            emit(SearchPhase(PhaseKind.INITIAL, [], 0.0, metrics=metrics))
            self._export(metrics, t_start)
            return outcome

        # intent-aware stage plan (runtime/query_planner.py), off by default
        plan = None
        if self.config.query_planning:
            from frankensearch_tpu_torch.core.decision_plane import ResourceBudget
            from frankensearch_tpu_torch.runtime.query_planner import plan_query

            plan = plan_query(
                parsed.positive or canonical,
                budget=ResourceBudget(wall_ms=self.config.query_budget_ms),
                has_quality=(
                    self.quality_embedder is not None
                    and self.index.has_quality_tier
                    and self._quality_admitted
                ),
                has_reranker=self.config.rerank_enabled and self.reranker is not None,
            )
            metrics.query_intent = plan.intent.value

        # conformal required-k: widen k to the calibrated coverage target
        if self.conformal is not None:
            k = max(k, self.conformal.required_k())

        # phase-2 query-embed prefetch: the quality forward is enqueued
        # before phase 1, so the device runs it while the host fuses and
        # delivers the Initial phase. Its failure is raised again inside
        # phase 2, whose RefinementFailed protocol reports it.
        phase2_prefetch = None
        if (
            not self.config.fast_only
            and self.quality_embedder is not None
            and self.index.has_quality_tier
            and self._quality_admitted
        ):
            try:
                phase2_prefetch = self.quality_embedder.embed_prefetch(parsed.positive)
            except Exception as exc:
                def phase2_prefetch(exc=exc):
                    raise exc

        # 2. Phase 1
        initial_results, fast_hits, lexical_pool = self._run_phase1(
            parsed, qclass, k, metrics, search_filter, text_fn
        )
        metrics.phase1_ms = (time.monotonic() - t_start) * 1000.0
        emit(SearchPhase(PhaseKind.INITIAL, list(initial_results), metrics.phase1_ms, metrics=metrics))

        results = initial_results

        # 3. Phase 2 gates (searcher.rs:1080-1094)
        skip_reason = self._phase2_skip_reason(fast_hits, initial_results, plan=plan)
        if skip_reason is not None:
            metrics.phase2_skip_reason = skip_reason
        else:
            quality_budget_ms = None
            if plan is not None:
                stage = plan.stage("quality")
                if stage is not None and stage.enabled and stage.budget_ms > 0:
                    quality_budget_ms = stage.budget_ms
            t2 = time.monotonic()
            refined, failure = self._run_phase2_with_timeout(
                parsed, qclass, k, fast_hits, lexical_pool, initial_results, metrics, text_fn,
                quality_prefetch=phase2_prefetch,
                timeout_ms_override=quality_budget_ms,
            )
            metrics.phase2_ms = (time.monotonic() - t2) * 1000.0
            if refined is not None:
                if self.config.explain:
                    initial_rank = {r.doc_id: i for i, r in enumerate(initial_results)}
                    for rank, r in enumerate(refined):
                        if r.explanation is None:
                            r.explanation = self._build_explanation(
                                FusedHit(doc_id=r.doc_id, score=r.score), rank, r
                            )
                        r.explanation.rank_before = initial_rank.get(r.doc_id)
                        r.explanation.rank_after = rank
                results = refined
                emit(SearchPhase(
                    PhaseKind.REFINED, list(results),
                    (time.monotonic() - t_start) * 1000.0, metrics=metrics,
                ))
            else:
                metrics.phase2_skip_reason = failure
                emit(SearchPhase(
                    PhaseKind.REFINEMENT_FAILED, list(results),
                    (time.monotonic() - t_start) * 1000.0, reason=failure, metrics=metrics,
                ))

        # 4. Phase 3 rerank (searcher.rs:1219, :2477)
        rerank_allowed = self.governor is None or self.governor.allow_rerank
        if not rerank_allowed and self.config.rerank_enabled:
            metrics.phase3_skip_reason = "pressure"
        if rerank_allowed and plan is not None and self.config.rerank_enabled:
            stage = plan.stage("rerank")
            if stage is None or not stage.enabled:
                rerank_allowed = False
                metrics.phase3_skip_reason = f"query_plan:{plan.intent.value}"
        if (
            rerank_allowed
            and self.config.rerank_enabled
            and self.reranker is not None
            and results
            and text_fn is not None
        ):
            t3 = time.monotonic()
            reranked = self._run_phase3(parsed.positive, results, k, text_fn, metrics)
            metrics.phase3_ms = (time.monotonic() - t3) * 1000.0
            if reranked is not None:
                results = reranked
                emit(SearchPhase(
                    PhaseKind.RERANKED, list(results),
                    (time.monotonic() - t_start) * 1000.0, metrics=metrics,
                ))
        elif (self.config.rerank_enabled and self.reranker is not None
                and metrics.phase3_skip_reason is None):
            metrics.phase3_skip_reason = "no_text_fn"

        if self.feedback is not None and results:
            results = self.feedback.apply(results)

        results = results[:k]
        self._export(metrics, t_start)
        return SearchOutcome(results=results, phases=phases, metrics=metrics)

    # ------------------------------------------------------------------ batch

    def search_batch(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        search_filter=None,
    ) -> list[SearchOutcome]:
        """Batched multi-query search: all query vectors embed in one call,
        both arms run as one device pass, the RRF merge runs on the device,
        the quality tier rescores the whole batch at once, and per-query
        fusion and hydration stay on the host. Results match per-query
        ``search()`` for the same config; no phase callbacks or timeouts."""
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

        # boolean/phrase queries take the scalar lane (tree retrieval and
        # per-hit constraint filtering do not batch); the rest stay on the
        # batched device path
        if self.lexical is not None:
            from frankensearch_tpu_torch.lexical.query import is_boolean_syntax

            structured = {
                i for i, q in enumerate(queries)
                if is_boolean_syntax(self.canonicalizer.canonicalize_query(q))
            }
            if structured:
                plain = [i for i in range(len(queries)) if i not in structured]
                for i in sorted(structured):
                    outcomes[i] = self.search(queries[i], k, search_filter=search_filter)
                if plain:
                    sub = self.search_batch([queries[i] for i in plain], k, search_filter=search_filter)
                    for j, i in enumerate(plain):
                        outcomes[i] = sub[j]
                return outcomes

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
                mrl_search_dims=cfg.mrl_search_dims,
                nprobe=cfg.ivf_nprobe,
            )
            hydrated = self.index.fast.hydrate(res)
            for j, i in enumerate(live):
                hits_per_query[i] = hydrated[j]

        # batched quality rescore: one encoder forward for all live queries,
        # the aligned rescore of each query's hits, and with quality_rescan
        # one quality-tier scan for the whole batch (K1 + K2 on CUDA)
        qscores_per_query: dict[int, dict[str, float]] = {}
        scan_per_query: dict[int, list[VectorHit]] = {}
        if (
            not cfg.fast_only
            and self.quality_embedder is not None
            and self.index.has_quality_tier
            and self._quality_admitted
            and hits_per_query
        ):
            q_vecs = self.quality_embedder.embed_batch([parsed_list[i].positive for i in live])
            for j, i in enumerate(live):
                hits = hits_per_query.get(i, [])
                if hits:
                    q_vec_i = q_vecs[j]
                    if self.prf is not None:
                        q_vec_i = self.prf.expand(q_vec_i, hits, self.index)
                    qs = self.index.quality_scores_for_hits(q_vec_i, hits)
                    if self.calibrator is not None:
                        qs = {d: self.calibrator(v) for d, v in qs.items()}
                    qscores_per_query[i] = qs
            if cfg.quality_rescan and self.index.quality is not None:
                q_budget = max(
                    int(candidate_count(k, 0, cfg.candidate_multiplier)
                        * max(classes[i].semantic_budget_multiplier() for i in live)),
                    k,
                )
                qres = self.index.quality.search_batch(q_vecs, q_budget)
                qhydrated = self.index.quality.hydrate(qres)
                for j, i in enumerate(live):
                    scan_hits = qhydrated[j]
                    scan_per_query.setdefault(i, []).extend(scan_hits)
                    qd = qscores_per_query.setdefault(i, {})
                    for h in scan_hits:
                        qd.setdefault(h.doc_id, h.score)

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
            and not qscores_per_query
            and not scan_per_query
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
            qscores = qscores_per_query.get(i)
            if qscores and i in scan_per_query:
                # expanded pool (quality_rescan): the two-pool blend
                qpool: dict[str, VectorHit] = {h.doc_id: h for h in scan_per_query[i]}
                fast_rows = {h.doc_id: h.row for h in fast_hits}
                for d, sc in qscores.items():
                    if d not in qpool:
                        qpool[d] = VectorHit(doc_id=d, score=sc, row=fast_rows.get(d, -1))
                blended = blend_two_tier(
                    fast_hits, list(qpool.values()), self._effective_quality_weight(qclass)
                )
                fused = fuse_by_strategy(cfg.fusion_strategy, lexical_pool, blended, k, 0, rrf_cfg)
            elif qscores:
                aligned = [qscores.get(h.doc_id) for h in fast_hits]
                blended = blend_two_tier_aligned(
                    fast_hits, aligned, self._effective_quality_weight(qclass)
                )
                fused = fuse_by_strategy(cfg.fusion_strategy, lexical_pool, blended, k, 0, rrf_cfg)
            elif batch_fused is not None and i in batch_fused and fast_hits:
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
            if qscores:
                for r in results:
                    if r.doc_id in qscores:
                        r.quality_score = qscores[r.doc_id]
                        r.sources |= SearchSource.QUALITY_VECTOR
            if self.feedback is not None and results:
                results = self.feedback.apply(results)
            outcomes[i].results = results[:k]
            outcomes[i].metrics.fast_candidates = len(fast_hits)
            outcomes[i].metrics.lexical_candidates = len(lexical_pool)
            outcomes[i].metrics.quality_candidates = len(qscores or {})
        return outcomes

    # ------------------------------------------------------------------ phase 1

    def _run_phase1(
        self,
        parsed: ParsedQuery,
        qclass: QueryClass,
        k: int,
        metrics: TwoTierMetrics,
        search_filter,
        text_fn: TextFn | None,
    ) -> tuple[list[ScoredResult], list[VectorHit], list[ScoredResult]]:
        cfg = self.config
        lex_budget = max(
            int(candidate_count(k, 0, cfg.candidate_multiplier) * qclass.lexical_budget_multiplier()),
            k,
        )
        sem_budget = max(
            int(candidate_count(k, 0, cfg.candidate_multiplier) * qclass.semantic_budget_multiplier()),
            k,
        )

        # fully fused singleton lane: with a device lexical arm, phase 1's
        # (embed +) scan + BM25 run as one device pass. Off when a per-hit
        # control of the classified path is set, for boolean-lane queries
        # (tree retrieval + per-hit filtering) and for identifier queries
        # on a non-semantic stack (that lane decides after seeing the
        # lexical pool); an empty fused result falls back so the zero-signal
        # taxonomy still classifies genuinely empty lanes.
        if (
            self._semantic_admitted
            and self.lexical is not None
            and search_filter is None
            and self.calibrator is None
            and self.hubness is None
            and self.smoother is None
            and parsed.boolean_query is None
            and not (qclass is QueryClass.IDENTIFIER and not self.fast_embedder.is_semantic)
        ):
            t_f = time.monotonic()
            fused_single = self._fused_phase1_batch(None, [parsed.positive], sem_budget, lex_budget)
            if fused_single is None:
                # not a Model2Vec fast tier: embed first, then fuse scan + BM25
                vec = self.fast_embedder.embed(parsed.positive)
                fused_single = self._fused_phase1_batch(
                    vec[None, :], [parsed.positive], sem_budget, lex_budget
                )
            if fused_single is not None and fused_single[0][0]:
                hydrated, lex_lists, _raw = fused_single
                fast_hits = hydrated[0]
                cands = lex_lists[0]
                meta = self.lexical.hydrate_candidates([c.doc_id for c in cands])
                lexical_pool = self._drop_superseded([
                    ScoredResult(
                        doc_id=c.doc_id, score=c.score, lexical_score=c.score,
                        title=(meta.get(c.doc_id) or {}).get("title"),
                        metadata=(meta.get(c.doc_id) or {}).get("metadata"),
                    )
                    for c in cands
                ])
                metrics.fast_embed_ms = 0.0  # inside the scan's pass
                metrics.vector_scan_ms = (time.monotonic() - t_f) * 1000.0
                metrics.lexical_ms = 0.0
                metrics.lexical_candidates = len(lexical_pool)
                metrics.scan_docs = self.index.fast.live_count
                metrics.fast_candidates = len(fast_hits)
                metrics.phase1_fused = True
                return self._phase1_fuse(parsed, qclass, k, metrics, text_fn, lexical_pool, fast_hits)

        # concurrent fast embed + lexical search (searcher.rs:1536 rayon::join)
        fast_future = None
        if self._semantic_admitted:
            fast_future = self._pool.submit(self._timed_fast_embed, parsed.positive, metrics)
        lexical_pool: list[ScoredResult] = []
        if self.lexical is not None:
            t_lex = time.monotonic()
            if parsed.boolean_query is not None:
                # tree retrieval: exact on the oracle, bag + post-filter on
                # device arms
                pool = self.lexical.search_boolean(parsed.boolean_query, lex_budget)
            else:
                pool = self.lexical.search(parsed.positive, lex_budget)
            lexical_pool = self._apply_filter_to_pool(self._drop_superseded(pool), search_filter)
            metrics.lexical_ms = (time.monotonic() - t_lex) * 1000.0
            metrics.lexical_candidates = len(lexical_pool)

        # identifier short-circuit (searcher.rs:1451,1641): identifier
        # queries with enough lexical evidence skip a non-semantic vector arm
        fast_hits: list[VectorHit] = []
        short_circuit = (
            qclass is QueryClass.IDENTIFIER
            and len(lexical_pool) >= k
            and not self.fast_embedder.is_semantic
        )
        if fast_future is not None and not short_circuit:
            query_vec = fast_future.result()
            t_scan = time.monotonic()
            classified: ClassifiedHits = self.index.search_fast_classified(
                query_vec, sem_budget, search_filter=search_filter,
                mrl_search_dims=cfg.mrl_search_dims,
                mrl_rescore_top_k=cfg.mrl_rescore_top_k,
                mode="mrl" if cfg.mrl_search_dims else cfg.scan_mode,
                nprobe=cfg.ivf_nprobe,
            )
            metrics.vector_scan_ms = (time.monotonic() - t_scan) * 1000.0
            metrics.scan_docs = self.index.fast.live_count
            if classified.zero_signal is not None:
                metrics.zero_signal = classified.zero_signal.value
            fast_hits = list(classified.hits)
            if self.calibrator is not None:
                fast_hits = [VectorHit(h.doc_id, self.calibrator(h.score), h.row) for h in fast_hits]
            if self.hubness is not None:
                fast_hits = self.hubness.apply(fast_hits)
            if self.smoother is not None:
                fast_hits = self.smoother.apply(fast_hits)
        elif fast_future is not None:
            fast_future.cancel()
        metrics.fast_candidates = len(fast_hits)
        return self._phase1_fuse(parsed, qclass, k, metrics, text_fn, lexical_pool, fast_hits)

    def _phase1_fuse(self, parsed, qclass, k, metrics, text_fn, lexical_pool, fast_hits):
        cfg = self.config
        # fuse (searcher.rs:1760-1825); a graph ranker feeds RRF a third arm
        t_fuse = time.monotonic()
        rrf_cfg = RrfConfig(
            k=self._effective_rrf_k(qclass),
            lexical_weight=cfg.lexical_rrf_weight,
            semantic_weight=self._effective_semantic_weight(lexical_pool, parsed),
            tiebreak=cfg.tiebreak,
        )
        if self.graph_ranker is not None and cfg.graph_rrf_weight > 0.0:
            from frankensearch_tpu_torch.fusion.rrf import rrf_fuse_with_graph

            seeds = lexical_pool or [ScoredResult(doc_id=h.doc_id, score=h.score) for h in fast_hits]
            graph_pool = self.graph_ranker.rank(seeds, limit=k * cfg.candidate_multiplier)
            fused = rrf_fuse_with_graph(
                lexical_pool, fast_hits, graph_pool, cfg.graph_rrf_weight, k, 0, rrf_cfg,
            )
        else:
            fused = fuse_by_strategy(cfg.fusion_strategy, lexical_pool, fast_hits, k, 0, rrf_cfg)
        results = self._fused_to_results(fused, lexical_pool, fast_hits, text_fn, parsed)
        metrics.fusion_ms = (time.monotonic() - t_fuse) * 1000.0
        metrics.fused_candidates = len(results)
        return results, fast_hits, lexical_pool

    def _timed_fast_embed(self, text: str, metrics: TwoTierMetrics) -> np.ndarray:
        t0 = time.monotonic()
        vec = self.fast_embedder.embed(text)
        metrics.fast_embed_ms = (time.monotonic() - t0) * 1000.0
        return vec

    # ------------------------------------------------------------------ fusion helpers

    def _effective_rrf_k(self, qclass: QueryClass) -> float:
        if self.adaptive is not None:
            return float(self.adaptive.choose_rrf_k(qclass))
        return float(qclass.rrf_k_adjustment(self.config.rrf_k))

    def _effective_quality_weight(self, qclass: QueryClass) -> float:
        if self.adaptive is not None:
            return float(self.adaptive.choose_blend(qclass))
        return self.config.quality_weight

    def record_feedback(
        self,
        query: str,
        doc_id: str | None = None,
        *,
        success: bool = True,
        rank: int | None = None,
        requested_k: int | None = None,
        dwell_s: float | None = None,
    ) -> None:
        """Record one implicit-feedback outcome against this searcher's
        controls (adaptive arms, click boosts, conformal coverage); no-op
        when none is attached."""
        if self.control_plane is not None:
            self.control_plane.record(
                query, doc_id, success=success, rank=rank,
                requested_k=requested_k, dwell_s=dwell_s,
            )
            return
        qclass = QueryClass.classify(query)
        if self.adaptive is not None:
            self.adaptive.update(qclass, success)
        if self.feedback is not None and doc_id and success:
            self.feedback.record_click(doc_id)
        if self.conformal is not None:
            if rank is not None and success:
                self.conformal.add_rank(rank)
            if requested_k is not None:
                self.conformal.observe(success and rank is not None and rank <= requested_k)

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
        if result.quality_score is not None:
            components["quality_cosine"] = result.quality_score
        notes = [f"fusion={self.config.fusion_strategy.value}", f"rrf_k={self.config.rrf_k}"]
        return HitExplanation(
            doc_id=result.doc_id,
            fused_score=fused.score,
            components=components,
            ranks=ranks,
            rank_after=rank,
            notes=notes,
        )

    @staticmethod
    def _attach_boolean_tree(parsed: ParsedQuery, canonical: str) -> ParsedQuery:
        """Quoted-phrase / AND/OR/NOT queries take the boolean lane: the
        tree is parsed once and carried on the ParsedQuery, so phase 1's
        retrieval and both phases' post-filters see the same constraints.
        Plain bags (bare ``-term`` negation included) pass through."""
        import dataclasses

        from frankensearch_tpu_torch.lexical.query import (
            has_structure,
            is_boolean_syntax,
            parse_query as parse_boolean,
        )

        if not is_boolean_syntax(canonical):
            return parsed
        btree = parse_boolean(canonical)
        if not has_structure(btree):
            return parsed
        return dataclasses.replace(parsed, boolean_query=btree)

    def _negation_excludes(
        self,
        doc_id: str,
        lex: ScoredResult | None,
        text_fn: TextFn | None,
        parsed: ParsedQuery,
        meta_cache: "dict | None" = None,
    ) -> bool:
        """Post-retrieval constraint filter over the available text
        (parsed_query.rs contract; both phases): the negative terms and,
        for boolean-lane queries, the whole tree. A hit whose text provably
        violates a constraint is dropped; docs with no available text are
        kept. The lexical arm's hydration, where it carries the full
        content, makes the verdict exact."""
        text = None
        fields: "tuple | None" = None  # (title, body) when structured
        authoritative = False  # True when text is the doc's full content
        hydrated = None
        if self.lexical is not None and (parsed.boolean_query is not None or parsed.has_negations):
            if meta_cache is not None:
                hydrated = meta_cache.get(doc_id)
            else:
                hydrated = self.lexical.hydrate_candidates([doc_id]).get(doc_id)
            if hydrated:
                full = hydrated.get("content") or None
                if full is not None:
                    fields = (hydrated.get("title"), str(full))
                    text = " ".join(p for p in fields if p) or None
                    authoritative = True
        # below the full content: the caller's text_fn, then the result's
        # metadata preview, its title, and the hydration preview last
        if text is None and text_fn is not None:
            text = text_fn(doc_id)
        if text is None and lex is not None and lex.metadata:
            text = str(lex.metadata.get("preview", "")) or None
        if text is None and lex is not None and lex.title:
            text = lex.title
        if text is None and hydrated:
            fields = (hydrated.get("title"), str(hydrated.get("preview", "")))
            text = " ".join(p for p in fields if p) or None
        if text is None:
            return False
        if parsed.excludes(text):
            return True
        bq = parsed.boolean_query
        if bq is not None and bq.root is not None:
            from frankensearch_tpu_torch.lexical.query import field_tokens, tree_drop_verdict

            # structured fields tokenize separately (no cross-field phrase
            # adjacency); ``fields`` is set only for the text in use
            tokens = field_tokens(*fields) if fields else field_tokens(text)
            return tree_drop_verdict(
                bq.root, tokens, full_known=authoritative, positive_terms=bq.positive_terms(),
            )
        return False

    def _constraint_filtering(self, parsed: ParsedQuery) -> bool:
        """True when fused results need the per-hit text filter."""
        return parsed.has_negations or parsed.boolean_query is not None

    # ------------------------------------------------------------------ phase 2

    def _phase2_skip_reason(
        self, fast_hits: list[VectorHit], initial: list[ScoredResult], plan=None
    ) -> str | None:
        if plan is not None:
            # the intent plan turns the quality stage off (lookup queries);
            # when it is off for an environmental reason the static ladder's
            # reason wins
            stage = plan.stage("quality")
            if (stage is None or not stage.enabled) and not (stage and stage.reason):
                return f"query_plan:{plan.intent.value}"
        return self._phase2_skip_reason_static(fast_hits, initial)

    def _phase2_skip_reason_static(
        self, fast_hits: list[VectorHit], initial: list[ScoredResult]
    ) -> str | None:
        if self.config.fast_only:
            return "fast_only"
        if self.quality_embedder is None and not self.index.has_quality_tier:
            return "no_quality_tier"
        if self.quality_embedder is None:
            return "no_quality_embedder"
        if not self.index.has_quality_tier:
            return "no_quality_tier"
        if not self._quality_admitted:
            return "quality_identity_mismatch"  # fail-closed, pre-embed
        if not initial:
            return "no_candidates"
        if not fast_hits:
            return "no_semantic_candidates"
        if self.governor is not None and not self.governor.allow_quality_tier:
            return "pressure"
        if self.circuit_breaker is not None and self.circuit_breaker.should_skip_quality():
            return "circuit_open"
        if self.phase_gate is not None and self.phase_gate.should_skip_quality():
            return "phase_gate"
        return None

    def _run_phase2_with_timeout(
        self,
        parsed: ParsedQuery,
        qclass: QueryClass,
        k: int,
        fast_hits: list[VectorHit],
        lexical_pool: list[ScoredResult],
        initial: list[ScoredResult],
        metrics: TwoTierMetrics,
        text_fn: TextFn | None,
        quality_prefetch=None,
        timeout_ms_override: float | None = None,
    ) -> tuple[list[ScoredResult] | None, str | None]:
        """Phase 2 on the worker pool under ``quality_timeout_ms`` (capped by
        the plan's stage budget; 0 waits without a limit). A timeout or an
        exception is the RefinementFailed outcome ("timeout" / "error"),
        recorded for the circuit breaker."""
        timeout_ms = self.config.quality_timeout_ms
        if timeout_ms_override is not None:
            timeout_ms = min(timeout_ms, timeout_ms_override)
        timeout_s = timeout_ms / 1000.0
        future = self._pool.submit(
            self._run_phase2, parsed, qclass, k, fast_hits, lexical_pool, metrics, text_fn,
            quality_prefetch,
        )
        t0 = time.monotonic()
        try:
            refined = future.result(timeout=timeout_s if timeout_s > 0 else None)
            improved = self._record_phase2_outcome(
                failed=False, timed_out=False, elapsed=time.monotonic() - t0, metrics=metrics
            )
            if self.phase_gate is not None:
                self.phase_gate.record(improved)
            return refined, None
        except concurrent.futures.TimeoutError:
            future.cancel()
            self._record_phase2_outcome(failed=False, timed_out=True, elapsed=timeout_s, metrics=metrics)
            return None, "timeout"
        except Exception:
            self._record_phase2_outcome(
                failed=True, timed_out=False, elapsed=time.monotonic() - t0, metrics=metrics
            )
            return None, "error"

    def _record_phase2_outcome(
        self, *, failed: bool, timed_out: bool, elapsed: float, metrics: TwoTierMetrics
    ) -> bool:
        tau = metrics.kendall_tau
        improved = (not failed) and (not timed_out) and (tau is None or tau < 0.98)
        if self.circuit_breaker is not None:
            slow = elapsed * 1000.0 > self.config.quality_timeout_ms * 0.8
            self.circuit_breaker.record_outcome(
                Phase2Outcome(failed=failed, timed_out=timed_out, slow=slow, improved=improved)
            )
        return improved

    def _run_phase2(
        self,
        parsed: ParsedQuery,
        qclass: QueryClass,
        k: int,
        fast_hits: list[VectorHit],
        lexical_pool: list[ScoredResult],
        metrics: TwoTierMetrics,
        text_fn: TextFn | None,
        quality_prefetch=None,
    ) -> list[ScoredResult]:
        assert self.quality_embedder is not None
        t0 = time.monotonic()
        if quality_prefetch is not None:
            quality_vec = quality_prefetch()  # the forward enqueued before phase 1
        else:
            quality_vec = self.quality_embedder.embed(parsed.positive)
        metrics.quality_embed_ms = (time.monotonic() - t0) * 1000.0

        # Rocchio PRF with the phase-1 top docs' centroid (prf.rs)
        if self.prf is not None and fast_hits:
            quality_vec = self.prf.expand(quality_vec, fast_hits, self.index)

        t1 = time.monotonic()
        qscores = self.index.quality_scores_for_hits(quality_vec, fast_hits)
        if self.calibrator is not None:
            qscores = {d: self.calibrator(s) for d, s in qscores.items()}
        aligned: list[float | None] = [qscores.get(h.doc_id) for h in fast_hits]
        metrics.quality_rescore_ms = (time.monotonic() - t1) * 1000.0
        metrics.quality_candidates = sum(1 for s in aligned if s is not None)

        t2 = time.monotonic()
        if self.config.quality_rescan and self.index.quality is not None:
            # pool expansion: a full quality-tier scan surfaces docs the
            # fast tier cannot see
            sem_budget = max(
                int(candidate_count(k, 0, self.config.candidate_multiplier)
                    * qclass.semantic_budget_multiplier()),
                k,
            )
            res = self.index.quality.search_batch(quality_vec, sem_budget)
            scan_hits = self.index.quality.hydrate(res)[0]
            if self.calibrator is not None:
                scan_hits = [VectorHit(h.doc_id, self.calibrator(h.score), h.row) for h in scan_hits]
            qpool: dict[str, VectorHit] = {h.doc_id: h for h in scan_hits}
            fast_rows = {h.doc_id: h.row for h in fast_hits}
            for d, s in qscores.items():
                if d not in qpool:
                    qpool[d] = VectorHit(doc_id=d, score=s, row=fast_rows.get(d, -1))
            for h in scan_hits:  # expanded docs carry quality scores too
                qscores.setdefault(h.doc_id, h.score)
            metrics.quality_candidates = len(qpool)
            blended = blend_two_tier(fast_hits, list(qpool.values()), self._effective_quality_weight(qclass))
        else:
            blended = blend_two_tier_aligned(fast_hits, aligned, self._effective_quality_weight(qclass))
        metrics.blend_ms = (time.monotonic() - t2) * 1000.0
        metrics.kendall_tau = kendall_tau(fast_hits, blended)

        # lexical re-fusion (searcher.rs:2359): the refined order reflects
        # both sources without a second lexical query
        rrf_cfg = RrfConfig(
            k=self._effective_rrf_k(qclass),
            lexical_weight=self.config.lexical_rrf_weight,
            semantic_weight=self._effective_semantic_weight(lexical_pool, parsed),
            tiebreak=self.config.tiebreak,
        )
        fused = fuse_by_strategy(self.config.fusion_strategy, lexical_pool, blended, k, 0, rrf_cfg)
        fast_by_doc = {h.doc_id: h.score for h in fast_hits}
        lex_by_doc = {r.doc_id: r for r in lexical_pool}
        meta_cache = self._constraint_meta_cache(parsed, fused)
        out: list[ScoredResult] = []
        for h in fused:
            lex = lex_by_doc.get(h.doc_id)
            if self._constraint_filtering(parsed) and self._negation_excludes(
                h.doc_id, lex, text_fn, parsed, meta_cache
            ):
                continue
            out.append(ScoredResult(
                doc_id=h.doc_id,
                score=h.score,
                lexical_score=lex.score if lex else None,
                fast_score=fast_by_doc.get(h.doc_id),
                quality_score=qscores.get(h.doc_id),
                sources=h.sources
                | (SearchSource.QUALITY_VECTOR if h.doc_id in qscores else SearchSource.NONE),
                title=lex.title if lex else None,
                metadata=lex.metadata if lex else None,
            ))
        return out

    # ------------------------------------------------------------------ phase 3

    def _run_phase3(
        self,
        query: str,
        results: list[ScoredResult],
        k: int,
        text_fn: TextFn,
        metrics: TwoTierMetrics,
    ) -> list[ScoredResult] | None:
        """Cross-encoder rerank of the top results (then MMR). A skip is
        typed in ``metrics.phase3_skip_reason`` (the pipeline's rerank_error
        / no_text / no_input, or rerank_failed for a ``SearchError`` of the
        step; rerank/pipeline.rs contract). Any other exception (a device
        fault in the cross-encoder or MMR) propagates."""
        from frankensearch_tpu_torch.rerank.pipeline import rerank_step

        try:
            reranked = rerank_step(
                self.reranker, query, results, text_fn,
                top_n=min(self.config.rerank_top_n, len(results)),
            )
            metrics.rerank_ms = reranked.rerank_ms
            if reranked.skipped:
                metrics.phase3_skip_reason = reranked.skip_reason or "rerank_skipped"
                return None
            out = reranked.results
            if self.mmr is not None:
                out = self.mmr.apply(out, self.index)
            return out
        except SearchError:
            metrics.phase3_skip_reason = "rerank_failed"
            return None

    # ------------------------------------------------------------------ misc

    def _export(self, metrics: TwoTierMetrics, t_start: float) -> None:
        metrics.total_ms = (time.monotonic() - t_start) * 1000.0
        metrics.device_kind = self.index.fast.device.type
        if self.metrics_exporter is not None:
            self.metrics_exporter.export(metrics)
        import logging

        from frankensearch_tpu_torch.utils.tracing import get_logger

        log = get_logger("searcher")
        if log.isEnabledFor(logging.DEBUG):  # hot path: format only when on
            log.debug(
                "search %s total=%.2fms p1=%.2fms p2=%.2fms skip2=%s skip3=%s",
                metrics.query_class, metrics.total_ms, metrics.phase1_ms,
                metrics.phase2_ms, metrics.phase2_skip_reason,
                metrics.phase3_skip_reason,
                extra={"fs_extra": metrics.to_dict()},
            )
