"""Two-tier search configuration + per-search metrics.

Parity target: reference crates/frankensearch-core/src/config.rs —
TwoTierConfig (:66) with env overrides FRANKENSEARCH_* (:242-341),
TwoTierMetrics (:455), FusionStrategy (:31).

TPU-specific additions are grouped at the bottom of the dataclass
(device batch/tile knobs replacing the reference's rayon thresholds).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field, fields
from typing import Any

from frankensearch_tpu_torch.core.errors import InvalidConfig

_ENV_PREFIX = "FRANKENSEARCH_"


class FusionStrategy(enum.Enum):
    """How lexical + vector arms are merged (parity: core config.rs:31)."""

    RRF = "rrf"
    POOL_MINMAX = "pool_minmax"


class TiebreakStrategy(enum.Enum):
    """Equal-score ordering inside fusion (parity: fusion/rrf.rs tiebreak;
    measured comparison in reference docs/NEGATIVE_EVIDENCE.md)."""

    LEXICAL_THEN_ID = "lexical_then_id"  # legacy default
    NEUTRAL_HASH = "neutral_hash"


@dataclass
class TwoTierConfig:
    """Configuration for the two-tier progressive searcher.

    Defaults mirror the reference (config.rs:66): quality_weight=0.7,
    rrf_k=60, candidate_multiplier=3, quality_timeout_ms=500,
    mrl_rescore_top_k=30.
    """

    # fusion
    quality_weight: float = 0.7  # blend alpha (blend.rs:107)
    rrf_k: int = 60
    candidate_multiplier: int = 3
    fusion_strategy: FusionStrategy = FusionStrategy.RRF
    tiebreak: TiebreakStrategy = TiebreakStrategy.LEXICAL_THEN_ID
    lexical_rrf_weight: float = 1.0
    fast_rrf_weight: float = 1.0
    quality_rrf_weight: float = 1.0
    graph_rrf_weight: float = 0.5

    # phases
    quality_timeout_ms: int = 500
    fast_only: bool = False
    rerank_enabled: bool = False
    rerank_top_n: int = 20

    # MRL (Matryoshka) two-pass
    mrl_search_dims: int | None = None
    mrl_rescore_top_k: int = 30

    # optional quality kernels (off by default; zero-cost when off —
    # config.rs:100-130 doc comments record measured nDCG deltas)
    neighbor_smoothing: bool = False
    smoothing_alpha: float = 0.1
    smoothing_neighbors: int = 5
    hubness_beta: float = 0.0  # 0.2 measured +0.0033 nDCG@10
    nqc_downweight: bool = False
    #: pseudo-relevance feedback: Rocchio-expand the query vector from
    #: the top fast hits before Phase 2 (prf.rs role)
    prf_enabled: bool = False
    #: MMR result diversification: None = off, else the relevance-
    #: diversity tradeoff in [0, 1] (mmr.rs lambda)
    mmr_lambda: float | None = None
    #: personalized-PageRank third fusion source over the document link
    #: graph built from metadata["links"] at open (graph_rank.rs); the
    #: blend weight is graph_rrf_weight above
    graph_rank: bool = False
    #: hubness correction is O(N^2) to precompute: corpora above this
    #: row count skip it at open (with a warning) rather than stall
    hubness_max_docs: int = 20_000
    #: intent-aware stage planning (runtime/query_planner.py; parity
    #: fsfs query_planning.rs): classify intent, allocate per-stage
    #: budgets from query_budget_ms, skip stages the plan disables
    #: (lookup queries skip the quality tier) and cap the quality
    #: timeout at the stage budget
    query_planning: bool = False
    query_budget_ms: float = 250.0

    # explanations
    explain: bool = False

    # --- TPU-native knobs (no reference analog; replace rayon thresholds) ---
    #: device scan tile size along the document axis (rows per grid step)
    scan_tile_docs: int = 1024
    #: max concurrent queries per device program invocation
    query_batch: int = 64
    #: int8 two-pass candidate multiplier (pass-1 keeps k*this, search.rs:514)
    int8_candidate_multiplier: int = 4
    #: storage dtype for the fast tier slab: "bf16" | "f16" | "f32" | "int8"
    slab_dtype: str = "bf16"
    #: use fused Pallas scan kernel when available (else pure-XLA path)
    use_pallas: bool = True
    #: scan lane: "auto" (fastest exact) | "int8" (capacity, 2x docs/chip)
    #: | "ivf" (latency; needs enable_ivf on the fast index) | "mrl"
    #: | "hierarchical" | "pallas" | "xla"
    scan_mode: str = "auto"
    #: clusters probed per query in the ivf lane (recall knob; certify
    #: with index/ivf.calibrate_nprobe)
    ivf_nprobe: int = 8
    #: fail-closed certification for approximate scan lanes
    #: (recall_certificate.rs parity): when True, scan_mode int8/ivf/mrl
    #: REFUSES to serve unless DeviceVectorIndex.certify_scan_mode has
    #: recorded a certificate for that mode whose certified recall meets
    #: min_certified_recall and whose k covers the request
    require_recall_certificate: bool = False
    #: certified-recall floor the certificate must meet when required
    min_certified_recall: float = 0.9
    #: phase 2 EXPANDS the candidate pool with a full quality-tier scan
    #: (a ~1 device-ms op on TPU; no reference analog — the CPU reference
    #: can only rescore phase-1 candidates). Off by default: it changes
    #: the candidate-pool contract, not just ordering.
    quality_rescan: bool = False
    #: shard the fast-tier slab rows over a device mesh of this many chips
    #: (0 = single device). The BASELINE "10M docs sharded across TPU
    #: cores" config: every batched scan runs the shard_map local-scan +
    #: all_gather top-k merge (parallel/sharded_scan.py), bit-identical
    #: ordering to single-device. Requires that many visible devices.
    mesh_shards: int = 0
    #: lexical engine backend: "auto" opens whatever the build produced
    #: (FTS5 .db if present, else oracle+packed device arm); "fts5"
    #: builds/opens the sqlite FTS5 engine (fts5_adapter.rs: one .db
    #: artifact, MVCC writes searchable at commit); "oracle" forces the
    #: in-memory+FLXB arms even when an fts5.db exists
    lexical_backend: str = "auto"
    #: WAL durability policy for live updates: "always" fsyncs every
    #: append batch; "deferred" group-commits (one fsync per watch poll
    #: cycle / durability window via TwoTierIndex.sync_wal) — the quill
    #: watch-contract throughput knob (>=5k updates/s, BASELINE.md:34-37).
    wal_sync: str = "always"

    # --- adaptive control plane (searcher.rs:312-868 with_* surface) ---
    #: learn per-query-class rrf_k / blend from recorded feedback
    #: (Thompson sampling, fusion/adaptive.py); state persists in the
    #: index root's control_plane.json so CLI feedback survives restarts
    adaptive_fusion: bool = False
    adaptive_seed: int = 0
    #: distribution-free required-k coverage (fusion/conformal.py):
    #: when set, search() widens k to the split-conformal quantile for
    #: coverage 1 - alpha (needs calibration via feedback ranks)
    conformal_alpha: float | None = None
    #: score-calibration preset applied pre-fusion (fusion/calibration.py):
    #: "temperature:<t>" | "platt:<a>,<b>" | "" (off)
    calibration: str = ""

    def validate(self) -> "TwoTierConfig":
        if not (0.0 <= self.quality_weight <= 1.0):
            raise InvalidConfig(f"quality_weight must be in [0,1], got {self.quality_weight}")
        if self.rrf_k <= 0:
            raise InvalidConfig(f"rrf_k must be positive, got {self.rrf_k}")
        if self.candidate_multiplier <= 0:
            raise InvalidConfig("candidate_multiplier must be positive")
        if self.quality_timeout_ms < 0:
            raise InvalidConfig("quality_timeout_ms must be >= 0")
        if self.slab_dtype not in ("bf16", "f16", "f32", "int8"):
            raise InvalidConfig(f"unknown slab_dtype {self.slab_dtype!r}")
        if self.mrl_search_dims is not None and self.mrl_search_dims <= 0:
            raise InvalidConfig("mrl_search_dims must be positive when set")
        if self.scan_mode not in ("auto", "int8", "ivf", "mrl", "hierarchical", "pallas", "xla"):
            raise InvalidConfig(f"unknown scan_mode {self.scan_mode!r}")
        if self.ivf_nprobe <= 0:
            raise InvalidConfig("ivf_nprobe must be positive")
        if self.mesh_shards < 0:
            raise InvalidConfig("mesh_shards must be >= 0 (0 = single device)")
        if self.wal_sync not in ("always", "deferred"):
            raise InvalidConfig(f"unknown wal_sync {self.wal_sync!r}")
        if self.lexical_backend not in ("auto", "fts5", "oracle"):
            raise InvalidConfig(f"unknown lexical_backend {self.lexical_backend!r}")
        if self.conformal_alpha is not None and not (0.0 < self.conformal_alpha < 1.0):
            raise InvalidConfig(
                f"conformal_alpha must be in (0,1), got {self.conformal_alpha}"
            )
        if self.calibration:
            from frankensearch_tpu_torch.fusion.control_plane import parse_calibrator

            parse_calibrator(self.calibration)  # raises InvalidConfig on bad spec
        if self.mmr_lambda is not None and not (0.0 <= self.mmr_lambda <= 1.0):
            raise InvalidConfig(f"mmr_lambda must be in [0,1], got {self.mmr_lambda}")
        if self.query_budget_ms <= 0:
            raise InvalidConfig(f"query_budget_ms must be > 0, got {self.query_budget_ms}")
        if self.hubness_beta < 0.0:
            raise InvalidConfig(f"hubness_beta must be >= 0, got {self.hubness_beta}")
        return self

    @classmethod
    def from_env(cls, base: "TwoTierConfig | None" = None) -> "TwoTierConfig":
        """Apply FRANKENSEARCH_* env overrides (parity: config.rs:242-341).

        Recognized: FRANKENSEARCH_QUALITY_WEIGHT, FRANKENSEARCH_RRF_K,
        FRANKENSEARCH_CANDIDATE_MULTIPLIER, FRANKENSEARCH_QUALITY_TIMEOUT_MS,
        FRANKENSEARCH_FAST_ONLY, FRANKENSEARCH_FUSION_STRATEGY,
        FRANKENSEARCH_MRL_SEARCH_DIMS, FRANKENSEARCH_HUBNESS_BETA, ...
        (every scalar field by upper-cased name).
        """
        cfg = base or cls()
        values: dict[str, Any] = {}
        for f in fields(cls):
            env_key = _ENV_PREFIX + f.name.upper()
            raw = os.environ.get(env_key)
            if raw is None:
                continue
            values[f.name] = _parse_env_value(f.name, raw, getattr(cfg, f.name))
        if not values:
            return cfg
        merged = {f.name: getattr(cfg, f.name) for f in fields(cls)}
        merged.update(values)
        return cls(**merged).validate()

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.value if isinstance(v, enum.Enum) else v
        return out

    @classmethod
    def optimized(cls, path: str = "data/optimized_params.json") -> "TwoTierConfig":
        """Load tuned parameters produced by tools/optimize_params.py
        (parity: config.rs ``optimized()`` reading
        data/optimized_params.toml from the CMA-ES tuner). Missing file
        falls back to defaults; env overrides still apply on top."""
        import json
        import os

        base = cls()
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    tuned = json.load(f).get("params", {})
                merged = {fld.name: getattr(base, fld.name) for fld in fields(cls)}
                for key, value in tuned.items():
                    if key in merged:
                        merged[key] = _parse_env_value(key, str(value), merged[key])
                base = cls(**merged).validate()
            except (json.JSONDecodeError, OSError, InvalidConfig):
                base = cls()
        return cls.from_env(base)


def _parse_env_value(name: str, raw: str, current: Any) -> Any:
    try:
        if name == "fusion_strategy":
            return FusionStrategy(raw.lower())
        if name == "tiebreak":
            return TiebreakStrategy(raw.lower())
        if isinstance(current, bool):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        if isinstance(current, int):
            return int(raw)
        if isinstance(current, float):
            return float(raw)
        if current is None and name == "mrl_search_dims":
            return int(raw)
        if current is None and name == "conformal_alpha":
            return float(raw)
        return raw
    except ValueError as e:
        raise InvalidConfig(f"bad env value for {name}: {raw!r}") from e


@dataclass
class TwoTierMetrics:
    """Per-search timing/count metrics (parity: config.rs:455).

    Every phase's wall time plus candidate counts, skip reasons, and
    rank-stability (Kendall tau between Phase 1 and Phase 2 orderings).
    Each time is the host time of the phase's span (utils/tracing.py
    ``span``), which is also a profiler range under ``torch.profiler``.
    ``search_batch`` gives every outcome the whole batch's times:
    ``canonicalize_us``, ``fast_embed_ms``, ``vector_scan_ms``,
    ``lexical_ms``, ``fusion_ms``, ``phase2_ms`` (the batched quality
    rescore), ``phase1_ms`` (the batch's time to its fused results less
    ``phase2_ms``) and ``total_ms``, where those phases ran.
    """

    query_class: str = ""
    canonicalize_us: float = 0.0
    fast_embed_ms: float = 0.0
    lexical_ms: float = 0.0
    vector_scan_ms: float = 0.0
    fusion_ms: float = 0.0
    phase1_ms: float = 0.0
    quality_embed_ms: float = 0.0
    quality_rescore_ms: float = 0.0
    blend_ms: float = 0.0
    phase2_ms: float = 0.0
    rerank_ms: float = 0.0
    phase3_ms: float = 0.0
    total_ms: float = 0.0
    lexical_candidates: int = 0
    fast_candidates: int = 0
    quality_candidates: int = 0
    fused_candidates: int = 0
    phase2_skip_reason: str | None = None
    phase3_skip_reason: str | None = None
    #: planner intent (query_planning on; runtime/query_planner.py)
    query_intent: str | None = None
    kendall_tau: float | None = None
    zero_signal: str | None = None
    #: device dispatch metadata (TPU-native)
    device_kind: str = ""
    #: phase 1 served by the fused embed+scan+BM25 device program
    #: (ops/hybrid_phase1.py) — observability for the lane choice
    phase1_fused: bool = False
    scan_docs: int = 0
    #: the lane this query's BM25 took inside the fused pass ("dense",
    #: "flat", "pruned" or "daat"); a field of the port's own, kept out of
    #: ``to_dict`` (the reference's wire form)
    lexical_lane: str | None = field(default=None, metadata={"wire": False})

    def to_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self) if f.metadata.get("wire", True)}


class MetricsExporter:
    """Callback interface for per-search metrics (parity: core traits.rs
    MetricsExporter :1063). Zero overhead when not installed."""

    def export(self, metrics: TwoTierMetrics) -> None:  # pragma: no cover
        raise NotImplementedError


@dataclass
class CollectingExporter(MetricsExporter):
    """Test/ops exporter that retains every metrics struct."""

    collected: list[TwoTierMetrics] = field(default_factory=list)

    def export(self, metrics: TwoTierMetrics) -> None:
        self.collected.append(metrics)
