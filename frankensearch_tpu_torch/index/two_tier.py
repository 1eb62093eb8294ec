"""Two-tier index: fast tier + optional quality tier (PyTorch port).

Port of ``TwoTierIndex.create`` / ``TwoTierIndex.open`` /
``certify_fast_scan_mode`` from frankensearch_tpu/index/two_tier.py, over
the port's copies of the FTVI/WAL modules, which write and read the
reference's bytes: both packages open the same on-disk artifact, int8
artifacts included. Recall certificates persist in the generation
manifest and rebind on open. The quality tier serves phase 2: the
aligned rescore of phase 1's hits (``quality_scores_for_hits``) and a
full quality-tier scan (``search_quality``). WAL appends, deletes and
compaction are not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.errors import IndexCorrupted, IndexNotFound
from frankensearch_tpu_torch.core.types import ClassifiedHits, VectorHit
from frankensearch_tpu_torch.index.durability import (
    ParityProtector,
    artifact_mutation_lock,
    ensure_artifact,
)
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity, FtviFile, write_ftvi
from frankensearch_tpu_torch.index.recall_certificate import (
    load_persisted_certificates,
    persist_certificate,
)
from frankensearch_tpu_torch.index.wal import WriteAheadLog
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.ops.quantize import calibrate_int8

FAST_FILE = "vector.fast.idx"
FAST_FALLBACK_FILE = "vector.idx"
QUALITY_FILE = "vector.quality.idx"


def _open_ftvi_repairing(path: str, verify: bool) -> FtviFile:
    """Verify-then-repair-on-open: check the digest sidecar (parity repair
    on mismatch), parse, and give a parse-level ``IndexCorrupted`` one
    parity-repair retry. Unrepairable corruption propagates."""

    def _ftvi_intrinsic(p: str) -> bool:
        FtviFile(p, verify_slab=True)
        return True

    if not ensure_artifact(path, intrinsic_check=_ftvi_intrinsic):
        raise IndexCorrupted(f"{path} failed durability verification and parity repair")
    try:
        return FtviFile(path, verify_slab=verify)
    except IndexCorrupted:
        with artifact_mutation_lock(path):
            report = ParityProtector.verify_and_repair(path)
        if not report.repaired_stripes:
            raise
        return FtviFile(path, verify_slab=verify)


def _fast_path(root: str) -> str:
    primary = os.path.join(root, FAST_FILE)
    if os.path.exists(primary):
        return primary
    fallback = os.path.join(root, FAST_FALLBACK_FILE)
    return fallback if os.path.exists(fallback) else primary


class TwoTierIndex:
    """Fast + optional quality device indexes over one on-disk root."""

    def __init__(
        self,
        fast: DeviceVectorIndex,
        quality: DeviceVectorIndex | None = None,
        *,
        root: str | None = None,
    ) -> None:
        self.fast = fast
        self.quality = quality
        self.root = root
        self._realign()

    def _realign(self) -> None:
        """Fast-tier row -> quality-tier row of the same doc (-1 where the
        quality tier lacks it); the identity when both tiers hold the same
        doc ids in the same order."""
        self._fast_to_quality = None
        if self.quality is None:
            return
        fast_ids, quality = self.fast.doc_ids, self.quality
        if fast_ids == quality.doc_ids:
            self._fast_to_quality = np.arange(len(fast_ids), dtype=np.int64)
            return
        row_of = quality._row_of
        self._fast_to_quality = np.fromiter(
            (row_of.get(d, -1) for d in fast_ids), dtype=np.int64, count=len(fast_ids)
        )

    @classmethod
    def open(
        cls,
        root: str,
        *,
        device: torch.device,
        slab_dtype: str = "bf16",
        verify: bool = False,
    ) -> "TwoTierIndex":
        """Open the on-disk tiers (artifact + replayed WAL) onto ``device``."""
        fast_path = _fast_path(root)
        if not os.path.exists(fast_path):
            raise IndexNotFound(f"no fast-tier artifact under {root}")
        fast = DeviceVectorIndex.from_ftvi(
            _open_ftvi_repairing(fast_path, verify),
            WriteAheadLog(fast_path + ".wal").replay(),
            device=device, slab_dtype=slab_dtype,
        )
        quality = None
        quality_path = os.path.join(root, QUALITY_FILE)
        if os.path.exists(quality_path):
            quality = DeviceVectorIndex.from_ftvi(
                _open_ftvi_repairing(quality_path, verify),
                WriteAheadLog(quality_path + ".wal").replay(),
                device=device, slab_dtype=slab_dtype,
            )
        # persisted recall certificates: rebind the manifest's certificates
        # whose binding matches the fast tier's durable identity (slab crc,
        # WAL census, counts); any mismatch drops them and the fail-closed
        # gate demands a fresh certify
        certs = load_persisted_certificates(root, fast.scan_state_signature())
        if certs:
            fast._recall_certs = dict(certs)
        return cls(fast, quality, root=root)

    @classmethod
    def create(
        cls,
        root: str,
        fast_vectors: np.ndarray,
        doc_ids: Sequence[str],
        fast_identity: EmbeddingIdentity,
        *,
        device: torch.device,
        quality_vectors: np.ndarray | None = None,
        quality_identity: EmbeddingIdentity | None = None,
        slab_dtype: str = "bf16",
    ) -> "TwoTierIndex":
        """Write the tiers as FTVI artifacts under ``root``, then open them.
        ``slab_dtype="int8"`` writes int8 artifacts (the normalized rows
        quantized per dim, the scale in the artifact) and opens them with a
        bf16 slab beside the preloaded int8 arm."""
        if slab_dtype not in ("bf16", "f16", "f32", "int8"):
            raise ValueError(f"unknown slab_dtype {slab_dtype!r}")
        os.makedirs(root, exist_ok=True)

        def write_tier(path: str, vectors: np.ndarray, identity: EmbeddingIdentity) -> None:
            vectors = np.asarray(vectors, dtype=np.float32)
            if slab_dtype == "int8":
                norms = np.linalg.norm(vectors, axis=1, keepdims=True)
                vectors = np.where(norms > 1e-12, vectors / np.maximum(norms, 1e-12), vectors)
                q = calibrate_int8(vectors)
                write_ftvi(path, q.values, doc_ids, identity, dtype="int8", scale=q.scale)
            else:
                write_ftvi(path, vectors, doc_ids, identity, dtype=slab_dtype)

        write_tier(os.path.join(root, FAST_FILE), fast_vectors, fast_identity)
        if quality_vectors is not None:
            if quality_identity is None:
                raise ValueError("quality_vectors requires quality_identity")
            write_tier(os.path.join(root, QUALITY_FILE), quality_vectors, quality_identity)
        return cls.open(
            root, device=device, slab_dtype="bf16" if slab_dtype == "int8" else slab_dtype
        )

    def certify_fast_scan_mode(
        self,
        mode: str,
        k: int,
        sample_queries: np.ndarray,
        *,
        confidence: float = 0.95,
        persist: bool = True,
        **mode_kwargs,
    ):
        """Certify an approximate fast-tier scan mode and persist the
        certificate into the generation manifest, bound to the current
        slab/WAL state: a reopened index in the same state rebinds it
        without the exact pass; any slab or WAL change voids it."""
        cert = self.fast.certify_scan_mode(
            mode, k, sample_queries, confidence=confidence, **mode_kwargs
        )
        if persist and self.root is not None:
            sig = self.fast.scan_state_signature()
            if sig is not None:
                persist_certificate(self.root, mode, cert, sig)
        return cert

    @property
    def has_quality_tier(self) -> bool:
        return self.quality is not None

    def search_fast_classified(self, query: np.ndarray, k: int, **kwargs) -> ClassifiedHits:
        """Phase-1 vector arm (two_tier.rs:1358)."""
        return self.fast.search_classified(query, k, **kwargs)

    def quality_scores_for_hits(
        self,
        quality_query: np.ndarray,
        hits: Sequence[VectorHit],
    ) -> dict[str, float]:
        """Aligned quality rescoring of the phase-1 pool (two_tier.rs:1566):
        each hit's quality row dotted with the quality query in f32 on the
        host copy, no second scan."""
        if self.quality is None:
            return {}
        rows = []
        keep: list[str] = []
        for h in hits:
            q_row = self._fast_to_quality[h.row] if h.row >= 0 else -1
            if q_row >= 0:
                rows.append(int(q_row))
                keep.append(h.doc_id)
        if not rows:
            return {}
        scores = self.quality.scores_for_rows(quality_query, rows)
        return {doc_id: float(s) for doc_id, s in zip(keep, scores)}

    def search_quality(self, quality_query: np.ndarray, k: int, **kwargs) -> ClassifiedHits:
        """Full quality-tier retrieval (owner-backed path,
        searcher.rs:2081-2110)."""
        if self.quality is None:
            return ClassifiedHits(hits=())
        return self.quality.search_classified(quality_query, k, **kwargs)

    def doc_count(self) -> int:
        return self.fast.live_count
