"""Two-tier index: fast tier + optional quality tier (PyTorch port).

Port of ``TwoTierIndex.create`` / ``TwoTierIndex.open`` from
frankensearch_tpu/index/two_tier.py over the reference's own FTVI/WAL
modules, so both packages open the same on-disk artifact. WAL appends,
deletes, compaction, recall certificates and the quality tier's aligned
rescoring (phase 2) are not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu.core.errors import IndexCorrupted, IndexNotFound
from frankensearch_tpu.core.types import ClassifiedHits
from frankensearch_tpu.index.durability import (
    ParityProtector,
    artifact_mutation_lock,
    ensure_artifact,
)
from frankensearch_tpu.index.fsvi import EmbeddingIdentity, FtviFile, write_ftvi
from frankensearch_tpu.index.wal import WriteAheadLog
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex

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
        """Write the tiers as FTVI artifacts under ``root``, then open them."""
        if slab_dtype not in ("bf16", "f16", "f32"):
            raise NotImplementedError(
                f"slab_dtype {slab_dtype!r} is not ported yet (ROADMAP: the int8/MRL/IVF lanes)"
            )
        os.makedirs(root, exist_ok=True)
        write_ftvi(
            os.path.join(root, FAST_FILE), np.asarray(fast_vectors, dtype=np.float32),
            doc_ids, fast_identity, dtype=slab_dtype,
        )
        if quality_vectors is not None:
            if quality_identity is None:
                raise ValueError("quality_vectors requires quality_identity")
            write_ftvi(
                os.path.join(root, QUALITY_FILE),
                np.asarray(quality_vectors, dtype=np.float32),
                doc_ids, quality_identity, dtype=slab_dtype,
            )
        return cls.open(root, device=device, slab_dtype=slab_dtype)

    @property
    def has_quality_tier(self) -> bool:
        return self.quality is not None

    def search_fast_classified(self, query: np.ndarray, k: int, **kwargs) -> ClassifiedHits:
        """Phase-1 vector arm (two_tier.rs:1358)."""
        return self.fast.search_classified(query, k, **kwargs)

    def doc_count(self) -> int:
        return self.fast.live_count
