"""Two-tier index: fast tier + optional quality tier (PyTorch port).

Port of frankensearch_tpu/index/two_tier.py, over the port's copies of
the FTVI/WAL modules, which write and read the reference's bytes: both
packages open the same on-disk artifact, int8 artifacts included.
Recall certificates persist in the generation manifest and rebind on open. The quality tier serves phase 2: the aligned
rescore of phase 1's hits (``quality_scores_for_hits``) and a full
quality-tier scan (``search_quality``). The write path appends and
tombstones through each tier's WAL sidecar (``append_fast``,
``append_quality``, ``delete``, group-committed by ``sync_wal`` under
``wal_sync="deferred"``) and folds them back into the artifacts with
``compact``. ``mesh_shards > 0`` opens the fast tier row-sharded over a
mesh (parallel/sharded_index.py); the quality tier stays on one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.errors import IndexCorrupted, IndexNotFound
from frankensearch_tpu_torch.core.generation import refresh_manifest
from frankensearch_tpu_torch.core.types import ClassifiedHits, VectorHit
from frankensearch_tpu_torch.index.durability import (
    ParityProtector,
    artifact_mutation_lock,
    ensure_artifact,
)
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity, FtviFile, bf16_bits_to_f32, write_ftvi
from frankensearch_tpu_torch.index.recall_certificate import (
    load_persisted_certificates,
    persist_certificate,
)
from frankensearch_tpu_torch.index.wal import WriteAheadLog
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex, _l2_normalize_rows
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


def _compacted_rows(tier: DeviceVectorIndex, path: str) -> np.ndarray:
    """The rows ``compact`` writes as bf16: each row's vector, as the
    reference writes it, except where reopening would renormalize that
    row's bf16 rounding to other bits than the slab holds now (a few
    HashEmbedder rows move by one bf16 ulp so). Such a row takes the bits
    the artifact at ``path`` stores for its doc when reopening those gives
    the slab's row back, as it does for every base row no WAL record
    replaced: compaction then moves no base row's score. The reference
    rewrites them all, so its compaction moves those rows."""
    vecs = tier._vectors_f32[: tier.n_rows]
    if tier.slab_dtype != "bf16" or not os.path.exists(path):
        return vecs
    held = tier.slab[: tier.n_rows, : tier.dim].float().cpu().numpy()

    def reopened(rows: np.ndarray) -> np.ndarray:  # what a reopen's slab holds for these bf16 rows
        return torch.from_numpy(_l2_normalize_rows(rows)).to(torch.bfloat16).float().numpy()

    moved = np.flatnonzero((reopened(held) != held).any(axis=1))
    base = FtviFile(path, verify_slab=False) if moved.size else None
    if base is None or base.header.dtype != "bf16":
        return vecs
    file_row = {d: r for r, d in enumerate(base.doc_ids)}
    out = vecs.copy()
    for r in moved:
        fr = file_row.get(tier.doc_ids[r])
        if fr is None:
            continue
        stored = bf16_bits_to_f32(np.asarray(base.slab[fr : fr + 1]))
        if np.array_equal(reopened(stored), held[r : r + 1]):
            out[r] = stored[0]
    return out


@dataclass(frozen=True)
class VacuumStats:
    """Compaction accounting (parity: index/src/lib.rs:703 VacuumStats)."""

    records_before: int
    records_after: int
    tombstones_folded: int
    bytes_before: int
    bytes_after: int
    wal_bytes_folded: int

    @property
    def bytes_reclaimed(self) -> int:
        return max(self.bytes_before - self.bytes_after, 0)


@dataclass(frozen=True)
class TwoTierPaths:
    """The tiers' artifact paths under one root."""

    root: str

    @property
    def fast(self) -> str:
        primary = os.path.join(self.root, FAST_FILE)
        if os.path.exists(primary):
            return primary
        fallback = os.path.join(self.root, FAST_FALLBACK_FILE)
        return fallback if os.path.exists(fallback) else primary

    @property
    def quality(self) -> str:
        return os.path.join(self.root, QUALITY_FILE)

    def wal_for(self, idx_path: str) -> str:
        return idx_path + ".wal"


@dataclass(frozen=True)
class _Tiers:
    """What a reader sees: both tiers and the fast-tier row -> quality-tier
    row map built for exactly these tiers, published as one object. A
    writer builds the next one whole and swaps it in with one assignment,
    so a reader that takes it once per call never pairs a tier with a map
    built for another (the reference's writer assigns a tier and then
    rebuilds the map, so a reader in between pairs the new fast tier with
    the old, shorter map)."""

    fast: DeviceVectorIndex
    quality: DeviceVectorIndex | None
    fast_to_quality: np.ndarray | None


class TwoTierIndex:
    """Fast + optional quality device indexes over one on-disk root."""

    def __init__(
        self,
        fast: DeviceVectorIndex,
        quality: DeviceVectorIndex | None = None,
        *,
        root: str | None = None,
    ) -> None:
        self.root = root
        #: WAL durability policy for appends and tombstones: "always" fsyncs
        #: each batch; "deferred" group-commits, the caller fsyncs once per
        #: cycle with sync_wal()
        self.wal_sync: str = "always"
        self.last_vacuum_stats: dict[str, VacuumStats] = {}
        # per tier, the WAL prefix this open materialized (compact folds
        # and truncates exactly that much)
        self._wal_consumed: dict[str, int] = {}
        # deleted doc ids that hold no fast-tier row (a WAL append deleted
        # before this open, a doc only another arm holds): tombstoned all
        # the same, so the searcher's supersession hides them everywhere
        self._rowless_tombstones: frozenset[str] = frozenset()
        #: shards of the fast tier's mesh (0: one device); a compaction
        #: reopens with the same
        self.mesh_shards = 0
        self._publish(fast, quality)

    @staticmethod
    def _realign(fast: DeviceVectorIndex, quality: DeviceVectorIndex | None) -> np.ndarray | None:
        """Fast-tier row -> quality-tier row of the same doc (-1 where the
        quality tier lacks it); the identity when both tiers hold the same
        doc ids in the same order."""
        if quality is None:
            return None
        fast_ids = fast.doc_ids
        if fast_ids == quality.doc_ids:
            return np.arange(len(fast_ids), dtype=np.int64)
        row_of = quality._row_of
        return np.fromiter((row_of.get(d, -1) for d in fast_ids), dtype=np.int64, count=len(fast_ids))

    def _publish(self, fast: DeviceVectorIndex, quality: DeviceVectorIndex | None) -> None:
        """Build the row map for ``fast`` and ``quality``, then swap all
        three in at once."""
        self._tiers = _Tiers(fast, quality, self._realign(fast, quality))

    @property
    def fast(self) -> DeviceVectorIndex:
        return self._tiers.fast

    @fast.setter
    def fast(self, tier: DeviceVectorIndex) -> None:
        self._publish(tier, self._tiers.quality)

    @property
    def quality(self) -> DeviceVectorIndex | None:
        return self._tiers.quality

    @quality.setter
    def quality(self, tier: DeviceVectorIndex | None) -> None:
        self._publish(self._tiers.fast, tier)

    @property
    def _fast_to_quality(self) -> np.ndarray | None:
        return self._tiers.fast_to_quality

    @classmethod
    def open(
        cls,
        root: str,
        *,
        device: torch.device,
        slab_dtype: str = "bf16",
        verify: bool = False,
        mesh_shards: int = 0,
    ) -> "TwoTierIndex":
        """Open the on-disk tiers (artifact + replayed WAL) onto ``device``.
        ``mesh_shards > 0`` shards the fast tier's rows over a mesh of that
        many devices from ``device`` on (``make_mesh``: at most the visible
        cards; on the CPU that many shards of it), with results equal to
        the single-device tier's; the quality tier stays on ``device``."""
        fast_path = TwoTierPaths(root).fast
        if not os.path.exists(fast_path):
            raise IndexNotFound(f"no fast-tier artifact under {root}")
        fast_wal = WriteAheadLog(fast_path + ".wal").replay()
        wal_consumed = {FAST_FILE: fast_wal.bytes_consumed}
        fast_file = _open_ftvi_repairing(fast_path, verify)
        if mesh_shards > 0:
            from frankensearch_tpu_torch.parallel.mesh import make_mesh
            from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

            fast = ShardedDeviceVectorIndex.from_ftvi(
                fast_file, fast_wal, mesh=make_mesh(mesh_shards, axes=("d",), device=device),
                slab_dtype=slab_dtype,
            )
        else:
            fast = DeviceVectorIndex.from_ftvi(fast_file, fast_wal, device=device, slab_dtype=slab_dtype)
        quality = None
        quality_path = os.path.join(root, QUALITY_FILE)
        if os.path.exists(quality_path):
            quality_wal = WriteAheadLog(quality_path + ".wal").replay()
            wal_consumed[QUALITY_FILE] = quality_wal.bytes_consumed
            quality = DeviceVectorIndex.from_ftvi(
                _open_ftvi_repairing(quality_path, verify), quality_wal,
                device=device, slab_dtype=slab_dtype,
            )
        # persisted recall certificates: rebind the manifest's certificates
        # whose binding matches the fast tier's durable identity (slab crc,
        # WAL census, counts); any mismatch drops them and the fail-closed
        # gate demands a fresh certify
        certs = load_persisted_certificates(root, fast.scan_state_signature())
        if certs:
            fast._recall_certs = dict(certs)
        index = cls(fast, quality, root=root)
        index.mesh_shards = mesh_shards
        index._wal_consumed = wal_consumed
        index._rowless_tombstones = frozenset(d for d in fast_wal.tombstones if fast.row_for(d) is None)
        return index

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
        mesh_shards: int = 0,
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
            root, device=device, slab_dtype="bf16" if slab_dtype == "int8" else slab_dtype,
            mesh_shards=mesh_shards,
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

    def compact(self) -> "TwoTierIndex":
        """Fold the WALs and tombstones back into the base artifacts (written
        as bf16 FTVI, as the reference does), truncate each WAL by the prefix
        this open materialized, refresh the generation manifest and reopen
        (bf16, on the same device and mesh). Per-tier stats land in the reopened
        index's ``last_vacuum_stats``."""
        if self.root is None:
            raise ValueError("compact requires a rooted index")
        stats: dict[str, VacuumStats] = {}
        for tier, fname in ((self.fast, FAST_FILE), (self.quality, QUALITY_FILE)):
            if tier is None:
                continue
            live = tier._valid_host[: tier.n_rows]
            ids = [d for d, ok in zip(tier.doc_ids, live) if ok]
            path = os.path.join(self.root, fname)
            bytes_before = os.path.getsize(path) if os.path.exists(path) else 0
            wal_path = path + ".wal"
            wal_bytes = os.path.getsize(wal_path) if os.path.exists(wal_path) else 0
            write_ftvi(path, _compacted_rows(tier, path)[live], ids, tier.identity, dtype="bf16")
            # truncate only the prefix this open materialized: batches another
            # writer appended after it survive (replay re-applies our own as
            # idempotent upserts); an unknown boundary (0) keeps everything
            WriteAheadLog(wal_path).truncate(consumed=self._wal_consumed.get(fname, 0))
            # the WAL was rewritten: a second compact of this object keeps all
            self._wal_consumed[fname] = 0
            stats[fname] = VacuumStats(
                records_before=tier.n_rows,
                records_after=len(ids),
                tombstones_folded=int((~live).sum()),
                bytes_before=bytes_before + wal_bytes,
                bytes_after=os.path.getsize(path),
                wal_bytes_folded=wal_bytes,
            )
        # the artifacts changed: the manifest's hashes follow (commit_seq bumps)
        refresh_manifest(self.root)
        compacted = TwoTierIndex.open(self.root, device=self.fast.device, mesh_shards=self.mesh_shards)
        compacted.last_vacuum_stats = stats
        return compacted

    # -- appends and tombstones (WAL path) -----------------------------------

    def _wal(self, fname: str, *, sync: str = "always") -> WriteAheadLog:
        path = TwoTierPaths(self.root).fast if fname == FAST_FILE else os.path.join(self.root, fname)
        return WriteAheadLog(path + ".wal", sync=sync)

    def append_fast(self, doc_ids: Sequence[str], vectors: np.ndarray) -> None:
        """Durable append through the fast tier's WAL, then the in-memory
        functional update (which drops the IVF arm)."""
        if self.root is not None:
            self._wal(FAST_FILE, sync=self.wal_sync).append(doc_ids, vectors)
        self.fast = self.fast.with_appended(doc_ids, vectors)
        self._rowless_tombstones -= set(doc_ids)

    def append_quality(self, doc_ids: Sequence[str], vectors: np.ndarray) -> None:
        if self.quality is None:
            raise ValueError("index has no quality tier")
        if self.root is not None:
            self._wal(QUALITY_FILE, sync=self.wal_sync).append(doc_ids, vectors)
        self.quality = self.quality.with_appended(doc_ids, vectors)

    def delete(self, doc_ids: Sequence[str]) -> None:
        """Tombstone docs in both tiers, durably through their WALs."""
        if self.root is not None:
            self._wal(FAST_FILE, sync=self.wal_sync).tombstone(doc_ids)
            if self.quality is not None:
                self._wal(QUALITY_FILE, sync=self.wal_sync).tombstone(doc_ids)
        fast = self.fast.with_tombstones(doc_ids)
        quality = None if self.quality is None else self.quality.with_tombstones(doc_ids)
        self._rowless_tombstones |= {d for d in doc_ids if fast.row_for(d) is None}
        self._publish(fast, quality)

    def sync_wal(self) -> None:
        """Group-commit point under ``wal_sync="deferred"``: fsync both
        tiers' WAL sidecars (a no-op when nothing was deferred)."""
        if self.root is None:
            return
        self._wal(FAST_FILE).sync()
        if self.quality is not None:
            self._wal(QUALITY_FILE).sync()

    def tombstoned_ids(self) -> frozenset:
        """Every deleted doc id: the fast tier's tombstoned rows, and the
        deletes that hold no row there (the reference counts only the
        rows, so a WAL append deleted before a reopen resurfaced through a
        lexical generation sealed before the delete)."""
        rowless = self._rowless_tombstones
        return self.fast.tombstoned_ids() | rowless if rowless else self.fast.tombstoned_ids()

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
        tiers = self._tiers
        if tiers.quality is None:
            return {}
        rows = []
        keep: list[str] = []
        for h in hits:
            q_row = tiers.fast_to_quality[h.row] if h.row >= 0 else -1
            if q_row >= 0:
                rows.append(int(q_row))
                keep.append(h.doc_id)
        if not rows:
            return {}
        scores = tiers.quality.scores_for_rows(quality_query, rows)
        return {doc_id: float(s) for doc_id, s in zip(keep, scores)}

    def search_quality(self, quality_query: np.ndarray, k: int, **kwargs) -> ClassifiedHits:
        """Full quality-tier retrieval (owner-backed path,
        searcher.rs:2081-2110)."""
        if self.quality is None:
            return ClassifiedHits(hits=())
        return self.quality.search_classified(quality_query, k, **kwargs)

    def doc_count(self) -> int:
        return self.fast.live_count
