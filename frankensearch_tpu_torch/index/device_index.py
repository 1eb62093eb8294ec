"""Device-resident vector index: padded slab + validity mask + doc table (PyTorch).

Port of frankensearch_tpu/index/device_index.py. The FTVI artifact (plus
the replayed WAL) is normalized, padded and uploaded once; tombstones,
filters and padding all lower to one additive f32 mask. The slab is padded
to a multiple of 8192 rows and 128 dims, so the hierarchical scan (kernels
K1/K2), its int8 capacity lane (K4, K2's int8 form) and the per-tile
top-k scan (K5) always apply on CUDA, at every slab dtype (bf16, f16,
f32). The int8 arm (a per-dim calibrated int8 copy of the slab) is
preloaded from an int8 artifact or calibrated on first use; the IVF arm
(index/ivf.py) is built by :meth:`DeviceVectorIndex.enable_ivf` and dropped
by an append. Recall certificates gate the approximate int8, MRL and IVF
lanes.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.errors import DimensionMismatch, InvalidConfig
from frankensearch_tpu_torch.core.filter import SearchFilter
from frankensearch_tpu_torch.core.types import ClassifiedHits, VectorHit, ZeroSignalReason
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity, FtviFile
from frankensearch_tpu_torch.index.wal import WalState
from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.ops.quantize import calibrate_int8

NEG_INF = float("-inf")
#: slab row padding unit (a multiple of the scan kernels' 128-row group)
ROW_PAD = 8192
#: slab dim padding unit
DIM_PAD = 128
_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(norms > 1e-12, x / np.maximum(norms, 1e-12), x)


def _sanitize_rows(x: np.ndarray) -> np.ndarray:
    """Non-finite rows become zero vectors at admission: a zero row scores
    0 against every query and sinks, where a NaN row would flood the top-k.
    Poisoned embeddings degrade to unfindable docs, never to blacked-out
    search."""
    if not x.size:
        return x
    bad = ~np.isfinite(x).all(axis=1)
    n_bad = int(bad.sum())
    if n_bad:
        x = x.copy()
        x[bad] = 0.0
        from frankensearch_tpu_torch.utils.tracing import get_logger

        get_logger("index").warning(
            "%d non-finite vector row(s) zeroed at admission "
            "(docs become unfindable instead of starving top-k)",
            n_bad,
            extra={"fs_extra": {"non_finite_rows": n_bad}},
        )
    return x


class DeviceVectorIndex:
    """An immutable, device-resident flat vector index.

    Construction normalizes rows (cosine == dot), pads the doc axis to a
    multiple of 8192 and the dim axis to a multiple of 128, and uploads one
    slab + one additive base mask to ``device``. Appends and tombstones
    produce a new index.
    """

    def __init__(
        self,
        vectors: np.ndarray,
        doc_ids: Sequence[str],
        identity: EmbeddingIdentity,
        *,
        device: torch.device,
        tombstoned: np.ndarray | None = None,
        slab_dtype: str = "bf16",
        normalize: bool = True,
    ) -> None:
        if slab_dtype not in _DTYPES:
            raise ValueError(f"unknown slab_dtype {slab_dtype!r}")
        vectors = _sanitize_rows(np.asarray(vectors, dtype=np.float32))
        n, d = vectors.shape if vectors.size else (0, identity.dim or 0)
        if len(doc_ids) != n:
            raise ValueError(f"{n} vectors for {len(doc_ids)} doc ids")
        if normalize and n:
            vectors = _l2_normalize_rows(vectors)
        n_pad = max(_round_up(max(n, 1), ROW_PAD), ROW_PAD)
        d_pad = _round_up(max(d, 1), DIM_PAD)
        padded = np.zeros((n_pad, d_pad), dtype=np.float32)
        if n:
            padded[:n, :d] = vectors
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = True
        if tombstoned is not None and n:
            valid[:n] &= ~np.asarray(tombstoned, dtype=bool)
        slab = torch.from_numpy(padded).to(device=device, dtype=_DTYPES[slab_dtype])
        mask = torch.from_numpy(np.where(valid, 0.0, NEG_INF).astype(np.float32)).to(device)
        self._set_state(
            slab, mask, valid, doc_ids, identity,
            dim=d, vectors_f32=vectors, slab_dtype=slab_dtype,
        )

    def _set_state(
        self, slab, base_mask, valid, doc_ids, identity, *, dim, vectors_f32, slab_dtype
    ) -> None:
        self.identity = identity
        self.doc_ids = list(doc_ids)
        self._row_of = {doc_id: i for i, doc_id in enumerate(self.doc_ids)}
        self.dim = dim
        self.slab_dtype = slab_dtype
        self.device = slab.device
        self._vectors_f32 = vectors_f32  # host copy for rescore/rebuild
        self._valid_host = valid
        self.live_count = int(valid.sum())
        self.slab = slab
        self.base_mask = base_mask
        self.n_rows = len(self.doc_ids)
        self.n_pad, self.d_pad = slab.shape
        # int8 arm (lazy): (padded int8 slab, (d_pad,) f32 scale) on the device
        self._int8 = None
        # IVF arm (enable_ivf) and the row count it was built over
        self._ivf = None
        self._ivf_built_rows = -1

    @classmethod
    def from_padded(
        cls,
        slab: torch.Tensor,
        base_mask: torch.Tensor,
        doc_ids: Sequence[str],
        identity: EmbeddingIdentity,
    ) -> "DeviceVectorIndex":
        """An index over an already padded slab and mask (the device state
        of another index, which may pad rows to any multiple of the scan's
        128-row group). The host f32 copy is the slab's own rows."""
        n, d = len(doc_ids), identity.dim
        if slab.shape[0] % topk_scan.GROUP or slab.shape[1] % DIM_PAD or slab.shape[1] < d:
            raise ValueError(f"slab {tuple(slab.shape)} is not padded to ({topk_scan.GROUP}, {DIM_PAD})")
        dtype_name = {v: k for k, v in _DTYPES.items()}[slab.dtype]
        index = cls.__new__(cls)
        index._set_state(
            slab, base_mask, (base_mask == 0).cpu().numpy(), doc_ids, identity,
            dim=d, vectors_f32=slab[:n, :d].to(torch.float32).cpu().numpy(),
            slab_dtype=dtype_name,
        )
        return index

    # -- construction helpers --------------------------------------------

    @classmethod
    def from_ftvi(
        cls, f: FtviFile, wal: WalState | None = None, **kwargs
    ) -> "DeviceVectorIndex":
        """Load an FTVI artifact, merging replayed WAL state with the
        reference's supersession rules (search.rs:276-300): WAL appends
        supersede base rows of the same doc id; WAL tombstones kill both."""
        vectors = f.vectors_f32()
        doc_ids = list(f.doc_ids)
        tomb = f.tombstoned().copy()
        if wal is not None and (wal.live or wal.tombstones):
            base_rows = {d: i for i, d in enumerate(doc_ids)}
            extra_ids: list[str] = []
            extra_vecs: list[np.ndarray] = []
            for doc_id, vec in wal.live.items():
                row = base_rows.get(doc_id)
                if row is not None:
                    vectors = vectors.copy() if vectors.base is not None else vectors
                    if vec.shape[0] != vectors.shape[1]:
                        raise DimensionMismatch(vectors.shape[1], vec.shape[0])
                    vectors[row] = vec
                    tomb[row] = False
                else:
                    extra_ids.append(doc_id)
                    extra_vecs.append(vec)
            if extra_ids:
                vectors = np.concatenate([vectors, np.stack(extra_vecs)], axis=0)
                doc_ids = doc_ids + extra_ids
                tomb = np.concatenate([tomb, np.zeros(len(extra_ids), dtype=bool)])
            for doc_id in wal.tombstones:
                row = base_rows.get(doc_id)
                if row is not None:
                    tomb[row] = True
        index = cls(vectors, doc_ids, f.header.identity, tombstoned=tomb, **kwargs)
        # durable identity for recall-certificate binding (the persisted
        # cert is void when any of these change — see scan_state_signature)
        index._base_slab_crc32 = int(f.header.slab_crc32)
        index._wal_mutations = (
            (len(wal.live), len(wal.tombstones)) if wal is not None else (0, 0)
        )
        if f.header.dtype == "int8" and f.scale is not None and not (
            wal is not None and (wal.live or wal.tombstones)
        ):
            # the artifact carries the int8 arm: preload it, so mode "int8"
            # skips recalibration (FSVI quantization parity)
            padded_i8 = np.zeros((index.n_pad, index.d_pad), dtype=np.int8)
            padded_i8[: index.n_rows, : index.dim] = np.asarray(f.slab)
            scale = np.zeros(index.d_pad, dtype=np.float32)
            scale[: index.dim] = np.asarray(f.scale)
            scale[index.dim :] = 1.0
            index._int8 = (
                torch.from_numpy(padded_i8).to(index.device),
                torch.from_numpy(scale).to(index.device),
            )
        return index

    def with_appended(self, doc_ids: Sequence[str], vectors: np.ndarray) -> "DeviceVectorIndex":
        """Functional append -> new index. When every new doc is new and
        fits in the padding rows, the new index gets a device copy of the
        slab with the rows written in (no host re-upload); supersessions or
        exhausted padding rebuild from the host copy."""
        vecs = _sanitize_rows(np.asarray(vectors, dtype=np.float32))
        if vecs.size and vecs.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, vecs.shape[1])
        new_ids = list(doc_ids)
        if len(set(new_ids)) != len(new_ids):
            # in-batch duplicates are upserts (last occurrence wins)
            last = {d: i for i, d in enumerate(new_ids)}
            keep = sorted(last.values())
            new_ids = [new_ids[i] for i in keep]
            vecs = vecs[keep]
        fresh = all(d not in self._row_of for d in new_ids)
        m = len(new_ids)
        if fresh and m and self.n_rows + m <= self.n_pad:
            norm_vecs = _l2_normalize_rows(vecs)
            padded = np.zeros((m, self.d_pad), dtype=np.float32)
            padded[:, : self.dim] = norm_vecs
            slab = self.slab.clone()
            slab[self.n_rows : self.n_rows + m] = torch.from_numpy(padded).to(
                device=self.device, dtype=slab.dtype
            )
            mask = self.base_mask.clone()
            mask[self.n_rows : self.n_rows + m] = 0.0
            valid = self._valid_host.copy()
            valid[self.n_rows : self.n_rows + m] = True
            clone = DeviceVectorIndex.__new__(DeviceVectorIndex)
            clone._set_state(
                slab, mask, valid, self.doc_ids + new_ids, self.identity, dim=self.dim,
                vectors_f32=np.concatenate([self._vectors_f32[: self.n_rows], norm_vecs], axis=0),
                slab_dtype=self.slab_dtype,
            )
            # the durable identity rides along (its row counts now differ,
            # so a persisted certificate cannot rebind); certificates
            # measured on the parent do not carry over (fail-closed)
            for attr in ("_base_slab_crc32", "_wal_mutations"):
                if hasattr(self, attr):
                    setattr(clone, attr, getattr(self, attr))
            if self._int8 is not None:
                # new rows quantized with the EXISTING per-dim scale (fixed at
                # calibration); rows outside the old range clip, which the
                # recall certificates and a full recalibration cover
                i8_slab, scale = self._int8
                q = np.clip(
                    np.round(padded / np.maximum(scale.cpu().numpy(), 1e-12)), -127, 127
                ).astype(np.int8)
                i8_slab = i8_slab.clone()
                i8_slab[self.n_rows : self.n_rows + m] = torch.from_numpy(q).to(self.device)
                clone._int8 = (i8_slab, scale)
            return clone
        all_vecs, all_ids, all_tomb = self._merged_host(new_ids, vecs)
        return DeviceVectorIndex(
            all_vecs, all_ids, self.identity, device=self.device,
            tombstoned=all_tomb, slab_dtype=self.slab_dtype, normalize=False,
        )

    def _merged_host(
        self, new_ids: list[str], vecs: np.ndarray
    ) -> tuple[np.ndarray, list[str], np.ndarray]:
        """Host-side append merge (search.rs:276-300): same-id appends
        overwrite in place and clear the tombstone; new ids extend the rows."""
        keep_ids = list(self.doc_ids)
        tomb = ~self._valid_host[: self.n_rows]
        superseded = {d: i for i, d in enumerate(keep_ids)}
        new_base = self._vectors_f32[: self.n_rows].copy()
        extra_ids, extra_rows = [], []
        for i, doc_id in enumerate(new_ids):
            row = superseded.get(doc_id)
            v = _l2_normalize_rows(vecs[i : i + 1])[0]
            if row is not None:
                new_base[row] = v
                tomb = tomb.copy()
                tomb[row] = False
            else:
                extra_ids.append(doc_id)
                extra_rows.append(v)
        if extra_ids:
            return (
                np.concatenate([new_base, np.stack(extra_rows)], axis=0),
                keep_ids + extra_ids,
                np.concatenate([tomb, np.zeros(len(extra_ids), dtype=bool)]),
            )
        return new_base, keep_ids, tomb

    def tombstoned_ids(self) -> frozenset:
        """Doc ids masked out of this index (cached; the index is
        immutable). Drives the searcher's cross-arm supersession."""
        cached = getattr(self, "_tombstoned_ids", None)
        if cached is None:
            cached = frozenset(
                self.doc_ids[i] for i in range(self.n_rows) if not self._valid_host[i]
            )
            self._tombstoned_ids = cached
        return cached

    def with_tombstones(self, doc_ids: Sequence[str]) -> "DeviceVectorIndex":
        tomb = (~self._valid_host[: self.n_rows]).copy()
        for doc_id in doc_ids:
            row = self._row_of.get(doc_id)
            if row is not None:
                tomb[row] = True
        return DeviceVectorIndex(
            self._vectors_f32[: self.n_rows], self.doc_ids, self.identity,
            device=self.device, tombstoned=tomb, slab_dtype=self.slab_dtype,
            normalize=False,
        )

    # -- search ------------------------------------------------------------

    def row_for(self, doc_id: str) -> int | None:
        return self._row_of.get(doc_id)

    def vector_for_row(self, row: int) -> np.ndarray:
        return self._vectors_f32[row]

    def vectors_f32(self) -> np.ndarray:
        """All rows as f32 (the host copy), row-indexed."""
        return self._vectors_f32[: self.n_rows]

    def _effective_mask(
        self,
        search_filter: SearchFilter | None,
        metadata: Sequence[Mapping | None] | None,
    ) -> torch.Tensor:
        if search_filter is None:
            return self.base_mask
        admit = search_filter.mask(
            self.doc_ids, metadata if metadata is not None else [None] * self.n_rows
        )
        full = np.full(self.n_pad, NEG_INF, dtype=np.float32)
        full[: self.n_rows] = np.where(admit, 0.0, NEG_INF)
        return torch.minimum(torch.from_numpy(full).to(self.device), self.base_mask)

    def search_batch(
        self,
        queries,
        k: int,
        *,
        search_filter: SearchFilter | None = None,
        metadata: Sequence[Mapping | None] | None = None,
        mode: str = "auto",  # "auto" | "hierarchical" | "xla" | "int8" | "pallas" | "mrl" | "ivf"
        mrl_search_dims: int | None = None,
        mrl_rescore_top_k: int = 30,
        int8_candidate_multiplier: int = 4,
        nprobe: int = 8,
    ) -> topk_scan.TopKResult:
        """Batched scan; returns device (scores, indices). Rows are slab
        rows; use :meth:`hydrate` to map to doc ids. ``auto`` is the
        hierarchical kernel scan on CUDA and the plain scan on the CPU; it
        resolves before the MRL check, as in the reference, so
        ``mrl_search_dims`` alone selects nothing (the searcher asks for
        ``mrl`` itself). ``int8`` is the capacity lane over the int8 arm:
        K4 + K2's int8 form on CUDA, the plain two-pass scan (a pool of
        ``k * int8_candidate_multiplier`` rescored against the slab) on the
        CPU. ``pallas`` is the per-tile top-k scan (K5 on CUDA). ``mrl`` is
        the Matryoshka two-pass scan over the first ``mrl_search_dims``
        (default 64) dims, rescoring ``mrl_rescore_top_k``. ``ivf`` probes
        ``nprobe`` clusters of the IVF arm (K2 on CUDA), with this index's
        mask permuted into the arm; it raises ``InvalidConfig`` until
        :meth:`enable_ivf` has built the arm over the current rows."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q.shape[1])
        if q.shape[1] != self.d_pad:
            q = np.pad(q, ((0, 0), (0, self.d_pad - q.shape[1])))
        q_dev = torch.from_numpy(q).to(self.device)
        mask = self._effective_mask(search_filter, metadata)

        if mode == "auto":
            mode = "hierarchical" if self.device.type == "cuda" else "xla"
        if mode == "mrl":
            return topk_scan.scan_topk_mrl(
                self.slab, q_dev, k, mask,
                search_dims=mrl_search_dims or 64, rescore_top_k=mrl_rescore_top_k,
            )
        if mode == "ivf":
            if self._ivf is None or self._ivf_built_rows != self.n_rows:
                raise InvalidConfig("ivf arm not built for the current rows; call enable_ivf()")
            return self._ivf.search_batch(q[:, : self.dim], k, nprobe=nprobe, extra_row_mask=mask)
        if mode == "int8":
            i8_slab, scale = self._int8_arm()
            if self.device.type == "cuda":
                return topk_scan.scan_topk_hierarchical_int8(i8_slab, scale, q_dev, k, mask)
            return topk_scan.scan_topk_int8_two_pass(
                i8_slab, scale, self.slab, q_dev, k, mask,
                candidate_multiplier=int8_candidate_multiplier,
            )
        if mode == "pallas":
            return topk_scan.scan_topk_pallas(self.slab, q_dev, k, mask)
        if mode == "hierarchical":
            return topk_scan.scan_topk_hierarchical(self.slab, q_dev, k, mask)
        if mode == "xla":
            return topk_scan.scan_topk_xla(self.slab, q_dev, k, mask)
        raise ValueError(f"unknown scan mode {mode!r}")

    def certify_scan_mode(
        self,
        mode: str,
        k: int,
        sample_queries: np.ndarray,
        *,
        confidence: float = 0.95,
        **mode_kwargs,
    ):
        """Measure an approximate mode's recall@k against the exact scan on
        ``sample_queries`` and record a split-conformal certificate
        (index/recall_certificate.py). With
        ``TwoTierConfig.require_recall_certificate`` the searcher refuses
        an approximate mode unless such a certificate covers (mode, k) at
        the configured floor."""
        from frankensearch_tpu_torch.index.recall_certificate import (
            certify_recall,
            per_query_recall,
        )

        exact = self.search_batch(sample_queries, k, mode="xla")
        approx = self.search_batch(sample_queries, k, mode=mode, **mode_kwargs)
        recalls = per_query_recall(approx.indices.cpu().numpy(), exact.indices.cpu().numpy())
        param_name, param_value = next(iter(mode_kwargs.items()), ("mode", 0.0))
        cert = certify_recall(
            recalls, k=k,
            parameter_name=str(param_name),
            parameter_value=float(param_value) if np.isscalar(param_value) else 0.0,
            confidence=confidence,
        )
        if not hasattr(self, "_recall_certs"):
            self._recall_certs = {}
        self._recall_certs[mode] = cert
        return cert

    def recall_certificate(self, mode: str):
        """The recorded certificate for an approximate mode, or None."""
        return getattr(self, "_recall_certs", {}).get(mode)

    def scan_state_signature(self) -> dict | None:
        """Durable identity of the scanned state, for binding persisted
        recall certificates: None for an index that was not opened from an
        artifact (nothing durable to bind to)."""
        crc = getattr(self, "_base_slab_crc32", None)
        if crc is None:
            return None
        wal_live, wal_tomb = getattr(self, "_wal_mutations", (0, 0))
        return {
            "slab_crc32": int(crc),
            "n_rows": int(self.n_rows),
            "live_count": int(self.live_count),
            "dim": int(self.dim),
            "slab_dtype": self.slab_dtype,
            "embedder_id": self.identity.embedder_id,
            "wal_live": int(wal_live),
            "wal_tombstones": int(wal_tomb),
        }

    def enable_ivf(self, n_clusters: int | None = None, **kwargs) -> None:
        """Build the IVF arm over the live rows on this index's device
        (k-means is an expensive build step, hence explicit). The arm
        snapshots the current rows: an append drops it and ``mode="ivf"``
        raises until it is built again; tombstones and filters stay live
        through the mask. ``kwargs`` go to ``IvfDeviceIndex`` (``dtype``,
        a torch dtype, default bf16; ``seed``; ``kmeans_iters``;
        ``capacity_slack``)."""
        from frankensearch_tpu_torch.index.ivf import IvfDeviceIndex

        self._ivf = IvfDeviceIndex(
            self._vectors_f32[: self.n_rows], n_clusters, device=self.device, **kwargs
        )
        self._ivf_built_rows = self.n_rows

    def _int8_arm(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The int8 arm, calibrated from the host rows on first use."""
        if self._int8 is None:
            padded = np.zeros((self.n_pad, self.d_pad), dtype=np.float32)
            padded[: self.n_rows, : self.dim] = self._vectors_f32[: self.n_rows]
            q = calibrate_int8(padded)
            self._int8 = (
                torch.from_numpy(q.values).to(self.device),
                torch.from_numpy(q.scale).to(self.device),
            )
        return self._int8

    def search_classified(self, query: np.ndarray, k: int, **kwargs) -> ClassifiedHits:
        """Single-query search with typed zero-signal classification
        (parity: search_top_k_classified, index/src/search.rs:227)."""
        q = np.asarray(query, dtype=np.float32).reshape(1, -1)
        if self.n_rows == 0:
            return ClassifiedHits(hits=(), zero_signal=ZeroSignalReason.NO_RECORDS)
        if self.live_count == 0:
            return ClassifiedHits(hits=(), zero_signal=ZeroSignalReason.ALL_TOMBSTONED)
        norm = float(np.linalg.norm(q))
        if norm < 1e-12 or math.isnan(norm):
            return ClassifiedHits(hits=(), zero_signal=ZeroSignalReason.DEGENERATE_QUERY)
        hits = self.hydrate(self.search_batch(q, k, **kwargs))[0]
        if not hits:
            return ClassifiedHits(hits=(), zero_signal=ZeroSignalReason.ALL_FILTERED)
        return ClassifiedHits(hits=tuple(hits))

    def hydrate(self, result: topk_scan.TopKResult) -> list[list[VectorHit]]:
        """Device result -> host VectorHits (drops -1 padding)."""
        scores = torch.as_tensor(result.scores).cpu().tolist()
        indices = torch.as_tensor(result.indices).cpu().tolist()
        doc_ids = self.doc_ids
        isfinite = math.isfinite
        return [
            [
                VectorHit(doc_id=doc_ids[i], score=s, row=i)
                for s, i in zip(srow, irow)
                if i >= 0 and isfinite(s)
            ]
            for srow, irow in zip(scores, indices)
        ]

    def scores_for_rows(self, query: np.ndarray, rows: Sequence[int]) -> np.ndarray:
        """Exact f32 rescore of specific rows against a query (host copy)."""
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        if q.shape[0] != self.dim:
            raise DimensionMismatch(self.dim, q.shape[0])
        return self._vectors_f32[np.asarray(rows, dtype=np.int64)] @ q
