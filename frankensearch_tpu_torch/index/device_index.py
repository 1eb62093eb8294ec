"""Device-resident vector index: padded slab + validity mask + doc table (PyTorch).

Port of frankensearch_tpu/index/device_index.py. The FTVI artifact (plus
the replayed WAL) is normalized, padded and uploaded once; tombstones,
filters and padding all lower to one additive f32 mask. The slab is padded
to a multiple of 8192 rows and 128 dims, so the hierarchical scan (kernels
K1/K2) always applies on CUDA.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch

from frankensearch_tpu.core.errors import DimensionMismatch
from frankensearch_tpu.core.filter import SearchFilter
from frankensearch_tpu.core.types import ClassifiedHits, VectorHit, ZeroSignalReason
from frankensearch_tpu.index.fsvi import EmbeddingIdentity, FtviFile
from frankensearch_tpu.index.wal import WalState
from frankensearch_tpu_torch.ops import topk_scan

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
        from frankensearch_tpu.utils.tracing import get_logger

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
        return cls(vectors, doc_ids, f.header.identity, tombstoned=tomb, **kwargs)

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
        mode: str = "auto",  # "auto" | "hierarchical" | "xla"
    ) -> topk_scan.TopKResult:
        """Batched scan; returns device (scores, indices). Rows are slab
        rows; use :meth:`hydrate` to map to doc ids. ``auto`` is the
        hierarchical kernel scan on CUDA and the plain scan on the CPU."""
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
        if mode in ("mrl", "ivf", "int8", "pallas"):
            raise NotImplementedError(
                f"scan mode {mode!r} is not ported yet (ROADMAP: the "
                "int8/MRL/IVF lanes and kernels K4/K5)"
            )
        if mode == "hierarchical":
            return topk_scan.scan_topk_hierarchical(self.slab, q_dev, k, mask)
        if mode == "xla":
            return topk_scan.scan_topk_xla(self.slab, q_dev, k, mask)
        raise ValueError(f"unknown scan mode {mode!r}")

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
