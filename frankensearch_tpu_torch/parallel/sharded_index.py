"""Mesh-sharded ``DeviceVectorIndex``: the multi-device fast tier (PyTorch).

Port of frankensearch_tpu/parallel/sharded_index.py. The host interface is
``DeviceVectorIndex``'s; the padded slab and its mask live on the lead
device (the mesh's first) and are cut into one contiguous block of rows per
shard (views on the lead device, copies on other cards), and every batched
search runs the sharded scan (parallel/sharded_scan.py) with its exact
merge. It is the fast tier that ``TwoTierConfig.mesh_shards`` /
``--shards`` give (``TwoTierIndex.open(mesh_shards=...)``).

Rows pad to a multiple of ``shards * per_shard`` at the end: ``per_shard``
is 8192 on CUDA, so every shard is 8192-row aligned for the hierarchical
scan's kernels, and 8 on the CPU (``hier_align=True`` forces 8192 there,
for the hierarchical lanes' parity tests). Modes: ``auto`` is ``hier`` on
CUDA and the plain exact sharded scan (``xla``) on the CPU; ``hier`` runs
K1 + K2 per shard; ``int8`` the int8 lane (K4 + K2-i8 per shard on CUDA,
the plain two-pass scan per shard on the CPU) and ``int8_hier`` its
hierarchical form anywhere. The IVF, MRL and per-tile lanes stay
single-device lanes, as in the reference, and are refused here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.errors import DimensionMismatch, InvalidConfig
from frankensearch_tpu_torch.core.filter import SearchFilter
from frankensearch_tpu_torch.index.device_index import (
    ROW_PAD,
    DeviceVectorIndex,
    ScanStats,
    _last_wins,
    _sanitize_rows,
)
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.parallel.mesh import Mesh, make_mesh
from frankensearch_tpu_torch.parallel.sharded_scan import (
    replicate,
    shard_rows,
    sharded_scan_topk,
    sharded_scan_topk_hier,
    sharded_scan_topk_hier_int8,
    sharded_scan_topk_int8,
)

#: rows per shard's padding unit off the hierarchical lanes
_PLAIN_SHARD_UNIT = 8


@dataclass(frozen=True)
class ShardedScanStats(ScanStats):
    shards: int
    devices: tuple[str, ...]


class ShardedDeviceVectorIndex(DeviceVectorIndex):
    """A ``DeviceVectorIndex`` whose slab and mask are row-sharded over a
    mesh axis."""

    def __init__(
        self,
        vectors: np.ndarray,
        doc_ids: Sequence[str],
        identity: EmbeddingIdentity,
        *,
        mesh: Mesh | None = None,
        axis: str = "d",
        device="cuda",
        hier_align: bool | None = None,
        tombstoned: np.ndarray | None = None,
        slab_dtype: str = "bf16",
        normalize: bool = True,
    ) -> None:
        self.mesh = mesh or make_mesh(axes=(axis,), device=device)
        self.axis = axis
        self.shard_devices = self.mesh.shard_devices(axis)
        lead = self.shard_devices[0]
        self.hier_align = lead.type == "cuda" if hier_align is None else hier_align
        super().__init__(
            vectors, doc_ids, identity, device=lead, tombstoned=tombstoned,
            slab_dtype=slab_dtype, normalize=normalize,
        )

    def _row_pad_unit(self) -> int:
        per_shard = ROW_PAD if self.hier_align else _PLAIN_SHARD_UNIT
        return per_shard * len(self.shard_devices)

    def _set_state(self, slab, base_mask, *args, **kwargs) -> None:
        super()._set_state(slab, base_mask, *args, **kwargs)
        self._slab_shards = shard_rows(slab, self.shard_devices)
        self._mask_shards = shard_rows(base_mask, self.shard_devices)
        self._int8_shards = None

    @property
    def local_rows(self) -> int:
        return self.n_pad // len(self.shard_devices)

    def stats(self) -> ShardedScanStats:
        return ShardedScanStats(
            self.n_rows, self.live_count, self.n_pad - self.n_rows,
            shards=len(self.shard_devices), devices=tuple(str(d) for d in self.shard_devices),
        )

    # -- updates: rebuilt sharded (the spare-row fast path is single-device) --

    def _rebuilt(self, vectors: np.ndarray, doc_ids: Sequence[str], tombstoned: np.ndarray):
        return ShardedDeviceVectorIndex(
            vectors, doc_ids, self.identity, mesh=self.mesh, axis=self.axis,
            hier_align=self.hier_align, tombstoned=tombstoned,
            slab_dtype=self.slab_dtype, normalize=False,
        )

    def with_appended(self, doc_ids: Sequence[str], vectors: np.ndarray) -> "ShardedDeviceVectorIndex":
        vecs = _sanitize_rows(np.asarray(vectors, dtype=np.float32))
        if vecs.size and vecs.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, vecs.shape[1])
        new_ids, vecs = _last_wins(list(doc_ids), vecs)
        return self._rebuilt(*self._merged_host(new_ids, vecs))

    def with_tombstones(self, doc_ids: Sequence[str]) -> "ShardedDeviceVectorIndex":
        tomb = (~self._valid_host[: self.n_rows]).copy()
        for doc_id in doc_ids:
            row = self.doc_ids.row_for(doc_id)
            if row is not None:
                tomb[row] = True
        return self._rebuilt(self._vectors_f32[: self.n_rows], self.doc_ids, tomb)

    # -- search ----------------------------------------------------------------

    def _int8_arm_sharded(self) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
        """The int8 arm (calibrated on the host from the padded rows, or
        preloaded from an int8 artifact) row-sharded, its scale on every
        shard's device."""
        if self._int8_shards is None:
            values, scale = self._int8_arm()
            self._int8_shards = (shard_rows(values, self.shard_devices), replicate(scale, self.shard_devices))
        return self._int8_shards

    def search_batch(
        self,
        queries,
        k: int,
        *,
        search_filter: SearchFilter | None = None,
        metadata: Sequence[Mapping | None] | None = None,
        mode: str = "auto",
        int8_candidate_multiplier: int = 4,
        **_unused,
    ) -> topk_scan.TopKResult:
        """Batched sharded scan; (B, k) global rows and scores on the lead
        device. A filter's mask is rebuilt on the host and cut per shard."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q.shape[1])
        if q.shape[1] != self.d_pad:
            q = np.pad(q, ((0, 0), (0, self.d_pad - q.shape[1])))
        q_dev = torch.from_numpy(q).to(self.device)
        mask = self._mask_shards
        if search_filter is not None:
            mask = shard_rows(self._effective_mask(search_filter, metadata), self.shard_devices)
        aligned = self.local_rows % ROW_PAD == 0
        cuda = self.device.type == "cuda"
        if mode == "auto":
            mode = "hier" if cuda else "xla"
        if mode in ("int8", "int8_hier"):
            values, scale = self._int8_arm_sharded()
            if aligned and (mode == "int8_hier" or cuda):
                return sharded_scan_topk_hier_int8(
                    values, scale, mask, q_dev, k, group_overfetch=int8_candidate_multiplier,
                )
            return sharded_scan_topk_int8(
                values, scale, mask, q_dev, k, candidate_multiplier=int8_candidate_multiplier,
            )
        if mode in ("hier", "hierarchical"):
            if not aligned:
                raise InvalidConfig(
                    "sharded hierarchical mode needs 8192-row shards (build with hier_align=True)"
                )
            return sharded_scan_topk_hier(self._slab_shards, mask, q_dev, k)
        if mode == "xla":
            return sharded_scan_topk(self._slab_shards, mask, q_dev, k)
        raise InvalidConfig(
            f"scan mode {mode!r} is a single-device lane; the sharded index serves "
            "auto, hier, xla, int8 and int8_hier"
        )
