"""Document-axis sharded scan with an exact top-k merge (PyTorch).

Port of frankensearch_tpu/parallel/sharded_scan.py. Each shard holds a
contiguous block of the padded slab's rows on its device and scans it with
the single-device bodies (the plain scan, the hierarchical scan on kernels
K1 + K2, its int8 form on K4 + K2-i8, the plain int8 two-pass scan); the
per-shard (B, k) heaps are copied to the lead device (the first shard's),
laid out shard-major with local rows offset to global rows, and merged by
one exact top-k. No (B, N) score matrix leaves a shard.

Ordering contract (the reference's): scores descending, ties toward the
lower global row, +0.0 above -0.0; a non-finite score gives index -1. The
shard-major layout keeps equal scores in ascending global row order, so the
merge's (value desc, position asc) top-k is that order. Padding rows sit at
the end of the last shards, their mask is -inf, and they never win.

A sharded tensor here is a tuple of per-shard tensors, each on its shard's
device; a shard on the device of the tensor it was cut from is a view of
it (no copy), and a slab cut at a multiple of 8192 rows keeps every
shard's base 8192-row aligned for K1's TMA loads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.ops.topk_scan import (
    GROUP,
    NEG_INF,
    TopKResult,
    _finalize,
    _pad_topk,
    topk_desc_rowasc,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> tuple[torch.Tensor, ...]:
    """Cut ``x`` into ``len(devices)`` equal blocks of rows, block s on
    ``devices[s]``: a view where that is ``x``'s own device, a copy
    elsewhere."""
    n_dev = len(devices)
    if x.shape[0] % n_dev:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_dev} equal shards")
    local = x.shape[0] // n_dev
    return tuple(
        x[s * local : (s + 1) * local] if dev == x.device else x[s * local : (s + 1) * local].to(dev)
        for s, dev in enumerate(devices)
    )


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> tuple[torch.Tensor, ...]:
    """``x`` on every shard's device (one copy per distinct device)."""
    copies: dict[torch.device, torch.Tensor] = {x.device: x}
    for dev in devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
    return tuple(copies[dev] for dev in devices)


def _merge_local_topk(scores: Sequence[torch.Tensor], rows: Sequence[torch.Tensor], k: int) -> TopKResult:
    """Merge per-shard (B, kk) heaps holding global rows into the global
    (B, k) on the lead device: shard-major concatenation, one exact top-k,
    -inf / -1 padding past the candidates, -1 for every non-finite score."""
    lead = scores[0].device
    cand_s = torch.cat([s.to(lead) for s in scores], dim=1)
    cand_i = torch.cat([i.to(lead).to(torch.int64) for i in rows], dim=1)
    out_s, pos = topk_desc_rowasc(cand_s, min(k, cand_s.shape[1]))
    return _finalize(*_pad_topk(out_s, torch.gather(cand_i, 1, pos), k))


def _global_rows(local: TopKResult, offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's heap with its local rows offset to global rows (-1 kept)."""
    idx = local.indices.to(torch.int64)
    return local.scores, torch.where(idx >= 0, idx + offset, -1)


def _sharded(local_scan, shards: Sequence[tuple], queries: torch.Tensor, k: int) -> TopKResult:
    """Run ``local_scan(*shard, its queries, kk)`` on every shard (a tuple
    whose first tensor is its slab) and merge the heaps."""
    local_rows = shards[0][0].shape[0]
    qs = replicate(queries, [sh[0].device for sh in shards])
    heaps = [_global_rows(local_scan(*sh, q, min(k, local_rows)), i * local_rows)
             for i, (sh, q) in enumerate(zip(shards, qs))]
    return _merge_local_topk([h[0] for h in heaps], [h[1] for h in heaps], k)


def _check_shards(slab: Sequence[torch.Tensor], mask: Sequence[torch.Tensor]) -> int:
    local_rows = slab[0].shape[0]
    if len(slab) != len(mask) or any(s.shape[0] != local_rows or m.shape != (local_rows,) for s, m in zip(slab, mask)):
        raise ValueError("shards must be equal: one (rows, d) slab and one (rows,) mask per shard")
    return local_rows


def _pad_and_shard(values: np.ndarray, devices: Sequence[torch.device], local_multiple: int, dtype):
    """Rows padded with zeros to ``len(devices) * local_multiple`` (padding
    at the end) and their additive validity mask (0 on the given rows,
    -inf on padding), each cut into one shard per device. The padded rows
    are uploaded to the first device, whose shards are views of them."""
    n = values.shape[0]
    n_pad = _round_up(max(n, 1), len(devices) * local_multiple)
    padded = np.zeros((n_pad,) + values.shape[1:], dtype=values.dtype)
    padded[:n] = values
    mask = np.full(n_pad, NEG_INF, dtype=np.float32)
    mask[:n] = 0.0
    lead = devices[0]
    return (shard_rows(torch.from_numpy(padded).to(device=lead, dtype=dtype), devices),
            shard_rows(torch.from_numpy(mask).to(lead), devices))


def shard_slab(
    slab: np.ndarray,
    devices: Sequence[torch.device],
    *,
    dtype=torch.bfloat16,
    local_multiple: int = 8,
) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """A host slab's rows in ``dtype`` and its validity mask, padded and cut
    into one shard per device (:func:`_pad_and_shard`)."""
    return _pad_and_shard(np.asarray(slab, dtype=np.float32), devices, local_multiple, dtype)


def shard_slab_int8(
    q8_values: np.ndarray, devices: Sequence[torch.device], *, local_multiple: int = 8
) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """:func:`shard_slab` for an int8-quantized slab: padding rows are 0 and
    masked out."""
    return _pad_and_shard(np.asarray(q8_values, dtype=np.int8), devices, local_multiple, torch.int8)


def sharded_scan_topk(
    slab: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
) -> TopKResult:
    """Exact global top-k over a row-sharded slab with the plain scan per
    shard (the query rounded to the slab dtype, f32 sums)."""
    _check_shards(slab, mask)
    return _sharded(lambda s, m, q, kk: topk_scan.scan_topk_xla(s, q, kk, m), list(zip(slab, mask)), queries, k)


def sharded_scan_topk_hier(
    slab: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
) -> TopKResult:
    """The hierarchical scan per shard (K1's group maxima, the top groups,
    K2's exact rescore: ``scan_topk_hierarchical``), heaps merged exactly.
    Each shard's rows must be a multiple of 128. Every row is scored alone
    by K1 and K2, so the result equals the single-device hierarchical scan
    over the same rows bit for bit."""
    local_rows = _check_shards(slab, mask)
    if local_rows % GROUP:
        raise ValueError(f"shard rows {local_rows} not a multiple of {GROUP}")
    return _sharded(lambda s, m, q, kk: topk_scan.scan_topk_hierarchical(s, q, kk, m),
                    list(zip(slab, mask)), queries, k)


def sharded_scan_topk_hier_int8(
    slab_i8: Sequence[torch.Tensor],
    slab_scale: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    *,
    group_overfetch: int = 1,
) -> TopKResult:
    """The int8 capacity lane per shard (K4's group maxima, K2-i8's
    rescore with the per-dim scale folded into the query:
    ``scan_topk_hierarchical_int8``), heaps merged exactly. The
    ``group_overfetch`` recall knob applies per shard, as on one device."""
    local_rows = _check_shards(slab_i8, mask)
    if local_rows % GROUP:
        raise ValueError(f"shard rows {local_rows} not a multiple of {GROUP}")
    def local(s, scale, m, q, kk):
        return topk_scan.scan_topk_hierarchical_int8(s, scale, q, kk, m, group_overfetch=group_overfetch)

    return _sharded(local, list(zip(slab_i8, slab_scale, mask)), queries, k)


def sharded_scan_topk_int8(
    slab_i8: Sequence[torch.Tensor],
    slab_scale: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    *,
    candidate_multiplier: int = 4,
) -> TopKResult:
    """The plain int8 two-pass scan per shard, as the reference's: pass 1
    ranks the shard's rows by the exact int8 dot with the prepared query
    and keeps ``k * candidate_multiplier``; pass 2 rescores those rows
    dequantized (``q · (c * scale)``, f32) and keeps the exact top-k. Only
    the exact heaps leave a shard."""
    local_rows = _check_shards(slab_i8, mask)
    def local(s, scale, m, q, kk):
        rough = topk_scan.int8_dot(topk_scan.prepare_query_int8(q, scale), s) + m[None, :]
        kc = min(max(kk * candidate_multiplier, kk), local_rows)
        _, cand = topk_desc_rowasc(rough, kc)  # (B, kc) local rows
        rows = s[cand].to(torch.float32) * scale.to(torch.float32)  # (B, kc, D)
        exact = torch.einsum("bd,bcd->bc", q.to(torch.float32), rows) + m[cand]
        top_s, pos = topk_desc_rowasc(exact, min(kk, kc))
        return _finalize(*_pad_topk(top_s, torch.gather(cand, 1, pos), kk))

    return _sharded(local, list(zip(slab_i8, slab_scale, mask)), queries, k)


class ShardedVectorScan:
    """A host slab as a mesh-sharded scan service: rows normalized, padded,
    sharded over ``mesh``'s ``axis``, served by the plain sharded scan."""

    def __init__(
        self,
        vectors: np.ndarray,
        doc_ids: list[str],
        mesh=None,
        *,
        dtype=torch.bfloat16,
        axis: str = "d",
        device="cuda",
    ) -> None:
        from frankensearch_tpu_torch.parallel.mesh import make_mesh

        self.mesh = mesh or make_mesh(device=device)
        self.axis = axis
        self.doc_ids = doc_ids
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = np.where(norms > 1e-12, vectors / np.maximum(norms, 1e-12), vectors)
        self.slab, self.mask = shard_slab(vectors, self.mesh.shard_devices(axis), dtype=dtype)
        self.dim = vectors.shape[1]

    def search_batch(self, queries: np.ndarray, k: int) -> TopKResult:
        q = torch.from_numpy(np.asarray(queries, dtype=np.float32))
        return sharded_scan_topk(self.slab, self.mask, q, k)
