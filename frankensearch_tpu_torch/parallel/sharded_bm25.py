"""Block-sharded device BM25 with an exact top-k merge (PyTorch).

Port of frankensearch_tpu/parallel/sharded_bm25.py: the lexical arm's
share of the mesh. The length-graded blocked layout (lexical/device_bm25.py)
shards on its block axis: each class's blocks are padded to a multiple of
the shard count and cut into one contiguous run per shard; each shard
streams its runs through the pruned lane (``_graded_scan_pruned``: the
seq-T step ``_group_block_scores`` and block-max skipping) on its device,
and the per-shard (B, k) heaps merge on the lead device by the exact
(score desc, row asc) two-key sort. A doc's score depends only on its own
postings, and every merge is exact, so the result equals the port's
single-device pruned lane bit for bit however the blocks land on shards.
Padding blocks (term 0, tf 0, doc_map -1, bound 0) are always skipped by
the zero-bound rule, and counted as skipped, as in the reference.

The reference steps each block with a one-shot einsum over the query's
terms; the port's step is its own pruned lane's (terms in chunks of 8,
a fused multiply-add each): the scores agree within 1e-6 relative.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.lexical import device_bm25 as _bm
from frankensearch_tpu_torch.lexical.base import LexicalCandidate, LexicalRead
from frankensearch_tpu_torch.lexical.device_bm25 import (
    FusedLexPlan,
    _BlockedPostings,
    _build_blocked,
    _graded_scan_pruned,
    _GradedClass,
    _topk_score_row,
)
from frankensearch_tpu_torch.parallel.mesh import Mesh
from frankensearch_tpu_torch.parallel.sharded_scan import replicate, shard_rows


@dataclass
class _ShardedBlocks:
    """The graded blocked layout cut per shard on the block axis."""

    shards: tuple  # per shard: tuple[_GradedClass] (its run of every class)
    n_pad: tuple  # per class: padded block count (a multiple of the shard count)
    devices: tuple  # per shard: its device


def _pad_blocks(x: torch.Tensor, extra: int, fill) -> torch.Tensor:
    if extra == 0:
        return x
    return torch.cat([x, x.new_full((extra,) + tuple(x.shape[1:]), fill)])


def shard_blocked(blocked: _BlockedPostings, devices: Sequence[torch.device]) -> _ShardedBlocks:
    """Pad each class's block axis to a multiple of ``len(devices)``
    (padding blocks: term 0, tf 0, doc_map -1) and cut it into one run of
    blocks per shard (views on the layout's device, copies elsewhere)."""
    n_dev = len(devices)
    per_class = []
    n_pads = []
    for cls in blocked.classes:
        if cls.term is None:
            raise ValueError("the sharded arm needs the doc-major (unsplit) layout")
        n_c = cls.doc_map.shape[0]
        n_pad = max(-(-n_c // n_dev) * n_dev, n_dev)
        extra = n_pad - n_c
        per_class.append([
            shard_rows(_pad_blocks(x, extra, fill), devices)
            for x, fill in ((cls.term, 0), (cls.tf, 0.0), (cls.doc_map, -1))
        ])
        n_pads.append(n_pad)
    shards = tuple(
        tuple(_GradedClass(term=t[s], tf=f[s], doc_map=m[s]) for t, f, m in per_class)
        for s in range(n_dev)
    )
    return _ShardedBlocks(shards=shards, n_pad=tuple(n_pads), devices=tuple(devices))


def place_bounds(blocked: _BlockedPostings, sharded: _ShardedBlocks, bounds: np.ndarray) -> tuple:
    """Host (n_blk, B) query bounds -> per shard, per class, the bounds of
    that shard's run of blocks on its device (0 on padding blocks): the
    ``bounds`` of :func:`sharded_bm25_topk`."""
    n_dev = len(sharded.devices)
    out: list[list[torch.Tensor]] = [[] for _ in range(n_dev)]
    for c, cls in enumerate(blocked.classes):
        start = blocked.class_offsets[c]
        chunk = bounds[start : start + cls.doc_map.shape[0]]
        padded = np.zeros((sharded.n_pad[c], bounds.shape[1]), dtype=np.float32)
        padded[: chunk.shape[0]] = chunk
        per = sharded.n_pad[c] // n_dev
        for s, dev in enumerate(sharded.devices):
            out[s].append(torch.from_numpy(padded[s * per : (s + 1) * per]).to(dev))
    return tuple(tuple(b) for b in out)


def sharded_bm25_topk(sharded: _ShardedBlocks, bounds: tuple, q_ids: torch.Tensor, q_w: torch.Tensor, *, k: int):
    """Pruned BM25 per shard, heaps merged by the exact two-key sort on the
    lead device. Returns ((B, k) f32 scores, (B, k) i32 global doc rows,
    blocks skipped over all shards)."""
    ids = replicate(q_ids, sharded.devices)
    ws = replicate(q_w, sharded.devices)
    lead = sharded.devices[0]
    heaps_s, heaps_i = [], []
    skipped = 0
    for s in range(len(sharded.devices)):
        top_s, top_i, n_skip = _graded_scan_pruned(sharded.shards[s], bounds[s], ids[s], ws[s], k=k)
        heaps_s.append(top_s.to(lead))
        heaps_i.append(top_i.to(lead))
        skipped += n_skip
    out_s, out_i = _topk_score_row(torch.cat(heaps_s, dim=1), torch.cat(heaps_i, dim=1), k)
    return out_s, out_i, skipped


class ShardedBulkDeviceBm25Index(LexicalRead):
    """A device BM25 index whose postings blocks are sharded over a mesh
    axis. Wraps a built ``DeviceBm25Index`` / ``BulkDeviceBm25Index``: its
    unsplit blocked layout is sharded as it stands; a split layout (hot
    arm) or the dense lane's arrays give way to the unsplit graded layout
    rebuilt from the index's host postings (below the blocked threshold
    with blocks of about ``postings / shards``, at least one block a
    shard). Query rows, bounds and hydration are the wrapped index's."""

    def __init__(self, inner, mesh: Mesh, *, axis: str = "d", block_postings: int | None = None) -> None:
        self.inner = inner
        self.mesh = mesh
        self.axis = axis
        devices = mesh.shard_devices(axis)
        self.device = devices[0]
        self.doc_ids = inner.doc_ids
        self.n_docs = inner.n_docs
        blocked = inner._blocked
        if blocked is None or inner._hot is not None:
            terms, docs, tfs = inner._post_host
            if block_postings is None and len(terms) < _bm.BLOCKED_THRESHOLD_POSTINGS:
                block_postings = max(len(terms) // len(devices), 128)
            blocked = _build_blocked(
                terms.astype(np.int64), docs.astype(np.int64), tfs,
                n_docs=inner.n_docs, vocab_size=inner.vocab_size, device=self.device,
                block_postings=block_postings,
            )
        self._blocked_host = blocked
        self._sharded = shard_blocked(blocked, devices)
        self.last_blocks_skipped = 0

    def place_bounds(self, bounds: np.ndarray) -> tuple:
        """Host (n_blk, B) bounds -> the per-shard device bounds."""
        return place_bounds(self._blocked_host, self._sharded, bounds)

    def _bounded_rows(self, queries) -> tuple:
        """(placed per-shard bounds, device ids, device weights) of a batch."""
        ids, w = self.inner._query_sparse_rows(list(queries))
        bounds = self.place_bounds(self._blocked_host.query_bounds(ids, w))
        return bounds, torch.from_numpy(ids).to(self.device), torch.from_numpy(w).to(self.device)

    def fused_plan(self, queries) -> FusedLexPlan:
        """The lexical half of ``fused_phase1_sharded`` for a padded batch:
        (sharded blocks, placed bounds, ids, w); every query takes the
        block-sharded pruned scan."""
        return FusedLexPlan("sharded", ["pruned"] * len(queries), (self._sharded, *self._bounded_rows(queries)), {})

    def rows_to_candidates(self, s: np.ndarray, i: np.ndarray) -> list[list[LexicalCandidate]]:
        return self.inner.rows_to_candidates(s, i)

    # -- LexicalRead -----------------------------------------------------------

    def search_candidates_batch(self, queries, budget: int) -> list[list[LexicalCandidate]]:
        if self.n_docs == 0 or not queries:
            return [[] for _ in queries]
        top_s, top_i, skipped = sharded_bm25_topk(
            self._sharded, *self._bounded_rows(queries), k=min(budget, self.n_docs),
        )
        self.last_blocks_skipped = skipped
        return self.rows_to_candidates(top_s.cpu().numpy(), top_i.cpu().numpy())

    def search_candidates(self, query: str, budget: int) -> list[LexicalCandidate]:
        return self.search_candidates_batch([query], budget)[0]

    def hydrate_candidates(self, doc_ids):
        return self.inner.hydrate_candidates(doc_ids)

    def doc_count(self) -> int:
        return self.n_docs
