"""IVF (inverted-file) coarse-quantized vector index (PyTorch port).

Port of frankensearch_tpu/index/ivf.py. A query is

    centroid matmul (B x C) -> top-nprobe clusters ->
    gather nprobe dense buckets -> exact scores -> top-k

Recall is tunable by ``nprobe`` and certifiable with the conformal recall
certificates (index/recall_certificate.py). Buckets are balanced:
capacity-constrained assignment keeps every bucket <= cap.

:class:`IvfDeviceIndex` (the ``scan_mode="ivf"`` arm of
``DeviceVectorIndex``) sorts the slab by cluster, so a bucket is a run of
128-row groups. On a bf16/f16 arm the probe after the centroid top-k is
K2-ivf (``topk_scan.ivf_probe_topk``, csrc/ivf_probe.cu on CUDA: each
probed cluster streamed once for the queries that probe it, the mask and
the top-k on the card); an f32 arm keeps K2-f32 on the probe's groups
(``topk_scan._rescore_groups``). Both round the query to the slab dtype,
and on the CPU both run K2's plain twin. The reference takes an f32-query
einsum off its TPU; the difference is bounded by the query's rounding
(ROADMAP queue 3). The k-means update sums clusters with a one-hot
product, as the reference does: no float atomics. The host helpers
(:func:`balanced_assign`, :func:`spill_assign`) are the reference's numpy,
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.ops.topk_scan import NEG_INF, TopKResult


def _l2n(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(n > 1e-12, x / np.maximum(n, 1e-12), x)


def _f32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as an f32 tensor on ``device`` (a copy)."""
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return torch.where(norms > 1e-12, x / norms, x)


def kmeans(
    vectors: np.ndarray, n_clusters: int, iters: int = 10, seed: int = 0,
    train_sample: int = 262_144, *, device: torch.device,
) -> np.ndarray:
    """Spherical k-means (cosine) on ``device``; returns (C, D) unit
    centroids. Trains on a uniform subsample (numpy-seeded, as the
    reference) when the (N, C) similarities would be large; the full corpus
    is assigned afterwards."""
    n, _ = vectors.shape
    rng = np.random.default_rng(seed)
    if n > train_sample:
        vectors = vectors[rng.choice(n, size=train_sample, replace=False)]
        n = train_sample
    init = vectors[rng.choice(n, size=n_clusters, replace=False)]
    x = _f32(_l2n(vectors), device)
    c = _f32(_l2n(init), device)
    for _ in range(iters):
        assign = torch.argmax(x @ c.T, dim=1)  # first maximum, as jnp.argmax
        one_hot = torch.nn.functional.one_hot(assign, n_clusters).to(torch.float32)
        sums = one_hot.T @ x  # (C, D): a product, not an atomic scatter
        counts = one_hot.sum(dim=0)[:, None]
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
        c = _normalize_rows(new)
    return c.cpu().numpy()


def balanced_assign(vectors: np.ndarray, centroids: np.ndarray, cap: int) -> np.ndarray:
    """Capacity-constrained nearest-centroid assignment: docs in order of
    confidence (best minus second-best similarity) take their nearest
    centroid with space. Returns (N,) cluster ids."""
    sims = _l2n(vectors) @ centroids.T  # (N, C)
    s = np.sort(sims, axis=1)
    # a single cluster has no second best: the margin is the best sim
    margin = s[:, -1] - (s[:, -2] if s.shape[1] > 1 else 0.0)
    order = np.argsort(-margin)
    prefs = np.argsort(-sims, axis=1)  # (N, C) preference lists
    counts = np.zeros(centroids.shape[0], dtype=np.int64)
    assign = np.full(vectors.shape[0], -1, dtype=np.int64)
    for doc in order:
        for c in prefs[doc]:
            if counts[c] < cap:
                assign[doc] = c
                counts[c] += 1
                break
    assert (assign >= 0).all(), "cap too small for corpus"
    return assign


def _ivf_search(
    centroids: torch.Tensor,  # (C, D) f32
    buckets: torch.Tensor,  # (C, CAP, D)
    bucket_rows: torch.Tensor,  # (C, CAP) i32, -1 padding
    queries: torch.Tensor,  # (B, D) f32
    *,
    nprobe: int,
    k: int,
) -> TopKResult:
    b = queries.shape[0]
    cap = buckets.shape[1]
    _, probe = topk_scan.topk_desc_rowasc(queries @ centroids.T, nprobe)  # (B, nprobe)
    cand = buckets[probe].to(torch.float32)  # (B, nprobe, CAP, D)
    rows = bucket_rows[probe].reshape(b, nprobe * cap)
    scores = torch.einsum("bd,bpcd->bpc", queries, cand).reshape(b, nprobe * cap)
    scores = torch.where(rows >= 0, scores, NEG_INF)
    top_s, pos = topk_scan.topk_desc_rowasc(scores, min(k, scores.shape[1]))
    top_s, top_i = topk_scan._pad_topk(top_s, torch.gather(rows, 1, pos).to(torch.int64), k)
    return topk_scan._finalize(top_s, top_i)


def _prefs_device(
    vectors: np.ndarray, centroids: np.ndarray, *, device: torch.device,
    top: int = 4, chunk: int = 131_072,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-``top`` centroid preferences + assignment margin per doc, on
    ``device`` in chunks (never the whole (N, C) similarity matrix)."""
    cents = _f32(centroids, device)
    width = min(top, cents.shape[0])
    prefs, margins = [], []
    for s in range(0, len(vectors), chunk):
        xc = _f32(vectors[s : s + chunk], device)
        top_s, top_i = topk_scan.topk_desc_rowasc(xc @ cents.T, width)
        margin = top_s[:, 0] - (top_s[:, 1] if width > 1 else 0.0)
        prefs.append(top_i.cpu().numpy())
        margins.append(margin.cpu().numpy())
    return np.concatenate(prefs), np.concatenate(margins)


def spill_assign(prefs: np.ndarray, margins: np.ndarray, n_clusters: int, cap: int) -> np.ndarray:
    """Greedy capacity-constrained assignment over top-preference lists,
    in confidence (margin) order; docs whose listed preferences are all
    full land in the first cluster with space (rare, lowest-margin)."""
    order = np.argsort(-margins, kind="stable")
    counts = np.zeros(n_clusters, dtype=np.int64)
    assign = np.full(len(prefs), -1, dtype=np.int64)
    spill: list[int] = []
    for doc in order:
        placed = False
        for c in prefs[doc]:
            if counts[c] < cap:
                assign[doc] = c
                counts[c] += 1
                placed = True
                break
        if not placed:
            spill.append(doc)
    if spill:
        open_clusters = np.flatnonzero(counts < cap).tolist()
        ci = 0
        for doc in spill:
            while counts[open_clusters[ci]] >= cap:
                ci += 1
            c = open_clusters[ci]
            assign[doc] = c
            counts[c] += 1
    assert (assign >= 0).all(), "cap too small for corpus"
    return assign


class IvfDeviceIndex:
    """IVF over a slab sorted by cluster: each bucket is a run of
    contiguous 128-row groups, which a probe streams (K2-ivf; K2-f32 on an
    f32 arm).

    Rows are L2-normalized at build (cosine == dot). The small-batch,
    low-latency lane: a probe reads about ``nprobe * cap`` rows instead of
    N. The slab's dim is padded with zero columns to a multiple of 8 (K2's
    16-byte loads); scores are unchanged by the zeros."""

    GROUP = topk_scan.GROUP

    def __init__(
        self,
        vectors: np.ndarray,
        n_clusters: int | None = None,
        *,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        kmeans_iters: int = 10,
        capacity_slack: float = 1.5,
    ) -> None:
        vectors = _l2n(np.asarray(vectors, dtype=np.float32))
        n, d = vectors.shape
        c = n_clusters or max(min(int(np.sqrt(n * 4)), n // 8 or 1), 1)
        cents = kmeans(vectors, c, iters=kmeans_iters, seed=seed, device=device)
        prefs, margins = _prefs_device(vectors, cents, device=device)
        cap = int(np.ceil(n / c * capacity_slack))
        cap = max(((cap + self.GROUP - 1) // self.GROUP) * self.GROUP, self.GROUP)
        assign = spill_assign(prefs, margins, c, cap)

        # sorted-slab build: stable sort by cluster, then each doc's slot is
        # cluster * cap + its place in the cluster
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=c)
        starts = np.zeros(c, dtype=np.int64)
        np.cumsum(sizes[:-1], out=starts[1:])
        within = np.arange(n, dtype=np.int64) - starts[assign[order]]
        slots = assign[order] * cap + within
        d_pad = -(-d // 8) * 8
        slab = np.zeros((c * cap, d_pad), dtype=np.float32)
        row_map = np.full(c * cap, -1, dtype=np.int64)
        slab[slots, :d] = vectors[order]
        row_map[slots] = order
        mask = np.where(row_map >= 0, 0.0, NEG_INF).astype(np.float32)

        self.device = device
        self.n_docs = n
        self.dim = d
        self.n_clusters = c
        self.cap = cap
        self.groups_per_cluster = cap // self.GROUP
        self.centroids = _f32(cents, device)
        self.slab = torch.from_numpy(slab).to(device=device, dtype=dtype)
        self.mask = torch.from_numpy(mask).to(device)
        self.row_map = row_map
        self._row_map_dev = torch.from_numpy(row_map).to(device)
        self._safe_map_dev = None

    def scanned_fraction(self, nprobe: int = 8) -> float:
        return min(nprobe, self.n_clusters) * self.cap / max(self.n_docs, 1)

    def search_batch(
        self,
        queries,
        k: int,
        *,
        nprobe: int = 8,
        extra_row_mask: torch.Tensor | None = None,
    ) -> TopKResult:
        """``extra_row_mask`` is an additive mask over ORIGINAL row ids (the
        owning index's tombstone/filter mask), permuted into the sorted
        slab's order on the device. Returns original rows on the device."""
        q = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(self.device)
        if q.dim() == 1:
            q = q[None, :]
        if q.shape[1] != self.slab.shape[1]:
            q = torch.nn.functional.pad(q, (0, self.slab.shape[1] - q.shape[1]))
        nprobe = min(nprobe, self.n_clusters)
        mask = self.mask
        if extra_row_mask is not None:
            if self._safe_map_dev is None:  # one upload, not one per search
                self._safe_map_dev = torch.clamp(self._row_map_dev, min=0)
            mask = mask + extra_row_mask[self._safe_map_dev]
        s, pos = _ivf_probe_rescore(
            self.centroids, self.slab, mask, q, nprobe=nprobe, k=k, gpc=self.groups_per_cluster,
        )
        rows = torch.where(pos >= 0, self._row_map_dev[torch.clamp(pos, min=0).to(torch.int64)], -1)
        rows = torch.where(torch.isfinite(s), rows, -1)
        return TopKResult(s, rows.to(torch.int32))


def calibrate_nprobe(
    ivf: IvfDeviceIndex,
    queries: np.ndarray,
    exact_idx: np.ndarray,
    *,
    k: int,
    target_recall: float = 0.95,
    confidence: float = 0.95,
    candidates: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
):
    """Certified minimal nprobe for a recall target (the analog of the
    reference's certified minimal-ef HNSW calibration)."""
    from frankensearch_tpu_torch.index.recall_certificate import calibrate_minimal_parameter

    def run(v: float) -> np.ndarray:
        return ivf.search_batch(queries, k, nprobe=int(v)).indices.cpu().numpy()

    return calibrate_minimal_parameter(
        run,
        np.asarray(exact_idx),
        [c for c in candidates if c <= ivf.n_clusters],
        parameter_name="nprobe",
        k=k,
        target_recall=target_recall,
        confidence=confidence,
    )


def _ivf_probe_rescore(
    centroids: torch.Tensor,  # (C, D) f32
    slab: torch.Tensor,  # (C*cap, D) sorted by cluster
    mask: torch.Tensor,  # (C*cap,) f32 additive
    queries: torch.Tensor,  # (B, D) f32
    *,
    nprobe: int,
    k: int,
    gpc: int,  # groups (of 128 rows) per cluster
) -> tuple[torch.Tensor, torch.Tensor]:
    """The centroid top-k (:func:`probe_clusters`), then the probed rows'
    exact top-k: K2-ivf on a bf16/f16 slab, the hierarchical scan's tail on
    K2-f32 on an f32 one (chosen by dtype). Returns (B, k) f32 scores and
    int32 slab positions (-1 where the score is -inf)."""
    probe = probe_clusters(centroids, queries, nprobe=nprobe)
    if slab.dtype == torch.float32:
        res = topk_scan._rescore_groups(slab, queries, mask, topk_scan.cluster_groups(probe, gpc), k=k)
    else:
        res = topk_scan.ivf_probe_topk(slab, queries, mask, probe, k=k, gpc=gpc)
    return res.scores, res.indices


def probe_clusters(centroids: torch.Tensor, queries: torch.Tensor, *, nprobe: int) -> torch.Tensor:
    """Centroid sims (f32) -> each query's top ``nprobe`` clusters, (B,
    nprobe) int64 in (sim desc, id asc) order."""
    return topk_scan.topk_desc_rowasc(queries[:, : centroids.shape[1]] @ centroids.T, nprobe)[1]


def probe_groups(centroids: torch.Tensor, queries: torch.Tensor, *, nprobe: int, gpc: int) -> torch.Tensor:
    """The probed clusters' ``nprobe * gpc`` 128-row group ids in the sorted
    slab, (B, nprobe * gpc) int32, cluster by cluster (unsorted)."""
    return topk_scan.cluster_groups(probe_clusters(centroids, queries, nprobe=nprobe), gpc)


@dataclass
class IvfParams:
    n_clusters: int = 64
    capacity_slack: float = 1.5
    kmeans_iters: int = 10
    seed: int = 0


class IvfIndex:
    """Device-resident IVF over dense (C, cap, D) buckets."""

    def __init__(
        self, vectors: np.ndarray, params: IvfParams | None = None,
        dtype: torch.dtype = torch.bfloat16, *, device: torch.device,
    ) -> None:
        params = params or IvfParams()
        self.params = params
        vectors = _l2n(np.asarray(vectors, dtype=np.float32))
        n, d = vectors.shape
        c = min(params.n_clusters, max(n // 4, 1))
        cap = int(np.ceil(n / c * params.capacity_slack))
        cap = max(((cap + 7) // 8) * 8, 8)
        centroids = kmeans(vectors, c, iters=params.kmeans_iters, seed=params.seed, device=device)
        assign = balanced_assign(vectors, centroids, cap)

        buckets = np.zeros((c, cap, d), dtype=np.float32)
        rows = np.full((c, cap), -1, dtype=np.int32)
        fill = np.zeros(c, dtype=np.int64)
        for doc in range(n):
            cl = assign[doc]
            buckets[cl, fill[cl]] = vectors[doc]
            rows[cl, fill[cl]] = doc
            fill[cl] += 1
        self.device = device
        self.n_docs = n
        self.n_clusters = c
        self.cap = cap
        self.centroids = _f32(centroids, device)
        self.buckets = torch.from_numpy(buckets).to(device=device, dtype=dtype)
        self.bucket_rows = torch.from_numpy(rows).to(device)

    def search_batch(self, queries: np.ndarray, k: int, *, nprobe: int = 8) -> TopKResult:
        q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(self.device)
        if q.dim() == 1:
            q = q[None, :]
        nprobe = min(nprobe, self.n_clusters)
        return _ivf_search(self.centroids, self.buckets, self.bucket_rows, q, nprobe=nprobe, k=k)

    def scanned_fraction(self, nprobe: int = 8) -> float:
        """Fraction of the corpus scanned per query at a given probe."""
        return min(nprobe, self.n_clusters) * self.cap / max(self.n_docs, 1)
