"""K2-ivf on the CPU: the IVF probe's wrapper (``topk_scan.ivf_probe_topk``)
and its plain twin against the path the probe took before it
(``probe_groups`` -> ``_rescore_groups`` on K2's twin), bitwise; the CUDA
kernel's work layout and list merge modelled on the CPU, bitwise the twin;
and ``IvfDeviceIndex.search_batch`` against the JAX reference's.

The kernel itself runs only on a card (tests/test_torch_kernels_cuda.py,
``-m cuda``). What it writes is modelled here: for each (query, probed
cluster) pair and each of its runs of groups, the run's top ``kp`` rows by
(score, slab position), or every row above ``IVF_LIST_K``, then
:func:`topk_scan.merge_probe_lists`. The model takes the twin's own scores,
so the comparison is of the selection and the layout, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.index import ivf as rivf
from frankensearch_tpu_torch.index import ivf as pivf
from frankensearch_tpu_torch.ops import topk_scan as tts
from tests.conftest import make_unit_rows

NEG_INF = float("-inf")


def probe_arm(seed, n_clusters, gpc, *, b=8, nprobe=4, d=32, tombstones=0.1, dead_cluster=False, dup=False,
              zeros=False):
    """A bf16 slab sorted by cluster (n_clusters x gpc groups of 128 rows),
    its additive mask (a ``tombstones`` share of rows at -inf, optionally a
    whole probed cluster), queries, their probe table (the centroid
    top-nprobe, as the index takes it) and the centroids. ``dup`` copies
    rows across the probed clusters (exact ties); ``zeros`` gives rows
    whose products with every query are +0.0 or -0.0 and a mask of -0.0
    on others: scores of exactly zero, tied (the f32 sums give +0.0; the
    merge's -0.0 order is test_merge_ranks_by_score_then_position's)."""
    rng = np.random.default_rng(seed)
    n = n_clusters * gpc * 128
    x = make_unit_rows(rng, n, d)
    q = make_unit_rows(rng, b, d)
    cents = make_unit_rows(rng, n_clusters, d)
    if dup:
        src = rng.integers(0, n, size=n // 4)
        x[rng.integers(0, n, size=n // 4)] = x[src]
    if zeros:  # q[:, 0] = 0, and rows that only hold dim 0: every product +0.0 or -0.0
        q[:, 0] = 0.0
        rows = rng.integers(0, n, size=n // 8)
        x[rows] = 0.0
        x[rows, 0] = np.where(rng.random(len(rows)) < 0.5, 1.0, -1.0)
    mask = np.where(rng.random(n) < tombstones, NEG_INF, 0.0).astype(np.float32)
    if zeros:
        mask[rng.integers(0, n, size=n // 8)] = -0.0
    slab = torch.from_numpy(x).to(torch.bfloat16)
    qt = torch.from_numpy(q)
    ct = torch.from_numpy(cents)
    probe = pivf.probe_clusters(ct, qt, nprobe=nprobe)
    if dead_cluster:
        c = int(probe[0, 0])
        mask[c * gpc * 128 : (c + 1) * gpc * 128] = NEG_INF
    return slab, torch.from_numpy(mask), qt, probe, ct


def path_before(centroids, slab, mask, q, *, nprobe, k, gpc):
    """The probe as it ran before K2-ivf: the centroid top-k expanded to
    group ids, then the hierarchical scan's tail on K2 (its twin here)."""
    b = q.shape[0]
    _, probe = tts.topk_desc_rowasc(q[:, : centroids.shape[1]] @ centroids.T, nprobe)
    goff = torch.arange(gpc, dtype=torch.int64)
    gids = (probe[:, :, None] * gpc + goff).reshape(b, nprobe * gpc).to(torch.int32)
    res = tts._rescore_groups(slab, q, mask, gids, k=k, rescore=tts.gather_rescore_plain)
    return res.scores, res.indices


def bits_equal(got_s, got_i, want_s, want_i):
    assert torch.equal(got_s.contiguous().view(torch.int32), want_s.contiguous().view(torch.int32))
    assert torch.equal(got_i, want_i)


#: (n_clusters, groups a cluster, nprobe, k): k = 1, 10, 64, 65, above the
#: cap (3 groups: 384 rows), above nprobe x cap (pads with -1), the full
#: probe
PROBE_CASES = [
    (16, 1, 4, 1), (16, 1, 4, 10), (32, 2, 5, 64), (32, 2, 5, 65), (16, 3, 2, 400), (16, 3, 2, 900),
    (16, 2, 16, 10), (64, 1, 64, 12),
]


@pytest.mark.parametrize("variant", ["plain", "tombstones", "dead_cluster", "duplicates", "signed_zeros"])
@pytest.mark.parametrize("n_clusters,gpc,nprobe,k", PROBE_CASES)
def test_probe_is_bitwise_the_path_before(n_clusters, gpc, nprobe, k, variant):
    """``ivf._ivf_probe_rescore`` (bf16 arm: K2-ivf, its twin on the CPU) and
    the wrapper on a given probe table give the rows and score bits of the
    path before, on arms of 16-64 clusters of 128-384 rows."""
    slab, mask, q, probe, cents = probe_arm(
        n_clusters * 31 + k, n_clusters, gpc, nprobe=nprobe, tombstones=0.0 if variant == "plain" else 0.1,
        dead_cluster=variant == "dead_cluster", dup=variant == "duplicates", zeros=variant == "signed_zeros")
    want_s, want_i = path_before(cents, slab, mask, q, nprobe=nprobe, k=k, gpc=gpc)
    got_s, got_i = pivf._ivf_probe_rescore(cents, slab, mask, q, nprobe=nprobe, k=k, gpc=gpc)
    bits_equal(got_s, got_i, want_s, want_i)
    res = tts.ivf_probe_topk(slab, q, mask, probe, k=k, gpc=gpc)
    bits_equal(res.scores, res.indices, want_s, want_i)
    assert got_s.shape == (q.shape[0], k) and got_i.dtype == torch.int32
    assert bool((got_i[~torch.isfinite(got_s)] == -1).all())
    if variant == "dead_cluster":
        c = int(probe[0, 0])
        assert not set(range(c * gpc * 128, (c + 1) * gpc * 128)) & set(got_i[0].tolist())


def kernel_model(slab, q, mask, probe, *, k, gpc, splits):
    """What csrc/ivf_probe.cu writes for this probe, from the twin's own
    scores: per (pair, run) the run's top kp rows in (score total order
    desc, position asc) order padded with (-inf, -1), or above IVF_LIST_K
    every row of the run in position order; then the wrapper's merge."""
    b, nprobe = probe.shape
    cap = gpc * tts.GROUP
    gs = -(-gpc // splits)
    kp = k if k <= tts.IVF_LIST_K else gs * tts.GROUP
    gids = torch.sort(tts.cluster_groups(probe, gpc), dim=1).values
    exact = tts.gather_rescore_plain(slab, q, gids) + mask.view(-1, tts.GROUP)[gids.to(torch.int64)].reshape(b, -1)
    pos = (gids.to(torch.int64)[:, :, None] * tts.GROUP + torch.arange(tts.GROUP)).reshape(b, -1)
    dense = torch.full((b, slab.shape[0]), float("nan"))
    dense.scatter_(1, pos, exact)
    out_s = torch.full((b, nprobe, splits, kp), NEG_INF)
    out_i = torch.full((b, nprobe, splits, kp), -1, dtype=torch.int32)
    for bi in range(b):
        for j in range(nprobe):
            for s in range(splits):
                g0, g1 = s * gs, min(gpc, (s + 1) * gs)
                rows = torch.arange(int(probe[bi, j]) * cap + g0 * tts.GROUP, int(probe[bi, j]) * cap + g1 * tts.GROUP)
                sc = dense[bi, rows]
                if kp > tts.IVF_LIST_K:
                    out_s[bi, j, s, : len(rows)], out_i[bi, j, s, : len(rows)] = sc, rows.to(torch.int32)
                    continue
                live = sc > NEG_INF
                sc, rows = sc[live], rows[live]
                key = (tts.float_order_key(sc) << 32) | (0xFFFFFFFF - rows)
                top = torch.argsort(key, descending=True)[:kp]
                out_s[bi, j, s, : len(top)], out_i[bi, j, s, : len(top)] = sc[top], rows[top].to(torch.int32)
    return tts.merge_probe_lists(out_s.view(b, -1), out_i.view(b, -1), k)


@pytest.mark.parametrize("splits", [1, 2, "gpc"])
@pytest.mark.parametrize("variant", ["tombstones", "duplicates", "signed_zeros"])
@pytest.mark.parametrize("n_clusters,gpc,nprobe,k", [(16, 3, 4, 1), (16, 3, 4, 10), (16, 3, 4, 64), (16, 3, 4, 65),
                                                     (16, 3, 2, 900), (8, 3, 8, 10)])
def test_kernel_layout_and_merge_give_the_twins_bits(n_clusters, gpc, nprobe, k, variant, splits):
    """The kernel's lists (runs of one, two or all groups; lists and, above
    64, whole runs) merged by (score, position) are the twin's top-k, bit
    for bit: the cluster-major cut loses no row and keeps the tiebreak."""
    splits = gpc if splits == "gpc" else splits
    slab, mask, q, probe, _ = probe_arm(k + nprobe + splits, n_clusters, gpc, nprobe=nprobe,
                                        dup=variant == "duplicates", zeros=variant == "signed_zeros")
    want = tts.ivf_probe_topk_plain(slab, q, mask, probe, k=k, gpc=gpc)
    got = kernel_model(slab, q, mask, probe, k=k, gpc=gpc, splits=splits)
    bits_equal(got.scores, got.indices, want.scores, want.indices)


def test_merge_ranks_by_score_then_position():
    """``merge_probe_lists``: +0.0 above -0.0, equal scores by position
    ascending whatever their column, -inf entries and (-inf, -1) pads last
    with index -1."""
    s = torch.tensor([[0.5, -0.0, 0.0, 0.5, NEG_INF, 0.25, NEG_INF, 0.5]])
    i = torch.tensor([[70, 3, 9, 12, 5, 1, -1, 40]], dtype=torch.int32)
    got = tts.merge_probe_lists(s, i, 10)
    assert got.indices.tolist() == [[12, 40, 70, 1, 9, 3, -1, -1, -1, -1]]
    assert got.scores[0, :6].tolist() == [0.5, 0.5, 0.5, 0.25, 0.0, -0.0]
    assert torch.signbit(got.scores[0, 5]) and not torch.signbit(got.scores[0, 4])
    assert got.scores[0, 6:].tolist() == [NEG_INF] * 4


@pytest.mark.parametrize("b,nprobe,k,want", [
    (1, 8, 10, (True, 6, 8, 10)),  # pair order, a run a group: 48 units
    (8, 8, 10, (True, 6, 8, 10)),
    (8, 32, 10, (True, 1, 8, 10)),  # 256 pairs: still pair order, 256 units of a cluster each
    (64, 8, 10, (True, 1, 8, 10)),  # 512: the last in pair order
    (65, 8, 10, (False, 1, 8, 10)),  # 520: the counting sort
    (256, 8, 10, (False, 1, 8, 10)),  # about one query a cluster
    (256, 32, 10, (False, 1, 16, 10)),  # about four
    (256, 256, 10, (False, 1, 16, 10)),  # about 33 (the calibration's widest): two units a cluster
    (8, 2000, 10, (False, 1, 8, 10)),  # the full probe: eight a cluster
    (256, 8, 65, (False, 1, 8, 768)),  # above the list: every row of a run
    (1, 8, 300, (True, 6, 8, 128)),
])
def test_layout_at_the_main_paths_shapes(b, nprobe, k, want):
    """How the wrapper cuts the 1M-doc arm's probes (2,000 clusters of 6
    groups) for a 132-SM card: (pair order, runs, query tile, list)."""
    assert tts._ivf_probe_layout(b, nprobe, 2000, 6, k, 132) == want


@pytest.mark.parametrize("nprobe", [1, 3, 12])
@pytest.mark.parametrize("tombstones", [False, True])
def test_search_batch_matches_the_reference(nprobe, tombstones):
    """``IvfDeviceIndex.search_batch`` (bf16 arm) against the reference's,
    run as its own tests run it on the CPU (its f32-query einsum): scores
    within the query's bf16 rounding (2^-9 for unit rows) and rows equal
    wherever no two candidates lie within 2^-8, the bound
    tests/test_torch_ivf.py states; tombstones as ``extra_row_mask``."""
    rng = np.random.default_rng(17 + nprobe)
    x = make_unit_rows(rng, 3000, 64)
    q = make_unit_rows(rng, 8, 64)
    ref = rivf.IvfDeviceIndex(x, n_clusters=12, seed=2)
    port = pivf.IvfDeviceIndex(x, n_clusters=12, device=torch.device("cpu"), seed=2)
    extra = np.where(rng.random(3000) < 0.2, NEG_INF, 0.0).astype(np.float32) if tombstones else None
    want = ref.search_batch(q, 10, nprobe=nprobe, extra_row_mask=None if extra is None else jnp.asarray(extra))
    got = port.search_batch(q, 10, nprobe=nprobe, extra_row_mask=None if extra is None else torch.from_numpy(extra))
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    gi, wi = got.indices.numpy(), np.asarray(want.indices)
    assert np.array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    assert np.abs(gs[fin] - ws[fin]).max() <= 2.0 ** -9
    for b in range(8):
        for j in np.flatnonzero(gi[b] != wi[b]):
            assert np.min(np.abs(ws[b] - gs[b, j])) <= 2.0 ** -8, (b, j)
    if tombstones:
        assert not set(gi[gi >= 0].tolist()) & set(np.flatnonzero(extra).tolist())
