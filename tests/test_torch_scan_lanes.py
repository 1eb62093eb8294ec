"""Every fast-tier scan lane ``TwoTierConfig`` can select, at every slab
dtype, held to the JAX reference on the CPU.

The ops: the f32 (and f16) slab through the hierarchical and per-tile
scans (the reference's Pallas kernels in interpret mode, the port's plain
twins), the Matryoshka two-pass scan and the packed int4 two-pass scan.
The searcher: ``search_batch`` over one artifact per slab dtype, opened by
both packages, for every ``scan_mode``; and the plumbing of
``ivf_nprobe``, ``mrl_search_dims`` and ``mrl_rescore_top_k`` into both
``search_batch`` and ``search()``.

Tolerances: indices equal and scores within 1e-6 relative, except where
two rows swap whose scores lie within 1e-6 (the two CPU backends sum f32
products in different orders); fused doc ids and RRF scores equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.core.config import TwoTierConfig as RefConfig
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHashEmbedder
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu.ops import topk_scan as jts
from frankensearch_tpu.ops.quantize import calibrate_int4 as ref_calibrate_int4
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig
from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
from frankensearch_tpu_torch.index import ivf as pivf
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.ops import topk_scan as tts
from frankensearch_tpu_torch.ops.quantize import calibrate_int4
from tests.test_torch_int8_scan import assert_equal_up_to_near_ties
from tests.test_torch_searcher import QUERIES, _docs, _results

CPU = torch.device("cpu")
DIM = 64
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f16": (jnp.float16, torch.float16),
          "f32": (jnp.float32, torch.float32)}
MODES = ("auto", "hierarchical", "pallas", "xla", "int8", "mrl", "ivf")


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _masked(n, live):
    mask = np.zeros(n, np.float32)
    mask[live:] = -np.inf
    mask[[3, 200, 577]] = -np.inf  # tombstones
    return mask


def _same(got, want):
    assert_equal_up_to_near_ties(got.scores.numpy(), got.indices.numpy(),
                                 np.asarray(want.scores), np.asarray(want.indices))


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f16", "f32"])
@pytest.mark.parametrize("lane,b,k", [("hierarchical", 8, 10), ("hierarchical", 16, 70),
                                      ("pallas", 1, 10), ("pallas", 8, 10), ("pallas", 8, 70)])
def test_f32_and_f16_slabs_match_reference_kernels(dtype, lane, b, k):
    """K1 + K2 (hierarchical; B % 8 == 0, where the reference rescores with
    its K2, not its f32-query XLA path) and K5 (pallas, 2048-row tiles; k =
    70 takes the wide entry) on slabs the tensor-core forms do not take on
    CUDA (f32) or take beside bf16 (f16)."""
    rng = np.random.default_rng(b * 100 + k)
    slab = _unit_rows(rng, 4096, 128)
    q = _unit_rows(rng, b, 128)
    mask = _masked(4096, 3900)
    jd, td = DTYPES[dtype]
    if lane == "hierarchical":
        want = jts.scan_topk_hierarchical(jnp.asarray(slab, jd), jnp.asarray(q), k, jnp.asarray(mask),
                                          tile_n=1024, group=128, rescore="pallas", interpret=True)
        got = tts.scan_topk_hierarchical(torch.from_numpy(slab).to(td), torch.from_numpy(q), k,
                                         torch.from_numpy(mask))
    else:
        want = jts.scan_topk_pallas(jnp.asarray(slab, jd), jnp.asarray(q), k, jnp.asarray(mask),
                                    tile_n=2048, interpret=True)
        got = tts.scan_topk_pallas(torch.from_numpy(slab).to(td), torch.from_numpy(q), k,
                                   torch.from_numpy(mask))
    _same(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("search_dims,rescore_top_k,k", [(32, 50, 10), (64, 30, 10), (16, 5, 12), (500, 30, 7)])
def test_mrl_matches_reference(dtype, search_dims, rescore_top_k, k):
    """The reference's MRL oracle (tests/test_ops_scan.py::TestMrl): energy
    concentrated in the leading dims, plus a mask; search_dims beyond d
    clamps to d, and a pool below k widens to k."""
    rng = np.random.default_rng(search_dims)
    decay = np.exp(-np.arange(128) / 16.0).astype(np.float32)
    slab = rng.standard_normal((600, 128)).astype(np.float32) * decay
    slab /= np.linalg.norm(slab, axis=1, keepdims=True)
    q = rng.standard_normal((6, 128)).astype(np.float32) * decay
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = _masked(600, 580)
    jd, td = DTYPES[dtype]
    want = jts.scan_topk_mrl(jnp.asarray(slab, jd), jnp.asarray(q), k, jnp.asarray(mask),
                             search_dims=search_dims, rescore_top_k=rescore_top_k)
    got = tts.scan_topk_mrl(torch.from_numpy(slab).to(td), torch.from_numpy(q), k, torch.from_numpy(mask),
                            search_dims=search_dims, rescore_top_k=rescore_top_k)
    _same(got, want)
    # pass 2 is exact at full dim against the f32 query (not the rounded one)
    rows = got.indices.numpy()
    exact = np.einsum("bd,bkd->bk", q, torch.from_numpy(slab).to(td).to(torch.float32).numpy()[rows])
    np.testing.assert_allclose(got.scores.numpy(), exact, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,mult", [(10, 6), (5, 1), (40, 6)])
def test_int4_two_pass_matches_reference(dtype, k, mult):
    """Pass 1 is exact int32 sums in both packages; pass 2 rounds the query
    to the exact slab's dtype (the reference's ``astype``)."""
    rng = np.random.default_rng(k * 7 + mult)
    slab = _unit_rows(rng, 900, 64)
    q = _unit_rows(rng, 5, 64)
    mask = _masked(900, 880)
    q4, rq4 = calibrate_int4(slab), ref_calibrate_int4(slab)
    np.testing.assert_array_equal(q4.packed, rq4.packed)
    jd, td = DTYPES[dtype]
    want = jts.scan_topk_int4_two_pass(jnp.asarray(rq4.packed), jnp.asarray(rq4.scale), jnp.asarray(slab, jd),
                                       jnp.asarray(q), k, jnp.asarray(mask), candidate_multiplier=mult)
    got = tts.scan_topk_int4_two_pass(torch.from_numpy(q4.packed), torch.from_numpy(q4.scale),
                                      torch.from_numpy(slab).to(td), torch.from_numpy(q), k,
                                      torch.from_numpy(mask), candidate_multiplier=mult)
    _same(got, want)
    if dtype != "f32":  # the rounded query, not the f32 one
        rows = got.indices.numpy()
        slab_t = torch.from_numpy(slab).to(td).to(torch.float32).numpy()
        q_r = torch.from_numpy(q).to(td).to(torch.float32).numpy()
        np.testing.assert_allclose(got.scores.numpy(), np.einsum("bd,bkd->bk", q_r, slab_t[rows]),
                                   rtol=1e-6, atol=1e-6)


def test_int4_pass_one_is_the_exact_int_product():
    """Pass 1's ranking keys: the int32 sums of the prepared query and the
    unpacked nibbles, exact (no float sums)."""
    rng = np.random.default_rng(5)
    slab = _unit_rows(rng, 300, 32)
    q4 = calibrate_int4(slab)
    from frankensearch_tpu_torch.ops.quantize import unpack_int4_device
    from frankensearch_tpu_torch.ops.vector_math import int8_matmul

    q_i8 = tts.prepare_query_int8(torch.from_numpy(_unit_rows(rng, 3, 32)), torch.from_numpy(q4.scale))
    unpacked = unpack_int4_device(torch.from_numpy(q4.packed))
    got = int8_matmul(unpacked, q_i8.T.contiguous()).T
    want = q_i8.numpy().astype(np.int64) @ unpacked.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the searcher, every scan mode at every slab dtype
# --------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def reference_kernels_interpreted(monkeypatch):
    """The reference's index calls its Pallas scans without ``interpret``;
    on the CPU they run only in interpret mode."""
    monkeypatch.setattr(jts, "scan_topk_pallas", functools.partial(jts.scan_topk_pallas, interpret=True))
    monkeypatch.setattr(jts, "scan_topk_hierarchical",
                        functools.partial(jts.scan_topk_hierarchical, interpret=True))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One artifact per slab dtype, written by the reference, opened by
    both packages; each fast tier carries an f32 IVF arm built by each
    package from the same rows."""
    docs = _docs()
    ref_emb, emb = RefHashEmbedder(dim=DIM), HashEmbedder(dim=DIM)
    vecs = ref_emb.embed_batch([d.content for d in docs])
    out = {"docs": docs, "ref_emb": ref_emb, "emb": emb}
    for dtype in DTYPES:
        root = str(tmp_path_factory.mktemp(f"lanes_{dtype}"))
        ref = RefIndex.create(root, vecs, [d.doc_id for d in docs], ref_emb.identity(),
                              slab_dtype=dtype, use_pallas=True)
        port = TwoTierIndex.open(root, device=CPU, slab_dtype=dtype)
        ref.fast.enable_ivf(dtype=jnp.float32, seed=0)
        port.fast.enable_ivf(dtype=torch.float32, seed=0)
        out[dtype] = (ref, port)
    return out


def _searchers(roots, dtype, **cfg):
    ref_index, port_index = roots[dtype]
    ref = RefSearcher(ref_index, roots["ref_emb"], config=RefConfig(fast_only=True, **cfg))
    port = TwoTierSearcher(port_index, roots["emb"], config=TwoTierConfig(fast_only=True, **cfg))
    return ref, port


def test_ivf_arms_are_the_reference_arms(roots):
    """The two packages' k-means, preferences and spill give the same
    cluster-sorted slab: equal row maps and sizes, centroids within 1e-6."""
    for dtype in DTYPES:
        ref, port = (r.fast._ivf for r in roots[dtype])
        assert (port.n_clusters, port.cap, port.groups_per_cluster) == (ref.n_clusters, ref.cap,
                                                                         ref.groups_per_cluster)
        np.testing.assert_array_equal(port.row_map, ref._row_map)
        np.testing.assert_allclose(port.centroids.numpy(), np.asarray(ref.centroids), atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_every_scan_mode_serves_like_the_reference(roots, mode, dtype):
    """``search_batch`` over the batch and each query alone: equal doc ids
    and fused scores, fast scores within 1e-6 relative. One stated
    exception (ROADMAP queue 3): off its TPU the reference's hierarchical
    lane rescores a bf16/f16 slab with the f32 query (its K2 only at B % 8
    == 0 and at most 12 MB of scratch), the port with the query rounded to
    the slab dtype (K2 everywhere). Each fast score then moves by at most
    ||q - round(q)|| ||x|| <= u * 1.01 for unit rows (u = 2^-9 bf16, 2^-12
    f16, the unit roundoff; 1.01 covers the rounded row's norm)."""
    ref, port = _searchers(roots, dtype, scan_mode=mode)
    atol = {"bf16": 2.0 ** -9, "f16": 2.0 ** -12}.get(dtype, 0.0) * 1.01 if mode == "hierarchical" else 0.0
    for batch in [QUERIES] + [[q] for q in QUERIES if q][:4]:
        for k in (1, 10):
            got, want = port.search_batch(batch, k=k), ref.search_batch(batch, k=k)
            assert _results(got) == _results(want), (batch, k)
            np.testing.assert_allclose([r.fast_score for o in got for r in o.results],
                                       [r.fast_score for o in want for r in o.results], rtol=1e-6, atol=atol)


def _spy(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)
    return calls


@pytest.mark.parametrize("entry", ["search_batch", "search"])
def test_ivf_nprobe_reaches_the_arm(roots, monkeypatch, entry):
    """``ivf_nprobe`` reaches the IVF probe from both entry points (it was
    dropped before), and the results are the reference's."""
    ref, port = _searchers(roots, "bf16", scan_mode="ivf", ivf_nprobe=2)
    calls = _spy(monkeypatch, pivf.IvfDeviceIndex, "search_batch")
    for q in [q for q in QUERIES if q][:4]:
        if entry == "search":
            got, want = port.search(q, k=10), ref.search(q, k=10)
            assert [(r.doc_id, r.score) for r in got.results] == [(r.doc_id, r.score) for r in want.results]
        else:
            assert _results(port.search_batch([q], k=10)) == _results(ref.search_batch([q], k=10))
    assert calls and all(c["nprobe"] == 2 for c in calls)
    # a narrower probe than the default changes what the lane sees
    narrow = port.search_batch(QUERIES, k=10)
    wide = _searchers(roots, "bf16", scan_mode="ivf")[1].search_batch(QUERIES, k=10)
    assert _results(narrow) != _results(wide)


@pytest.mark.parametrize("entry", ["search_batch", "search"])
def test_mrl_settings_reach_the_scan(roots, monkeypatch, entry):
    """``mrl_search_dims`` selects the MRL lane and sets its pass-1 dims in
    both entry points; ``search()`` also passes ``mrl_rescore_top_k`` (the
    reference's ``search_batch`` does not: its pool stays 30)."""
    ref, port = _searchers(roots, "f32", mrl_search_dims=16, mrl_rescore_top_k=12)
    calls = _spy(monkeypatch, tts, "scan_topk_mrl")
    for q in [q for q in QUERIES if q][:4]:
        if entry == "search":
            got, want = port.search(q, k=10), ref.search(q, k=10)
            assert [(r.doc_id, r.score) for r in got.results] == [(r.doc_id, r.score) for r in want.results]
        else:
            assert _results(port.search_batch([q], k=10)) == _results(ref.search_batch([q], k=10))
    assert calls and all(c["search_dims"] == 16 for c in calls)
    assert all(c["rescore_top_k"] == (12 if entry == "search" else 30) for c in calls)


def test_auto_resolves_before_the_mrl_check(roots):
    """As in the reference, ``mode="auto"`` resolves to the exact scan
    before the MRL check: ``mrl_search_dims`` alone selects nothing."""
    ref, port = (r.fast for r in roots["f32"])
    qv = roots["emb"].embed_batch([q for q in QUERIES if q])
    got = port.search_batch(qv, 10, mrl_search_dims=8)
    want_auto = ref.search_batch(qv, 10, mrl_search_dims=8)
    exact = port.search_batch(qv, 10, mode="xla")
    _same(got, want_auto)
    assert torch.equal(got.indices, exact.indices)
