"""The port on an NVIDIA GPU: kernels K1-K6 and K2's int8 form against
their plain twins (K6's selection also alone, on crafted maxima), the deterministic lanes (dense, pruned and DAAT BM25,
device RRF) bitwise against the CPU, the int8 and per-tile scan lanes
against their CPU twin pipelines, the A/B scan's K6 route bitwise against
the K1/K2 route, the Model2Vec pool and bag lane against the CPU, the
pool's kernel against its twin on the card and on the CPU, K1 and
K2 at the quality tier's width (384), the int8 GEMM behind the encoder at
padded shapes (exact), the trained 384 encoder's forward against the
CPU (f32, bf16, int8), the f32 forms of K1, K2 and K5 against their twins
(K5's candidates and K1's maxima the same bits, a row's bits independent
of its batch), K2 and K2-ivf (the IVF probe's kernel: pair order, a hot
cluster over 64 queries, the full probe, k up to 300, a masked cluster, a
width not a multiple of 64, ids outside the arm) at the IVF probe's
shapes, and the MRL, int4 and IVF lanes against the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

``PYTHONPATH=ROOT python tests/test_torch_kernels_cuda.py`` prints the K2,
K2-i8 and K5-f32 digests (``K2_DIGESTS``, ``K2I8_DIGESTS``,
``K5F32_DIGESTS``) that the port package under ROOT gives on the card, for
pinning them from an earlier tree.

Tolerances: K1/K2/K2-i8/K5/K6 vs twin 1e-5 relative (bf16 and int8
products are exact; the tensor-core and warp sums run in another order
than the twins', so K5, K6's group ids and the scan lanes may also swap
near ties); K5's scores and K6's maxima are K1's bits (K5 scores with
K1's body, K6 with K1's kernel), and on inputs whose every score is exact
in f32 K5 is bitwise its twin; K6's selection does no arithmetic, so it is
bitwise its twin (the argmax passes) on any maxima; K4's int32
sums are exact, so it is bitwise; the Model2Vec pool is elementwise f32
adds in a fixed order, within 1e-6 of the CPU, and its kernel takes its
twin's rounded steps in the twin's order, so it is bitwise; K3 sums
in its twin's order with unfused products and adds, then adds the hot
partial, masks and reduces as the twin does, so it is bitwise; the
BM25 and RRF lanes are order-pinned f32 adds (the pruned lane's exact
FMA included), so GPU and CPU agree bit for bit. The hot partial is a
cuBLAS product and is not compared bitwise across devices.
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.lexical import device_bm25, hot_arm
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from frankensearch_tpu_torch.embed import bulk, model2vec
from frankensearch_tpu_torch.ops import ab_primitives, device_rrf, topk_scan
from frankensearch_tpu_torch.ops.quantize import calibrate_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from frankensearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b", [1, 8, 70])
def test_kernels_match_twins(cuda_device, b, dtype):
    gen = torch.Generator(device="cpu").manual_seed(b)
    slab = torch.randn(16384, 256, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(cuda_device, dtype)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    mask = torch.zeros(16384, device=cuda_device)
    mask[16000:] = float("-inf")
    launches = (topk_scan.group_max.launches, topk_scan.gather_rescore.launches)
    gm, gp = topk_scan.group_max(slab, q, mask), topk_scan.group_max_plain(slab, q, mask)
    torch.testing.assert_close(gm, gp, rtol=1e-5, atol=1e-5)
    groups = torch.topk(gm, 12, dim=1).indices.to(torch.int32)
    r = topk_scan.gather_rescore(slab, q, groups)
    torch.testing.assert_close(r, topk_scan.gather_rescore_plain(slab, q, groups), rtol=1e-5, atol=1e-5)
    assert (topk_scan.group_max.launches, topk_scan.gather_rescore.launches) == (
        launches[0] + 1, launches[1] + 1,
    )
    hier = topk_scan.scan_topk_hierarchical(slab, q, 10, mask)
    plain = topk_scan.scan_topk_xla(slab, q, 10, mask)
    torch.testing.assert_close(hier.scores, plain.scores, rtol=1e-5, atol=1e-5)


def test_kernels_reject_unsupported_operands(cuda_device):
    """An f64 slab has no kernel form (f32 has one since the scan lanes took
    f32 slabs): the wrapper raises, and launches nothing."""
    slab = torch.zeros(256, 64, dtype=torch.float64, device=cuda_device)
    launches = topk_scan.group_max.launches
    with pytest.raises(ValueError, match="bf16/f16/f32"):
        topk_scan.group_max(slab, torch.zeros(1, 64, device=cuda_device), torch.zeros(256, device=cuda_device))
    assert topk_scan.group_max.launches == launches


def test_dense_bm25_bitwise_cpu_vs_gpu(cuda_device):
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(200)]
    p = 1.0 / np.arange(1, 201) ** 1.1
    p /= p.sum()
    docs = [
        IndexableDocument(doc_id=f"d{i:04d}", content=" ".join(rng.choice(words, size=30, p=p)))
        for i in range(300)
    ]
    queries = ["w1 w2", "w3", "w50 w7 w9", "w0 w11 w12 w13"]
    cpu = BulkDeviceBm25Index(docs, device=torch.device("cpu"))
    gpu = BulkDeviceBm25Index(docs, device=cuda_device)
    want = [[(c.doc_id, c.score) for c in r] for r in cpu.search_candidates_batch(queries, 25)]
    got = [[(c.doc_id, c.score) for c in r] for r in gpu.search_candidates_batch(queries, 25)]
    assert got == want


def test_device_rrf_bitwise_cpu_vs_gpu(cuda_device):
    rng = np.random.default_rng(5)
    b, kl, kv, n = 16, 30, 30, 400
    lex_i = np.stack([rng.choice(n, kl, replace=False) for _ in range(b)]).astype(np.int32)
    lex_s = np.sort(rng.uniform(0.1, 9.0, (b, kl)).astype(np.float32), axis=1)[:, ::-1].copy()
    lex_s[:, -3:] = 0.0
    vec_i = np.stack([rng.choice(n, kv, replace=False) for _ in range(b)]).astype(np.int32)
    row_map = np.arange(n, dtype=np.int32)
    parts = device_rrf.make_contrib_tables(np.full(b, 60.0), kl, kv, 1.0, np.full(b, 1.0))

    def run(dev):
        t = [torch.from_numpy(x).to(dev) for x in (lex_i, lex_s, vec_i, row_map, *parts)]
        return [x.cpu() for x in device_rrf.rrf_tail(*t, limit=10)]

    for got, want in zip(run(cuda_device), run(torch.device("cpu"))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,t_q,l_c", [(1, 8, 4), (8, 8, 12), (70, 16, 8)])
def test_flat_score_matches_twin_bitwise(cuda_device, b, t_q, l_c):
    """K3 (the fused class step) against its twin: masked scores, group
    maxima and group rows, with and without a hot partial, padding slots
    and an all-padding group included."""
    gen = np.random.default_rng(b + t_q)
    n_c, d_pad, vocab, off = 3, 384, 50, 256
    term = gen.integers(-1, vocab, size=(n_c, l_c, d_pad)).astype(np.int32)
    tf = np.where(term >= 0, gen.uniform(0.1, 3.0, term.shape), 0.0).astype(np.float32)
    ids = gen.integers(0, vocab, size=(b, t_q)).astype(np.int32)
    w = gen.uniform(0.1, 9.0, size=(b, t_q)).astype(np.float32)
    w[:, -2:] = 0.0  # padding terms: id 0, weight 0
    ids[:, -2:] = 0
    ids[:, 1] = ids[:, 0]  # a repeated term id
    dmap = np.arange(n_c * d_pad, dtype=np.int32).reshape(n_c, d_pad)
    dmap[0, 128:256] = -1  # an all-padding group
    dmap[2, 300:] = -1
    hot = gen.uniform(0.0, 2.0, size=(b, off + n_c * d_pad + 128)).astype(np.float32)
    for s_phys in (torch.from_numpy(hot), None):
        args = [torch.from_numpy(x) for x in (term, tf, ids, w)] + [s_phys, off, torch.from_numpy(dmap)]
        want = device_bm25.flat_class_fused_plain(*args)
        on_card = [x.to(cuda_device) if isinstance(x, torch.Tensor) else x for x in args]
        launches = device_bm25.flat_class_fused.launches
        got = device_bm25.flat_class_fused(*on_card)
        torch.cuda.synchronize()
        assert device_bm25.flat_class_fused.launches == launches + 1
        plain_on_card = device_bm25.flat_class_fused_plain(*on_card)
        for g, c, x in zip(got, plain_on_card, want):
            assert torch.equal(g.cpu().view(torch.int32), x.view(torch.int32))
            assert torch.equal(c.cpu().view(torch.int32), x.view(torch.int32))


def _blocked_docs():
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    return [
        IndexableDocument(doc_id=f"d{i:04d}", content=" ".join(rng.choice(words, size=int(rng.integers(3, 60)), p=p)))
        for i in range(400)
    ]


@pytest.mark.parametrize("hot", [True, False])
def test_blocked_lanes_bitwise_cpu_vs_gpu(cuda_device, monkeypatch, hot):
    """Blocked scale (thresholds lowered): the pruned lane (hot arm off) and
    the split layout's DAAT and flat lanes for queries without hot terms
    give the same bits on the card as on the CPU."""
    monkeypatch.setattr(device_bm25, "BLOCKED_THRESHOLD_POSTINGS", 1)
    monkeypatch.setattr(device_bm25, "DEFAULT_BLOCK_POSTINGS", 512)
    monkeypatch.setattr(hot_arm, "HOT_MIN_POSTINGS", 1 if hot else 1 << 60)
    monkeypatch.setattr(hot_arm, "HOT_MAX_TERMS", 6)
    docs = _blocked_docs()
    cpu = BulkDeviceBm25Index(docs, device=torch.device("cpu"))
    gpu = BulkDeviceBm25Index(docs, device=cuda_device)
    queries = ["w250", "w40 w41 w42", "w100 w120 w140 w160 w180 w200 w220 w240 w260", "w290 w291"]
    if hot:
        ids, w = cpu._query_sparse_rows(queries)
        assert not (hot_arm.split_hot_rows(cpu._hot.hot_row_of, ids, w, cpu._hot.h_pad) > 0).any()
    for mode in ("daat", "blocked"):
        cpu.daat_mode = gpu.daat_mode = mode
        want = [[(c.doc_id, c.score) for c in r] for r in cpu.search_candidates_batch(queries, 25)]
        got = [[(c.doc_id, c.score) for c in r] for r in gpu.search_candidates_batch(queries, 25)]
        assert got == want, mode
        assert gpu.last_blocks_skipped == cpu.last_blocks_skipped


def _unit_slab(seed, n=16384, d=256):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    slab = torch.randn(n, d, generator=gen)
    mask = torch.zeros(n)
    mask[n - 384 :] = float("-inf")
    return slab / slab.norm(dim=1, keepdim=True), mask, gen


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b", [1, 8, 256])
def test_group_max_int8_bitwise(cuda_device, b, d):
    gen = torch.Generator(device="cpu").manual_seed(b + d)
    slab = torch.randint(-127, 128, (16384, d), generator=gen, dtype=torch.int8)
    slab[:3] = 127  # the largest sums
    q = torch.randint(-127, 128, (b, d), generator=gen, dtype=torch.int8)
    q[0] = 127
    mask = torch.zeros(16384)
    mask[16000:] = float("-inf")
    launches = topk_scan.group_max_int8.launches
    got = topk_scan.group_max_int8(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device))
    torch.cuda.synchronize()
    assert topk_scan.group_max_int8.launches == launches + 1
    want = topk_scan.group_max_int8_plain(slab, q, mask)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    on_card = topk_scan.group_max_int8_plain(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device))
    assert torch.equal(got.view(torch.int32), on_card.view(torch.int32))


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("d", [384, 1024])
@pytest.mark.parametrize("b", [70, 300])
def test_group_max_int8_bitwise_at_the_exactness_limit(cuda_device, b, d, graded):
    """K4 at ragged query tiles (B = 70, 300) and widths up to d = 1024,
    where all-127 rows give the largest sum that is still exact in f32
    (127 * 127 * 1024 < 2^24), of both signs. A mask of 0 and -inf takes
    the kernel's int32 max; ``graded`` adds finite nonzero mask values on
    some rows, whose warps take the f32 path, in the same launch."""
    gen = torch.Generator(device="cpu").manual_seed(b * d)
    slab = torch.randint(-127, 128, (8192, d), generator=gen, dtype=torch.int8)
    slab[:5] = 127
    slab[200:203] = -127
    q = torch.randint(-127, 128, (b, d), generator=gen, dtype=torch.int8)
    q[0] = 127
    q[b - 1] = -127
    mask = torch.zeros(8192)
    mask[1::7] = float("-inf")
    mask[7936:] = float("-inf")  # a masked group
    if graded:
        mask[3::11] = -0.5
        mask[4::97] = 0.25
    got = topk_scan.group_max_int8(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device)).cpu()
    want = topk_scan.group_max_int8_plain(slab, q, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert want[0, 0] == 127 * 127 * d and want[b - 1, 1] == 127 * 127 * d


@pytest.mark.parametrize("d", [8, 12304])
def test_gather_rescore_i8_rejects_widths_outside_the_kernel(cuda_device, d):
    """K2-i8 takes d % 16 == 0 with 16 <= d <= 12288; the wrapper raises on
    a card tensor outside that (no twin to fall back to)."""
    slab = torch.zeros(256, d, dtype=torch.int8, device=cuda_device)
    q = torch.zeros(2, d, device=cuda_device)
    groups = torch.zeros(2, 1, dtype=torch.int32, device=cuda_device)
    launches = topk_scan.gather_rescore_i8.launches
    with pytest.raises(ValueError, match="16 <= dim <= 12288"):
        topk_scan.gather_rescore_i8(slab, q, groups)
    assert topk_scan.gather_rescore_i8.launches == launches


@pytest.mark.parametrize("tile_n,t", chip_smoke.SELECT_EDGES)
def test_tile_select_bitwise_to_argmax_passes(cuda_device, tile_n, t):
    """K6's selection kernel on crafted maxima (equal maxima in a tile,
    +0.0 and -0.0 in one tie class in both orders, -inf groups between
    finite ones, a fully masked tile), values and group ids bitwise the
    argmax passes' on the CPU."""
    gm = torch.from_numpy(chip_smoke.crafted_maxima(70, 4, tile_n // 128, seed=tile_n + t))
    got_v, got_g = topk_scan.tile_select(gm.to(cuda_device), t, tile_n)
    want_v, want_g = topk_scan.tile_select_plain(gm, t, tile_n)
    assert torch.equal(got_g.cpu(), want_g)
    assert torch.equal(got_v.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.parametrize("b,kk", [(1, 12), (8, 60), (70, 30)])
def test_gather_rescore_i8_matches_twin(cuda_device, b, kk):
    gen = torch.Generator(device="cpu").manual_seed(b * kk)
    slab = torch.randint(-127, 128, (16384, 256), generator=gen, dtype=torch.int8).to(cuda_device)
    q = (torch.randn(b, 256, generator=gen) * 0.01).to(cuda_device)
    groups = torch.sort(torch.stack([torch.randperm(128, generator=gen)[:kk] for _ in range(b)]), dim=1)
    groups = groups.values.to(torch.int32).to(cuda_device)
    launches = topk_scan.gather_rescore_i8.launches
    got = topk_scan.gather_rescore_i8(slab, q, groups)
    assert topk_scan.gather_rescore_i8.launches == launches + 1
    torch.testing.assert_close(got, topk_scan.gather_rescore_i8_plain(slab, q, groups), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,kk", [(1, 10), (8, 60), (70, 30)])
def test_tile_topk_matches_twin(cuda_device, b, kk, dtype):
    slab, mask, gen = _unit_slab(b + kk)
    mask[2048 + 3 : 4096] = float("-inf")  # tile 1 holds 3 live rows: it runs out
    slab, mask = slab.to(cuda_device, dtype), mask.to(cuda_device)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    launches = topk_scan.tile_topk.launches
    got_s, got_i = topk_scan.tile_topk(slab, q, mask, kk)
    torch.cuda.synchronize()
    assert topk_scan.tile_topk.launches == launches + 1
    want_s, want_i = topk_scan.tile_topk_plain(slab, q, mask, kk)
    chip_smoke.check_close(got_s, want_s, "K5 scores")
    chip_smoke.check_tile_rows(slab, q, mask, got_s, got_i, "K5 rows")
    spent = ~torch.isfinite(got_s)
    assert bool(spent[1, 3:].all()) and torch.equal(got_i[spent], want_i[spent])


def _same_up_to_near_ties(got, want, rel=1e-5):
    torch.testing.assert_close(got.scores.cpu(), want.scores.cpu(), rtol=rel, atol=rel)
    gi, wi, ws = got.indices.cpu(), want.indices.cpu(), want.scores.cpu()
    for b, j in (gi != wi).nonzero().tolist():
        near = (ws[b] - ws[b, j]).abs() <= rel * max(abs(float(ws[b, j])), 1.0)
        assert int(gi[b, j]) in set(wi[b][near].tolist()), (b, j)


@pytest.mark.parametrize("k", [10, 60])
def test_int8_and_tile_lanes_gpu_vs_cpu(cuda_device, k):
    """The capacity lane (K4 + K2-i8) and the per-tile lane (K5) against
    the same lanes on the CPU, where the twins run."""
    slab, mask, gen = _unit_slab(k)
    q = torch.randn(13, 256, generator=gen)
    arm = calibrate_int8(slab.numpy())
    i8, scale = torch.from_numpy(arm.values), torch.from_numpy(arm.scale)
    cpu = topk_scan.scan_topk_hierarchical_int8(i8, scale, q, k, mask)
    gpu = topk_scan.scan_topk_hierarchical_int8(
        i8.to(cuda_device), scale.to(cuda_device), q.to(cuda_device), k, mask.to(cuda_device)
    )
    _same_up_to_near_ties(gpu, cpu)
    bf = slab.to(torch.bfloat16)
    cpu = topk_scan.scan_topk_pallas(bf, q, k, mask)
    gpu = topk_scan.scan_topk_pallas(bf.to(cuda_device), q.to(cuda_device), k, mask.to(cuda_device))
    _same_up_to_near_ties(gpu, cpu)


#: sha256 of K1's output bits on _k1_input's seeded data, as the kernel
#: gave them before its scoring body moved to group_scan.cuh (H100, nvcc
#: 12.8): the move must not change a bit
K1_DIGESTS = {
    ("torch.bfloat16", 70): "3571d87c8b52fa7f0ac303daa280375ed20ee22019b6ae6556084d942c112837",
    ("torch.float16", 256): "cf777e37e38aeda57eb7664b528cfeb8982c98927ae9213959fce47d381f9ff4",
    ("torch.bfloat16", 1): "b804c639aae174ab4ca3cc51c2ef77c64104fece141247702c2e70c1728f39f1",
}


def _k1_input(dtype, b):
    gen = torch.Generator(device="cpu").manual_seed(20261016)
    slab = torch.randn(16384, 256, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(dtype)
    q = torch.randn(b, 256, generator=gen)
    mask = torch.zeros(16384)
    mask[16000:] = float("-inf")
    return slab, q, mask


@pytest.mark.parametrize("dtype,b", [(torch.bfloat16, 70), (torch.float16, 256), (torch.bfloat16, 1)])
def test_group_max_bits_unchanged_by_the_header_split(cuda_device, dtype, b):
    slab, q, mask = _k1_input(dtype, b)
    out = topk_scan.group_max(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device)).cpu()
    digest = hashlib.sha256(out.view(torch.int32).numpy().tobytes()).hexdigest()
    assert digest == K1_DIGESTS[(str(dtype), b)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("kk", [1, 2, 7, 64, 65, 2048])
def test_tile_topk_edges_bitwise(cuda_device, kk, dtype):
    """K5 on chip_smoke's adversarial tiles (every score exact in f32):
    rows and score bits equal to the twin's through both entries (the
    threshold list up to kk = 64, the wide entry above), and each first
    candidate is K1's tile maximum bit for bit."""
    slab, q, mask = (torch.from_numpy(x) for x in chip_smoke.adversarial_tile_inputs(4, 256, 70, seed=kk))
    slab = slab.to(dtype)
    want_s, want_i = topk_scan.tile_topk_plain(slab, q, mask, kk)
    slab, q, mask = slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device)
    launches, wide = topk_scan.tile_topk.launches, topk_scan.tile_topk.wide_launches
    got_s, got_i = topk_scan.tile_topk(slab, q, mask, kk)
    torch.cuda.synchronize()
    assert topk_scan.tile_topk.launches == launches + 1
    assert topk_scan.tile_topk.wide_launches == wide + (kk > topk_scan.TILE_TOPK_LIST_K)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_s.cpu().view(torch.int32), want_s.view(torch.int32))
    k1_first = topk_scan.group_max(slab, q, mask).view(70, 4, 16).amax(dim=2)
    assert torch.equal(got_s[:, 0, :].T.contiguous().view(torch.int32), k1_first.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [1, 8, 256])
def test_group_candidates_matches_twin_and_k1(cuda_device, b, dtype):
    slab, mask, gen = _unit_slab(b)
    mask[8192 + 3 * 128 :] = float("-inf")  # the last tile runs out after 3 groups
    slab, mask = slab.to(cuda_device, dtype), mask.to(cuda_device)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    launches = (topk_scan.group_candidates.launches, topk_scan.group_max.launches)
    got_v, got_g = topk_scan.group_candidates(slab, q, mask, 60, 8192)
    torch.cuda.synchronize()
    # one K6 launch; K1's kernel runs inside it and is not counted as K1
    assert (topk_scan.group_candidates.launches, topk_scan.group_max.launches) == (launches[0] + 1, launches[1])
    want_v, want_g = topk_scan.group_candidates_plain(slab, q, mask, 60, 8192)
    chip_smoke.check_close(got_v, want_v, "K6 values")
    chip_smoke.check_group_ids(topk_scan.group_max_plain(slab, q, mask), got_g, want_g, "K6 group ids")
    gm = topk_scan.group_max(slab, q, mask)  # K6's maxima are K1's bits
    k1 = gm[torch.arange(b, device=cuda_device)[None, None, :].expand_as(got_g), got_g.long()]
    fin = torch.isfinite(got_v)
    assert torch.equal(k1[fin].view(torch.int32), got_v[fin].view(torch.int32))
    assert bool((got_g[1, 3:] == 64).all()) and not bool(fin[1, 3:].any())  # exhausted: group 0 of tile 1


@pytest.mark.parametrize("b,k", [(1, 10), (8, 60), (256, 30)])
def test_ab_tile_topk_route_bitwise_to_k1_route(cuda_device, b, k):
    slab, mask, gen = _unit_slab(b + k, n=8192 * 4)
    slab, mask = slab.to(cuda_device, torch.bfloat16), mask.to(cuda_device)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    want = topk_scan.scan_topk_hierarchical(slab, q, k, mask)
    for kw in ({"emit": "tile_topk"}, {"emit": "tile_topk", "tile_n": 2048}, {"group_select": "iter"}):
        got = ab_primitives.scan_topk_hierarchical_ab(slab, q, k, mask, **kw)
        assert torch.equal(got.indices, want.indices), kw
        assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32)), kw


def test_model2vec_pool_and_bag_lane_gpu_vs_cpu(cuda_device):
    words = [f"w{i}" for i in range(500)]
    rng = np.random.default_rng(3)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(0, 60)))) for _ in range(300)]
    cpu = model2vec.random_model2vec(words, dim=256, seed=1, device=torch.device("cpu"))
    gpu = model2vec.random_model2vec(words, dim=256, seed=1, device=cuda_device)
    ids, msk = cpu.tokenize_batch(texts)
    want = model2vec.gather_pool_normalize(cpu._emb, torch.from_numpy(ids), torch.from_numpy(msk))
    got = model2vec.gather_pool_normalize(gpu._emb, torch.from_numpy(ids).to(cuda_device),
                                          torch.from_numpy(msk).to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    bag_cpu = bulk.bag_embed_corpus(cpu, texts, chunk_docs=128)
    bag_gpu = bulk.bag_embed_corpus(gpu, texts, chunk_docs=128)
    np.testing.assert_array_equal(bag_gpu.view(np.uint32), bulk.bag_embed_corpus(gpu, texts, chunk_docs=128).view(np.uint32))
    np.testing.assert_allclose(bag_gpu, bag_cpu, rtol=0, atol=1e-6)


def _pool_input(seed: int, b: int, t: int, d: int, dtype, *, prefix: bool = True, v: int = 1000):
    """A signed (v, d) table and (b, t) int32 ids and 0/1 mask: prefix masks
    of every length 0 .. t (row 0 empty), or random masks over real ids;
    padding ids are 0 and masked ids are real rows, so the gathered zeros
    carry both signs."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, v, size=(b, t)).astype(np.int32)
    if prefix:
        lens = rng.integers(0, t + 1, size=b)
        lens[0] = 0
        mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
        ids[mask == 0] = 0
    else:
        mask = (rng.random((b, t)) < 0.5).astype(np.int32)
        mask[0] = 0
    return table, torch.from_numpy(ids), torch.from_numpy(mask)


def _same_bits(got, want) -> bool:
    return torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 256, 384, 1024])
@pytest.mark.parametrize("t", [16, 32, 64, 128, 256, 512])
def test_embed_pool_bitwise_to_twin(cuda_device, t, d, dtype):
    """The pool kernel gives its plain twin's bits on the same card, at every
    bucket, with prefix and scattered masks and rows of no token."""
    for b in (1, 7, 64, 300):
        for prefix in (True, False):
            table, ids, mask = _pool_input(b * t + d, b, t, d, dtype, prefix=prefix)
            table, ids, mask = table.to(cuda_device), ids.to(cuda_device), mask.to(cuda_device)
            got = model2vec.gather_pool_normalize(table, ids, mask)
            want = model2vec.gather_pool_normalize_plain(table, ids, mask)
            assert _same_bits(got, want), (b, prefix)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embed_pool_empty_rows_keep_the_twins_zero_signs(cuda_device, dtype):
    """Rows with no token: every product is a signed zero, and the sum's sign
    follows the gathered rows' signs as the twin's adds give it."""
    d, t = 256, 16
    signs = torch.tensor([[-1.0] * d, [1.0] * d, [-1.0] * (d // 2) + [1.0] * (d // 2)], dtype=dtype)
    ids = torch.tensor([[0] * t, [1] * t, [0, 1] * (t // 2), [2] * t, [0] * (t - 1) + [1]], dtype=torch.int32)
    mask = torch.zeros_like(ids)
    table, ids, mask = signs.to(cuda_device), ids.to(cuda_device), mask.to(cuda_device)
    got = model2vec.gather_pool_normalize(table, ids, mask)
    want = model2vec.gather_pool_normalize_plain(table, ids, mask)
    assert _same_bits(got, want)
    assert not bool(got.any())
    assert bool(torch.signbit(got[0]).all()) and not bool(torch.signbit(got[1]).any())


def test_embed_pool_bitwise_to_the_cpu(cuda_device):
    """The kernel on the card gives the twin's bits on the CPU (IEEE steps,
    each rounded once, in one order on both)."""
    for prefix in (True, False):
        table, ids, mask = _pool_input(5, 64, 32, 256, torch.bfloat16, prefix=prefix)
        want = model2vec.gather_pool_normalize(table, ids, mask)
        got = model2vec.gather_pool_normalize(table.to(cuda_device), ids.to(cuda_device), mask.to(cuda_device))
        assert _same_bits(got.cpu(), want), prefix


def test_embed_pool_row_bits_alone_in_a_batch_and_in_a_larger_bucket(cuda_device):
    table, ids, mask = _pool_input(9, 64, 16, 256, torch.bfloat16)
    table, ids, mask = table.to(cuda_device), ids.to(cuda_device), mask.to(cuda_device)
    batch = model2vec.gather_pool_normalize(table, ids, mask)
    wide = model2vec.gather_pool_normalize(
        table, torch.nn.functional.pad(ids, (0, 496)), torch.nn.functional.pad(mask, (0, 496)))
    assert _same_bits(wide, batch)
    for j in (0, 1, 31, 63):
        alone = model2vec.gather_pool_normalize(table, ids[j : j + 1].contiguous(), mask[j : j + 1].contiguous())
        assert _same_bits(alone, batch[j : j + 1]), j


def test_embed_pool_counts_one_launch_a_call(cuda_device):
    gpu = model2vec.random_model2vec([f"w{i}" for i in range(50)], dim=64, seed=1, device=cuda_device)
    before = model2vec.gather_pool_normalize.launches
    _, ids, mask = _pool_input(3, 8, 16, 64, torch.bfloat16, v=50)
    model2vec.gather_pool_normalize(gpu._emb, ids.to(cuda_device), mask.to(cuda_device))
    assert model2vec.gather_pool_normalize.launches == before + 1
    gpu.embed_batch(["w1 w2", "w3"])
    torch.cuda.synchronize()
    assert model2vec.gather_pool_normalize.launches == before + 2
    model2vec.gather_pool_normalize_plain(gpu._emb, ids.to(cuda_device), mask.to(cuda_device))
    assert model2vec.gather_pool_normalize.launches == before + 2


def test_embed_pool_rejects_unsupported_operands(cuda_device):
    table, ids, mask = _pool_input(4, 2, 16, 64, torch.bfloat16)
    table, ids, mask = table.to(cuda_device), ids.to(cuda_device), mask.to(cuda_device)
    with pytest.raises(ValueError):
        model2vec.gather_pool_normalize(table, ids.long(), mask)
    with pytest.raises(ValueError):
        model2vec.gather_pool_normalize(table.double(), ids, mask)
    with pytest.raises(ValueError):
        model2vec.gather_pool_normalize(table, ids, mask[:, :8])
    with pytest.raises(ValueError):
        model2vec.gather_pool_normalize(table, ids.cpu(), mask)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_group_max_row_bits_independent_of_batch(cuda_device, dtype):
    """A query's K1 row is the same bits at B = 1, 8 and 256, whatever
    query tile width and tile position it lands in."""
    slab, q, mask = _k1_input(dtype, 256)
    slab, q, mask = slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device)
    full = topk_scan.group_max(slab, q, mask).view(torch.int32)
    for b in (1, 8):
        for start in (0, 5, 129, 255 - b + 1):
            part = topk_scan.group_max(slab, q[start : start + b].contiguous(), mask).view(torch.int32)
            assert torch.equal(part, full[start : start + b]), (b, start)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 256, 768])
@pytest.mark.parametrize("b", [1, 3, 63, 65, 256, 300])
def test_k1_k2_edge_shapes_match_twins(cuda_device, b, d, dtype):
    """Query counts around K1's tile widths (8 .. 256, two tiles at 300)
    and dims that shrink the tile (768: 64 queries); K2 on K1's top groups,
    K2's lanes holding 1 (d <= 256) or 4 (768) chunks of a row."""
    gen = torch.Generator(device="cpu").manual_seed(b * 1000 + d)
    slab = torch.randn(4096, d, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(cuda_device, dtype)
    q = torch.randn(b, d, generator=gen).to(cuda_device)
    mask = torch.zeros(4096, device=cuda_device)
    mask[4000:] = float("-inf")
    gm = topk_scan.group_max(slab, q, mask)
    chip_smoke.check_close(gm, topk_scan.group_max_plain(slab, q, mask), "K1")
    groups = torch.sort(torch.topk(gm, 20, dim=1).indices.to(torch.int32), dim=1).values
    r = topk_scan.gather_rescore(slab, q, groups)
    chip_smoke.check_close(r, topk_scan.gather_rescore_plain(slab, q, groups), "K2")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_one_group_and_masked_group(cuda_device, dtype):
    """A one-group slab (one item for one block), and a group whose every
    row is masked: K1 gives -inf there; K2, which takes no mask, scores it."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    for n in (128, 1024):
        slab = torch.randn(n, 256, generator=gen).to(cuda_device, dtype)
        q = torch.randn(5, 256, generator=gen).to(cuda_device)
        mask = torch.zeros(n, device=cuda_device)
        mask[:128] = float("-inf")  # group 0 fully masked
        gm = topk_scan.group_max(slab, q, mask)
        assert bool(torch.isneginf(gm[:, 0]).all())
        chip_smoke.check_close(gm, topk_scan.group_max_plain(slab, q, mask), f"K1 n={n}")
        groups = torch.zeros(5, 1, dtype=torch.int32, device=cuda_device)
        r = topk_scan.gather_rescore(slab, q, groups)
        chip_smoke.check_close(r, topk_scan.gather_rescore_plain(slab, q, groups), f"K2 n={n}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["shared", "distinct", "out_of_range"])
def test_gather_rescore_sharing_edges(cuda_device, case, dtype):
    """K2's group-major order at its extremes: every query choosing the same
    groups (runs longer than one block takes), every pair a distinct group,
    and ids outside the slab, which poison their 128 outputs with NaN."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    slab = torch.randn(16384, 256, generator=gen).to(cuda_device, dtype)
    q = torch.randn(40, 256, generator=gen).to(cuda_device)
    if case == "shared":
        groups = torch.arange(0, 120, 4, dtype=torch.int32).expand(40, 30).contiguous()
    else:
        groups = torch.randperm(128, generator=gen)[:120].view(40, 3).sort(dim=1).values.to(torch.int32)
    if case == "out_of_range":
        groups[3, 1], groups[7, 0], groups[7, 2] = 128, -1, 1 << 30
    groups = groups.to(cuda_device)
    launches = topk_scan.gather_rescore.launches
    got = topk_scan.gather_rescore(slab, q, groups)
    torch.cuda.synchronize()
    assert topk_scan.gather_rescore.launches == launches + 1
    bad = (groups < 0) | (groups >= 128)
    poisoned = bad.repeat_interleave(128, dim=1)
    assert bool(torch.isnan(got[poisoned]).all()) and not bool(torch.isnan(got[~poisoned]).any())
    want = topk_scan.gather_rescore_plain(slab, q, torch.where(bad, 0, groups))
    chip_smoke.check_close(got[~poisoned], want[~poisoned], f"K2 {case}")


@pytest.mark.parametrize("case", ["random", "shared", "out_of_range"])
def test_gather_plan_orders_every_pair_once(cuda_device, case):
    """K2's counting sort: each (query, j) pair exactly once, the ids in
    ascending order and ids outside the slab last, as -1: one run per
    distinct id."""
    from frankensearch_tpu_torch.ops import _build

    gen = torch.Generator(device="cpu").manual_seed(5)
    n_groups = 7872
    groups = torch.randint(0, n_groups, (256, 60), generator=gen, dtype=torch.int32)
    if case == "shared":
        groups[:] = groups[0]
    if case == "out_of_range":
        groups[3, :5], groups[9, 7] = -1, n_groups + 3
    flat = groups.reshape(-1)
    on_card = flat.to(cuda_device)
    plan, ids, pairs = topk_scan._gather_plan_scratch(n_groups, flat.numel(), cuda_device)
    rc = _build.library().fs_gather_plan(on_card.data_ptr(), plan.data_ptr(), flat.numel(), n_groups,
                                         torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    gids, order = plan[-2 * flat.numel():].view(2, -1).cpu().long()
    assert torch.equal(torch.sort(order).values, torch.arange(flat.numel()))
    inside = (flat >= 0) & (flat < n_groups)
    assert torch.equal(gids, torch.where(inside, flat, -1)[order].long())
    key = torch.where(gids < 0, n_groups, gids)
    assert bool((key[1:] >= key[:-1]).all())


#: K2's cases: (dtype, B, kk) plus the batch whose queries all chose the
#: same groups
K2_CASES = [(dt, b, kk) for dt in ("bfloat16", "float16") for b in (1, 8, 256) for kk in (30, 60)] + [
    ("bfloat16", "shared", 60), ("float16", "shared", 60)]

#: sha256 of K2's output bits on _k2_input's seeded data, as the first
#: port's kernel (one block per (query, group) pair) gave them
#: (H100, nvcc 12.8, `PYTHONPATH=ROOT python tests/test_torch_kernels_cuda.py`
#: on that tree): the group-major design keeps its dot order, so it must not
#: change a bit, in pair order (B = 1, 8) or group order (B = 256)
K2_DIGESTS = {
    ('bfloat16', 1, 30): "e730ed3e852396aa0fff0ff5836c744406cc71e0df66daaed47a936ea5091885",
    ('bfloat16', 1, 60): "73b5e0c7c26dff78dfad80c7eb81196344ae8f81c043f717f5457e417ed9b7a7",
    ('bfloat16', 8, 30): "7f840c535d535c2df7ae71c8ac089332c716a739abf6f1b66c92851174d82561",
    ('bfloat16', 8, 60): "4560ddb10ad370b87c2bfd7347b02e8c8155caa3d331b38725fd73e167585d46",
    ('bfloat16', 256, 30): "08213a7945ef71bfba029cfbd27ed6c36c9c25474184ba5f0dac5973cd69e06d",
    ('bfloat16', 256, 60): "48f90f7b7070c5cc5e8868c2d1053c5b8dadefde704c870ff17df19702aa7bce",
    ('float16', 1, 30): "95deef518aa6beb36de7080669d87e72f9a07e89eac65966aa2ef1f2409dba69",
    ('float16', 1, 60): "ee45a14e0502389c10ea44def37690792f911e58ab87c1062db09cfea28c9fdb",
    ('float16', 8, 30): "d4c91fd10b15fd38ddc5a3886af33ac46b89cdf01b48970709979bbaed5b23b9",
    ('float16', 8, 60): "cf93d0361065e4d396df9323c4d76d391dca70074d73fd5e7873967d3115d9b1",
    ('float16', 256, 30): "62f903a8c3cb4d0f5d57c61e099fe728cec4d677c3928ccb6743e214b33163f4",
    ('float16', 256, 60): "b20fddf661f3f6da7bce024901274649eeb5553cf64edbf7928a4de90eb16284",
    ('bfloat16', 'shared', 60): "bd6c407fb717b3e1731327e7d394ae6f07179bfe940727895b889c37a524f899",
    ('float16', 'shared', 60): "d097a35ff513933bcaa67915ae6b36e9a3ca1135ad62571a1f909544f40549ef",
}


def _k2_input(dtype: str, b, kk: int):
    gen = torch.Generator(device="cpu").manual_seed(20261017)
    slab = torch.randn(16384, 256, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(getattr(torch, dtype))
    if b == "shared":
        q = torch.randn(256, 256, generator=gen)
        groups = torch.sort(torch.randperm(128, generator=gen)[:kk]).values.expand(256, kk)
    else:
        q = torch.randn(b, 256, generator=gen)
        groups = torch.sort(torch.stack([torch.randperm(128, generator=gen)[:kk] for _ in range(b)]), dim=1).values
    return slab, q, groups.to(torch.int32).contiguous()


def _k2_digest(dev, case) -> str:
    slab, q, groups = _k2_input(*case)
    out = topk_scan.gather_rescore(slab.to(dev), q.to(dev), groups.to(dev)).cpu()
    return hashlib.sha256(out.view(torch.int32).numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("case", K2_CASES, ids=[f"{dt}-{b}-{kk}" for dt, b, kk in K2_CASES])
def test_gather_rescore_bits_equal_the_first_port(cuda_device, case):
    assert _k2_digest(cuda_device, case) == K2_DIGESTS[case]


#: K2-i8's cases: (d, B, kk) on a 16,384-row int8 slab (2,048 rows at d =
#: 12288), B = 256 group-major and B = 1, 8 in pair order, plus a batch
#: whose queries all chose the same groups and one with ids outside the
#: slab (NaN poison); d = 16 and 48 take the narrowest row layouts, 528 a
#: row of 33 chunks, 12288 the widest d the kernel takes
K2I8_CASES = [(256, b, kk) for b in (1, 8, 256) for kk in (30, 60)] + [
    (256, "shared", 60), (256, "out_of_range", 60)] + [
    (d, b, 60) for d in (128, 384, 1024) for b in (8, 256)] + [
    (16, 8, 60), (48, 256, 60), (528, 8, 30), (12288, 8, 30)]

#: sha256 of K2-i8's output bits on _k2i8_input's seeded data, as the first
#: port's kernel (one block per (query, group) pair, one row per warp,
#: `static_cast<float>` of each byte) gave them on the tree of commit 6a44cd9
#: (H100, nvcc 12.9, `PYTHONPATH=ROOT python tests/test_torch_kernels_cuda.py`
#: on that tree): the group-major design with full warps and the exact
#: byte cast keeps each lane's fmaf chain and the butterfly's sums, so it
#: must not change a bit, in pair order (B < 192) or group order
K2I8_DIGESTS = {
    (256, 1, 30): "062ad633f9dd29f5d3aec85bfdcdde2ce4a86bc5bcddabccff366022f5e128d2",
    (256, 1, 60): "8e004c9ae02ceb438f3dd1fa7222ab5d74e1ca772fc49beac02f401edaf26b61",
    (256, 8, 30): "7b9234e96a343011a6ee02a21684c2af958b57d99dccaa595965e8b09bde918f",
    (256, 8, 60): "6015edd2de06b52475afedb2323752111bab4fab82fa10ebea816ae64f32fe8e",
    (256, 256, 30): "f9f8a18ac1dc5c8cfcbea8a10e9ed724504548e866dc54ef127f81f27009d526",
    (256, 256, 60): "9e0befb90d5f26002f9910aedb145e677e5e6e57d1428b8172ae959001351afd",
    (256, 'shared', 60): "5453354654c4a13dd1b789b34309b5d8685b1c4836d8d0374e34f8eb2ce82040",
    (256, 'out_of_range', 60): "46d152e2514a737c66e0c27e9604c2de05ff270b4dc4173d66988451b37781a9",
    (128, 8, 60): "43805c5a766779e2b2624ca5847c83319ebd8ce529b1c5a69a0fadd7d2f58144",
    (128, 256, 60): "efcb24264d5ffef353aaca8f32406a31a2f92bf0fef74d856e39e2f6296944cc",
    (384, 8, 60): "5e1634c2cdad2866f7bbc47217e859dd8927ad44711f3824f762ccc260a2a2c3",
    (384, 256, 60): "9bbf123fa6fb5f4068425a409d1aaf6e894aea786f05da0646692eaeaa0a3fce",
    (1024, 8, 60): "7c74aee511fec74fa941befe085680c2e9137d1f0cadc3ba480fb3f89bd4b9cc",
    (1024, 256, 60): "b357ff82b175150089860ac69e3fce1d014877873caa4a580d0f821dee69ba82",
    (16, 8, 60): "727619464f1217590b441588766817839b7cce11bdb402a3e4bb86b594dcd930",
    (48, 256, 60): "cea6ba55794dfc2fe510f84a55e01def3967184bc23545794b663be8484c8406",
    (528, 8, 30): "11ea9bb3b1389b3abf1d3de3192058d1baa5427a59d9b4d7c10a4ee295cac44c",
    (12288, 8, 30): "9689efc2db59e8d5fc463753252d60dc4e3e11a01a7b6f92fa8456bb02a713d3",
}


def _k2i8_input(d: int, b, kk: int):
    gen = torch.Generator(device="cpu").manual_seed(20261018 + d)
    n = 16384 if d <= 1024 else 2048
    slab = torch.randint(-128, 128, (n, d), generator=gen, dtype=torch.int8)
    slab[5:9] = 0  # zero rows: every product a signed zero
    slab[9], slab[10] = 127, -128
    nb = 256 if b in ("shared", "out_of_range") else b
    q = torch.randn(nb, d, generator=gen) * (torch.rand(d, generator=gen) * 0.02)  # q x per-dim scale
    q[0, : d // 2] = 0.0
    ng = n // 128
    if b == "shared":
        groups = torch.sort(torch.randperm(ng, generator=gen)[:kk]).values.expand(nb, kk)
    else:
        groups = torch.sort(torch.stack([torch.randperm(ng, generator=gen)[:kk] for _ in range(nb)]), dim=1).values
    groups = groups.to(torch.int32).contiguous()
    if b == "out_of_range":
        groups[3, 1], groups[7, 0], groups[7, 2], groups[200, kk - 1] = ng, -1, 1 << 30, -(1 << 30)
    return slab, q, groups


def _k2i8_digest(dev, case) -> str:
    slab, q, groups = _k2i8_input(*case)
    out = topk_scan.gather_rescore_i8(slab.to(dev), q.to(dev), groups.to(dev)).cpu()
    return hashlib.sha256(out.view(torch.int32).numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("case", K2I8_CASES, ids=[f"d{d}-{b}-{kk}" for d, b, kk in K2I8_CASES])
def test_gather_rescore_i8_bits_equal_the_first_port(cuda_device, case):
    assert _k2i8_digest(cuda_device, case) == K2I8_DIGESTS[case]


@pytest.mark.parametrize("kk", [30, 60])
@pytest.mark.parametrize("b", [1, 8, 256])
def test_k1_k2_at_the_quality_width_match_twins(cuda_device, b, kk):
    """K1 and K2 over a 384-wide bf16 slab (the quality tier's rescan) at
    the serve batch, the fused lane's pad and a singleton."""
    gen = torch.Generator(device="cpu").manual_seed(b * 100 + kk)
    slab = torch.randn(32768, 384, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(cuda_device, torch.bfloat16)
    q = torch.randn(b, 384, generator=gen).to(cuda_device)
    mask = torch.zeros(32768, device=cuda_device)
    mask[32000:] = float("-inf")
    gm = topk_scan.group_max(slab, q, mask)
    torch.testing.assert_close(gm, topk_scan.group_max_plain(slab, q, mask), rtol=1e-5, atol=1e-5)
    groups = torch.sort(torch.topk(gm, kk, dim=1).indices.to(torch.int32), dim=1).values
    r = topk_scan.gather_rescore(slab, q, groups)
    torch.testing.assert_close(r, topk_scan.gather_rescore_plain(slab, q, groups), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(1, 384, 1), (5, 1536, 384), (16, 384, 1536), (300, 384, 1)])
def test_int8_matmul_padded_shapes_exact(cuda_device, m, k, n):
    """torch._int_mm behind rerank.bert.int8_matmul at shapes its rules
    refuse unpadded (16 rows or fewer, n = 1): zero padding keeps the int32
    sums exact."""
    from frankensearch_tpu_torch.rerank.bert import int8_matmul

    gen = torch.Generator(device="cpu").manual_seed(m + n)
    x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    got = int8_matmul(x.to(cuda_device), w.to(cuda_device)).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), x.to(torch.int64) @ w.to(torch.int64))


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_encoder_forward_card_vs_cpu(cuda_device, form):
    """The trained 384 encoder's forward on the card against the port on
    the CPU, within tests/test_torch_rerank.py's stated tolerances (card and
    CPU sum in different orders; int8 sums are exact)."""
    import dataclasses

    from frankensearch_tpu_torch.rerank.bert import Bert, quantize_linear_weights
    from frankensearch_tpu_torch.rerank.encoder import load_artifact

    cpu = load_artifact(chip_smoke.QUALITY_ARTIFACT, device=torch.device("cpu"))
    cfg = dataclasses.replace(cpu.cfg, compute="bf16" if form == "bf16" else "f32")
    state = quantize_linear_weights(cpu.params) if form == "int8" else cpu.params
    texts = ["cw001 cw002 sy003", "the quick brown fox", "fil010", "cw050 sy051 fil052 cw053 sy054"]
    ids, mask = cpu.tokenize_batch(texts)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    want = Bert(cfg, state, device=torch.device("cpu")).embed_forward(ids, mask)
    got = Bert(cfg, state, device=cuda_device).embed_forward(ids.to(cuda_device), mask.to(cuda_device)).cpu()
    tol = {"f32": chip_smoke.ENC_F32_TOL, "bf16": chip_smoke.ENC_BF16_TOL, "int8": 2e-3}[form]
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# the f32 forms (K1, K2, K5 by FFMA), K2 and K2-ivf at the IVF probe's
# shapes, and the MRL, int4 and IVF lanes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 256, 1024])
@pytest.mark.parametrize("b", [1, 9, 33, 256, 300])
def test_f32_forms_share_k1_bits(cuda_device, b, d):
    """K1's f32 form against its twin (1e-5: FFMA chains in dim order
    against cuBLAS's f32 order), K5's f32 candidates (list entry, kk <= 64;
    wide entry, kk = 100) bitwise K1's maxima, and a row's bits the same
    alone and in the batch."""
    slab, mask, gen = _unit_slab(b + d, n=8192, d=d)
    slab, mask = slab.to(cuda_device), mask.to(cuda_device)
    q = torch.randn(b, d, generator=gen).to(cuda_device)
    gm = topk_scan.group_max(slab, q, mask)
    torch.testing.assert_close(gm, topk_scan.group_max_plain(slab, q, mask), rtol=1e-5, atol=1e-5)
    tile_max = gm.view(b, -1, topk_scan.TILE_N // 128).amax(dim=2)
    for kk in (10, 100):
        s, _ = topk_scan.tile_topk(slab, q, mask, kk)
        assert torch.equal(s[:, 0, :].T.contiguous().view(torch.int32), tile_max.view(torch.int32)), kk
    alone = topk_scan.group_max(slab, q[b - 1 :], mask)
    assert torch.equal(alone.view(torch.int32), gm[b - 1 :].view(torch.int32))


@pytest.mark.parametrize("b,kk", [(1, 12), (8, 60), (70, 30), (256, 60)])
def test_gather_rescore_f32_matches_twin(cuda_device, b, kk):
    """K2's f32 form in pair order (B < 64) and on the group-major plan."""
    slab, _, gen = _unit_slab(b * kk)
    slab = slab.to(cuda_device)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    groups = torch.randint(0, 128, (b, kk), generator=gen, dtype=torch.int32).to(cuda_device)
    got = topk_scan.gather_rescore(slab, q, groups)
    torch.testing.assert_close(got, topk_scan.gather_rescore_plain(slab, q, groups), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [8192, 4104])
def test_f32_forms_reject_widths_outside_the_kernels(cuda_device, d):
    slab = torch.zeros(256, d, device=cuda_device)
    with pytest.raises(ValueError, match="4096"):
        topk_scan.gather_rescore(slab, torch.zeros(2, d, device=cuda_device),
                                 torch.zeros(2, 1, dtype=torch.int32, device=cuda_device))


@pytest.mark.parametrize("b,nprobe", [(1, 8), (8, 8), (256, 8), (8, 64)])
def test_gather_rescore_at_the_ivf_probe_shapes(cuda_device, b, nprobe):
    """The IVF probe's K2 call: kk = nprobe x 6 groups per cluster, ids
    sorted per query, queries sharing clusters (drawn from 16 hot ones);
    nprobe = 64 probes every cluster of the slab."""
    gen = torch.Generator(device="cpu").manual_seed(b * nprobe)
    n_clusters, gpc = 64, 6
    slab = torch.randn(n_clusters * gpc * 128, 256, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(cuda_device, torch.bfloat16)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    hot = torch.randperm(n_clusters, generator=gen)[:16]
    probe = torch.stack([
        torch.randperm(n_clusters, generator=gen)[:nprobe] if nprobe == n_clusters
        else hot[torch.randperm(16, generator=gen)[:nprobe]] for _ in range(b)
    ])
    ids = (probe[:, :, None] * gpc + torch.arange(gpc)).reshape(b, -1).sort(dim=1).values
    ids = ids.to(torch.int32).to(cuda_device)
    got = topk_scan.gather_rescore(slab, q, ids)
    torch.testing.assert_close(got, topk_scan.gather_rescore_plain(slab, q, ids), rtol=1e-5, atol=1e-5)


def _ivf_arm(seed, b, nprobe, *, d=256, n_clusters=64, gpc=6, dtype=torch.bfloat16, hot=16):
    """A slab sorted by cluster (n_clusters x gpc groups), a tombstone mask
    over a tenth of its rows, and a probe table: nprobe of ``hot`` clusters
    a query (so B = 256 puts about 128 queries on a cluster), or, above
    ``hot``, nprobe of all clusters."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    slab = torch.randn(n_clusters * gpc * 128, d, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(dtype)
    q = torch.randn(b, d, generator=gen)
    mask = torch.zeros(slab.shape[0])
    mask[torch.randperm(slab.shape[0], generator=gen)[: slab.shape[0] // 10]] = float("-inf")
    hot_ids = torch.randperm(n_clusters, generator=gen)[:hot]
    probe = torch.stack([torch.randperm(n_clusters, generator=gen)[:nprobe] if nprobe > hot
                         else hot_ids[torch.randperm(hot, generator=gen)[:nprobe]] for _ in range(b)])
    return slab, q, mask, probe


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k", [1, 10, 65, 300])
@pytest.mark.parametrize("b,nprobe", [(1, 8), (8, 8), (32, 8), (256, 8), (8, 64)])
def test_ivf_probe_matches_twin(cuda_device, b, nprobe, k, dtype):
    """K2-ivf against its twin at the IVF probe's shapes (those of
    test_gather_rescore_at_the_ivf_probe_shapes, and 32 x 8): pair order
    with a run a group at B = 1 and 8 x 8, pair order with a run a cluster
    at 32 x 8, a hot cluster probed by about 128 queries at B = 256, the full
    probe at nprobe 64), lists at k <= 64 and every row above, within
    1e-5 (tensor-core sums in another order; rows equal but at such
    ties); it launches no K2."""
    slab, q, mask, probe = _ivf_arm(b * nprobe + k, b, nprobe, dtype=dtype)
    want = topk_scan.ivf_probe_topk_plain(slab, q, mask, probe, k=k, gpc=6)
    before = (topk_scan.ivf_probe_topk.launches, topk_scan.gather_rescore.launches)
    got = topk_scan.ivf_probe_topk(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device),
                                   probe.to(cuda_device), k=k, gpc=6)
    assert (topk_scan.ivf_probe_topk.launches, topk_scan.gather_rescore.launches) == (before[0] + 1, before[1])
    assert got.scores.shape == (b, k) and got.indices.dtype == torch.int32
    _same_up_to_near_ties(got, want)


@pytest.mark.parametrize("d,b,nprobe", [(256, 8, 8), (256, 256, 8), (200, 8, 8), (200, 256, 40)])
def test_ivf_probe_masked_cluster_and_narrow_rows(cuda_device, d, b, nprobe):
    """A probed cluster whose rows are all masked gives no row; a width that
    is not a multiple of 64 (the last chunk's columns read as zeros)."""
    slab, q, mask, probe = _ivf_arm(d + b, b, nprobe, d=d)
    mask[probe[0, 0] * 768 : probe[0, 0] * 768 + 768] = float("-inf")
    want = topk_scan.ivf_probe_topk_plain(slab, q, mask, probe, k=10, gpc=6)
    got = topk_scan.ivf_probe_topk(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device),
                                   probe.to(cuda_device), k=10, gpc=6)
    _same_up_to_near_ties(got, want)
    dead = set(range(int(probe[0, 0]) * 768, int(probe[0, 0]) * 768 + 768))
    assert not dead & set(got.indices[0].tolist())


def test_ivf_probe_poisons_ids_outside_the_arm(cuda_device):
    """A probe id outside [0, C) is not streamed: its lists come back as
    NaN (ranked first by the merge, as K2 poisons such ids), the other
    queries' rows are the twin's."""
    slab, q, mask, probe = _ivf_arm(7, 200, 8)
    probe[3, 2] = 64
    got = topk_scan.ivf_probe_topk(slab.to(cuda_device), q.to(cuda_device), mask.to(cuda_device),
                                   probe.to(cuda_device), k=10, gpc=6)
    assert bool(torch.isnan(got.scores[3]).all())
    keep = torch.arange(200) != 3
    want = topk_scan.ivf_probe_topk_plain(slab, q[keep], mask, probe[keep], k=10, gpc=6)
    _same_up_to_near_ties(topk_scan.TopKResult(got.scores[keep.to(cuda_device)], got.indices[keep.to(cuda_device)]),
                          want)


def test_mrl_int4_and_ivf_lanes_gpu_vs_cpu(cuda_device):
    """MRL and int4 (plain ops on both devices) and the IVF arm (built on the
    card; full probe equals the exact scan up to bf16 near ties) on the
    card against the CPU."""
    from frankensearch_tpu_torch.index.ivf import IvfDeviceIndex
    from frankensearch_tpu_torch.ops.quantize import calibrate_int4

    slab, mask, gen = _unit_slab(5)
    q = torch.randn(8, 256, generator=gen)
    bf = slab.to(torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for dims in (64, 256):
            s_d = slab.to(dtype)
            cpu = topk_scan.scan_topk_mrl(s_d, q, 10, mask, search_dims=dims)
            gpu = topk_scan.scan_topk_mrl(s_d.to(cuda_device), q.to(cuda_device), 10, mask.to(cuda_device),
                                          search_dims=dims)
            _same_up_to_near_ties(gpu, cpu)
    q4 = calibrate_int4(slab.numpy())
    packed, scale = torch.from_numpy(q4.packed), torch.from_numpy(q4.scale)
    cpu = topk_scan.scan_topk_int4_two_pass(packed, scale, bf, q, 10, mask)
    gpu = topk_scan.scan_topk_int4_two_pass(packed.to(cuda_device), scale.to(cuda_device), bf.to(cuda_device),
                                            q.to(cuda_device), 10, mask.to(cuda_device))
    _same_up_to_near_ties(gpu, cpu)
    x = slab[:6000].numpy()
    ivf = IvfDeviceIndex(x, n_clusters=16, device=cuda_device)
    full = ivf.search_batch(q.numpy(), 10, nprobe=16)
    exact = topk_scan.scan_topk_xla(torch.from_numpy(x).to(torch.bfloat16), q, 10)
    _same_up_to_near_ties(full, exact, rel=2.0 ** -8)


#: K5-f32's cases: (d, B, kk) on an 8-tile f32 slab, every query-tile width
#: (B = 1 .. 256, ragged tiles at 5, 9, 33, 65) and kk from 1 to the list
#: entry's widest
K5F32_CASES = [(d, b, kk) for d in (256, 64) for b in (1, 5, 8, 9, 33, 64, 65, 256) for kk in (1, 10, 60, 64)]

#: sha256 of K5-f32's (out_s, out_i) bits on _k5f32_input's seeded data, as
#: the first f32 list entry (one block per (tile, 64 queries), the selection
#: after each group's scan) gave them on the tree of commit 7f543f5 (H100,
#: nvcc 12.9, `PYTHONPATH=ROOT python tests/test_torch_kernels_cuda.py` on
#: that tree): every score is one fmaf chain in dim order and the list keeps
#: the top kk by a total order, so no redesign may change a bit
K5F32_DIGESTS = {
    (256, 1, 1): "27d57ed5fbe1efb4b96908c8da1cf275bd66b28913dab312788c3e362c47d4b4",
    (256, 1, 10): "0c0e2b93bee511389e9d069a3d15978e7d49bf846260d187b4f2e30d354e6205",
    (256, 1, 60): "f2e6a0823c8df96a9ae6c7bb3aa625c0ffa8602c4671eaa2c50ef39833a68f3f",
    (256, 1, 64): "125fab9a56a18b99630292719b0b563b05220d3861964c38328d2fc662683de9",
    (256, 5, 1): "07bc76d622abf62b5e8e811cf42088a3d92fc2942ef31f4902327e63cfddf4ab",
    (256, 5, 10): "ceb16cb80f1bee88fbf5c4d5ddc634557d53c42d6a608d11a13877ae0d8b9b5c",
    (256, 5, 60): "ef978ca1e9f787db986deb45ff4470ef220743855baf1c232d7f84467525194c",
    (256, 5, 64): "a4060c1338184b1ecd6b178db6aa7695a3a39e60828762ae1f505acbb8253911",
    (256, 8, 1): "5937f7a38c13060194fb75ea53b02475eea2fbbd66db259784864e1f72463111",
    (256, 8, 10): "6bde78fcf64762ac466fa3e0ffe2bcb3d48731a59285c18dd5254d809b2d58fd",
    (256, 8, 60): "f24627b35e351a9cbbfd923b976a0171cfbb67a3f5592af1eea62b1f99ab7a10",
    (256, 8, 64): "b482de3a61cdf79ef610c2628242a65f8f8cc113b8bf8edfe8c48edc3c7ee648",
    (256, 9, 1): "72d078ddf80ef06fd327f0594c220db6b20fc75f726117a5e50a5fc6affe75d4",
    (256, 9, 10): "135d1659359d7415426c6df4fceecf1446a43fe8121102d6c5e3b340cb6789bf",
    (256, 9, 60): "24086030783fea8f89f3cc8d11f939bef92622a9e93db3629b9c68a2418dcec4",
    (256, 9, 64): "53b541387cac924f8003da2faa660b6bc62a0a761ae9a481470ed41c82f12cbd",
    (256, 33, 1): "e1afcb6c1ece5c56e17d5be7ecaf7bd4de8b1e2b6f362082a121c8c2fdad60a5",
    (256, 33, 10): "f09aa18e63f4e752f1c862b5dd3f707a3c446423bf268798e30125dcaa911c47",
    (256, 33, 60): "55a4fef2702353b8604e97fe1a8ca9d36c7b5ed0e7c79216ddc9bc5b4767556d",
    (256, 33, 64): "d264577dafe6675466ea0e5f8ee661ca8fa8c097f8bd9499fb9c56caa0fb044c",
    (256, 64, 1): "0fc319b260f998a41ac2e6d7e23913da61328619b2341cd18cc4cbb1bcf7e24f",
    (256, 64, 10): "956a74e5dd7fb6e0cd50cd38c4792072ff7f9bc56963ccc14b21010fcc4b6d38",
    (256, 64, 60): "545c8a9c0c9e5afad05aed775ab731427da0b360293603c2459d7fb944e47b5e",
    (256, 64, 64): "52c65f95b19937407b1fc653965f553ec7e55a0b12c6231228518c51b16c2c9b",
    (256, 65, 1): "fc4dd50f0e6635a061bcc942307f39c991ac46ebc9aeaaf01e45495d6820fe29",
    (256, 65, 10): "410b5bda69c460ac8f00780dee3355f0d02528903c49a30f9693ae91e92c0f56",
    (256, 65, 60): "24f4cae7171b9d4c8f91142be283ecc4394db353b71597fa49cb1f74a3339af0",
    (256, 65, 64): "9703ea1f55cb3beca3a3df618dced444e6360ce1517d9b6085065c0410e10f4b",
    (256, 256, 1): "909facf4d23c0808d5c0f33d93bd6b408420cd83bd12bdf6df7947232488e91c",
    (256, 256, 10): "5bcd426dad6bfb15365cbee9585f5778e985cd9e988e3ff571879c72eec507fb",
    (256, 256, 60): "abd0960cf342031e73041f84eaf05f2da4f9668c6a605eba402241fe82b53350",
    (256, 256, 64): "879d403836e5085b86ebd6e0336833525f8aee15d1102c86ee9a5957fec415da",
    (64, 1, 1): "09aef11012186df82e4dacb9c0802f38aad505116c2652490cc4f0656f577e5b",
    (64, 1, 10): "2e0d75897eb9b996db3b9730c17044bc8e4d3ba72ed47cf66e47aceb27b7fa1d",
    (64, 1, 60): "bafed995b6586a0bd28c3c9044e577423619db69521079152ad3d5b86212b055",
    (64, 1, 64): "b2b10b5c5f738809b6ae983b937da5a9b0882c28e3af6657c8059303f9a7a446",
    (64, 5, 1): "279b50a68bf70f981584d2c82e3ec58e1b2218464920a39ef31d383a3689a91f",
    (64, 5, 10): "0fbd44d04c0df79a9f7eb02631bf3deab1562b23f130223fd8a9209513ec16df",
    (64, 5, 60): "97437d4c10d64da7a3e380646d063ea9d4bbcb28f47c9c347d45585db4f5a54f",
    (64, 5, 64): "af194acd45b21a1f3be32c70f2ee39b935c661f6f35f01085edb6fc996072ba7",
    (64, 8, 1): "b3b73d9fc112adb65d28994f0c433be249b7829f577a711aaa132f8cc988296c",
    (64, 8, 10): "6d80a1756d016303975cdad6072946f2197241579c5f0406d451b2ee4be88a75",
    (64, 8, 60): "66597f40da946241411779cd0341f2f32f152f93d84a5850583c4e4fc32072c4",
    (64, 8, 64): "d344b3f4814d2c31b9aaf90dbe6325cd1d5c429ea502eb773e6827523d086586",
    (64, 9, 1): "6f7f22ca555ab01aa2037b55336efd11f5de29aa97a6faf976295286143989c9",
    (64, 9, 10): "4d180322848dfa0aee40c95d2919994640649f293e1df928188eed1292198845",
    (64, 9, 60): "9528aaa1c2956a0c926b0f9c4de4e09b64911f4e2ed46bb0c58b95a4c18a0ed1",
    (64, 9, 64): "a7b03c630cb796e2cb4af376783b5ce71f1a070cd47ad8f130c79155d634cd82",
    (64, 33, 1): "6712dd560c35895918c4f9ee163c263ec225638e5b92a7b19dd2e76f53237afb",
    (64, 33, 10): "70633eae9dbcd5ee60e10258b5cafdf83a4e62d3230525725c71f1395120aa91",
    (64, 33, 60): "51eb37331739af1f051ba17a09d613c5840f55d289ee4eda93ba4079f1e8cc72",
    (64, 33, 64): "bc4c442740d0ac1e803de704f3242435d08d255b21c3f7c8dedacc695e0b43ec",
    (64, 64, 1): "4c824ae45642ad7a3f63b3e3e466ad65db3afadd057653af6a61776fe36e0ac4",
    (64, 64, 10): "ae33efb5a9b7e99ae1647b9085313acf738543563fc4b66f3ea07d5bfd7bceaa",
    (64, 64, 60): "a1bfc8cea2ff928f4c01a73dfba85cd96b1e353fdcddc8caa984c7717e461722",
    (64, 64, 64): "68e4053994892cddf607e00ff6134f6de6ff0d170219e5f85d5ca2dc86cfbc47",
    (64, 65, 1): "aeb6500fc715cfa2bb71feda090ee3dd049e2b1fe9987c2b9974d1719fb69e81",
    (64, 65, 10): "82c42f4b290226b43bd72156123e70c61c95be797e9b07c878949bb6827888da",
    (64, 65, 60): "83433ae87ac80fcd8e5a293794e3df6c136a52dae826d441b02e6630e91e42cc",
    (64, 65, 64): "fe9c1c11c72eaa94270df393e3d7677c5723750c80a07fdf104688f029d6191c",
    (64, 256, 1): "41c04818d7ab0c1c827ab21278d379762199b76f5c4af768cf4548a939f11550",
    (64, 256, 10): "578f94c63a86059aeb74c6409c03682a12e4aff344149518778b453f5414db04",
    (64, 256, 60): "5f15ae772cc447190feaae9b5a3dc6ec0a219086c37dd5fdf5b5842cc639c174",
    (64, 256, 64): "2795028695befb34afe85d314fb4f6b18c805dba0a62b278389e4a62b53798a0",
}


def _k5f32_input(d: int, b: int):
    gen = torch.Generator(device="cpu").manual_seed(20261019 + d)
    slab = torch.randn(16384, d, generator=gen)
    slab = slab / slab.norm(dim=1, keepdim=True)
    q = torch.randn(b, d, generator=gen)
    mask = torch.where(torch.rand(16384, generator=gen) < 0.1, float("-inf"), 0.0)
    mask[5 * 2048 : 6 * 2048] = float("-inf")  # a masked tile
    mask[6 * 2048 : 7 * 2048] = float("-inf")  # a tile of three live rows
    mask[6 * 2048 + torch.tensor([0, 1000, 2047])] = 0.0
    return slab, q, mask


def _k5f32_digest(dev, case) -> str:
    d, b, kk = case
    slab, q, mask = (x.to(dev) for x in _k5f32_input(d, b))
    out_s, out_i = topk_scan.tile_topk(slab, q, mask, kk)
    return hashlib.sha256(out_s.cpu().view(torch.int32).numpy().tobytes()
                          + out_i.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("case", K5F32_CASES, ids=[f"d{d}-{b}-{kk}" for d, b, kk in K5F32_CASES])
def test_tile_topk_f32_bits_equal_the_first_port(cuda_device, case):
    assert _k5f32_digest(cuda_device, case) == K5F32_DIGESTS[case]


@pytest.mark.parametrize("b", [1, 8, 9, 16, 17, 32, 33, 64, 65, 300])
def test_tile_topk_f32_query_tiles_match_twin_and_solo(cuda_device, b):
    """Every query-tile width of K5-f32's list entry (8, 16, 32, 64 queries,
    full and ragged) against its twin (1e-5, near ties may swap), its rows
    distinct and in their tiles, and the first and last query's bits the
    same alone as in the batch."""
    slab, mask, gen = _unit_slab(b + 1000)
    mask[2048 + 3 : 4096] = float("-inf")  # tile 1 holds 3 live rows: it runs out
    slab, mask = slab.to(cuda_device), mask.to(cuda_device)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    got_s, got_i = topk_scan.tile_topk(slab, q, mask, 60)
    want_s, _ = topk_scan.tile_topk_plain(slab, q, mask, 60)
    chip_smoke.check_close(got_s, want_s, "K5-f32 scores")
    chip_smoke.check_tile_rows(slab, q, mask, got_s, got_i, "K5-f32 rows")
    for j in {0, b - 1}:
        one_s, one_i = topk_scan.tile_topk(slab, q[j : j + 1], mask, 60)
        assert torch.equal(one_s[:, :, 0].view(torch.int32), got_s[:, :, j].view(torch.int32)), j
        assert torch.equal(one_i[:, :, 0], got_i[:, :, j]), j


if __name__ == "__main__":
    for case in K2_CASES:
        print(f"    {case!r}: \"{_k2_digest(torch.device('cuda'), case)}\",")
    print("K2I8_DIGESTS")
    for case in K2I8_CASES:
        print(f"    {case!r}: \"{_k2i8_digest(torch.device('cuda'), case)}\",")
    print("K5F32_DIGESTS")
    for case in K5F32_CASES:
        print(f"    {case!r}: \"{_k5f32_digest(torch.device('cuda'), case)}\",")
