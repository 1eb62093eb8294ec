"""The int8 capacity lane and the per-tile top-k lane of ops/topk_scan.py
against the JAX reference, both on the CPU.

The reference runs its Pallas kernels in interpret mode: K4
(``_group_max_int8_kernel``), K2's int8 form (``_gather_rescore_kernel``
with ``compute_f32=True``) and K5 (``_tile_topk_kernel``); the port runs
their plain twins. Inputs are seeded numpy arrays: N = 16,384 rows (two
8192-row tiles), the last 384 rows padding.

Tolerances:
- the prepared int8 query and K4's group maxima are bitwise: the query is
  the reference's f32 ops in its order, and K4's sums are exact integers;
- rescored and scanned scores are f32 sums of exact products whose order
  differs between the two CPU backends: 1e-6 relative, indices equal;
- the per-tile top-k and the two-pass rescore may swap two rows whose
  scores lie within 1e-6 of each other (a near tie); every other row is
  equal;
- at B % 8 != 0 or a wide rescore the reference leaves its kernel for
  ``q · (c * scale)``; the port always scores ``(q * scale) · c`` (the
  kernel's form): the two agree within 1e-6 relative.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from frankensearch_tpu.ops import topk_scan as jts
from frankensearch_tpu_torch.ops import topk_scan as tts
from frankensearch_tpu_torch.ops.quantize import calibrate_int8

N, LIVE = 16384, 16000
REL = 1e-6


def _slab(d, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[LIVE:] = 0.0
    mask = np.zeros(N, np.float32)
    mask[LIVE:] = -np.inf
    return v, mask


def _queries(b, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _int8(d):
    v, mask = _slab(d)
    q = calibrate_int8(v)
    return v, mask, q.values, q.scale


@jax.jit
def _ref_prepare(queries, scale):
    # scan_topk_hierarchical_int8's preparation (topk_scan.py:295-297)
    q_prep = queries.astype(jnp.float32) * scale.astype(jnp.float32)
    qmax = jnp.maximum(jnp.max(jnp.abs(q_prep), axis=1, keepdims=True), 1e-6)
    return jnp.clip(jnp.round(q_prep / qmax * 127.0), -127, 127).astype(jnp.int8)


def _ref_group_max_int8(q_i8, slab_i8, mask, tile_n=8192, group=128):
    """The reference's K4 pallas_call (topk_scan.py:300), interpreted."""
    n, d = slab_i8.shape
    b, t = q_i8.shape[0], n // tile_n
    out = pl.pallas_call(
        functools.partial(jts._group_max_int8_kernel, group=group),
        grid=(t,),
        in_specs=[
            pl.BlockSpec((b, d), lambda i: (0, 0)),
            pl.BlockSpec((tile_n, d), lambda i: (i, 0)),
            pl.BlockSpec((1, 1, tile_n), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, tile_n // group, b), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((t, tile_n // group, b), jnp.float32),
        interpret=True,
    )(jnp.asarray(q_i8), jnp.asarray(slab_i8), jnp.asarray(mask).reshape(t, 1, tile_n))
    return np.asarray(jnp.transpose(out.reshape(n // group, b), (1, 0)))


def _ref_tile_topk(slab, q, mask, kk, tile_n=2048):
    """The reference's K5 pallas_call (topk_scan.py:180), interpreted."""
    n, d = slab.shape
    b, t = q.shape[0], n // tile_n
    shape = jax.ShapeDtypeStruct((t, kk, b), jnp.float32)
    s, i = pl.pallas_call(
        functools.partial(jts._tile_topk_kernel, k=kk),
        grid=(t,),
        in_specs=[
            pl.BlockSpec((b, d), lambda i: (0, 0)),
            pl.BlockSpec((tile_n, d), lambda i: (i, 0)),
            pl.BlockSpec((1, 1, tile_n), lambda i: (i, 0, 0)),
        ],
        out_specs=(pl.BlockSpec((1, kk, b), lambda i: (i, 0, 0)),) * 2,
        out_shape=(shape, jax.ShapeDtypeStruct((t, kk, b), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q), slab, jnp.asarray(mask).reshape(t, 1, tile_n))
    return np.asarray(s), np.asarray(i)


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def assert_equal_up_to_near_ties(got_s, got_i, want_s, want_i, axis=-1):
    """Scores within REL position by position; rows equal except where the
    two lists swap rows whose scores lie within REL of each other."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    np.testing.assert_allclose(got_s, want_s, rtol=REL, atol=REL)
    got_i, want_i = np.moveaxis(np.asarray(got_i), axis, -1), np.moveaxis(np.asarray(want_i), axis, -1)
    ws = np.moveaxis(want_s, axis, -1)
    for idx in zip(*np.nonzero((got_i != want_i).any(axis=-1))):
        g, w, s = got_i[idx], want_i[idx], ws[idx]
        for j in np.flatnonzero(g != w):
            near = np.abs(s - s[j]) <= REL * max(abs(s[j]), 1.0)
            assert g[j] in set(w[near].tolist()), (idx, j, g[j], w[j])


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b", [1, 8, 13])
def test_prepared_query_and_k4_twin_bitwise(d, b):
    v, mask, values, scale = _int8(d)
    qs = _queries(b, d, seed=b)
    want_q = np.asarray(_ref_prepare(jnp.asarray(qs), jnp.asarray(scale)))
    got_q = tts.prepare_query_int8(torch.from_numpy(qs), torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    want = _ref_group_max_int8(want_q, values, mask)
    got = tts.group_max_int8(torch.from_numpy(values), torch.from_numpy(got_q), torch.from_numpy(mask))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("d,b,k", [(128, 8, 10), (256, 8, 48), (256, 16, 30), (256, 8, 1)])
def test_hierarchical_int8_matches_reference_kernel(d, b, k):
    """kk <= 48 groups and B % 8 == 0: the reference takes its K2 rescore
    (``compute_f32``), the same form as the port's."""
    v, mask, values, scale = _int8(d)
    qs = _queries(b, d, seed=k)
    want = jts.scan_topk_hierarchical_int8(
        jnp.asarray(values), jnp.asarray(scale), jnp.asarray(qs), k, jnp.asarray(mask),
        rescore="pallas", interpret=True,
    )
    got = tts.scan_topk_hierarchical_int8(
        torch.from_numpy(values), torch.from_numpy(scale), torch.from_numpy(qs), k,
        torch.from_numpy(mask),
    )
    assert got.indices.dtype == torch.int32 and got.scores.dtype == torch.float32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=REL, atol=REL)


@pytest.mark.parametrize("overfetch", [1, 3])
def test_hierarchical_int8_against_the_reference_fallback(overfetch):
    """kk = 60 at B = 13: the reference leaves its kernel (B % 8 != 0) for
    the dequantize-then-einsum rescore, q · (c * scale); the port keeps the
    kernel's (q * scale) · c. Deliberate divergence: same rows, scores
    within 1e-6 relative."""
    v, mask, values, scale = _int8(256)
    qs = _queries(13, 256, seed=60)
    want = jts.scan_topk_hierarchical_int8(
        jnp.asarray(values), jnp.asarray(scale), jnp.asarray(qs), 60, jnp.asarray(mask),
        rescore="pallas", interpret=True, group_overfetch=overfetch,
    )
    got = tts.scan_topk_hierarchical_int8(
        torch.from_numpy(values), torch.from_numpy(scale), torch.from_numpy(qs), 60,
        torch.from_numpy(mask), group_overfetch=overfetch,
    )
    assert_equal_up_to_near_ties(got.scores.numpy(), got.indices.numpy(),
                                 np.asarray(want.scores), np.asarray(want.indices))


@pytest.mark.parametrize("kk", [10, 48])
def test_gather_rescore_i8_twin_matches_reference_kernel(kk):
    v, mask, values, scale = _int8(256)
    qs = _queries(8, 256, seed=kk)
    q_scaled = qs * scale
    rng = np.random.default_rng(kk)
    groups = np.sort(np.stack([rng.permutation(N // 128)[:kk] for _ in range(8)]), axis=1)
    want = jts._gather_rescore_pallas(
        jnp.asarray(values), jnp.asarray(q_scaled), jnp.asarray(groups, jnp.int32),
        group=128, kk=kk, interpret=True, compute_f32=True,
    )
    got = tts.gather_rescore_i8(
        torch.from_numpy(values), torch.from_numpy(q_scaled), torch.from_numpy(groups).to(torch.int32)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL, atol=REL)


@pytest.mark.parametrize("b,k", [(1, 10), (8, 10), (13, 40)])
def test_int8_two_pass_matches_reference(b, k):
    """Pass 1 (the exact int8 ranking) is bitwise the reference's; pass 2's
    f32 rescore sums in another order than XLA's CPU dot, so rows are equal
    up to near ties and scores within 1e-6."""
    v, mask, values, scale = _int8(256)
    qs = _queries(b, 256, seed=b + k)
    q_i8 = tts.prepare_query_int8(torch.from_numpy(qs), torch.from_numpy(scale))
    want_rough = jax.lax.dot_general(
        jnp.asarray(q_i8.numpy()), jnp.asarray(values), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    got_rough = tts.int8_dot(q_i8, torch.from_numpy(values))
    np.testing.assert_array_equal(bits(got_rough.numpy()), bits(want_rough))
    exact = v.astype(jnp.bfloat16)
    want = jts.scan_topk_int8_two_pass(
        jnp.asarray(values), jnp.asarray(scale), jnp.asarray(exact), jnp.asarray(qs), k,
        jnp.asarray(mask),
    )
    got = tts.scan_topk_int8_two_pass(
        torch.from_numpy(values), torch.from_numpy(scale), torch.from_numpy(v).to(torch.bfloat16),
        torch.from_numpy(qs), k, torch.from_numpy(mask),
    )
    assert_equal_up_to_near_ties(got.scores.numpy(), got.indices.numpy(),
                                 np.asarray(want.scores), np.asarray(want.indices))


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b,kk", [(1, 10), (8, 60), (13, 30)])
def test_tile_topk_twin_matches_reference_kernel(d, b, kk):
    """The raw (T, kk, B) per-tile candidates, including the -inf entries
    of the tile that holds the padding rows."""
    v, mask = _slab(d)
    qs = _queries(b, d, seed=d + kk)
    slab = jnp.asarray(v, jnp.bfloat16)
    want_s, want_i = _ref_tile_topk(slab, qs, mask, kk)
    got_s, got_i = tts.tile_topk(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(qs), torch.from_numpy(mask), kk
    )
    assert got_s.shape == (N // 2048, kk, b) and got_i.dtype == torch.int32
    assert_equal_up_to_near_ties(got_s.numpy(), got_i.numpy(), want_s, want_i, axis=1)


def test_tile_topk_exhausted_tile_repeats_column_zero():
    """A tile with fewer live rows than kk: after its live rows, every pass
    takes column 0 at -inf, as ``jnp.argmax`` does; the scan maps them to -1."""
    v, mask = _slab(128)
    mask[:2048] = -np.inf
    mask[5] = 0.0  # one live row in tile 0
    qs = _queries(2, 128)
    want_s, want_i = _ref_tile_topk(jnp.asarray(v, jnp.bfloat16), qs, mask, 4)
    got_s, got_i = tts.tile_topk(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(qs), torch.from_numpy(mask), 4
    )
    np.testing.assert_array_equal(got_i[0].numpy(), want_i[0])
    assert (got_i[0, 0] == 5).all() and (got_i[0, 1:] == 0).all()
    np.testing.assert_allclose(got_s[0].numpy(), want_s[0], rtol=REL, atol=REL)
    res = tts.scan_topk_pallas(
        torch.from_numpy(v[:2048]).to(torch.bfloat16), torch.from_numpy(qs), 4,
        torch.from_numpy(mask[:2048]),
    )
    assert (res.indices[:, 0] == 5).all() and (res.indices[:, 1:] == -1).all()


def test_tile_topk_ties_take_the_first_column():
    """Equal scores, -0.0 beside +0.0 included, go to the first column."""
    slab = np.zeros((2048, 128), np.float32)
    slab[3, 0] = slab[9, 0] = slab[700, 0] = 0.5
    slab[1, 0], slab[2, 0] = -0.0, 0.0
    q = np.zeros((1, 128), np.float32)
    q[0, 0] = 1.0
    mask = np.zeros(2048, np.float32)
    want_s, want_i = _ref_tile_topk(jnp.asarray(slab, jnp.bfloat16), q, mask, 6)
    got_s, got_i = tts.tile_topk(
        torch.from_numpy(slab).to(torch.bfloat16), torch.from_numpy(q), torch.from_numpy(mask), 6
    )
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert got_i[0, :, 0].tolist() == [3, 9, 700, 0, 1, 2]


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b,k", [(1, 10), (8, 60), (13, 10)])
def test_scan_topk_pallas_matches_reference(d, b, k):
    v, mask = _slab(d)
    qs = _queries(b, d, seed=k)
    want = jts.scan_topk_pallas(
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(qs), k, jnp.asarray(mask),
        tile_n=2048, interpret=True,
    )
    got = tts.scan_topk_pallas(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(qs), k, torch.from_numpy(mask)
    )
    assert got.indices.dtype == torch.int32
    assert_equal_up_to_near_ties(got.scores.numpy(), got.indices.numpy(),
                                 np.asarray(want.scores), np.asarray(want.indices))


def test_int8_and_tile_wrappers_take_the_twin_on_cpu():
    v, mask, values, scale = _int8(128)
    qs = torch.from_numpy(_queries(3, 128))
    before = (tts.group_max_int8.launches, tts.gather_rescore_i8.launches, tts.tile_topk.launches)
    tts.scan_topk_hierarchical_int8(torch.from_numpy(values), torch.from_numpy(scale), qs, 5)
    tts.scan_topk_pallas(torch.from_numpy(v).to(torch.bfloat16), qs, 5)
    assert (tts.group_max_int8.launches, tts.gather_rescore_i8.launches, tts.tile_topk.launches) == before
