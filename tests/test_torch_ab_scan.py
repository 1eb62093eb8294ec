"""The A/B scan lanes of ops/ab_primitives.py and kernel K6's plain twin
against the JAX reference, both on the CPU.

The reference runs its Pallas kernels in interpret mode: K6
(``_group_candidates_kernel``), K1 (``_group_max_kernel``) and K2
(``_gather_rescore_kernel``, ``rescore="pallas"``); the port runs their
plain twins. Inputs are seeded numpy arrays, 128-row groups.

Tolerances:
- group ids, selected groups and result rows are equal;
- group maxima and scores are f32 sums of exact bf16 products whose order
  differs between the two CPU backends: 1e-6 relative;
- inside the port every route of the A/B entry is bitwise equal to
  ``scan_topk_hierarchical``: they differ only in how the groups are
  chosen, and the twins' sums do not depend on the route.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from frankensearch_tpu.ops import ab_primitives as jab
from frankensearch_tpu.ops import topk_scan as jts
from frankensearch_tpu_torch.ops import ab_primitives as tab
from frankensearch_tpu_torch.ops import topk_scan as tts

REL = 1e-6


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _slab(n=8192, d=128, seed=0, live=None):
    rng = np.random.default_rng(seed)
    v = _unit(rng, n, d)
    mask = np.zeros(n, np.float32)
    if live is not None:
        v[live:] = 0.0
        mask[live:] = -np.inf
    return v, mask


def _both(v):
    """The slab as the reference's bf16 array and the port's bf16 tensor."""
    j = jnp.asarray(v, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).astype(np.float32)).to(torch.bfloat16)


def _ref_group_candidates(slab, q, mask, t, tile_n):
    """The reference's K6 pallas_call (ab_primitives.py:199), interpreted."""
    n, d = slab.shape
    b, nt = q.shape[0], n // tile_n
    v, g = pl.pallas_call(
        functools.partial(jab._group_candidates_kernel, group=128, t=t),
        grid=(nt,),
        in_specs=[
            pl.BlockSpec((b, d), lambda i: (0, 0)),
            pl.BlockSpec((tile_n, d), lambda i: (i, 0)),
            pl.BlockSpec((1, 1, tile_n), lambda i: (i, 0, 0)),
        ],
        out_specs=(pl.BlockSpec((1, t, b), lambda i: (i, 0, 0)),) * 2,
        out_shape=(jax.ShapeDtypeStruct((nt, t, b), jnp.float32),
                   jax.ShapeDtypeStruct((nt, t, b), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q), slab, jnp.asarray(mask).reshape(nt, 1, tile_n))
    return np.asarray(v), np.asarray(g)


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


@pytest.mark.parametrize("tile_n,t,live,b", [
    (2048, 10, None, 8),
    (2048, 16, None, 3),  # t = g_tile: every group of the tile, in order
    (1024, 5, 6000, 8),  # masked tail; the last tiles run out and repeat group 0
    (8192, 60, None, 2),  # the card's tile: 64 groups
])
def test_group_candidates_twin_matches_reference_kernel(tile_n, t, live, b):
    v, mask = _slab(live=live)
    sj, st = _both(v)
    q = _unit(np.random.default_rng(1), b, 128)
    want_v, want_g = _ref_group_candidates(sj, q, mask, t, tile_n)
    got_v, got_g = tts.group_candidates(st, torch.from_numpy(q), torch.from_numpy(mask), t, tile_n)
    assert got_v.shape == got_g.shape == (8192 // tile_n, t, b) and got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=REL, atol=REL)
    assert np.array_equal(np.isinf(got_v.numpy()), np.isinf(want_v))


@pytest.mark.parametrize("emit", ["gmax", "tile_topk"])
@pytest.mark.parametrize("group_select", ["sort", "iter"])
@pytest.mark.parametrize("rescore", ["pallas", "xla"])
def test_ab_scan_matches_reference(emit, group_select, rescore):
    """group 128, N = 8192, tile_n = 2048, B = 8, k = 10: the tile_topk
    route narrows (4 tiles x 10 < 64 groups)."""
    v, mask = _slab(live=8000)
    sj, st = _both(v)
    q = _unit(np.random.default_rng(2), 8, 128)
    kw = {"tile_n": 2048, "emit": emit, "group_select": group_select, "rescore": rescore}
    want = jab.scan_topk_hierarchical_ab(sj, jnp.asarray(q), 10, jnp.asarray(mask), interpret=True, **kw)
    got = tab.scan_topk_hierarchical_ab(st, torch.from_numpy(q), 10, torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=REL, atol=REL)


@pytest.mark.parametrize("b", [1, 8, 13])
@pytest.mark.parametrize("k", [1, 10, 30, 60])
def test_ab_routes_bitwise_equal_to_hierarchical(b, k):
    v, mask = _slab(live=7900, seed=b + k)
    _, st = _both(v)
    q, m = torch.from_numpy(_unit(np.random.default_rng(k), b, 128)), torch.from_numpy(mask)
    want = tts.scan_topk_hierarchical(st, q, k, m)
    for kw in ({"emit": "tile_topk"}, {"emit": "tile_topk", "tile_n": 1024}, {"group_select": "iter"}):
        got = tab.scan_topk_hierarchical_ab(st, q, k, m, **{"tile_n": 2048, **kw})
        assert torch.equal(got.indices, want.indices), kw
        assert np.array_equal(bits(got.scores), bits(want.scores)), kw


def _winners_in_one_tile():
    rng = np.random.default_rng(3)
    slab = _unit(rng, 8192, 128) * 0.1
    q = _unit(rng, 1, 128)
    for i in range(10):
        slab[2048 + i * 128] = q[0] * (1.0 - 0.001 * i)  # tile 1, 10 different groups
    return slab, q, np.zeros(8192, np.float32), 10


def _tie_heavy():
    row = np.zeros((1, 128), np.float32)
    row[0, 0] = 1.0
    return np.tile(row, (8192, 1)), row, np.zeros(8192, np.float32), 10


def _masked():
    v, mask = _slab(seed=4)
    mask[6000:] = -np.inf
    return v, _unit(np.random.default_rng(5), 4, 128), mask, 12


def _fully_masked():
    v, _ = _slab(seed=6)
    return v, _unit(np.random.default_rng(7), 2, 128), np.full(8192, -np.inf, np.float32), 5


def _random():
    v, mask = _slab(seed=8)
    return v, _unit(np.random.default_rng(9), 8, 128), mask, 10


@pytest.mark.parametrize("case", [_random, _masked, _winners_in_one_tile, _tie_heavy, _fully_masked])
def test_tile_topk_cases_bit_parity(case):
    """The reference's own emit="tile_topk" cases (tests/test_ops_scan.py),
    re-cut to 128-row groups and 2048-row tiles: the route narrows, is
    bitwise the hierarchical scan in the port, and returns the reference's
    rows."""
    slab, q, mask, k = case()
    sj, st = _both(slab)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mask)
    assert 4 * min(k, 16) < 64  # the narrowing branch
    got = tab.scan_topk_hierarchical_ab(st, qt, k, mt, tile_n=2048, emit="tile_topk")
    want = tts.scan_topk_hierarchical(st, qt, k, mt)
    assert torch.equal(got.indices, want.indices)
    assert np.array_equal(bits(got.scores), bits(want.scores))
    # the f32-query rescore (the reference's only rescore at B % 8 != 0)
    ref = jab.scan_topk_hierarchical_ab(sj, jnp.asarray(q), k, jnp.asarray(mask), tile_n=2048,
                                        emit="tile_topk", interpret=True)
    got_xla = tab.scan_topk_hierarchical_ab(st, qt, k, mt, tile_n=2048, emit="tile_topk", rescore="xla")
    np.testing.assert_array_equal(got_xla.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got_xla.scores.numpy(), np.asarray(ref.scores), rtol=REL, atol=REL)
    idx = got.indices.numpy()
    if case is _winners_in_one_tile:
        np.testing.assert_array_equal(idx[0], 2048 + np.arange(10) * 128)
    elif case is _tie_heavy:
        np.testing.assert_array_equal(idx[0], np.arange(10))
    elif case is _fully_masked:
        assert (idx == -1).all()
    elif case is _masked:
        assert idx.max() < 6000


@pytest.mark.parametrize("route", ["no_narrowing", "iter"])
def test_gmax_routes_match_reference(route):
    """tile_n = 1024 gives 8 groups a tile, so 8 tiles x 8 >= 64 groups and
    emit="tile_topk" takes the group-max route: exact against the f32 scan.
    group_select="iter" against the reference's own iter parity case."""
    v, mask = _slab(n=4096, seed=11)
    sj, st = _both(v)
    q = _unit(np.random.default_rng(12), 8, 128)
    if route == "no_narrowing":
        got = tab.scan_topk_hierarchical_ab(torch.from_numpy(v), torch.from_numpy(q), 10,
                                            tile_n=1024, emit="tile_topk", rescore="xla")
        want = jts.scan_topk_xla(jnp.asarray(v), jnp.asarray(q), 10, precise=True)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        return
    got = tab.scan_topk_hierarchical_ab(st, torch.from_numpy(q), 10, tile_n=1024, group_select="iter")
    want = jab.scan_topk_hierarchical_ab(sj, jnp.asarray(q), 10, tile_n=1024, group_select="iter",
                                         rescore="pallas", interpret=True)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=REL, atol=REL)
    control = tts.scan_topk_hierarchical(st, torch.from_numpy(q), 10)
    assert torch.equal(got.indices, control.indices)
    assert np.array_equal(bits(got.scores), bits(control.scores))


@pytest.mark.parametrize("n,kk", [(1000, 13), (1000, 130), (200, 7), (24, 3)])
def test_group_selection_against_lax_top_k(n, kk):
    """iter_topk and topk_groups_two_stage against lax.top_k, with a tie
    across two chunks of the two-stage split."""
    gmax = np.random.default_rng(n + kk).standard_normal((4, n)).astype(np.float32)
    gmax[:, min(500, n - 1)] = gmax[:, 10]
    want_s, want_i = jax.lax.top_k(jnp.asarray(gmax), kk)
    got_s, got_i = tab.iter_topk(torch.from_numpy(gmax), kk)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(bits(got_s), bits(want_s))
    two = tab.topk_groups_two_stage(torch.from_numpy(gmax), kk)
    assert two.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(two.numpy(), axis=1), np.sort(np.asarray(want_i), axis=1))
    np.testing.assert_array_equal(
        two.numpy(), np.asarray(jab.topk_groups_two_stage(jnp.asarray(gmax), kk)))


def test_signed_zero_pinned_to_reference():
    """Each argmax pass records the maximum with +0.0 above -0.0 (jnp.max)
    and the first column equal to it (-0.0 == +0.0), unlike lax.top_k,
    which ranks +0.0 first."""
    x = np.array([[-0.0, 0.0, -1.0, -np.inf], [0.0, -0.0, -1.0, -np.inf]], np.float32)
    want_s, want_i = jab.iter_topk(jnp.asarray(x), 4)
    got_s, got_i = tab.iter_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(bits(got_s), bits(want_s))
    # pass 4 finds every column at -inf and takes column 0 again
    assert np.asarray(want_i)[0].tolist() == [0, 1, 2, 0] and not np.signbit(np.asarray(want_s)[0, 0])


def test_ab_scan_rejects_what_it_does_not_run():
    st = torch.zeros(8192, 128, dtype=torch.bfloat16)
    q = torch.zeros(1, 128)
    for kw, match in [({"group": 64}, "128-row groups"), ({"emit": "tiles"}, "emit"),
                      ({"rescore": "mxu"}, "rescore"), ({"group_select": "heap"}, "group_select"),
                      ({"tile_n": 3000}, "n % tile_n")]:
        with pytest.raises(ValueError, match=match):
            tab.scan_topk_hierarchical_ab(st, q, 5, **kw)
