"""Kernel K6's selection (``topk_scan.tile_select``) on the CPU.

K6 is K1's group maxima followed by a selection: per tile and query, t
argmax passes over the tile's groups. Its plain twin is held here to the
reference's argmax passes (``frankensearch_tpu.ops.ab_primitives.iter_topk``,
the passes of ``_group_candidates_kernel``: the largest maximum, the first
group equal to it, knocked out with -inf), and to the ranking rule that
csrc/group_candidates.cu computes instead of the passes, written out in
numpy below. The card tests hold the kernel itself to the twin.

Inputs are ``chip_smoke.crafted_maxima``: ties, +0.0 and -0.0 in one tie
class in both group orders, -inf groups between finite ones, a masked tile
and a tile of zeros. Every comparison is bitwise: no arithmetic happens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from frankensearch_tpu.ops import ab_primitives as jab
from frankensearch_tpu_torch.ops import topk_scan as tts

CASES = [(8192, 1), (8192, 30), (8192, 60), (8192, 64), (2048, 1), (2048, 7), (2048, 16)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _ranked(row: np.ndarray, t: int) -> tuple[np.ndarray, np.ndarray]:
    """csrc/group_candidates.cu's rule for one row of maxima: group i (not
    -inf) goes to pass #{k: x_k > x_i} + #{k < i: x_k == x_i} with value
    x_i, except that a zero's value is +0.0 up to the pass that takes the
    last +0.0 group and -0.0 after it; the passes past the finite groups
    give (-inf, 0)."""
    g = row.shape[0]
    ranks = [int(np.sum(row > row[i])) + int(np.sum(row[:i] == row[i])) for i in range(g)]
    plus_last = max((ranks[i] for i in range(g) if _bits(row[i]) == 0), default=-1)
    vals = np.full(t, -np.inf, np.float32)
    cols = np.zeros(t, np.int64)
    for i in range(g):
        r = ranks[i]
        if row[i] == -np.inf or r >= t:
            continue
        vals[r] = (np.float32(0.0) if r <= plus_last else np.float32(-0.0)) if row[i] == 0 else row[i]
        cols[r] = i
    return vals, cols


@pytest.mark.parametrize("tile_n,t", CASES)
def test_tile_select_twin_matches_the_reference_passes(tile_n, t):
    g = tile_n // 128
    gm = chip_smoke.crafted_maxima(70, 4, g, seed=tile_n + t)
    got_v, got_g = tts.tile_select(torch.from_numpy(gm), t, tile_n)  # (T, t, B)
    want_v, want_c = jab.iter_topk(jnp.asarray(gm.reshape(70 * 4, g)), t)  # (B * T, t)
    want_v = np.asarray(want_v).reshape(70, 4, t).transpose(1, 2, 0)
    want_g = np.asarray(want_c).reshape(70, 4, t).transpose(1, 2, 0) + np.arange(4)[:, None, None] * g
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))


@pytest.mark.parametrize("tile_n,t", CASES)
def test_ranking_rule_gives_the_passes(tile_n, t):
    g = tile_n // 128
    gm = chip_smoke.crafted_maxima(70, 4, g, seed=3 * tile_n + t)
    got_v, got_g = tts.tile_select(torch.from_numpy(gm), t, tile_n)
    for b in range(70):
        for tile in range(4):
            vals, cols = _ranked(gm[b, tile * g : (tile + 1) * g], t)
            np.testing.assert_array_equal(_bits(got_v[tile, :, b].numpy()), _bits(vals))
            np.testing.assert_array_equal(got_g[tile, :, b].numpy(), cols + tile * g)


def test_crafted_maxima_reach_every_case():
    gm = chip_smoke.crafted_maxima(70, 4, 64, seed=1)
    tile0 = gm[:, :64]
    assert np.isneginf(gm[:, 64:128]).all()  # a masked tile
    assert (gm[:, 128:192] == 0).all() and np.signbit(gm[:, 128:192]).any()  # zeros of both signs
    assert _bits(gm[0, :4]).tolist() == _bits(np.array([0.0, -0.0, 0.0, -0.0])).tolist()
    assert _bits(gm[1, :4]).tolist() == _bits(np.array([-0.0, 0.0, -0.0, 0.0])).tolist()
    finite = np.isfinite(tile0)
    assert (np.isneginf(tile0) & np.roll(finite, 1, axis=1) & np.roll(finite, -1, axis=1)).any()
    assert all(len(np.unique(r[np.isfinite(r)])) < np.isfinite(r).sum() for r in tile0[:8])  # ties


@pytest.mark.parametrize("tile_n", [2048, 8192])
def test_group_candidates_twin_is_k1_then_the_selection(tile_n):
    rng = np.random.default_rng(tile_n)
    slab = torch.from_numpy(rng.standard_normal((16384, 128)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32))
    mask = torch.zeros(16384)
    mask[8192 + 300 :] = float("-inf")
    t = tile_n // 128 - 1
    got_v, got_g = tts.group_candidates(slab, q, mask, t, tile_n)
    want_v, want_g = tts.tile_select(tts.group_max(slab, q, mask), t, tile_n)
    assert torch.equal(got_g, want_g)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
