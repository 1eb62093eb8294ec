"""PyTorch port of ops/topk_scan.py against the JAX reference (both on the CPU).

The reference's hierarchical scan runs its Pallas kernels in interpret mode
(``rescore="pallas"``, the main path's rescore), the port its kernels' plain
twins. The JAX kernel rescore needs B % 8 == 0, so the reference batch is
padded by repeating query 0 and cut back (rows never depend on batchmates).

Tolerances: indices must be equal; scores agree to 1e-6 relative to the
unit score scale — bf16 products are exact in f32 and only the f32
summation order differs between the two CPU backends. Tie cases use
dyadic values whose sums are exact, so there the scores are bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.ops import topk_scan as jts
from frankensearch_tpu_torch.ops import topk_scan as tts

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _jax_hier(slab, q, k, mask, jdtype):
    b = q.shape[0]
    b_pad = max(-(-b // 8) * 8, 8)
    qp = np.concatenate([q, np.repeat(q[:1], b_pad - b, axis=0)])
    res = jts.scan_topk_hierarchical(
        jnp.asarray(slab, jdtype), jnp.asarray(qp), k,
        None if mask is None else jnp.asarray(mask),
        tile_n=1024, group=128, rescore="pallas", interpret=True,
    )
    return np.asarray(res.scores)[:b], np.asarray(res.indices)[:b]


def _torch_hier(slab, q, k, mask, tdtype):
    res = tts.scan_topk_hierarchical(
        torch.from_numpy(slab).to(tdtype), torch.from_numpy(q), k,
        None if mask is None else torch.from_numpy(mask),
    )
    assert res.indices.dtype == torch.int32 and res.scores.dtype == torch.float32
    return res.scores.numpy(), res.indices.numpy()


def _assert_same(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-6)


def _masked(n, live):
    mask = np.zeros(n, np.float32)
    mask[live:] = -np.inf  # padding rows
    mask[[3, 200, 777]] = -np.inf  # tombstones
    return mask


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b", [1, 5, 8, 13])
def test_hierarchical_matches_reference(dtype, b):
    rng = np.random.default_rng(b)
    slab = _unit_rows(rng, 2048, 128)
    q = _unit_rows(rng, b, 128)
    mask = _masked(2048, 1900)
    jd, td = DTYPES[dtype]
    _assert_same(_torch_hier(slab, q, 10, mask, td), _jax_hier(slab, q, 10, mask, jd))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("precise", [False, True])
def test_xla_scan_matches_reference(dtype, precise):
    rng = np.random.default_rng(7)
    slab = _unit_rows(rng, 1000, 96)
    q = _unit_rows(rng, 6, 96)
    mask = _masked(1000, 990)
    jd, td = DTYPES[dtype]
    want = jts.scan_topk_xla(jnp.asarray(slab, jd), jnp.asarray(q), 12, jnp.asarray(mask), precise=precise)
    got = tts.scan_topk_xla(
        torch.from_numpy(slab).to(td), torch.from_numpy(q), 12, torch.from_numpy(mask), precise=precise
    )
    _assert_same((got.scores.numpy(), got.indices.numpy()),
                 (np.asarray(want.scores), np.asarray(want.indices)))


@pytest.mark.parametrize("lane", ["hierarchical", "xla"])
def test_exact_ties_break_toward_lower_row(lane):
    """Duplicate rows score identically; both packages must keep the lower
    row first, in the same order. Dyadic values keep every sum exact."""
    rng = np.random.default_rng(3)
    slab = rng.integers(-4, 5, size=(1024, 128)).astype(np.float32) / 8.0
    q = rng.integers(-4, 5, size=(4, 128)).astype(np.float32) / 8.0
    slab[[900, 40, 513, 128, 129]] = slab[5]  # a 6-way tie across groups
    q[1] = slab[5]
    mask = np.zeros(1024, np.float32)
    if lane == "hierarchical":
        want = _jax_hier(slab, q, 10, mask, jnp.bfloat16)
        got = _torch_hier(slab, q, 10, mask, torch.bfloat16)
    else:
        w = jts.scan_topk_xla(jnp.asarray(slab, jnp.bfloat16), jnp.asarray(q), 10, jnp.asarray(mask))
        g = tts.scan_topk_xla(torch.from_numpy(slab).to(torch.bfloat16), torch.from_numpy(q), 10,
                              torch.from_numpy(mask))
        want = (np.asarray(w.scores), np.asarray(w.indices))
        got = (g.scores.numpy(), g.indices.numpy())
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1][1, :6].tolist() == [5, 40, 128, 129, 513, 900]


def test_fully_masked_and_short_corpus_give_minus_one():
    """k beyond the live rows: -inf scores come back as index -1."""
    rng = np.random.default_rng(11)
    slab = _unit_rows(rng, 1024, 64)
    q = _unit_rows(rng, 3, 64)
    mask = np.full(1024, -np.inf, np.float32)
    mask[[10, 500, 1000]] = 0.0
    want = _jax_hier(slab, q, 8, mask, jnp.bfloat16)
    got = _torch_hier(slab, q, 8, mask, torch.bfloat16)
    _assert_same(got, want)
    assert (got[1][:, 3:] == -1).all() and np.isneginf(got[0][:, 3:]).all()
    assert sorted(got[1][0, :3].tolist()) == [10, 500, 1000]


def test_k_larger_than_candidates_pads():
    rng = np.random.default_rng(12)
    slab = _unit_rows(rng, 256, 32)
    q = _unit_rows(rng, 2, 32)
    got = tts.scan_topk_hierarchical(torch.from_numpy(slab), torch.from_numpy(q), 300)
    want = tts.scan_topk_xla(torch.from_numpy(slab), torch.from_numpy(q), 300)
    assert got.indices.shape == (2, 300)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices.numpy())
    assert (got.indices[:, 256:] == -1).all()


def test_topk_order_matches_lax_top_k_on_zeros_and_ties():
    import jax

    x = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -np.inf, 1.0, 0.5]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 8)
    vals, got = tts.topk_desc_rowasc(torch.from_numpy(x), 8)
    assert got.tolist() == np.asarray(want).tolist() == [[4, 6, 7, 0, 2, 1, 3, 5]]
    assert torch.equal(torch.signbit(vals), torch.from_numpy(np.signbit(x[:, got[0].numpy()])))


def test_kernel_wrappers_take_the_twin_on_cpu():
    """On CPU tensors the wrappers run the plain twins and count nothing."""
    rng = np.random.default_rng(5)
    slab = torch.from_numpy(_unit_rows(rng, 512, 64)).to(torch.bfloat16)
    q = torch.from_numpy(_unit_rows(rng, 3, 64))
    mask = torch.zeros(512)
    groups = torch.tensor([[0, 2], [1, 3], [3, 0]], dtype=torch.int32)
    before = (tts.group_max.launches, tts.gather_rescore.launches)
    assert torch.equal(tts.group_max(slab, q, mask), tts.group_max_plain(slab, q, mask))
    assert torch.equal(
        tts.gather_rescore(slab, q, groups), tts.gather_rescore_plain(slab, q, groups)
    )
    assert (tts.group_max.launches, tts.gather_rescore.launches) == before


def test_gather_rescore_rounds_query_to_slab_dtype():
    """K2's numerics are the TPU kernel's: bf16 query x bf16 rows, f32 sum."""
    rng = np.random.default_rng(9)
    slab = _unit_rows(rng, 256, 64)
    q = _unit_rows(rng, 2, 64)
    groups = torch.tensor([[1], [0]], dtype=torch.int32)
    got = tts.gather_rescore_plain(torch.from_numpy(slab).to(torch.bfloat16), torch.from_numpy(q), groups)
    sb = torch.from_numpy(slab).to(torch.bfloat16).double()
    qb = torch.from_numpy(q).to(torch.bfloat16).double()
    want = torch.stack([sb[128:] @ qb[0], sb[:128] @ qb[1]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_additive_mask_matches_reference():
    valid = np.array([True, False, True, True, False])
    want = np.asarray(jts.additive_mask(jnp.asarray(valid)))
    got = tts.additive_mask(torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
