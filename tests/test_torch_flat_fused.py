"""K3's fused twin (``flat_class_fused_plain``, the plain version of
csrc/flat_score.cu) against the JAX reference's flat class step on the CPU:
its Pallas kernel ``_flat_class_scores_pallas`` in interpret mode, then its
post-pass ``_flat_class_poststats`` (hot partial add, padding mask, group
max and row of the first max).

Both take the same rounded f32 steps in the same order, so masked scores,
group maxima and group rows are compared bit for bit. The reference kernel
tiles the batch at 8 rows or more, so a ragged batch goes to it padded with
copies of row 0 (each row's values depend on that row alone) and its extra
rows are dropped.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.lexical import device_bm25 as jbm
from frankensearch_tpu.lexical import hot_arm as jhot
from frankensearch_tpu_torch.lexical import device_bm25 as tbm
from tests.test_torch_hot_arm import bits, query_rows, split_pair  # noqa: F401  (fixture)


def reference_step(term_t, tf_t, ids, w, s_phys, off, dmap):
    """The reference's Pallas flat step for one class, interpreted, at any B."""
    b = ids.shape[0]
    pad = (-b) % 8
    if pad:
        ids = np.concatenate([ids, np.repeat(ids[:1], pad, axis=0)])
        w = np.concatenate([w, np.repeat(w[:1], pad, axis=0)])
        if s_phys is not None:
            s_phys = np.concatenate([s_phys, np.repeat(s_phys[:1], pad, axis=0)])
    sc0 = jbm._flat_class_scores_pallas(jnp.asarray(term_t), jnp.asarray(tf_t), jnp.asarray(ids),
                                        jnp.asarray(w), interpret=True)
    out = jbm._flat_class_poststats(sc0, None if s_phys is None else jnp.asarray(s_phys), off,
                                    jnp.asarray(dmap))
    return [np.asarray(x)[:, :b] for x in out]


def assert_same(got, want):
    for g, w, what in zip(got, want, ("scores", "group maxima", "group rows")):
        g = g.numpy()
        assert g.shape == w.shape, what
        if g.dtype == np.float32:
            np.testing.assert_array_equal(bits(g), bits(w), what)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), what)


def synthetic_class(l_c, seed, n_c=3, d_pad=384, vocab=40):
    """One class: term ids from a small vocabulary (so query terms hit),
    -1 padding with tf 0, and a row map with padding slots: block 0's
    last group is padding whole, block 1 ends in a ragged pad."""
    rng = np.random.default_rng(seed)
    term = rng.integers(0, vocab, size=(n_c, l_c, d_pad)).astype(np.int32)
    term[rng.random(term.shape) < 0.2] = -1
    tf = np.where(term >= 0, rng.uniform(0.1, 3.0, term.shape), 0.0).astype(np.float32)
    dmap = np.arange(n_c * d_pad, dtype=np.int32).reshape(n_c, d_pad) * 3
    dmap[0, 256:] = -1
    term[0, :, 256:] = -1
    tf[0, :, 256:] = 0.0
    dmap[1, 300:] = -1
    return term, tf, dmap


def synthetic_rows(b, t_q, seed, vocab=40, repeat=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, t_q)).astype(np.int32)
    w = rng.uniform(0.1, 4.0, size=(b, t_q)).astype(np.float32)
    w[:, -1] = 0.0  # a padding term: weight 0
    ids[:, -1] = 0
    if repeat:  # a term id twice in one row: both weights add, in j order
        ids[:, 1] = ids[:, 0]
    return ids, w


@pytest.mark.parametrize("l_c", [1, 3])
@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("hot", [True, False])
def test_fused_twin_equals_reference_on_synthetic_classes(l_c, b, hot):
    term, tf, dmap = synthetic_class(l_c, seed=l_c)
    ids, w = synthetic_rows(b, 8, seed=b, repeat=b == 5)
    off = 128
    s_phys = None
    if hot:
        s_phys = np.random.default_rng(b + l_c).uniform(0.0, 2.0, size=(b, off + term.shape[0] * term.shape[2] + 64))
        s_phys = s_phys.astype(np.float32)
    want = reference_step(term, tf, ids, w, s_phys, off, dmap)
    got = tbm.flat_class_fused(*(torch.from_numpy(x) for x in (term, tf, ids, w)),
                               None if s_phys is None else torch.from_numpy(s_phys), off, torch.from_numpy(dmap))
    assert_same(got, want)
    gmax, grow = got[1].numpy(), got[2].numpy()
    assert (gmax[0, :, 2] == -np.inf).all() and (grow[0, :, 2] == -1).all()  # the all-padding group: lane 0's row


@pytest.mark.parametrize("b", [1, 5, 16])
def test_fused_twin_equals_reference_on_the_blocked_layout(split_pair, b):  # noqa: F811
    """The split layout's own classes (the toy corpus at lowered
    thresholds) with the reference's hot partial: every class, in its slot
    range of the hot partial and its slice of the row map."""
    _, ref, port = split_pair
    ids, w, q_hot = query_rows(port, b, seed=40 + b)
    s_phys = np.array(jhot.hot_partial(ref._hot.cols_phys, jnp.asarray(q_hot)))
    dmap_groups = port._hot.dmap_groups.numpy()
    off = goff = 0
    l_seen = set()
    for pc in port._blocked.classes:
        n_c, l_c, d_pad = pc.term_t.shape
        gc = d_pad // 128
        dmap = dmap_groups[goff : goff + n_c * gc].reshape(n_c, d_pad)
        want = reference_step(pc.term_t.numpy(), pc.tf_t.numpy(), ids, w, s_phys, off, dmap)
        got = tbm.flat_class_fused(pc.term_t, pc.tf_t, torch.from_numpy(ids), torch.from_numpy(w),
                                   torch.from_numpy(s_phys), off, torch.from_numpy(dmap))
        assert_same(got, want)
        l_seen.add(l_c)
        off += n_c * d_pad
        goff += n_c * gc
    assert len(l_seen) > 1


def test_fused_wrapper_takes_the_twin_on_cpu():
    term, tf, dmap = synthetic_class(2, seed=9)
    ids, w = synthetic_rows(4, 8, seed=9)
    args = [torch.from_numpy(x) for x in (term, tf, ids, w)]
    before = tbm.flat_class_fused.launches
    got = tbm.flat_class_fused(*args, None, 0, torch.from_numpy(dmap))
    want = tbm._flat_class_poststats(tbm.flat_class_scores_plain(*args), None, 0, torch.from_numpy(dmap))
    assert tbm.flat_class_fused.launches == before
    for g, x in zip(got, want):
        assert torch.equal(g, x)
