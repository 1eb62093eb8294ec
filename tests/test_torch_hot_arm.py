"""PyTorch port of the split (hot-arm) BM25 layout and its flat lane
against the JAX reference, on the CPU.

The same corpus builds the reference's and the port's ``DeviceBm25Index``
with the blocked threshold and the hot arm's minimum lowered in both
packages, as tests/test_hot_arm.py does for the reference. The reference's
flat lane runs its Pallas kernel K3 in interpret mode (``FLAT_PALLAS =
"interpret"``): the port's only flat scorer is K3's (l, j) order, which
the reference's default XLA einsum does not share (it differs by ~1e-7
relative). With the same hot partial given to both, the flat lane is
bitwise equal. The port's own hot partial (``torch.matmul``, fixed at
``FLAT_B_TILE`` rows) may differ from the reference's XLA dot in the last
bits: where it enters, rows must be equal wherever the reference's k-th
score has no tie within 1e-6, and scores within 1e-6 relative. The
retired hot combine of the term-driven lane (``ops/ab_primitives.
hot_daat_topk_ab``) is held the same way to the reference's, and by rank,
scores within 1e-5, to the split layout's flat lane (tests/test_hot_arm.py).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu.lexical import daat as jdaat
from frankensearch_tpu.lexical import device_bm25 as jbm
from frankensearch_tpu.lexical import hot_arm as jhot
from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex
from frankensearch_tpu_torch.core.types import IndexableDocument as PortDocument
from frankensearch_tpu_torch.lexical import daat as tdaat
from frankensearch_tpu_torch.lexical import device_bm25 as tbm
from frankensearch_tpu_torch.lexical import hot_arm as thot
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex as PortMemoryIndex

CPU = torch.device("cpu")
WORDS = [f"w{i}" for i in range(300)]
QUERIES = [
    "w0 w1", "w0", "w250", "w40 w41 w42", "w0 w1 w2 w3 w4", "nothing",
    "w100 w120 w140 w160 w180 w200 w220 w240 w260", "w7 w199 w3",
    "w290 w291", "w60 w61",
]
REL = 1e-6


def corpus(n_docs=400, seed=11):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    docs = [
        IndexableDocument(
            doc_id=f"d{i:04d}",
            content=" ".join(rng.choice(WORDS, size=int(rng.integers(3, 60)), p=p)),
            title=" ".join(rng.choice(WORDS[:40], size=2)) if i % 4 == 0 else None,
        )
        for i in range(n_docs)
    ]
    # a doc made only of the commonest word owns no tail posting
    docs.append(IndexableDocument(doc_id="hotonly", content="w0 w0 w0"))
    return docs


@contextlib.contextmanager
def lowered(*, hot: bool = True, max_terms: int = 6, extra=()):
    """Force the blocked layout (and the hot arm unless ``hot`` is False)
    in both packages; ``extra`` sets further (module, name, value)s."""
    sets = [
        (jbm, "BLOCKED_THRESHOLD_POSTINGS", 1), (tbm, "BLOCKED_THRESHOLD_POSTINGS", 1),
        (jhot, "HOT_MIN_POSTINGS", 1 if hot else 1 << 60),
        (thot, "HOT_MIN_POSTINGS", 1 if hot else 1 << 60),
        (jhot, "HOT_MAX_TERMS", max_terms), (thot, "HOT_MAX_TERMS", max_terms),
    ] + list(extra)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sets]
    for mod, name, v in sets:
        setattr(mod, name, v)
    try:
        yield
    finally:
        for mod, name, v in saved:
            setattr(mod, name, v)


def port_docs(docs):
    """The same documents as the port's own ``IndexableDocument``s."""
    return [PortDocument(d.doc_id, d.content, d.title, d.metadata) for d in docs]


def memory_pair(docs):
    """The same committed documents in the reference's
    ``MemoryLexicalIndex`` and in the port's own copy of it."""
    mem, port_mem = MemoryLexicalIndex(), PortMemoryIndex()
    for d, pd in zip(docs, port_docs(docs)):
        mem.add_document(d)
        port_mem.add_document(pd)
    mem.commit()
    port_mem.commit()
    return mem, port_mem


def build_pair(docs=None, *, hot=True, max_terms=6):
    mem, port_mem = memory_pair(docs or corpus())
    with lowered(hot=hot, max_terms=max_terms):
        return mem, jbm.DeviceBm25Index(mem), tbm.DeviceBm25Index(port_mem, device=CPU)


@contextlib.contextmanager
def reference_flat_interpret():
    """Run the reference's flat lane through K3 in interpret mode. The flag
    is read when a jitted program traces, so the jit caches are cleared on
    the way in and out."""
    old = jbm.FLAT_PALLAS
    jbm.FLAT_PALLAS = "interpret"
    jax.clear_caches()
    try:
        yield
    finally:
        jbm.FLAT_PALLAS = old
        jax.clear_caches()


@pytest.fixture(scope="module")
def split_pair():
    mem, ref, port = build_pair()
    assert ref._hot is not None and port._hot is not None and port._hot.n_hot == 6
    return mem, ref, port


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def query_rows(port, b, seed, t_q=8):
    """Random sparse rows over the vocab, hot and tail mixed, as
    (tail ids, tail weights, q_hot) numpy arrays."""
    rng = np.random.default_rng(seed)
    hot = port._hot
    ids = rng.integers(0, port.vocab_size, size=(b, t_q)).astype(np.int32)
    hot_ids = np.flatnonzero(hot.hot_row_of >= 0)
    ids[::2, 0] = rng.choice(hot_ids, size=len(ids[::2, 0]))
    w = rng.uniform(0.1, 4.0, size=(b, t_q)).astype(np.float32)
    w[1::3, -1] = 0.0
    q_hot = thot.split_hot_rows(hot.hot_row_of, ids, w, hot.h_pad)
    t_ids, t_w = thot.compact_tail_rows(hot.hot_row_of, ids, w)
    return t_ids, t_w, q_hot


# -- host structures (e) ----------------------------------------------------


def test_split_host_structures_equal(split_pair):
    _, ref, port = split_pair
    rh, ph = ref._hot, port._hot
    np.testing.assert_array_equal(ph.hot_row_of, rh.hot_row_of)
    assert ph.n_hot == rh.n_hot and ph.h_pad == rh.h_pad
    for name in ("cols_phys", "cold_cols", "cold_rows", "dmap_groups"):
        np.testing.assert_array_equal(getattr(ph, name).numpy(), np.asarray(getattr(rh, name)), name)
    assert port.cold_posting_count == ref.cold_posting_count < port.posting_count
    for got, want in zip(port._cold_host, ref._cold_host):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port._cold_raw[:2], ref._cold_raw[:2]):
        np.testing.assert_array_equal(got, want)


def test_blocked_layout_equal(split_pair):
    _, ref, port = split_pair
    rb, pb = ref._blocked, port._blocked
    assert pb.class_offsets == rb.class_offsets and pb.n_blk == rb.n_blk
    np.testing.assert_array_equal(pb.phys_doc, rb.phys_doc)
    for name in ("bm_ptr", "bm_blk", "bm_max"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(rb, name), name)
    assert len(pb.classes) == len(rb.classes) > 1
    for pc, rc in zip(pb.classes, rb.classes):
        assert pc.term is None and pc.tf is None
        for name in ("doc_map", "term_t", "tf_t"):
            np.testing.assert_array_equal(getattr(pc, name).numpy(), np.asarray(getattr(rc, name)), name)


@pytest.mark.parametrize("b", [1, 5])
def test_hot_rows_and_tail_compaction_equal(split_pair, b):
    _, ref, port = split_pair
    ids, w = port._query_sparse_rows(QUERIES[:b])
    rids, rw = ref._query_sparse_rows(QUERIES[:b])
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(w, rw)
    h = port._hot
    np.testing.assert_array_equal(
        thot.split_hot_rows(h.hot_row_of, ids, w, h.h_pad),
        jhot.split_hot_rows(h.hot_row_of, ids, w, h.h_pad),
    )
    for got, want in zip(thot.compact_tail_rows(h.hot_row_of, ids, w),
                         jhot.compact_tail_rows(h.hot_row_of, ids, w)):
        np.testing.assert_array_equal(got, want)


def test_split_budget_caps_like_reference():
    rng = np.random.default_rng(0)
    terms = (rng.zipf(1.3, size=4096) - 1) % 50
    docs = rng.integers(0, 300, size=4096)
    tfs = rng.uniform(0.1, 2.0, size=4096).astype(np.float32)
    for max_bytes in (3 << 29, 384 * 4 * 2, 0):
        with lowered(extra=[(jhot, "HOT_MAX_BYTES", max_bytes), (thot, "HOT_MAX_BYTES", max_bytes)]):
            got = thot.split_postings(terms, docs, tfs, n_docs=300, vocab_size=50)
            want = jhot.split_postings(terms, docs, tfs, n_docs=300, vocab_size=50)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.n_hot == want.n_hot
            np.testing.assert_array_equal(got.cols_np, want.cols_np)


# -- K3 and its twin (a) ----------------------------------------------------


@pytest.mark.parametrize("b,t_q", [(8, 8), (16, 16)])
def test_k3_twin_equals_reference_kernel_interpret(split_pair, b, t_q):
    """The scoring half of K3's twin against the reference kernel; the
    fused wrapper on CPU tensors runs the twin (its own tests:
    tests/test_torch_flat_fused.py)."""
    _, ref, port = split_pair
    ids, w, _ = query_rows(port, b, seed=b + t_q, t_q=t_q)
    for pc, rc in zip(port._blocked.classes, ref._blocked.classes):
        want = jbm._flat_class_scores_pallas(
            rc.term_t, rc.tf_t, jnp.asarray(ids), jnp.asarray(w), interpret=True
        )
        args = (pc.term_t, pc.tf_t, torch.from_numpy(ids), torch.from_numpy(w))
        got = tbm.flat_class_scores_plain(*args)
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))
        n_c, _, d_pad = pc.term_t.shape
        unmasked = torch.zeros((n_c, d_pad), dtype=torch.int32)  # no padding slot: the raw scores
        np.testing.assert_array_equal(bits(tbm.flat_class_fused(*args, None, 0, unmasked)[0].numpy()), bits(want))
    assert tbm.flat_class_fused.launches == 0  # CPU tensors take the twin


# -- the flat lane (b) --------------------------------------------------------


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("k", [1, 7, 100])
def test_graded_scan_flat_equals_reference(split_pair, b, k):
    """Same tail rows and the same hot partial to both: indices equal and
    scores bitwise."""
    _, ref, port = split_pair
    ids, w, q_hot = query_rows(port, b, seed=3 * b + k)
    s_phys = jhot.hot_partial(ref._hot.cols_phys, jnp.asarray(q_hot))
    with reference_flat_interpret():
        ws, wi, _ = jbm._graded_scan_flat(
            ref._blocked.classes, jnp.asarray(ids), jnp.asarray(w), s_phys,
            ref._hot.dmap_groups, k=k,
        )
    gs, gi, skipped = tbm._graded_scan_flat(
        port._blocked.classes, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(np.array(s_phys)), port._hot.dmap_groups, k=k,
    )
    assert skipped == 0
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(bits(gs.numpy()), bits(ws))


def test_graded_scan_flat_without_hot_partial(split_pair):
    _, ref, port = split_pair
    ids, w, _ = query_rows(port, 8, seed=9)
    with reference_flat_interpret():
        ws, wi, _ = jbm._graded_scan_flat(
            ref._blocked.classes, jnp.asarray(ids), jnp.asarray(w), None, ref._hot.dmap_groups, k=25,
        )
    gs, gi, _ = tbm._graded_scan_flat(
        port._blocked.classes, torch.from_numpy(ids), torch.from_numpy(w), None,
        port._hot.dmap_groups, k=25,
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(bits(gs.numpy()), bits(ws))


def _hot_body_args(pkg_hot, classes, ids, w, q_hot, to):
    return (classes, to(ids), to(w), pkg_hot.cols_phys, to(q_hot),
            pkg_hot.cold_cols, pkg_hot.cold_rows, pkg_hot.dmap_groups)


def assert_rank_tolerant(gs, gi, ws, wi, rel=REL):
    """Rows equal wherever the reference's k-th score has no other score
    within ``rel`` of it; scores within ``rel`` relative (the hot partial's
    f32 product order differs from the reference's)."""
    gs, gi, ws, wi = map(np.asarray, (gs, gi, ws, wi))
    np.testing.assert_allclose(gs, ws, rtol=rel, atol=0)
    for b in range(ws.shape[0]):
        fin = np.isfinite(ws[b])
        if not fin.any():
            np.testing.assert_array_equal(gi[b], wi[b])
            continue
        kth = ws[b][fin][-1]
        tied = np.abs(ws[b] - kth) <= rel * abs(kth)
        if tied.sum() > 1:
            sure = ~tied & fin
            assert set(gi[b][sure]) == set(wi[b][sure]), b
        else:
            np.testing.assert_array_equal(gi[b], wi[b])


@pytest.mark.parametrize("k", [5, 60])
def test_blocked_hot_body_matches_reference(split_pair, k):
    """The whole hot body, each package with its own hot partial."""
    _, ref, port = split_pair
    ids, w, q_hot = query_rows(port, 16, seed=k)
    with reference_flat_interpret():
        ws, wi, _ = jbm._blocked_hot_body(*_hot_body_args(ref._hot, ref._blocked.classes, ids, w, q_hot, jnp.asarray), k=k)
    gs, gi, _ = tbm._blocked_hot_body(*_hot_body_args(port._hot, port._blocked.classes, ids, w, q_hot, torch.from_numpy), k=k)
    assert gi.dtype == torch.int32
    assert_rank_tolerant(gs, gi, ws, wi)


# -- bit purity (d) -------------------------------------------------------------


def test_batch_tiling_and_solo_bits(split_pair, monkeypatch):
    """With FLAT_B_TILE lowered to 8, a 20-query batch runs in three tiles
    (the last padded): every row equals the same query run alone."""
    _, _, port = split_pair
    monkeypatch.setattr(tbm, "FLAT_B_TILE", 8)
    ids, w, q_hot = query_rows(port, 20, seed=31)
    h = port._hot
    args = _hot_body_args(h, port._blocked.classes, ids, w, q_hot, torch.from_numpy)
    s, i, _ = tbm._blocked_hot_body(*args, k=30)
    assert s.shape == (20, 30)
    for r in (0, 7, 8, 19):
        one = _hot_body_args(h, port._blocked.classes, ids[r : r + 1], w[r : r + 1],
                             q_hot[r : r + 1], torch.from_numpy)
        s1, i1, _ = tbm._blocked_hot_body(*one, k=30)
        np.testing.assert_array_equal(i1.numpy()[0], i.numpy()[r])
        np.testing.assert_array_equal(bits(s1.numpy()[0]), bits(s.numpy()[r]))


@pytest.mark.parametrize("tile", [8, 64])
def test_solo_vs_batch_through_search(split_pair, monkeypatch, tile):
    """Hot and pure-tail queries: a solo request's candidates are bitwise
    its row of the batch, in every lane mode."""
    _, _, port = split_pair
    monkeypatch.setattr(tbm, "FLAT_B_TILE", tile)
    for mode in ("auto", "blocked", "daat"):
        monkeypatch.setattr(port, "daat_mode", mode)
        batch = port.search_candidates_batch(QUERIES, 25)
        for q, row in zip(QUERIES, batch):
            solo = port.search_candidates_batch([q], 25)[0]
            assert [(c.doc_id, c.score) for c in solo] == [(c.doc_id, c.score) for c in row], (mode, q)


def test_hot_partial_runs_at_fixed_rows(monkeypatch):
    calls = []
    real = torch.matmul

    def spy(a, b):
        calls.append(a.shape[0])
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    cols = torch.rand(8, 300)
    q = torch.rand(70, 8)
    out = thot.hot_partial(cols, q)
    assert calls == [tbm.FLAT_B_TILE, tbm.FLAT_B_TILE] and out.shape == (70, 300)
    np.testing.assert_array_equal(bits(out[:1].numpy()), bits(thot.hot_partial(cols, q[:1]).numpy()))


def test_cold_doc_topk_equals_reference(split_pair):
    _, ref, port = split_pair
    h = port._hot
    q_hot = np.zeros((8, h.h_pad), np.float32)
    q_hot[:4, 0] = [1.0, 2.5, 0.0, 0.3]
    q_hot[2:6, 1] = 1.7
    gs, gi = thot.cold_doc_topk(h.cold_cols, h.cold_rows, torch.from_numpy(q_hot), k=5)
    ws, wi = jhot.cold_doc_topk(ref._hot.cold_cols, ref._hot.cold_rows, jnp.asarray(q_hot), k=5)
    assert_rank_tolerant(gs, gi, ws, wi)
    assert (gi.numpy()[6:] == -1).all()  # a zero hot row has no cold candidate


def test_hotonly_doc_reachable_in_every_lane(split_pair, monkeypatch):
    _, _, port = split_pair
    assert "hotonly" in {port.doc_ids[r] for r in port._hot.cold_rows.tolist() if r >= 0}
    for mode in ("auto", "daat", "blocked"):
        monkeypatch.setattr(port, "daat_mode", mode)
        assert "hotonly" in {c.doc_id for c in port.search_candidates("w0", 500)}, mode


def test_daat_modules_agree_on_tail_eligibility(split_pair):
    _, ref, port = split_pair
    ids, w = port._query_sparse_rows(QUERIES)
    ids, w = thot.compact_tail_rows(port._hot.hot_row_of, ids, w)
    tm = port._term_major()
    np.testing.assert_array_equal(
        tdaat.daat_eligible(tm.ptr, ids, w, total_postings=port.cold_posting_count),
        jdaat.daat_eligible(ref._term_major().ptr, ids, w, total_postings=ref.cold_posting_count),
    )


# -- the retired hot combine (ops/ab_primitives.hot_daat_topk_ab) ------------------------------


def global_hot_cols(index):
    """The retired layout's dense hot columns in global doc order, built on
    the host from the index's postings: (H_pad, N_pad) f32."""
    hot = index._hot
    terms, docs, tfs = index._post_host
    cols = np.zeros((hot.h_pad, max((index.n_docs + 127) // 128 * 128, 128)), dtype=np.float32)
    rows = hot.hot_row_of[terms.astype(np.int64)]
    sel = rows >= 0
    np.add.at(cols, (rows[sel], docs[sel].astype(np.int64)), tfs[sel])
    return cols


@pytest.mark.parametrize("k", [15, 60])
def test_retired_hot_daat_ab_matches_reference_and_flat_lane(split_pair, monkeypatch, k):
    from frankensearch_tpu.ops.ab_primitives import hot_daat_topk_ab as ref_ab
    from frankensearch_tpu_torch.ops.ab_primitives import hot_daat_topk_ab

    _, ref, port = split_pair
    cols = global_hot_cols(port)
    tm_t = tdaat.build_term_major(*port._cold_host, vocab_size=port.vocab_size, device=CPU)
    tm_j = jdaat.build_term_major(*ref._cold_host, vocab_size=ref.vocab_size)
    ids, w = port._query_sparse_rows(QUERIES)
    q_hot = thot.split_hot_rows(port._hot.hot_row_of, ids, w, port._hot.h_pad)
    assert ((q_hot > 0).any(axis=1) & (thot.compact_tail_rows(port._hot.hot_row_of, ids, w)[1] > 0).any(axis=1)).any()
    plan = tdaat.build_gather_plan(tm_t.ptr, ids, w)
    gs, gi = hot_daat_topk_ab(
        torch.from_numpy(cols), torch.from_numpy(q_hot), tm_t.tm_doc, tm_t.tm_tf,
        *(torch.from_numpy(x) for x in plan), k=k, t_run=ids.shape[1],
    )
    assert gi.dtype == torch.int32 and gs.shape == (len(QUERIES), k)
    ws, wi = ref_ab(jnp.asarray(cols), jnp.asarray(q_hot), tm_j.tm_doc, tm_j.tm_tf,
                    *(jnp.asarray(x) for x in plan), k=k, t_run=ids.shape[1])
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    pos_g, pos_w = gs > 0, ws > 0
    np.testing.assert_array_equal(pos_g, pos_w)
    assert_rank_tolerant(np.where(pos_g, gs, -np.inf), np.where(pos_g, gi, -1),
                         np.where(pos_w, ws, -np.inf), np.where(pos_w, wi, -1))
    monkeypatch.setattr(port, "daat_mode", "blocked")
    flat = port.search_candidates_batch(QUERIES, k)
    for b, cands in enumerate(flat):
        ab = [(port.doc_ids[int(gi[b, j])], float(gs[b, j])) for j in range(k) if gs[b, j] > 0.0]
        assert [c.doc_id for c in cands] == [d for d, _ in ab], QUERIES[b]
        np.testing.assert_allclose([c.score for c in cands], [x for _, x in ab], rtol=1e-5)
