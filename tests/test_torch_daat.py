"""PyTorch port of the term-driven (DAAT) BM25 lane against the JAX
reference, on the CPU.

Both layouts (f32, 8 B/posting, and packed, 5 B/posting) must hold the
reference's arrays; the packed decode must give the f32 layout's tf-side
bits; and ``daat_topk_tm`` must equal the reference's bit for bit in both
layouts: its ops are elementwise, a stable sort by doc and a run sum in
the plan's term order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.lexical import daat as jdaat
from frankensearch_tpu_torch.lexical import daat as tdaat
from frankensearch_tpu_torch.lexical import hot_arm as thot
from tests.test_torch_hot_arm import CPU, QUERIES, bits, build_pair


@pytest.fixture(scope="module")
def pair():
    _, ref, port = build_pair()
    return ref, port


def _layouts(ref, port, packed: bool):
    host = port._cold_host
    raw = port._cold_raw if packed else None
    want = jdaat.build_term_major(*host, vocab_size=port.vocab_size, raw=raw)
    got = tdaat.build_term_major(*host, vocab_size=port.vocab_size, device=CPU, raw=raw)
    assert got.packed == want.packed == packed
    return got, want


@pytest.mark.parametrize("packed", [False, True])
def test_term_major_layout_equal(pair, packed):
    got, want = _layouts(*pair, packed)
    np.testing.assert_array_equal(got.ptr, want.ptr)
    assert got.n_postings == want.n_postings
    for g, w in zip(got.device_arrays(), want.device_arrays()):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint16:  # the port keeps the u16 word's bits as i16
            g = g.view(np.uint16)
        np.testing.assert_array_equal(g, w)


def test_packed_decode_gives_f32_bits(pair):
    f32, _ = _layouts(*pair, False)
    packed, _ = _layouts(*pair, True)
    rows = torch.arange(f32.tm_doc.shape[0])
    b, r = 1, rows.numel()
    d0, f0 = tdaat._gather_span_tiles(f32.device_arrays(), rows, b, r, packed=False)
    d1, f1 = tdaat._gather_span_tiles(packed.device_arrays(), rows, b, r, packed=True)
    live = (d0 >= 0).numpy()
    np.testing.assert_array_equal(d1.numpy()[live], d0.numpy()[live])
    np.testing.assert_array_equal(bits(f1.numpy()[live]), bits(f0.numpy()[live]))


def _plan_rows(port, queries):
    ids, w = port._query_sparse_rows(queries)
    return thot.compact_tail_rows(port._hot.hot_row_of, ids, w)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_daat_topk_bitwise(pair, packed, k):
    got_tm, want_tm = _layouts(*pair, packed)
    ids, w = _plan_rows(pair[1], QUERIES[:8])
    plan = jdaat.build_gather_plan(want_tm.ptr, ids, w)
    for g, x in zip(tdaat.build_gather_plan(got_tm.ptr, ids, w), plan):
        np.testing.assert_array_equal(g, x)
    ws, wi = jdaat.daat_topk_tm(
        want_tm.device_arrays(), *(jnp.asarray(x) for x in plan),
        k=k, t_run=ids.shape[1], packed=packed,
    )
    gs, gi = tdaat.daat_topk_tm(
        got_tm.device_arrays(), *(torch.from_numpy(x) for x in plan),
        k=k, t_run=ids.shape[1], packed=packed,
    )
    assert gi.dtype == torch.int32 and gs.shape == (8, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(bits(gs.numpy()), bits(ws))


def test_plan_estimates_and_eligibility_equal(pair):
    ref, port = pair
    ids, w = _plan_rows(port, QUERIES)
    tm = port._term_major()
    np.testing.assert_array_equal(
        tdaat.query_plan_elements(tm.ptr, ids, w), jdaat.query_plan_elements(tm.ptr, ids, w)
    )
    for total in (port.cold_posting_count, 1 << 30):
        np.testing.assert_array_equal(
            tdaat.daat_eligible(tm.ptr, ids, w, total_postings=total),
            jdaat.daat_eligible(tm.ptr, ids, w, total_postings=total),
        )


def test_layout_gates_like_reference(pair, monkeypatch):
    _, port = pair
    host, raw = port._cold_host, port._cold_raw
    monkeypatch.setattr(tdaat, "PACKED_MAX_TF", 0)  # raw tf above the gate -> f32
    assert not tdaat.build_term_major(*host, vocab_size=port.vocab_size, device=CPU, raw=raw).packed
    monkeypatch.setattr(tdaat, "DAAT_MAX_LAYOUT_BYTES", 64)
    assert tdaat.build_term_major(*host, vocab_size=port.vocab_size, device=CPU, raw=raw) is None
