"""PyTorch port of ops/device_rrf.py against the JAX device RRF, bitwise.

Same cases as tests/test_device_rrf.py (fuzzed phase-1 outputs, exact
score ties, zero-score and -inf slots, extreme k constants, zero-weight
arms): the port's ``rrf_tail`` + ``finish_rrf`` must return exactly what
the reference's ``device_rrf`` + ``finish_rrf`` return — rows, ranks and
f64 scores — and both must equal the host oracle ``rrf_fuse_batch_rows``.
Where two docs' ranks are swapped between the arms their f64 sums tie; the
port sums in f64 as the oracle does and breaks the tie by the oracle's
keys, while the reference's f32 (hi, lo) sum can order them by its own
rounding: there the port is held to the oracle alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.ops import device_rrf as jrrf
from frankensearch_tpu_torch.ops import device_rrf as trrf

from test_device_rrf import fuzz_case, run_oracle


def run_jax(lex_rows, lex_scores, vec_rows, row_map, limit, k_arr, lex_w, sem_w):
    b, kl = lex_rows.shape
    contrib_l, contrib_v = jrrf.make_contrib_tables(k_arr, kl, vec_rows.shape[1], lex_w, sem_w)
    cl_hi, cl_lo = jrrf.split_f64(contrib_l)
    cv_hi, cv_lo = jrrf.split_f64(contrib_v)
    out = jrrf.device_rrf(
        jnp.asarray(lex_rows.astype(np.int32)), jnp.asarray(lex_scores.astype(np.float32)),
        jnp.asarray(vec_rows.astype(np.int32)), jnp.asarray(row_map.astype(np.int32)),
        jnp.asarray(cl_hi), jnp.asarray(cl_lo), jnp.asarray(cv_hi), jnp.asarray(cv_lo),
        limit=limit,
    )
    return jrrf.finish_rrf(*(np.asarray(x) for x in out), contrib_l, contrib_v)


def run_torch(lex_rows, lex_scores, vec_rows, row_map, limit, k_arr, lex_w, sem_w):
    b, kl = lex_rows.shape
    contrib_l, contrib_v = trrf.make_contrib_tables(k_arr, kl, vec_rows.shape[1], lex_w, sem_w)
    t = torch.from_numpy
    out = trrf.rrf_tail(
        t(lex_rows.astype(np.int32)), t(lex_scores.astype(np.float32)),
        t(vec_rows.astype(np.int32)), t(row_map.astype(np.int32)),
        t(contrib_l), t(contrib_v),
        limit=limit,
    )
    assert all(x.dtype == torch.int32 for x in out)
    return trrf.finish_rrf(*(x.numpy() for x in out), contrib_l, contrib_v)


def check(lex_rows, lex_scores, vec_rows, row_map, limit, k_arr, lex_w, sem_w, n_ids):
    args = (lex_rows, lex_scores, vec_rows, row_map, limit, k_arr, lex_w, sem_w)
    got = run_torch(*args)
    assert got == run_jax(*args)
    assert got == run_oracle(*args, n_ids)
    return got


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_bitwise(seed):
    rng = np.random.default_rng(seed)
    case = fuzz_case(rng, 8, 12, 10, 200, int_k=(seed % 2 == 0))
    limit = int(rng.integers(1, 12 + 10 + 2))
    lex_rows, lex_scores, vec_rows, row_map, k_arr, lex_w, sem_w = case
    check(lex_rows, lex_scores, vec_rows, row_map, limit, k_arr, lex_w, sem_w, 200)


def test_symmetric_tie():
    got = check(
        np.array([[5, 9, -1]]), np.array([[3.0, 3.0, 0.0]], np.float32),
        np.array([[9, 5, 7]]), np.arange(20), 5, np.array([60.0]), 1.0, np.array([1.0]), 20,
    )
    assert got[0][0][1] == got[0][1][1] and [got[0][0][0], got[0][1][0]] == [5, 9]


def test_empty_and_invalid_arms():
    vec_rows = np.full((2, 3), -1)
    vec_rows[1, 0] = 2
    got = check(
        np.full((2, 4), -1), np.zeros((2, 4), np.float32), vec_rows, np.arange(5), 3,
        np.array([60.0, 60.0]), 1.0, np.array([1.0, 1.0]), 5,
    )
    assert got[0] == [] and len(got[1]) == 1


def test_neg_inf_lex_score_is_invalid():
    got = check(
        np.array([[3, 4]]), np.array([[-np.inf, 2.0]], np.float32), np.array([[3]]),
        np.arange(6), 4, np.array([30.0]), 1.0, np.array([1.0]), 6,
    )
    by_id = {e[0]: e for e in got[0]}
    assert by_id[3][3] == -1 and by_id[3][4] == 0


def test_row_map_translates_vector_rows():
    args = (np.array([[7]]), np.array([[1.5]], np.float32), np.array([[2]]),
            np.array([4, 5, 7, 9]), 3, np.array([60.0]), 1.0, np.array([1.0]))
    got = run_torch(*args)
    assert got == run_jax(*args)
    assert got[0] == [(7, got[0][0][1], True, 0, 0)]


def test_large_batch_real_budgets():
    rng = np.random.default_rng(99)
    lex_rows, lex_scores, vec_rows, row_map, k_arr, lex_w, sem_w = fuzz_case(rng, 16, 40, 40, 1000)
    check(lex_rows, lex_scores, vec_rows, row_map, 10, k_arr, lex_w, sem_w, 1000)


@pytest.mark.parametrize("k_val", [1e-3, 0.5, 1.0, 1e6, 1e9])
def test_extreme_k_constants(k_val):
    rng = np.random.default_rng(int(abs(np.log10(k_val)) * 7 + 3))
    lex_rows, lex_scores, vec_rows, row_map, _, lex_w, sem_w = fuzz_case(rng, 4, 8, 6, 60)
    check(lex_rows, lex_scores, vec_rows, row_map, 10, np.full(4, k_val), lex_w, sem_w, 60)


def test_mixed_extreme_k_per_query():
    rng = np.random.default_rng(11)
    lex_rows, lex_scores, vec_rows, row_map, _, lex_w, sem_w = fuzz_case(rng, 6, 10, 8, 100)
    k_arr = np.array([1e-3, 0.7, 13.0, 60.0, 1e5, 1e8])
    check(lex_rows, lex_scores, vec_rows, row_map, 12, k_arr, lex_w, sem_w, 100)


@pytest.mark.parametrize("zero_arm", ["lex", "sem", "both"])
def test_zero_weight_arms(zero_arm):
    rng = np.random.default_rng(29)
    lex_rows, lex_scores, vec_rows, row_map, k_arr, _, _ = fuzz_case(rng, 4, 8, 6, 60)
    lex_w = 0.0 if zero_arm in ("lex", "both") else 1.0
    sem_w = np.full(4, 0.0 if zero_arm in ("sem", "both") else 1.0)
    check(lex_rows, lex_scores, vec_rows, row_map, 10, k_arr, lex_w, sem_w, 60)



@pytest.mark.parametrize("ranks", [(0, 16), (0, 28), (3, 40)])
def test_swapped_ranks_tie_like_the_oracle(ranks):
    """Doc 5 ranks (a, b) in (lexical, vector), doc 9 ranks (b, a): their
    f64 sums are equal, so in-both and then the lexical score decide."""
    a, b = ranks
    n = max(a, b) + 1
    lex = np.arange(100, 100 + n)
    vec = np.arange(200, 200 + n)
    lex[a], lex[b], vec[b], vec[a] = 5, 9, 5, 9
    scores = np.linspace(9.0, 1.0, n).astype(np.float32)
    args = (lex[None], scores[None], vec[None], np.arange(300), 4, np.array([60.0]), 1.0, np.array([1.0]))
    got = run_torch(*args)
    assert got == run_oracle(*args, 300)
    assert [e[0] for e in got[0][:2]] == [5, 9] and got[0][0][1] == got[0][1][1]
