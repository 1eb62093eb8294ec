"""The generators repeat by seed, and a seed orders the work rather than
changing it."""

import numpy as np
import pytest
import torch

from benchmark.harness import data

QSPEC = {"mean_words": 5.96, "zipf": 1.0, "vocab": 500_000}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_unit_rows_repeat_by_seed(seed):
    a = torch.cat([r for _, r in data.unit_rows(seed, "doc-vectors", 1000, 256, "cpu")])
    b = torch.cat([r for _, r in data.unit_rows(seed, "doc-vectors", 1000, 256, "cpu")])
    c = torch.cat([r for _, r in data.unit_rows(seed + 1, "doc-vectors", 1000, 256, "cpu")])
    assert a.dtype == torch.bfloat16 and a.shape == (1000, 256)
    assert torch.equal(a, b) and not torch.equal(a, c)
    norms = torch.linalg.vector_norm(a.float(), dim=1)
    assert torch.allclose(norms, torch.ones(1000), atol=1e-2)


def test_streams_differ_and_seeds_past_64_bits():
    assert data.sub_seed(3, "a") != data.sub_seed(3, "b")
    assert data.sub_seed(3, "a") == data.sub_seed(3, "a")
    assert 0 <= data.sub_seed(2**70 + 1, "a") < 2**63
    assert data.sub_seed(-1, "a") != data.sub_seed(1, "a")


def test_queries_repeat_by_seed_with_one_multiset_of_lengths():
    a = data.queries(11, "window", QSPEC, 2000)
    b = data.queries(11, "window", QSPEC, 2000)
    c = data.queries(12, "window", QSPEC, 2000)
    assert a.strings() == b.strings() and a.strings() != c.strings()
    assert sorted(a.lengths()) == sorted(c.lengths())  # the seed orders the lengths
    assert a.lengths().min() >= 1
    assert abs(a.lengths().mean() - 5.96) < 0.2
    assert data.queries(11, "warmup", QSPEC, 50).strings() != a.strings()[:50]


def test_strings_are_the_word_ids():
    t = data.Texts(np.array([0, 12, 499_999, 7], dtype=np.int32), np.array([0, 3, 4]))
    assert t.strings() == ["w000000 w000012 w499999", "w000007"]
    assert len(t) == 2 and list(t.ids(0)) == [0, 12, 499_999]


def test_zipf_words_follow_their_exponent():
    z = data.ZipfWords(1.07, 50_000)
    w = z.draw(np.random.default_rng(0), 200_000)
    assert w.min() >= 0 and w.max() < 50_000
    counts = np.bincount(w, minlength=50_000)
    # P(rank 0) / P(rank 1) = 2^1.07
    assert abs(counts[0] / counts[1] - 2**1.07) < 0.1
    assert counts[0] > counts[10] > counts[1000]


def test_doc_ids_round_trip():
    assert data.doc_id(42) == "d0000042" and data.row_of_doc("d0000042") == 42
    assert data.doc_ids(3) == ["d0000000", "d0000001", "d0000002"]
