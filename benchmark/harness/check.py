"""The comparison that decides ``correct``: which answers are judged,
and the verdict.

A run keeps the answers of a share of the pool's queries, drawn from the
seed, and of the longest ones; after the window a sample of them, again
drawn from the seed with the longest in it, goes to the system's own
``judge`` (``systems/<system>.py``), which holds each against the plain
reference (harness/reference.py) and gives each number with its limit.
Besides those, ``failed`` counts the queries of requests that raised
instead of answering (limit 0). A number is correct at or under its
limit.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.harness import data

#: the share of the pool, by words, whose answers are always kept; and how
#: many of the longest kept answers a sample always holds
LONGEST_SHARE = 0.001
LONGEST = 4


def keep_mask(pool: list[str], seed: int, every: int) -> np.ndarray:
    """The pool's queries whose answers a run keeps for the check: one in
    ``every`` drawn from the seed, and the longest ``LONGEST_SHARE`` of
    the pool by words."""
    rng = np.random.default_rng(data.sub_seed(seed, "check-keep"))
    words = np.fromiter((t.count(" ") + 1 for t in pool), dtype=np.int64, count=len(pool))
    cut = np.quantile(words, 1.0 - LONGEST_SHARE)
    return (rng.random(len(pool)) < 1.0 / every) | (words >= cut)


def sample(requests, seed: int, n: int) -> list[tuple[str, object]]:
    """(query text, outcome) of up to
    ``n`` of the kept answers: the ``LONGEST`` with the most words, and the
    rest drawn from the seed."""
    answered = []
    for r in requests:
        if r.error is None:
            answered.extend(r.kept)
    if len(answered) <= n:
        return answered
    words = np.array([len(t.split()) for t, _ in answered])
    first = [int(i) for i in np.argsort(-words, kind="stable")[:LONGEST]]
    rest = np.setdiff1d(np.arange(len(answered)), first)
    rng = np.random.default_rng(data.sub_seed(seed, "check-sample"))
    picked = first + [int(i) for i in rng.choice(rest, n - len(first), replace=False)]
    return [answered[i] for i in sorted(picked)]


def correct(numbers: dict) -> bool:
    return all(v <= lim and not (isinstance(v, float) and math.isnan(v)) for v, lim in numbers.values())
