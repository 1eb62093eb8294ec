"""Statistics over a window's requests."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least ``q`` percent of ``values`` do not exceed."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)]


def latencies_ms(requests) -> list[float]:
    """One latency a query, in ms: from the client's call to the return of
    its request; a failed request's queries count as never answered."""
    out = []
    for r in requests:
        out.extend([math.inf if r.error else (r.end - r.start) * 1000.0] * r.size)
    return out


def completed(requests, by: float) -> int:
    """Queries answered, without error, by time ``by``."""
    return sum(r.size for r in requests if r.error is None and r.end <= by)


def rate(requests, start: float, end: float) -> float:
    """Queries answered inside [start, end] over its length."""
    return completed(requests, end) / (end - start)
