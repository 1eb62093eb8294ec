"""The program's own spans in a traced run: the ``fs.*`` ranges that
``frankensearch_tpu_torch`` opens while a profiler records
(``utils/tracing.py``), read from ``run.trace.ranges`` and clipped to the
window.

A span's self time is its clipped duration minus the union of the
``fs.*`` ranges nested in it on the same thread (``fs.gc``, a collector
pass, included). A program that opens no ``fs.*`` range in the window (one
older than its spans) gives nothing to read: every reader then returns
``None``.

These are host times taken under the profiler, which records each torch
operator at some us: a span that enqueues many operators reads above its
untraced time, and a span that waits on the card (a fetch) reads below
it, since the slowed enqueue before it leaves the card less to finish.
Each reader's docstring says how far that moves it.
"""

from __future__ import annotations

import bisect

from benchmark.harness import trace

PREFIX = "fs."
GC = "fs.gc"


def program_ranges(tr) -> dict:
    """thread -> the ``fs.*`` ranges on it that reach into the window, as
    (start, end, name) clipped to it, sorted by start; {} without a window."""
    if tr is None or tr.window is None:
        return {}
    lo, hi = tr.window
    out: dict = {}
    for s, e, name, tid in tr.ranges:
        if name.startswith(PREFIX) and e > lo and s < hi:
            out.setdefault(tid, []).append((max(s, lo), min(e, hi), name))
    for ranges in out.values():
        ranges.sort(key=lambda r: (r[0], -r[1]))
    return out


def self_us(tr, name: str) -> float | None:
    """The summed self time, in us, of every ``name`` range in the window;
    None where the window holds none."""
    found, total = False, 0.0
    for ranges in program_ranges(tr).values():
        starts = [r[0] for r in ranges]
        for i, (s, e, n) in enumerate(ranges):
            if n != name:
                continue
            found = True
            children = []
            for cs, ce, _ in ranges[i + 1 : bisect.bisect_right(starts, e)]:
                if ce <= e:
                    children.append((cs, ce))
            total += (e - s) - trace.union_length(children, s, e)
    return total if found else None


def per_query_ms(run, names) -> float | None:
    """The self time of the ``names`` spans in ms, over the queries
    answered in the traced window; None where none of them was opened."""
    if run.answered == 0:
        return None
    times = [t for t in (self_us(run.trace, name) for name in names) if t is not None]
    return sum(times) / 1000.0 / run.answered if times else None


def gc_share(tr) -> float | None:
    """The union of the window's ``fs.gc`` ranges over its length, in %;
    None where the program opened no ``fs.*`` range in the window."""
    ranges = program_ranges(tr)
    if not ranges:
        return None
    passes = [(s, e) for rs in ranges.values() for s, e, name in rs if name == GC]
    lo, hi = tr.window
    return 100.0 * trace.union_length(passes, lo, hi) / (hi - lo)
