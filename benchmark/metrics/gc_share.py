"""gc_share (%): the share of the traced window in which the interpreter's
cyclic collector ran: the union of the program's ``fs.gc`` ranges (one a
collector pass, on whatever thread set it off) over the window's length.
Nothing to read where the program opened no ``fs.*`` range in the window.

Under the profiler each pass also pays for opening its range (some 15 us),
which at the cells' pass rates adds a fraction of a percent; the untraced
window's collector seconds are in the run's log (``harness/cell.py``).
"""

from benchmark.harness import spans


def read(run):
    return spans.gc_share(run.trace)
