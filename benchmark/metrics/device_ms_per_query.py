"""device_ms_per_query (ms): the union of device intervals over the traced
window, divided by the queries answered in it."""

from benchmark.harness import trace


def read(run):
    if run.trace is None or run.trace.window is None or run.answered == 0:
        return None
    return 1000.0 * trace.busy_s(run.trace) / run.answered
