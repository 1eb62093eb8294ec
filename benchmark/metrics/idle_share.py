"""idle_share (%): the share of the traced window in which no device
operation ran (one minus the union of device intervals over the window)."""

from benchmark.harness import trace


def read(run):
    if run.trace is None or run.trace.window is None:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.trace.window_s)
