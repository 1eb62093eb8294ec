"""fused_device_ms_per_query (ms): the device time of every operation
launched from inside the program's ``fs.fused_pass`` ranges (the fused
phase-1 pass: the embed, both arms' kernels, the RRF tail and the fetch's
copies) on the range's own thread, summed over the traced window, per
query answered. Summed, not a union: operations of one stream do not
overlap. Nothing is read where the ranges launched nothing (a run off the
card)."""

from benchmark.harness import trace


def read(run):
    if run.trace is None or run.trace.window is None or run.answered == 0:
        return None
    ops, _ = trace.launched_in(run.trace, "fs.fused_pass")
    return sum(e - s for s, e, _, _ in ops) / 1000.0 / run.answered if ops else None
