"""scan_roofline (%): the least time the card needs for the exact scans the
fast tier ran in the traced window, over the device time of every
operation launched inside the ``index.search_batch`` ranges (the benchmark's
spans around ``DeviceVectorIndex.search_batch``).

The least time of a call comes from its shapes (harness/roofline.py):
every live row read once plus the mask, the queries and the (score, row)
pairs out, or 2 B N d operations at the bf16 peak, whichever is longer.
Nothing is read unless the ranges' count equals the launches of K1
(``group_max``) and of K2 (``gather_rescore``) that the program counted,
and the trace holds one K1 and one K2 kernel a range."""

import sys

from benchmark.harness import roofline, trace

SPAN = "index.search_batch"
K1, K2 = "group_max_kernel<", "gather_rescore_kernel<"  # the kernels' names as a trace gives them


def read(run):
    if run.trace is None or run.trace.window is None:
        return None
    ops, ranges = trace.launched_in(run.trace, SPAN)
    calls = run.spans.args.get(SPAN, []) if run.spans is not None else []
    k1 = sum(K1 in name for _, _, name, _ in ops)
    k2 = sum(K2 in name for _, _, name, _ in ops)
    counted = (run.launches.get("group_max"), run.launches.get("gather_rescore"))
    if ranges == 0 or not (ranges == len(calls) == k1 == k2 == counted[0] == counted[1]):
        print(f"scan_roofline: {ranges} ranges, {len(calls)} calls, {k1} K1 and {k2} K2 kernels traced, "
              f"launch counters {counted}: not read", file=sys.stderr)
        return None
    sys_ = run.system
    least_ms = 0.0
    for batch, k in calls:
        moved, work = roofline.exact_scan(batch, sys_.n_docs, sys_.n_pad, sys_.dim, k)
        least_ms += roofline.bound(moved, work, "bf16")[0]
    device_ms = sum(e - s for s, e, _, _ in ops) / 1000.0
    return 100.0 * least_ms / device_ms
