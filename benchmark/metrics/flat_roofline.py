"""flat_roofline (%): the least time K3 (``flat_class_fused``) needs for the
flat lane's passes in the traced window, from their shapes
(harness/flat_roofline.py), over the device time of the K3 kernels
launched inside the ``lexical.flat_scan`` ranges (the benchmark's spans
around ``device_bm25._graded_scan_flat``, which notes each class's shapes).

Nothing is read unless the K3 kernels the trace holds there equal both the
shapes noted and the increase of the program's ``flat_class_fused.launches``
counter, and the ranges equal the calls noted."""

import sys

from benchmark.harness import flat_roofline, trace

SPAN = "lexical.flat_scan"
K3 = "flat_fused_kernel"  # the kernel's name as a trace gives it


def read(run):
    if run.trace is None or run.trace.window is None:
        return None
    ops, ranges = trace.launched_in(run.trace, SPAN)
    calls = run.spans.args.get(SPAN, []) if run.spans is not None else []
    shapes = [s for call in calls for s in call]
    k3 = [op for op in ops if K3 in op[2]]
    counted = run.launches.get("flat_class_fused")
    if not shapes or not (ranges == len(calls) and len(k3) == len(shapes) == counted):
        print(f"flat_roofline: {ranges} ranges, {len(calls)} calls, {len(shapes)} launches noted, {len(k3)} K3 "
              f"kernels traced, launch counter {counted}: not read", file=sys.stderr)
        return None
    device_ms = sum(e - s for s, e, _, _ in k3) / 1000.0
    return 100.0 * flat_roofline.least_ms(shapes) / device_ms
