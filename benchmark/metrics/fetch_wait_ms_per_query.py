"""fetch_wait_ms_per_query (ms): host time inside the program's
``fs.embed.fetch`` (the embed's ``.cpu()``) and ``fs.index.fetch``
(``hydrate``'s two device-to-host copies) spans, less any collector pass
(``fs.gc``) nested in them, over the traced window, per query answered.

It is host time taken under the profiler, not a reading of the device:
the fetch lasts as long as the work queued before it still has to run.
The profiler slows the host's enqueue of that work, so the fetch finds
more of it done than it would untraced, and the metric reads low where a
call enqueues many operations before its fetch. The cell it lists
(``msmarco-dense-batch``) records about 6 host operators a query; in the
B=1 cell the profiler's cost on the scan's enqueue outlasts the scan, and
the metric is not read there.
"""

from benchmark.harness import spans


def read(run):
    return spans.per_query_ms(run, ["fs.embed.fetch", "fs.index.fetch"])
