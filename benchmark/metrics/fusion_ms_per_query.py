"""fusion_ms_per_query (ms): the self time of the program's ``fs.search.fuse``
spans (RRF, ``_fused_to_results`` and the result objects; in a batch one
span around the per-query loop) over the traced window, per query answered.

Host time under the profiler, which records each torch operator run
inside the span at some us each; the fusion is host Python and runs few.
"""

from benchmark.harness import spans


def read(run):
    return spans.per_query_ms(run, ["fs.search.fuse"])
