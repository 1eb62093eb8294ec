"""fused_finish_ms_per_query (ms): the self time of the program's
``fs.fused_pass.finish`` spans (``hydrate``'s hits, the lexical candidate
lists and their pools, ``finish_rrf``) over the traced window, per query
answered. The ``fs.index.hydrate`` span nested in it is not counted
(hydrate_ms_per_query reads it), nor a collector pass.

Host time under the profiler; the finish is host Python and runs few
torch operators."""

from benchmark.harness import spans


def read(run):
    return spans.per_query_ms(run, ["fs.fused_pass.finish"])
