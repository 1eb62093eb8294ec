"""hydrate_ms_per_query (ms): the self time of the program's ``fs.index.hydrate``
spans (the ``VectorHit`` build of ``DeviceVectorIndex.hydrate``, without its
``fs.index.fetch`` child) over the traced window, per query answered.

Host time under the profiler: its two ``.tolist()`` calls are recorded as
four torch operators a call (``aten::resolve_conj``, ``aten::resolve_neg``),
some tens of us a call under the profiler, a part of a B=1 call's reading
and nothing of a batch's. A collector pass set off inside it is taken out.
"""

from benchmark.harness import spans


def read(run):
    return spans.per_query_ms(run, ["fs.index.hydrate"])
