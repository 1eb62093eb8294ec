"""embed_launches_per_query (launches): the device operations (kernels,
copies, sets) launched from inside the program's ``fs.embed.pool`` spans (the
upload and the gather-pool-normalize of ``Model2VecEmbedder.embed_batch``),
on the span's own thread, over the traced window, per query answered. A
count, so the host's speed does not move it."""

from benchmark.harness import trace


def read(run):
    if run.trace is None or run.trace.window is None or run.answered == 0:
        return None
    ops, ranges = trace.launched_in(run.trace, "fs.embed.pool")
    return len(ops) / run.answered if ranges else None
