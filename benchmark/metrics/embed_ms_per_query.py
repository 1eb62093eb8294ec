"""embed_ms_per_query (ms): host wall time inside the Model2Vec embedder's
``embed_batch`` over the traced window (its calls return the vectors on the
host, so the time includes the device's), per query answered. Nothing to
read where the searcher embeds inside its fused pass."""


def read(run):
    if run.spans is None or run.answered == 0 or "embed.embed_batch" not in run.spans.seconds:
        return None
    return 1000.0 * run.spans.seconds["embed.embed_batch"] / run.answered
