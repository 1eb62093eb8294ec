"""lex_plan_ms_per_query (ms): the self time of the program's
``fs.fused_pass.plan`` spans (tokenizing, the sparse query rows, the hot
split and tail compaction, DAAT eligibility and its gather plan, and their
uploads) over the traced window, per query answered.

Host time under the profiler, which records each torch operator at some
us: the plan's operators are its few uploads a batch."""

from benchmark.harness import spans


def read(run):
    return spans.per_query_ms(run, ["fs.fused_pass.plan"])
