"""qps (queries/s): the queries answered, without error, inside the run's
untraced window, over the window's length."""

from benchmark.harness import stats


def read(run):
    return stats.rate(run.plain, run.start, run.end)
