"""call_p95_ms (ms): the nearest-rank 95th percentile, over every query sent
in the run's untraced window, of the time from the client's call into the
searcher to the return of that query's final results: the whole call as
its caller sees it (a failed query counts as never answered). A traced run
drives that window before its traced one, so the profiler adds nothing."""

from benchmark.harness import stats


def read(run):
    lat = stats.latencies_ms(run.plain)
    return stats.percentile(lat, 95.0) if lat else None
