"""One run of one cell: build, warm up, measure, check.

``run`` returns the result line's object and the lines of the check for
standard error. It takes the device it is given; ``benchmark/run.py`` is
what refuses to run without a card. What it runs is found by name
(harness/spec.py): the configuration's system, the mix's load and call,
and a reader for each metric.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.harness import check, data, spec as specs, stats, trace
from benchmark.harness.window import Spans, Traced

#: seconds of the traced window of a ``--trace 1`` run (its trace is read
#: whole, so its length is fixed and short)
TRACE_SECONDS = 5.0
#: idle seconds inside the profiled run before and after the window (a
#: trace taken late in a process has missed the first kernel of a call)
TRACE_PAD_S = 0.5
#: warm-up queries drawn besides the long one, and the long query's words
WARMUP_POOL = 4096
LONG_QUERY_WORDS = 24


@dataclass
class Run:
    """What a metric's reader gets: the cell, its system, and what the
    measured window left."""

    cell: dict
    config: dict
    mix: dict
    system: object
    requests: list  # the requests of the window the run reports: the traced one in a traced run
    plain: list  # the requests of the untraced window, which every run drives
    start: float  # the untraced window's start and end, on time.perf_counter's clock
    end: float
    setup_s: float
    answered: int  # queries answered in the reported window, those that ended after it included
    trace: object | None = None
    spans: Spans | None = None
    launches: dict = field(default_factory=dict)  # launch counters' increase over the window


def queries_spec(cfg: dict, mix: dict) -> dict:
    """The configuration's query statistics, with the mix's own in their place."""
    return {**cfg["queries"], **mix.get("queries", {})}


def warmup_requests(cfg: dict, mix: dict, seed: int) -> list[list[str]]:
    """The warm-up's requests: one holding a query of ``LONG_QUERY_WORDS``
    words (the embedder's next length bucket), then the mix's
    ``warmup_calls`` requests of queries drawn outside the window's pool."""
    size = mix["batch"]
    qspec = queries_spec(cfg, mix)
    pool = data.queries(seed, "warmup", qspec, WARMUP_POOL).strings()
    rng = np.random.default_rng(data.sub_seed(seed, "warmup-edges"))
    zipf = data.ZipfWords(qspec["zipf"], qspec["vocab"])
    long_q = " ".join(data.word(int(w)) for w in zipf.draw(rng, LONG_QUERY_WORDS))
    calls = [pool[(i * size) % (len(pool) - size) :][:size] for i in range(mix["warmup_calls"])]
    return [[long_q] + pool[: size - 1]] + calls


class CollectorClock:
    """Seconds the interpreter's cyclic collector ran, by generation, while
    installed (``gc.callbacks``)."""

    def __init__(self) -> None:
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds[info["generation"]] += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def run(cell_name: str, seed: int, seconds: float, traced: bool, device, *, setup_clock,
        bench: dict | None = None, config: dict | None = None, mix_override: dict | None = None,
        system_hook=None) -> tuple[dict, list[str], list[str]]:
    """One run. ``setup_clock()`` gives the seconds since the process
    started. ``config`` replaces the configuration file (tests' tiny
    cells, the control), ``mix_override`` some of the mix's keys (the
    control's short warm-up); ``system_hook(system)`` may alter the built
    system (tests' faults). Returns (result object, log lines, check lines)."""
    bench = bench if bench is not None else specs.load()
    cell = specs.cell(bench, cell_name)
    cfg = config if config is not None else specs.config(bench, cell["config"])
    mix = {**specs.mix(cell["traffic"]), **(mix_override or {})}
    system_kind = specs.plugin("systems", cfg["system"])
    load = specs.plugin("loads", mix["load"])
    log: list[str] = []

    sysm = system_kind.build(cfg, seed, device)
    if system_hook is not None:
        system_hook(sysm)
    log.append(f"built {cfg['name']}: {sysm.layout}")
    size, call = specs.plugin("calls", mix["call"]).bind(sysm, mix)
    pool = data.queries(seed, "window", queries_spec(cfg, mix), mix["pool"]).strings()
    keep = check.keep_mask(pool, seed, mix["keep_every"]).tolist()
    for texts in warmup_requests(cfg, mix, seed):
        call(texts)
    counters = system_kind.counters() if hasattr(system_kind, "counters") else {}
    _sync(device)
    gc.collect()

    # every run drives an untraced window; a traced run then drives a
    # short one under the profiler, with the layer spans on
    setup_s = setup_clock()
    clock = CollectorClock()
    gc_before = [g["collections"] for g in gc.get_stats()]
    with clock:
        plain, start, end, last = load.run_window(call, size, mix, pool, keep, seconds)
        _sync(device)
    collections = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
    requests, tr, spans, hooks, launches = plain, None, None, None, {}
    if traced:
        from torch.profiler import record_function

        spans = Spans()
        hooks = Traced(system_kind.traced(sysm), spans)
        before = {name: fn.launches for name, fn in counters.items()}
        with trace.profiler() as prof:
            time.sleep(TRACE_PAD_S)
            with record_function(trace.WINDOW_SPAN):
                requests, *_ = load.run_window(call, size, mix, pool, keep, min(seconds, TRACE_SECONDS),
                                               span=f"searcher.{mix['call']}")
                _sync(device)
            time.sleep(TRACE_PAD_S)
        tr = trace.read(prof)
        hooks.remove()
        launches = {name: fn.launches - before[name] for name, fn in counters.items()}
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ran = plain + requests if traced else plain
    failed = sum(r.size for r in ran if r.error is not None)
    attempted = sum(r.size for r in ran)
    errors = sorted({r.error for r in ran if r.error is not None})
    if errors:
        log.append(f"{failed} queries failed: {errors[:3]}")
    if sum(r.size for r in plain) > len(pool):
        log.append(f"the window sent more queries than the pool's {len(pool)}: the pool was reused")
    result_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                     "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
                     "count": 1, "memory_peak_bytes": int(memory_peak)}

    answered = stats.completed(requests, math.inf)
    ctx = Run(cell, cfg, mix, sysm, requests, plain, start, end, setup_s, answered, tr, spans, launches)
    metrics = {}
    for m in specs.metrics_of(bench, "per_layer" if traced else "end_to_end", cell_name):
        value = specs.reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            log.append(f"{m['name']} read {value}: left out of the result line")
    del ctx
    lat = stats.latencies_ms(plain)
    log.append(f"window {end - start:.3f} s: {sum(r.size for r in plain)} queries sent, "
               f"{stats.completed(plain, end)} answered inside it, the last answer {last - end:.4f} s after it "
               f"closed; p50 {stats.percentile(lat, 50.0):.3f} ms, p95 {stats.percentile(lat, 95.0):.3f} ms; "
               f"setup {setup_s:.3f} s; collector passes by generation {collections}, seconds "
               f"{[round(x, 4) for x in clock.seconds]}")
    if traced:
        result_device["busy_s"] = trace.busy_s(tr)
        result_device["window_s"] = tr.window_s
        log.append(f"traced window {tr.window_s:.3f} s: {answered} queries, spans {spans.seconds}, "
                   f"launches {launches}")

    # the check: the program's state freed first, then the reference
    picked = check.sample(ran, seed, mix["sample"])
    del sysm, hooks, requests, plain, ran, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = {"failed": [failed, 0], **system_kind.judge(cfg, seed, picked, mix["k"], device)}
    log.append(f"check of {len(picked)} queries in {time.perf_counter() - t_ref:.2f} s")
    ok = check.correct(numbers)
    result = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": result_device}
    if traced:
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    lines = [f"check {name}: {v!r} (limit {lim!r})" for name, (v, lim) in numbers.items()]
    lines.append(f"correct: {ok}")
    return result, log, lines


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
