"""The device trace of a traced run: ``torch.profiler`` over the window,
read back from its Chrome trace.

What is read: every device operation (kernels, copies, sets) with its
start, end and the correlation id of the host call that launched it; the
host launch calls (thread and time); and the host ranges
(``record_function`` spans of the benchmark's hooks, and PyTorch's own
operators). From them: the union of device intervals inside the window
(busy time), the device time of the operations launched inside a named
range, the operations that took most time, and the idle gaps by what the
host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW_SPAN = "bench.window"
TOP = 10


def profiler():
    """A ``torch.profiler.profile`` of host and device that records every
    thread started under it (the clients' threads)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch.profiler import _ExperimentalConfig

        return profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=activities)


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (start us, end us, name, correlation)
    launches: dict = field(default_factory=dict)  # correlation -> (thread, time us)
    ranges: list = field(default_factory=list)  # (start us, end us, name, thread), record_function spans
    ops: list = field(default_factory=list)  # (start us, end us, name, thread), host operators
    window: tuple | None = None  # (start us, end us) of the WINDOW_SPAN range

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def parse(events: list) -> Trace:
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            tr.device.append((ts, ts + dur, e["name"], args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if "correlation" in args:
                tr.launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "user_annotation":
            if e["name"] == WINDOW_SPAN:
                tr.window = (ts, ts + dur)
            else:
                tr.ranges.append((ts, ts + dur, e["name"], e.get("tid")))
        elif cat == "cpu_op":
            tr.ops.append((ts, ts + dur, e["name"], e.get("tid")))
    tr.device.sort(key=lambda op: (op[0], op[1]))
    return tr


def read(prof) -> Trace:
    """Export the profiler's Chrome trace into ``TMPDIR``, parse it and
    delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)
    return parse(events)


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    disjoint sorted (start, end) pairs."""
    out: list[list[float]] = []
    for iv in sorted(intervals, key=lambda iv: (iv[0], iv[1])):
        s, e = max(iv[0], lo), min(iv[1], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval of ``busy`` (disjoint,
    sorted) covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def busy_s(tr: Trace) -> float:
    lo, hi = tr.window
    return union_length(tr.device, lo, hi) / 1e6


def launched_in(tr: Trace, span: str) -> tuple[list, int]:
    """(device operations launched from inside a ``span`` range, how many
    such ranges lie in the window). An operation belongs to a range when
    the host call that launched it ran inside the range, on its thread."""
    lo, hi = tr.window
    by_thread: dict = {}
    n = 0
    for s, e, name, tid in tr.ranges:
        if name == span and s >= lo and e <= hi:
            by_thread.setdefault(tid, []).append((s, e))
            n += 1
    for spans in by_thread.values():
        spans.sort()
    starts = {tid: [s for s, _ in spans] for tid, spans in by_thread.items()}
    out = []
    for op in tr.device:
        launch = tr.launches.get(op[3])
        if launch is None or launch[0] not in by_thread:
            continue
        tid, t = launch
        j = bisect.bisect_right(starts[tid], t) - 1
        if j >= 0 and by_thread[tid][j][1] >= t:
            out.append(op)
    return out, n


def host_during(tr: Trace, stretches: list[tuple[float, float]]) -> dict:
    """Seconds of ``stretches`` (disjoint, sorted) by what the host was
    doing: each instant goes to the shortest host range or operator, on
    any thread, that covers it."""
    events = []
    for s, e, name, _ in tr.ranges + tr.ops:
        if e > s:
            events.append((s, 1, e - s, name))
            events.append((e, 0, e - s, name))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    out: dict = {}
    active: list = []  # (duration, name) of the spans open now
    j, t = 0, None
    for at, opens, dur, name in events + [(float("inf"), 0, 0.0, "")]:
        if t is not None and at > t:
            label = min(active)[1] if active else "no traced host work"
            while j < len(stretches) and stretches[j][1] <= t:
                j += 1
            k = j
            while k < len(stretches) and stretches[k][0] < at:
                lo, hi = max(stretches[k][0], t), min(stretches[k][1], at)
                if hi > lo:
                    out[label] = out.get(label, 0.0) + (hi - lo) / 1e6
                k += 1
        if opens:
            active.append((dur, name))
        elif name:
            active.remove((dur, name))
        t = at if t is None else max(t, at)
    covered = sum(out.values())
    rest = sum(e - s for s, e in stretches) / 1e6 - covered
    if rest > 1e-12:
        out["no traced host work"] = out.get("no traced host work", 0.0) + rest
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.removeprefix("void ")[:160]


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time in the window, and the
    idle time of the device by what the host was doing, in seconds."""
    lo, hi = tr.window
    by_op: dict = {}
    for s, e, name, _ in tr.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + d / 1e6
    by_host = host_during(tr, gaps(merged(tr.device, lo, hi), lo, hi))
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
