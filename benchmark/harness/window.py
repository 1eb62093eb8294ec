"""What a measured window is made of: its requests, and the host spans a
traced run opens around the calls into each layer.

Spans are ``torch.profiler.record_function`` ranges around methods of the
objects the benchmark built, put on as instance attributes (no file of
the program changes). A system module names which methods, and under
which span (``systems/<system>.py``, ``traced``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class Request:
    client: int
    first: int  # index of its first query in the pool
    size: int
    start: float
    end: float = 0.0
    kept: list = field(default_factory=list)  # (query text, outcome) of the queries kept for the check
    error: str | None = None


@dataclass
class Spans:
    """Host seconds and calls inside each traced layer call, and what a
    span's ``note`` recorded of its calls' arguments."""

    seconds: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)
    args: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, name: str, dt: float) -> None:
        with self.lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def note(self, name: str, value) -> None:
        with self.lock:
            self.args.setdefault(name, []).append(value)


class Traced:
    """Puts a traced range around each (object, method name, span name,
    note) of ``targets``; ``note(args)``, where given, records what the
    span's readers need of each call's arguments. ``remove`` puts back
    what was there."""

    def __init__(self, targets, spans: Spans) -> None:
        from torch.profiler import record_function

        self._undo: list = []
        for obj, attr, span, note in targets:
            inner = getattr(obj, attr)

            def wrapper(*args, _inner=inner, _span=span, _note=note, **kwargs):
                t0 = time.perf_counter()
                with record_function(_span):
                    out = _inner(*args, **kwargs)
                spans.add(_span, time.perf_counter() - t0)
                if _note is not None:
                    spans.note(_span, _note(args))
                return out

            self._undo.append((obj, attr, vars(obj).get(attr)))
            setattr(obj, attr, wrapper)

    def remove(self) -> None:
        for obj, attr, before in reversed(self._undo):
            if before is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, before)
        self._undo.clear()
