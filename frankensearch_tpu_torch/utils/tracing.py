"""Logging/tracing setup, and the serving path's spans.

Parity target: reference core/src/tracing_config.rs + fsfs
tracing_setup.rs — library-optional structured logging configured from
FRANKENSEARCH_LOG (library never configures logging unless asked; the
product entrypoints do).

:class:`span` times one phase of the serving path on the host clock, and
while a ``torch.profiler`` records it is also a ``record_function`` range
of the same name, on the timeline of the kernels that phase launched.
A hook on ``gc.callbacks``, put there when this module is imported, makes
each pass of the interpreter's cyclic collector an ``fs.gc`` range under
the profiler. With no profiler recording, neither calls anything of
``torch.profiler``.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import sys
import time

LOGGER_NAME = "frankensearch_tpu"


class JsonFormatter(logging.Formatter):
    """One JSON object per line (evidence-friendly)."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "at": time.time(),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fs_extra", None)
        if isinstance(extra, dict):
            payload.update(extra)
        return json.dumps(payload, default=str)


def configure_tracing(
    level: str | None = None, *, json_lines: bool | None = None, stream=None
) -> logging.Logger:
    """Configure the framework logger from FRANKENSEARCH_LOG (e.g. 'info',
    'debug', 'warning'); idempotent; never touches the root logger."""
    level_name = (level or os.environ.get("FRANKENSEARCH_LOG", "warning")).upper()
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(getattr(logging, level_name, logging.WARNING))
    logger.propagate = False
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        use_json = (
            json_lines
            if json_lines is not None
            else os.environ.get("FRANKENSEARCH_LOG_FORMAT", "text") == "json"
        )
        if use_json:
            handler.setFormatter(JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
            )
        logger.addHandler(handler)
    return logger


def get_logger(component: str = "") -> logging.Logger:
    name = f"{LOGGER_NAME}.{component}" if component else LOGGER_NAME
    return logging.getLogger(name)


#: ``torch.autograd.profiler``, bound by the first span or collector pass
#: after torch is loaded (the CLI loads this module before torch; nothing
#: can record before torch is loaded). Its ``_is_profiler_enabled`` flag is
#: set while a ``torch.profiler`` (or the autograd profiler) records.
_prof = None


def _bind():
    global _prof
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and hasattr(prof, "_is_profiler_enabled"):  # loaded, not still loading
        _prof = prof
    return _prof


class span:
    """``with span("fs.search.fuse") as s: ...``: the host time of the block
    in ``s.ms`` (the time so far while the block runs), from two
    ``time.perf_counter`` reads. While a profiler records, the block is also
    a ``record_function`` range named ``name`` on the calling thread."""

    __slots__ = ("name", "t0", "t1", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t1 = None
        self._range = None

    def __enter__(self) -> "span":
        prof = _prof or _bind()
        if prof is not None and prof._is_profiler_enabled:
            self._range = prof.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)

    @property
    def ms(self) -> float:
        end = time.perf_counter() if self.t1 is None else self.t1
        return (end - self.t0) * 1000.0


#: the ``fs.gc`` range of the collector pass running now (a pass runs on
#: one thread, and passes never overlap)
_gc_range = None


def _collector_hook(phase: str, info: dict) -> None:
    """On ``gc.callbacks`` from this module's import: under a profiler each
    collector pass is an ``fs.gc`` range on the thread that set it off;
    otherwise the hook reads one flag a pass."""
    global _gc_range
    if phase == "start":
        prof = _prof or _bind()
        if prof is not None and prof._is_profiler_enabled:
            _gc_range = prof.record_function("fs.gc")
            _gc_range.__enter__()
    elif _gc_range is not None:
        rng, _gc_range = _gc_range, None
        rng.__exit__(None, None, None)


gc.callbacks.append(_collector_hook)
