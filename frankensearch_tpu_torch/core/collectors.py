"""Telemetry collectors: versioned envelopes, runtime collector, live
search stream.

Parity target: reference crates/frankensearch-core/src/collectors.rs —
``RuntimeMetricsCollector``, schema-versioned ``TelemetryEnvelope`` /
``TelemetryEvent`` with correlation ids, ``LiveSearchStreamEmitter``
(bounded frame ring), 1000 ms default cadence; zero overhead when no
sink is installed.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

TELEMETRY_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class TelemetryEvent:
    kind: str
    payload: Mapping[str, Any]
    at: float
    correlation_id: str

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "payload": dict(self.payload),
            "at": self.at,
            "correlation_id": self.correlation_id,
        }


@dataclass(frozen=True)
class TelemetryEnvelope:
    """Schema-versioned batch of events (collectors.rs TelemetryEnvelope)."""

    v: int
    source: str
    emitted_at: float
    events: tuple[TelemetryEvent, ...]

    def to_json(self) -> str:
        return json.dumps(
            {
                "v": self.v,
                "source": self.source,
                "emitted_at": self.emitted_at,
                "events": [e.to_dict() for e in self.events],
            },
            separators=(",", ":"),
        )


class RuntimeMetricsCollector:
    """Buffers events; flushes envelopes to a sink on cadence or on demand.
    With no sink installed every call is a cheap no-op (zero-overhead
    contract)."""

    def __init__(
        self,
        source: str = "frankensearch-tpu",
        sink: Callable[[TelemetryEnvelope], None] | None = None,
        cadence_ms: float = 1000.0,
        max_buffer: int = 4096,
    ) -> None:
        self.source = source
        self.sink = sink
        self.cadence_s = cadence_ms / 1000.0
        self._buffer: deque[TelemetryEvent] = deque(maxlen=max_buffer)
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self.dropped = 0

    def record(
        self, kind: str, payload: Mapping[str, Any], correlation_id: str | None = None
    ) -> None:
        if self.sink is None:
            return
        ev = TelemetryEvent(
            kind=kind,
            payload=payload,
            at=time.time(),
            correlation_id=correlation_id or uuid.uuid4().hex[:16],
        )
        with self._lock:
            if len(self._buffer) == self._buffer.maxlen:
                self.dropped += 1
            self._buffer.append(ev)
            due = time.monotonic() - self._last_flush >= self.cadence_s
        if due:
            self.flush()

    def flush(self) -> TelemetryEnvelope | None:
        if self.sink is None:
            return None
        with self._lock:
            if not self._buffer:
                return None
            events = tuple(self._buffer)
            self._buffer.clear()
            self._last_flush = time.monotonic()
        env = TelemetryEnvelope(
            v=TELEMETRY_SCHEMA_VERSION,
            source=self.source,
            emitted_at=time.time(),
            events=events,
        )
        self.sink(env)
        return env


@dataclass
class StreamFrame:
    """One live-search stream frame (fsfs stream_protocol.rs
    'fsfs.stream.query.v1' analog)."""

    seq: int
    kind: str  # "phase" | "result" | "metrics" | "end"
    payload: dict

    def to_json(self) -> str:
        return json.dumps(
            {"v": 1, "frame": "fs.stream.query.v1", "seq": self.seq,
             "kind": self.kind, "payload": self.payload},
            separators=(",", ":"), default=str,
        )


class LiveSearchStreamEmitter:
    """Bounded ring of stream frames; drops oldest under pressure
    (collectors.rs bounded frame ring)."""

    def __init__(self, capacity: int = 256) -> None:
        self._ring: deque[StreamFrame] = deque(maxlen=capacity)
        self._seq = 0
        self._lock = threading.Lock()
        self.dropped = 0

    def emit(self, kind: str, payload: dict) -> StreamFrame:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._seq += 1
            frame = StreamFrame(seq=self._seq, kind=kind, payload=payload)
            self._ring.append(frame)
            return frame

    def drain(self) -> list[StreamFrame]:
        with self._lock:
            frames = list(self._ring)
            self._ring.clear()
            return frames
