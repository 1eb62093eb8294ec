"""Host adapter SDK: embed framework telemetry into a host application.

Parity target: reference crates/frankensearch-core/src/host_adapter.rs —
adapter SDK + conformance harness: lifecycle hooks (attach/detach),
redaction applied BEFORE events leave the framework, and a conformance
checklist a host integration must pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from frankensearch_tpu_torch.core.collectors import TelemetryEnvelope
from frankensearch_tpu_torch.runtime.redaction import RedactionPolicy


@dataclass
class HostAdapter:
    """Bridges collector envelopes into a host sink with mandatory
    redaction."""

    name: str
    sink: Callable[[dict], None]
    policy: RedactionPolicy = field(default_factory=RedactionPolicy)
    attached: bool = False
    delivered: int = 0
    dropped_while_detached: int = 0

    def attach(self) -> None:
        self.attached = True

    def detach(self) -> None:
        self.attached = False

    def deliver(self, envelope: TelemetryEnvelope) -> None:
        if not self.attached:
            self.dropped_while_detached += 1
            return
        payload = {
            "v": envelope.v,
            "source": envelope.source,
            "emitted_at": envelope.emitted_at,
            "events": [
                {
                    "kind": e.kind,
                    "at": e.at,
                    "correlation_id": e.correlation_id,
                    "payload": self.policy.redact(e.payload),
                }
                for e in envelope.events
            ],
        }
        self.sink(payload)
        self.delivered += 1


@dataclass(frozen=True)
class ConformanceResult:
    passed: bool
    failures: tuple[str, ...] = ()


def run_adapter_conformance(adapter: HostAdapter) -> ConformanceResult:
    """Conformance harness (host_adapter.rs): the adapter must (1) drop
    events while detached, (2) deliver while attached, (3) redact
    sensitive payload fields, (4) preserve correlation ids."""
    import time

    from frankensearch_tpu_torch.core.collectors import TelemetryEvent

    failures: list[str] = []
    captured: list[dict] = []
    original_sink = adapter.sink
    adapter.sink = captured.append
    try:
        env = TelemetryEnvelope(
            v=1,
            source="conformance",
            emitted_at=time.time(),
            events=(
                TelemetryEvent(
                    kind="search",
                    payload={"query": "SENSITIVE", "latency_ms": 1.0},
                    at=time.time(),
                    correlation_id="conf-1",
                ),
            ),
        )
        adapter.detach()
        adapter.deliver(env)
        if captured:
            failures.append("delivered while detached")
        adapter.attach()
        adapter.deliver(env)
        if not captured:
            failures.append("did not deliver while attached")
        else:
            event = captured[-1]["events"][0]
            if event["payload"].get("query") == "SENSITIVE":
                failures.append("sensitive field not redacted")
            if event["correlation_id"] != "conf-1":
                failures.append("correlation id not preserved")
    finally:
        adapter.sink = original_sink
    return ConformanceResult(passed=not failures, failures=tuple(failures))
