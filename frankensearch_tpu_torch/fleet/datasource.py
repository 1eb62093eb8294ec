"""Fleet data sources: the DataSource contract + deterministic simulator.

Parity target: reference crates/frankensearch-ops — ``DataSource`` trait,
``MockDataSource`` and simulator.rs (seeded fleet telemetry generator).
Live discovery of real serve/daemon processes (discovery.rs heartbeat
reconciliation) lives in :mod:`frankensearch_tpu_torch.fleet.registry`
(``NodeRegistrar`` publishes, ``LiveDataSource`` reconciles); the
simulator here remains the deterministic test double.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Iterable

from frankensearch_tpu_torch.tui.determinism import DeterministicRng, TickClock


@dataclass(frozen=True)
class NodeInfo:
    node_id: str
    host: str
    generation_id: str
    healthy: bool
    last_heartbeat_s: float


@dataclass(frozen=True)
class NodeSample:
    """One telemetry sample from one node."""

    node_id: str
    at_s: float
    qps: float
    p50_ms: float
    p99_ms: float
    hbm_used_frac: float
    queue_pressure: float
    doc_count: int
    errors: int = 0


class DataSource(abc.ABC):
    @abc.abstractmethod
    def nodes(self) -> list[NodeInfo]: ...

    @abc.abstractmethod
    def samples(self) -> Iterable[NodeSample]: ...


@dataclass
class MockDataSource(DataSource):
    _nodes: list[NodeInfo] = field(default_factory=list)
    _samples: list[NodeSample] = field(default_factory=list)

    def nodes(self) -> list[NodeInfo]:
        return list(self._nodes)

    def samples(self) -> Iterable[NodeSample]:
        return list(self._samples)

    def add_node(self, node: NodeInfo) -> None:
        self._nodes.append(node)

    def add_sample(self, sample: NodeSample) -> None:
        self._samples.append(sample)


@dataclass
class FleetSimulator(DataSource):
    """Deterministic fleet: diurnal QPS curve + seeded noise + injected
    incidents (ops simulator.rs role). Same seed + same ticks => same
    telemetry byte-for-byte."""

    n_nodes: int = 4
    seed: int = 0
    clock: TickClock = field(default_factory=lambda: TickClock(tick_ms=1000.0))
    base_qps: float = 120.0
    #: node_id -> tick ranges of outage
    incidents: dict[str, tuple[int, int]] = field(default_factory=dict)
    _emitted: list[NodeSample] = field(default_factory=list)

    def _rng_for(self, node: str, tick: int) -> DeterministicRng:
        return DeterministicRng(self.seed).fork(f"{node}:{tick}")

    def nodes(self) -> list[NodeInfo]:
        now = self.clock.now_s()
        out = []
        for i in range(self.n_nodes):
            node_id = f"node-{i}"
            down = self._down(node_id, self.clock.ticks)
            out.append(
                NodeInfo(
                    node_id=node_id,
                    host=f"tpu-host-{i}",
                    generation_id="gen-001",
                    healthy=not down,
                    last_heartbeat_s=now if not down else max(now - 30.0, 0.0),
                )
            )
        return out

    def _down(self, node_id: str, tick: int) -> bool:
        window = self.incidents.get(node_id)
        return window is not None and window[0] <= tick < window[1]

    def step(self) -> list[NodeSample]:
        """Advance one tick and emit one sample per healthy node."""
        tick = self.clock.ticks
        t = self.clock.now_s()
        batch = []
        for i in range(self.n_nodes):
            node_id = f"node-{i}"
            if self._down(node_id, tick):
                continue
            rng = self._rng_for(node_id, tick)
            diurnal = 1.0 + 0.5 * math.sin(2 * math.pi * (t % 86400) / 86400)
            qps = self.base_qps * diurnal * (0.9 + 0.2 * rng.random())
            p50 = 5.0 + 2.0 * rng.random()
            sample = NodeSample(
                node_id=node_id,
                at_s=t,
                qps=qps,
                p50_ms=p50,
                p99_ms=p50 * (3.0 + rng.random()),
                hbm_used_frac=0.4 + 0.1 * rng.random(),
                queue_pressure=0.1 * rng.random(),
                doc_count=1_000_000 + i,
                errors=1 if rng.random() < 0.01 else 0,
            )
            batch.append(sample)
            self._emitted.append(sample)
        self.clock.tick()
        return batch

    def samples(self) -> Iterable[NodeSample]:
        return list(self._emitted)
