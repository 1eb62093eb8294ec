"""Resource-pressure sensing + degradation state machine.

Parity target: reference crates/frankensearch-fsfs/src/pressure.rs (+
pressure_sensing.rs) — /proc + sysinfo signals feed a 4-state
Normal/Elevated/Degraded/Emergency controller with hysteresis and
anti-flap; the ``ResourcePressureGovernor`` (:1181) gates the quality
tier and ranking priors under load.

Device-first signal set: host memory (/proc/meminfo), embedding-queue
depth, and device memory occupancy (the CUDA caching allocator's bytes in
tensors over the card's total memory) — the reference's CPU-load signal
maps to queue depth here because device work is queued, not
thread-starved.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable


class PressureState(enum.Enum):
    NORMAL = 0
    ELEVATED = 1
    DEGRADED = 2
    EMERGENCY = 3


@dataclass(frozen=True)
class PressureSignals:
    host_mem_used_frac: float = 0.0
    device_hbm_used_frac: float = 0.0
    queue_pressure: float = 0.0  # EmbeddingQueue.pressure

    @property
    def worst(self) -> float:
        return max(self.host_mem_used_frac, self.device_hbm_used_frac, self.queue_pressure)


def sense_host_memory() -> float:
    """Used-memory fraction from /proc/meminfo (MemAvailable-based)."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                info[parts[0].rstrip(":")] = int(parts[1])
        total = info.get("MemTotal", 1)
        avail = info.get("MemAvailable", total)
        return max(0.0, min(1.0, 1.0 - avail / total))
    except OSError:  # pragma: no cover
        return 0.0


def sense_device_hbm(device) -> float:
    """Device memory occupancy fraction of ``device`` (a :class:`torch.device`).

    On CUDA: the bytes this process's caching allocator holds in tensors
    (``torch.cuda.memory_allocated``) over the card's total memory. The
    JAX package reads XLA's ``bytes_in_use / bytes_limit``; here the
    limit is the whole card, not an allocator budget. On the CPU: 0.0.
    A failure to read the card raises."""
    if device.type != "cuda":
        return 0.0
    import torch

    total = torch.cuda.get_device_properties(device).total_memory
    return torch.cuda.memory_allocated(device) / total


# state enter-thresholds on the worst signal; exit requires dropping below
# (threshold - hysteresis) for min_dwell_s (anti-flap, pressure.rs:576)
_ENTER = {
    PressureState.ELEVATED: 0.70,
    PressureState.DEGRADED: 0.85,
    PressureState.EMERGENCY: 0.95,
}
_HYSTERESIS = 0.05


@dataclass
class DegradationStateMachine:
    min_dwell_s: float = 5.0
    clock: Callable[[], float] = time.monotonic
    state: PressureState = PressureState.NORMAL
    _entered_at: float = 0.0
    _pending_down: PressureState | None = None
    _pending_since: float = 0.0
    transitions: list[tuple[float, PressureState]] = field(default_factory=list)

    def observe(self, signals: PressureSignals) -> PressureState:
        now = self.clock()
        target = self._target_state(signals.worst)
        if target.value > self.state.value:
            # escalation is immediate (pressure rises fast)
            self._set(target, now)
            self._pending_down = None
        elif target.value < self.state.value:
            # de-escalation needs dwell below the exit threshold (anti-flap)
            exit_threshold = _ENTER.get(self.state, 1.0) - _HYSTERESIS
            if signals.worst < exit_threshold:
                if self._pending_down != target:
                    self._pending_down = target
                    self._pending_since = now
                elif now - self._pending_since >= self.min_dwell_s:
                    self._set(target, now)
                    self._pending_down = None
            else:
                self._pending_down = None
        else:
            self._pending_down = None
        return self.state

    def _target_state(self, worst: float) -> PressureState:
        if worst >= _ENTER[PressureState.EMERGENCY]:
            return PressureState.EMERGENCY
        if worst >= _ENTER[PressureState.DEGRADED]:
            return PressureState.DEGRADED
        if worst >= _ENTER[PressureState.ELEVATED]:
            return PressureState.ELEVATED
        return PressureState.NORMAL

    def _set(self, state: PressureState, now: float) -> None:
        self.state = state
        self._entered_at = now
        self.transitions.append((now, state))


@dataclass
class ResourcePressureGovernor:
    """Maps pressure state to gating decisions (pressure.rs:1181)."""

    machine: DegradationStateMachine = field(default_factory=DegradationStateMachine)

    def observe(self, signals: PressureSignals) -> PressureState:
        return self.machine.observe(signals)

    @property
    def state(self) -> PressureState:
        return self.machine.state

    @property
    def allow_quality_tier(self) -> bool:
        return self.machine.state.value < PressureState.DEGRADED.value

    @property
    def allow_rerank(self) -> bool:
        return self.machine.state is PressureState.NORMAL

    @property
    def allow_ranking_priors(self) -> bool:
        # priors disabled under pressure (fsfs ranking_priors contract)
        return self.machine.state.value < PressureState.DEGRADED.value

    @property
    def ingest_batch_scale(self) -> float:
        """Batch-size multiplier for background indexing under pressure."""
        return {
            PressureState.NORMAL: 1.0,
            PressureState.ELEVATED: 0.5,
            PressureState.DEGRADED: 0.25,
            PressureState.EMERGENCY: 0.0,
        }[self.machine.state]
