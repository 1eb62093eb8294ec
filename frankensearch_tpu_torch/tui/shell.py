"""App shell: screen registry, input dispatch, frame rendering, replay.

Parity target: reference crates/frankensearch-tui/src/shell.rs
(AppShell/ScreenRegistry), replay.rs (recorded input events replayed
against the TickClock for frame-identical sessions) and evidence.rs
(JSONL evidence of every frame/event).
"""

from __future__ import annotations

import abc
import json
from dataclasses import dataclass, field
from typing import Callable

from frankensearch_tpu_torch.tui.determinism import DeterministicRng, TickClock


@dataclass(frozen=True)
class InputEvent:
    kind: str  # "key" | "text" | "tick" | "resize"
    value: str = ""
    at_tick: int = 0

    def to_dict(self) -> dict:
        return {"kind": self.kind, "value": self.value, "at_tick": self.at_tick}


class Screen(abc.ABC):
    """A renderable screen; render() must be a pure function of state."""

    name: str = "screen"

    @abc.abstractmethod
    def render(self, width: int) -> str: ...

    def handle(self, event: InputEvent, shell: "AppShell") -> None:  # noqa: B027
        """Optional input handling."""


@dataclass
class EvidenceLog:
    """JSONL evidence of events + frame hashes (tui evidence.rs)."""

    records: list[dict] = field(default_factory=list)

    def record_event(self, event: InputEvent) -> None:
        self.records.append({"type": "event", **event.to_dict()})

    def record_frame(self, screen: str, frame: str, tick: int) -> None:
        import hashlib

        self.records.append(
            {
                "type": "frame",
                "screen": screen,
                "tick": tick,
                "frame_hash": hashlib.blake2b(frame.encode(), digest_size=8).hexdigest(),
                "lines": frame.count("\n") + 1,
            }
        )

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records)


class AppShell:
    """Screen registry + event loop core (pull-based: caller feeds events)."""

    def __init__(self, *, clock: TickClock | None = None, seed: int = 0, width: int = 80):
        self.clock = clock or TickClock()
        self.rng = DeterministicRng(seed=seed)
        self.width = width
        self._screens: dict[str, Screen] = {}
        self.active: str | None = None
        self.evidence = EvidenceLog()
        self.frames: list[str] = []
        self._input_log: list[InputEvent] = []

    def register(self, screen: Screen) -> None:
        self._screens[screen.name] = screen
        if self.active is None:
            self.active = screen.name

    def switch(self, name: str) -> None:
        if name not in self._screens:
            raise KeyError(name)
        self.active = name

    def feed(self, event: InputEvent) -> str:
        """Apply one input event, advance the clock on ticks, render."""
        self._input_log.append(event)
        self.evidence.record_event(event)
        if event.kind == "tick":
            self.clock.tick()
        elif event.kind == "resize":
            self.width = int(event.value)
        elif event.kind == "key" and event.value.startswith("screen:"):
            self.switch(event.value.split(":", 1)[1])
        else:
            screen = self._screens[self.active]
            screen.handle(event, self)
        frame = self.render()
        return frame

    def render(self) -> str:
        assert self.active is not None
        screen = self._screens[self.active]
        header = f"[{self.active}] t={self.clock.ticks}".ljust(self.width, "─")
        frame = header + "\n" + screen.render(self.width)
        self.frames.append(frame)
        self.evidence.record_frame(self.active, frame, self.clock.ticks)
        return frame

    # -- deterministic replay ------------------------------------------------

    def input_log(self) -> list[InputEvent]:
        return list(self._input_log)


def replay(
    make_shell: Callable[[], AppShell], events: list[InputEvent]
) -> AppShell:
    """Re-run a recorded session; deterministic screens yield identical
    frames (tui replay.rs contract)."""
    shell = make_shell()
    for e in events:
        shell.feed(e)
    return shell
