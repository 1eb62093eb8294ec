"""Built-in screens: search, status, metrics dashboard.

Parity target: the fsfs TUI dashboards (runtime.rs TUI paths) and the
explainability screen (fsfs/explainability_screen.rs) at text-frame
fidelity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from frankensearch_tpu_torch.core.types import ScoredResult
from frankensearch_tpu_torch.tui.shell import AppShell, InputEvent, Screen


def neutralize(text: str, limit: int = 64) -> str:
    """Control chars in UNTRUSTED display text become visible escapes
    (terminal ANSI-injection guard — applies to doc titles/ids AND fleet
    registry fields: any process that can write the registry dir chooses
    node_id/generation_id bytes)."""
    return "".join(
        c if (ord(c) >= 0x20 and ord(c) != 0x7F) else repr(c)[1:-1]
        for c in text[:limit]
    )


def _bar(value: float, max_value: float, width: int) -> str:
    if max_value <= 0:
        return ""
    n = int(round(min(value / max_value, 1.0) * width))
    return "█" * n + "░" * (width - n)


@dataclass
class SearchScreen(Screen):
    """Interactive query + progressive results (types text, sees phases)."""

    search_fn: Callable[[str, int], object]  # -> SearchOutcome
    name: str = "search"
    query: str = ""
    results: list[ScoredResult] = field(default_factory=list)
    phases: list[str] = field(default_factory=list)
    status: str = "type a query, press enter"
    k: int = 8

    def handle(self, event: InputEvent, shell: AppShell) -> None:
        if event.kind == "text":
            self.query = event.value
        elif event.kind == "key" and event.value == "enter":
            if not self.query.strip():
                self.status = "empty query"
                return
            self.phases = []
            outcome = self.search_fn(self.query, self.k)
            self.results = list(outcome.results)
            self.phases = [p.kind.value for p in outcome.phases]
            self.status = f"{len(self.results)} results ({' -> '.join(self.phases)})"
        elif event.kind == "key" and event.value == "clear":
            self.query, self.results, self.status = "", [], "cleared"

    def render(self, width: int) -> str:
        lines = [f"query> {self.query}", self.status, "─" * width]
        max_score = max((r.score for r in self.results), default=0.0)
        for i, r in enumerate(self.results, 1):
            bar = _bar(r.score, max_score, 12)
            # untrusted titles/ids: control chars become visible escapes
            # (terminal ANSI-injection guard, same as the table renderer)
            title = neutralize(r.title or r.doc_id, limit=width - 30)
            lines.append(f"{i:>2}. {bar} {r.score:>8.4f}  {title}")
        return "\n".join(lines)


@dataclass
class StatusScreen(Screen):
    """Index/arm status (fsfs status dashboard)."""

    status_fn: Callable[[], dict]
    name: str = "status"

    def render(self, width: int) -> str:
        lines = []
        for key, value in sorted(self.status_fn().items()):
            lines.append(f"{key:<28} {value}")
        return "\n".join(lines) or "(no status)"


@dataclass
class FleetScreen(Screen):
    """Fleet console: node health + rollups (frankensearch-ops screens)."""

    nodes_fn: Callable[[], list]  # -> list[NodeInfo]
    rollups_fn: Callable[[], list]  # -> list[NodeRollup]
    name: str = "fleet"

    def render(self, width: int) -> str:
        lines = [
            f"{'node':<12}{'health':<9}{'gen':<10}{'samples':>8}{'qps':>10}{'p99ms':>9}{'errors':>8}"
        ]
        rollups = {r.node_id: r for r in self.rollups_fn()}
        for n in self.nodes_fn():
            r = rollups.get(n.node_id)
            # registry fields are UNTRUSTED (shared-write directory)
            node_id = neutralize(n.node_id, limit=12)
            gen = neutralize(n.generation_id, limit=10)
            lines.append(
                f"{node_id:<12}{'up' if n.healthy else 'DOWN':<9}{gen:<10}"
                + (
                    f"{r.samples:>8}{r.mean_qps:>10.1f}{r.max_p99_ms:>9.1f}{r.total_errors:>8}"
                    if r
                    else f"{'-':>8}{'-':>10}{'-':>9}{'-':>8}"
                )
            )
        total = sum(r.mean_qps for r in rollups.values())
        lines.append("─" * width)
        lines.append(f"fleet qps ~ {total:.0f}")
        return "\n".join(lines)


@dataclass
class MetricsScreen(Screen):
    """Latency dashboard over StreamingStats."""

    stats_fn: Callable[[], dict]  # name -> StreamingStats.to_dict()
    name: str = "metrics"

    def render(self, width: int) -> str:
        lines = [f"{'metric':<20}{'count':>8}{'mean':>10}{'p50':>10}{'p95':>10}{'p99':>10}"]
        for name, s in sorted(self.stats_fn().items()):
            lines.append(
                f"{name:<20}{s.get('count', 0):>8}"
                f"{s.get('mean', 0.0):>10.2f}{s.get('p50', 0.0):>10.2f}"
                f"{s.get('p95', 0.0):>10.2f}{s.get('p99', 0.0):>10.2f}"
            )
        return "\n".join(lines)
