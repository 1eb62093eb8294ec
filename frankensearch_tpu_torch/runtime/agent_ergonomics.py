"""LLM-agent ergonomics: compact payloads, result-id registry, templates.

Parity target: reference crates/frankensearch-fsfs/src/agent_ergonomics.rs
— compact result payloads (token-budget friendly), a short result-id
registry so follow-up commands (`explain r3`) don't need full doc ids,
and query templates for common agent tasks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from frankensearch_tpu_torch.core.types import ScoredResult


@dataclass
class ResultRegistry:
    """Maps short handles (r1, r2, ...) to doc ids for the last search."""

    _handles: dict[str, str] = field(default_factory=dict)
    _counter: int = 0

    def register(self, results: Sequence[ScoredResult]) -> dict[str, str]:
        self._handles.clear()
        mapping = {}
        for i, r in enumerate(results, start=1):
            handle = f"r{i}"
            self._handles[handle] = r.doc_id
            mapping[handle] = r.doc_id
        return mapping

    def resolve(self, handle_or_doc_id: str) -> str:
        return self._handles.get(handle_or_doc_id, handle_or_doc_id)


def compact_results(
    results: Sequence[ScoredResult],
    *,
    registry: ResultRegistry | None = None,
    snippet_chars: int = 80,
) -> list[dict]:
    """Token-budget-friendly result rows: handle, id, score, tiny snippet."""
    if registry is not None:
        registry.register(results)
    out = []
    for i, r in enumerate(results, start=1):
        row: dict = {"h": f"r{i}", "id": r.doc_id, "s": round(r.score, 4)}
        if r.title:
            row["t"] = r.title[:snippet_chars]
        elif r.snippet:
            row["t"] = r.snippet[:snippet_chars]
        elif r.metadata and r.metadata.get("preview"):
            row["t"] = str(r.metadata["preview"])[:snippet_chars]
        out.append(row)
    return out


QUERY_TEMPLATES: dict[str, str] = {
    "find_definition": "fn {symbol} OR struct {symbol} OR class {symbol} OR def {symbol}",
    "find_usages": "{symbol} -def -struct -class",
    "find_config": "{key} config OR settings OR default",
    "find_error": '"{message}"',
    "find_tests": "test {subject}",
}


def render_template(name: str, **kwargs: str) -> str:
    template = QUERY_TEMPLATES[name]
    return template.format(**kwargs)


# -- cross-process registry persistence ---------------------------------------
# The CLI is one process per command, so `search` persists its handle
# mapping under the index root and a follow-up `feedback r3` (or any
# command accepting doc ids) resolves it (agent_ergonomics.rs result-id
# registry role).

REGISTRY_FILE = ".last_results.json"


def save_registry(root: str, mapping: dict[str, str]) -> None:
    import json
    import os

    from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

    path = os.path.join(root, REGISTRY_FILE)
    atomic_write_text(path, json.dumps({"version": 1, "handles": mapping}))


def load_registry(root: str) -> ResultRegistry:
    """Registry from the last persisted search; empty (handles resolve to
    themselves) when absent or corrupt — a stale/bad registry must never
    block a command that was passed a real doc id."""
    import json
    import os

    reg = ResultRegistry()
    path = os.path.join(root, REGISTRY_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        handles = raw.get("handles", {})
        if isinstance(handles, dict):
            reg._handles = {str(k): str(v) for k, v in handles.items()}
    except (OSError, ValueError):
        pass
    return reg
