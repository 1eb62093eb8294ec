"""Generation history + time travel by commit sequence.

Parity target: reference crates/frankensearch-core/src/time_travel.rs —
``GenerationHistory``: query historical generations by commit seq,
retention policy deciding which old generations to keep.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass

from frankensearch_tpu_torch.core.activation import GenerationController
from frankensearch_tpu_torch.core.generation import GenerationManifest, read_manifest


@dataclass(frozen=True)
class RetentionPolicy:
    """Keep the newest ``keep_latest`` generations plus everything newer
    than ``keep_days`` (time_travel.rs retention)."""

    keep_latest: int = 3
    keep_days: float = 7.0


class GenerationHistory:
    def __init__(self, controller: GenerationController) -> None:
        self.controller = controller

    def manifests(self) -> list[GenerationManifest]:
        out = []
        for gen_id in self.controller.list_generations():
            try:
                out.append(read_manifest(self.controller.generation_dir(gen_id)))
            except Exception:
                continue
        out.sort(key=lambda m: m.commit_seq)
        return out

    def at_commit_seq(self, seq: int) -> GenerationManifest | None:
        """The generation serving at commit seq: the newest generation with
        commit_seq <= seq."""
        best = None
        for m in self.manifests():
            if m.commit_seq <= seq:
                best = m
        return best

    def latest(self) -> GenerationManifest | None:
        ms = self.manifests()
        return ms[-1] if ms else None

    def prune(self, policy: RetentionPolicy, *, now: float | None = None) -> list[str]:
        """Delete generations outside the retention policy. Never deletes
        the CURRENT generation. Returns deleted generation ids."""
        import time as _time

        now = now if now is not None else _time.time()
        ms = self.manifests()
        keep: set[str] = set()
        current = self.controller.current_generation()
        if current:
            keep.add(current)
        for m in ms[-policy.keep_latest :]:
            keep.add(m.generation_id)
        for m in ms:
            if now - m.created_at <= policy.keep_days * 86400.0:
                keep.add(m.generation_id)
        deleted = []
        for m in ms:
            if m.generation_id not in keep:
                shutil.rmtree(self.controller.generation_dir(m.generation_id), ignore_errors=True)
                deleted.append(m.generation_id)
        return deleted
