"""Self-contained replay packs for bug reports / evidence.

Parity target: reference crates/frankensearch-fsfs/src/repro.rs — a repro
pack bundles the evidence JSONL, effective config, model/generation
manifests and environment fingerprint into one directory (+ index of
contents), so a report replays without the original machine.

``environment.json`` names the torch build, its CUDA version and the
cards (``torch.cuda.get_device_name``), as the CLI's ``version`` does.
"""

from __future__ import annotations

import json
import os
import platform
import time
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass
class ReproPack:
    root: str
    events: list[dict] = field(default_factory=list)
    config: Mapping[str, Any] | None = None
    manifests: dict[str, str] = field(default_factory=dict)  # name -> json
    notes: list[str] = field(default_factory=list)

    def record_event(self, kind: str, payload: Mapping[str, Any]) -> None:
        self.events.append({"kind": kind, "at": time.time(), "payload": dict(payload)})

    def attach_manifest(self, name: str, manifest_json: str) -> None:
        self.manifests[name] = manifest_json

    def write(self) -> str:
        os.makedirs(self.root, exist_ok=True)
        with open(os.path.join(self.root, "evidence.jsonl"), "w", encoding="utf-8") as f:
            for e in self.events:
                f.write(json.dumps(e, default=str) + "\n")
        if self.config is not None:
            with open(os.path.join(self.root, "config.json"), "w", encoding="utf-8") as f:
                json.dump(dict(self.config), f, indent=2, default=str)
        for name, raw in self.manifests.items():
            with open(os.path.join(self.root, f"manifest.{name}.json"), "w", encoding="utf-8") as f:
                f.write(raw)
        import torch

        env = {
            "python": platform.python_version(),
            "platform": platform.platform(),
            "created_at": time.time(),
            "notes": self.notes,
            # the stack and the cards, as ``version`` reports them
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
        }
        with open(os.path.join(self.root, "environment.json"), "w", encoding="utf-8") as f:
            json.dump(env, f, indent=2)
        index = {
            "v": 1,
            "files": sorted(set(os.listdir(self.root)) | {"INDEX.json"}),
            "event_count": len(self.events),
        }
        with open(os.path.join(self.root, "INDEX.json"), "w", encoding="utf-8") as f:
            json.dump(index, f, indent=2)
        return self.root

    @staticmethod
    def load(root: str) -> "ReproPack":
        pack = ReproPack(root=root)
        ev_path = os.path.join(root, "evidence.jsonl")
        if os.path.exists(ev_path):
            with open(ev_path, encoding="utf-8") as f:
                pack.events = [json.loads(line) for line in f if line.strip()]
        cfg_path = os.path.join(root, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                pack.config = json.load(f)
        for name in os.listdir(root):
            if name.startswith("manifest.") and name.endswith(".json"):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    pack.manifests[name[len("manifest.") : -len(".json")]] = f.read()
        return pack
