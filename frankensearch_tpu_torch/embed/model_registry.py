"""Model registry: directory layout + verification receipts.

Parity target: reference crates/frankensearch-embed/src/model_registry.rs
+ model_cache.rs — a models root with one directory per model, each
carrying a manifest; verification produces receipts keyed to the
manifest so later opens can skip re-hashing unless the manifest changed.
"""

from __future__ import annotations

from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

import json
import os
import time
from dataclasses import dataclass

from frankensearch_tpu_torch.embed.model_manifest import (
    ModelManifest,
    verify_model_dir,
)

RECEIPT_FILE = "verification_receipt.json"


@dataclass(frozen=True)
class RegisteredModel:
    name: str
    path: str
    manifest: ModelManifest | None
    verified: bool
    receipt_fresh: bool


@dataclass
class ModelRegistry:
    root: str  # <data_dir>/models

    def list_models(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            n for n in os.listdir(self.root) if os.path.isdir(os.path.join(self.root, n))
        )

    def _manifest_of(self, name: str) -> ModelManifest | None:
        path = os.path.join(self.root, name, "model_manifest.json")
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return ModelManifest.from_json(f.read())

    def _receipt_path(self, name: str) -> str:
        return os.path.join(self.root, name, RECEIPT_FILE)

    def _receipt_fresh(self, name: str, manifest: ModelManifest) -> bool:
        """A receipt is fresh if it references the same manifest content
        (model_cache.rs: receipts keyed to manifests)."""
        path = self._receipt_path(name)
        if not os.path.exists(path):
            return False
        try:
            with open(path, encoding="utf-8") as f:
                receipt = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        import hashlib

        manifest_hash = hashlib.sha256(manifest.to_json().encode()).hexdigest()
        return receipt.get("manifest_sha256") == manifest_hash and receipt.get("ok") is True

    def verify(self, name: str, *, force: bool = False) -> RegisteredModel:
        path = os.path.join(self.root, name)
        manifest = self._manifest_of(name)
        if manifest is None:
            return RegisteredModel(name, path, None, False, False)
        if not force and self._receipt_fresh(name, manifest):
            return RegisteredModel(name, path, manifest, True, True)
        result = verify_model_dir(path, manifest)
        if result.ok:
            import hashlib

            receipt = {
                "ok": True,
                "verified_at": time.time(),
                "manifest_sha256": hashlib.sha256(manifest.to_json().encode()).hexdigest(),
            }
            atomic_write_text(self._receipt_path(name), json.dumps(receipt))
        return RegisteredModel(name, path, manifest, result.ok, False)

    def verified_models(self) -> list[RegisteredModel]:
        return [self.verify(n) for n in self.list_models()]
