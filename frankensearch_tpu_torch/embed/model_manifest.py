"""Model artifact manifests: frozen, revision-pinned, fail-closed verify.

Parity target: reference crates/frankensearch-embed/src/model_manifest.rs —
per-model artifact manifests (file list + SHA-256 + byte length),
preprocessing/pooling/normalization contracts, download consent; and
src/model_download.rs's verify-then-atomically-promote contract (the
downloader itself is stubbed here: this environment is zero-egress, and
deployments ship models via their artifact store).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass, field

from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

MANIFEST_SCHEMA_VERSION = 1


def validate_artifact_name(name: str) -> str:
    """Fail-closed artifact-name gate. Manifests name FLAT files only
    (build_model_manifest lists a single directory), and every consumer
    joins the name under a staging/destination/source dir — so any
    separator, traversal component, or absolute path is an escape
    attempt, not a layout choice. Probed: a fetched manifest naming
    ``../escape.txt`` published a file OUTSIDE the model directory
    before this gate existed."""
    if (
        not name
        or name in (".", "..")
        or "/" in name
        or "\\" in name
        or "\x00" in name
        or name == "model_manifest.json"  # would collide with the
        # manifest the promote step writes, corrupting verification
    ):
        raise EmbeddingFailed(f"illegal artifact name in model manifest: {name!r}")
    return name


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclass(frozen=True)
class ModelFileEntry:
    name: str
    sha256: str
    bytes: int


@dataclass(frozen=True)
class PreprocessingContract:
    """What the embedder is allowed to assume (model_manifest.rs
    preprocessing/pooling/normalization contracts)."""

    tokenizer: str = "wordpiece"  # "wordpiece" | "bpe" | "whitespace"
    lowercase: bool = True
    max_tokens: int = 512
    pooling: str = "mean"  # "mean" | "cls"
    normalize: bool = True

    def to_dict(self) -> dict:
        return {
            "tokenizer": self.tokenizer,
            "lowercase": self.lowercase,
            "max_tokens": self.max_tokens,
            "pooling": self.pooling,
            "normalize": self.normalize,
        }


@dataclass
class ModelManifest:
    model_id: str
    revision: str
    dim: int
    kind: str  # "model2vec" | "bert-embedder" | "cross-encoder"
    files: list[ModelFileEntry] = field(default_factory=list)
    preprocessing: PreprocessingContract = field(default_factory=PreprocessingContract)
    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "v": MANIFEST_SCHEMA_VERSION,
                "model_id": self.model_id,
                "revision": self.revision,
                "dim": self.dim,
                "kind": self.kind,
                "files": [
                    {"name": f.name, "sha256": f.sha256, "bytes": f.bytes}
                    for f in self.files
                ],
                "preprocessing": self.preprocessing.to_dict(),
                "extra": self.extra,
            },
            indent=2,
        )

    @staticmethod
    def from_json(raw: str) -> "ModelManifest":
        d = json.loads(raw)
        if d.get("v") != MANIFEST_SCHEMA_VERSION:
            raise EmbeddingFailed(f"unsupported model manifest version {d.get('v')}")
        return ModelManifest(
            model_id=d["model_id"],
            revision=d["revision"],
            dim=d["dim"],
            kind=d["kind"],
            files=[
                ModelFileEntry(
                    name=validate_artifact_name(f["name"]),
                    sha256=f["sha256"],
                    bytes=f["bytes"],
                )
                for f in d["files"]
            ],
            preprocessing=PreprocessingContract(**d.get("preprocessing", {})),
            extra=d.get("extra", {}),
        )


def build_model_manifest(
    model_dir: str, model_id: str, revision: str, dim: int, kind: str,
    preprocessing: PreprocessingContract | None = None,
) -> ModelManifest:
    files = []
    for name in sorted(os.listdir(model_dir)):
        full = os.path.join(model_dir, name)
        if not os.path.isfile(full) or name == "model_manifest.json":
            continue
        files.append(
            ModelFileEntry(name=name, sha256=sha256_file(full), bytes=os.path.getsize(full))
        )
    return ModelManifest(
        model_id=model_id, revision=revision, dim=dim, kind=kind, files=files,
        preprocessing=preprocessing or PreprocessingContract(),
    )


def write_model_manifest(model_dir: str, manifest: ModelManifest) -> str:
    path = os.path.join(model_dir, "model_manifest.json")
    atomic_write_text(path, manifest.to_json())
    return path


@dataclass(frozen=True)
class ModelVerification:
    ok: bool
    missing: tuple[str, ...] = ()
    corrupted: tuple[str, ...] = ()


def verify_model_dir(model_dir: str, manifest: ModelManifest | None = None) -> ModelVerification:
    """Fail-closed verify (model_download.rs --verify contract)."""
    if manifest is None:
        path = os.path.join(model_dir, "model_manifest.json")
        if not os.path.exists(path):
            return ModelVerification(ok=False, missing=("model_manifest.json",))
        with open(path, encoding="utf-8") as f:
            manifest = ModelManifest.from_json(f.read())
    missing, corrupted = [], []
    for entry in manifest.files:
        full = os.path.join(model_dir, entry.name)
        if not os.path.exists(full):
            missing.append(entry.name)
        elif os.path.getsize(full) != entry.bytes or sha256_file(full) != entry.sha256:
            corrupted.append(entry.name)
    return ModelVerification(ok=not missing and not corrupted,
                             missing=tuple(missing), corrupted=tuple(corrupted))


def promote_staged_model(staging_dir: str, final_dir: str) -> None:
    """Verify-then-atomically-promote: a staged model directory becomes
    live only after verification passes (model_download.rs promotion)."""
    verification = verify_model_dir(staging_dir)
    if not verification.ok:
        raise EmbeddingFailed(
            f"staged model failed verification: missing={list(verification.missing)} "
            f"corrupted={list(verification.corrupted)}"
        )
    tmp = final_dir + ".old"
    if os.path.exists(final_dir):
        os.replace(final_dir, tmp)
    try:
        os.replace(staging_dir, final_dir)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
