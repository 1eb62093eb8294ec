"""Generation manifests: versioned, content-addressed index generations.

Parity target: reference crates/frankensearch-core/src/generation.rs —
``GenerationManifest`` (artifact list + hashes), embedding identity
bundles, activation invariants with anti-rollback floors, golden-vector
conformance certificates, quantization format tags. The reference's
distributed Native Mode replicates these manifests; on TPU the same
schema versions sharded-array checkpoints (SURVEY §5 checkpoint notes).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from frankensearch_tpu_torch.core.errors import IndexCorrupted

MANIFEST_VERSION = 1
MANIFEST_FILE = "MANIFEST.json"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


@dataclass(frozen=True)
class ArtifactEntry:
    name: str  # path relative to the generation root
    sha256: str
    bytes: int

    def to_dict(self) -> dict:
        return {"name": self.name, "sha256": self.sha256, "bytes": self.bytes}


@dataclass(frozen=True)
class GoldenVectorCertificate:
    """Conformance certificate: hash of expected vectors for sampled doc
    ids, proving an embedder produces the same space as at build time
    (generation.rs golden-vector certificates)."""

    embedder_id: str
    doc_ids: tuple[str, ...]
    vectors_sha256: str

    def to_dict(self) -> dict:
        return {
            "embedder_id": self.embedder_id,
            "doc_ids": list(self.doc_ids),
            "vectors_sha256": self.vectors_sha256,
        }

    @staticmethod
    def compute(embedder_id: str, doc_ids: Sequence[str], vectors) -> "GoldenVectorCertificate":
        import numpy as np

        arr = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
        return GoldenVectorCertificate(
            embedder_id=embedder_id,
            doc_ids=tuple(doc_ids),
            vectors_sha256=hashlib.sha256(arr.tobytes()).hexdigest(),
        )


@dataclass
class GenerationManifest:
    generation_id: str
    commit_seq: int
    created_at: float
    artifacts: list[ArtifactEntry] = field(default_factory=list)
    embedders: dict[str, Mapping] = field(default_factory=dict)  # tier -> identity dict
    quantization: str = "bf16"
    doc_count: int = 0
    golden: list[GoldenVectorCertificate] = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": MANIFEST_VERSION,
                "generation_id": self.generation_id,
                "commit_seq": self.commit_seq,
                "created_at": self.created_at,
                "artifacts": [a.to_dict() for a in self.artifacts],
                "embedders": {k: dict(v) for k, v in self.embedders.items()},
                "quantization": self.quantization,
                "doc_count": self.doc_count,
                "golden": [g.to_dict() for g in self.golden],
                "extra": self.extra,
            },
            indent=2,
        )

    @staticmethod
    def from_json(raw: str) -> "GenerationManifest":
        d = json.loads(raw)
        if d.get("version") != MANIFEST_VERSION:
            raise IndexCorrupted(f"unsupported manifest version {d.get('version')}")
        return GenerationManifest(
            generation_id=d["generation_id"],
            commit_seq=d["commit_seq"],
            created_at=d["created_at"],
            artifacts=[ArtifactEntry(**a) for a in d["artifacts"]],
            embedders=d.get("embedders", {}),
            quantization=d.get("quantization", "bf16"),
            doc_count=d.get("doc_count", 0),
            golden=[
                GoldenVectorCertificate(
                    embedder_id=g["embedder_id"],
                    doc_ids=tuple(g["doc_ids"]),
                    vectors_sha256=g["vectors_sha256"],
                )
                for g in d.get("golden", [])
            ],
            extra=d.get("extra", {}),
        )


#: deterministic probe texts for embedder conformance — chosen to cover
#: short keywords, natural language, numerals and mixed case
CONFORMANCE_PROBES = (
    "alpha",
    "the quick brown fox jumps over the lazy dog",
    "vector index search quality",
    "error 404 not found",
    "Mixed Case Query Terms",
    "durability repair parity stripe",
    "a b c d e f g",
    "progressive two tier fusion",
)


@dataclass(frozen=True)
class EmbedderConformanceCertificate:
    """Golden-vector conformance with a tolerance: pins f16-quantized
    probe vectors so a drop-in embedder claiming the same identity can
    be verified to produce the SAME SPACE (generation.rs golden-vector
    certificates). Cosine tolerance (not an exact hash) because the
    same weights produce slightly different floats across CPU/TPU
    backends — wrong weights score ~0, right weights ~1.
    """

    embedder_id: str
    probes: tuple[str, ...]
    #: f16-quantized probe embeddings, row-major
    vectors_f16: tuple[float, ...]
    dim: int
    min_cosine: float = 0.999

    def to_dict(self) -> dict:
        return {
            "embedder_id": self.embedder_id,
            "probes": list(self.probes),
            "vectors_f16": list(self.vectors_f16),
            "dim": self.dim,
            "min_cosine": self.min_cosine,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "EmbedderConformanceCertificate":
        return EmbedderConformanceCertificate(
            embedder_id=d["embedder_id"],
            probes=tuple(d["probes"]),
            vectors_f16=tuple(d["vectors_f16"]),
            dim=int(d["dim"]),
            min_cosine=float(d.get("min_cosine", 0.999)),
        )

    @staticmethod
    def compute(embedder, probes: Sequence[str] = CONFORMANCE_PROBES,
                min_cosine: float = 0.999) -> "EmbedderConformanceCertificate":
        import numpy as np

        vecs = np.asarray(embedder.embed_batch(list(probes)), dtype=np.float16)
        return EmbedderConformanceCertificate(
            embedder_id=embedder.embedder_id,
            probes=tuple(probes),
            vectors_f16=tuple(float(x) for x in vecs.reshape(-1)),
            dim=int(vecs.shape[1]),
            min_cosine=min_cosine,
        )

    def verify(self, embedder) -> tuple[bool, float]:
        """Returns (conformant, worst probe cosine).

        Degenerate probes: an embedder may map a probe to the zero
        vector (e.g. a word-level Model2Vec whose vocabulary contains
        none of the probe's tokens). Zero-at-build AND zero-at-verify is
        AGREEMENT (same tokenizer behavior — cosine forced to 1), while
        zero on exactly one side is a space mismatch (0). Without this,
        a valid embedder over a narrow vocabulary would fail its own
        certificate at open (found by cross-backend probing)."""
        import numpy as np

        if embedder.embedder_id != self.embedder_id:
            return False, 0.0
        got = np.asarray(embedder.embed_batch(list(self.probes)), dtype=np.float32)
        if got.shape != (len(self.probes), self.dim):
            return False, 0.0
        want = np.asarray(self.vectors_f16, dtype=np.float32).reshape(
            len(self.probes), self.dim
        )

        got_n = np.linalg.norm(got, axis=1)
        want_n = np.linalg.norm(want, axis=1)
        both_zero = (got_n < 1e-6) & (want_n < 1e-6)
        one_zero = ((got_n < 1e-6) | (want_n < 1e-6)) & ~both_zero

        def norm(a):
            return a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)

        cos = np.sum(norm(got) * norm(want), axis=1)
        cos = np.where(both_zero, 1.0, cos)
        cos = np.where(one_zero, 0.0, cos)
        worst = float(np.min(cos))
        return worst >= self.min_cosine, worst


def build_manifest(
    gen_dir: str,
    generation_id: str,
    commit_seq: int,
    *,
    embedders: Mapping[str, Mapping] | None = None,
    doc_count: int = 0,
    quantization: str = "bf16",
    golden: Sequence[GoldenVectorCertificate] = (),
) -> GenerationManifest:
    """Hash every file under gen_dir (except the manifest itself)."""
    artifacts = []
    for dirpath, _, files in os.walk(gen_dir):
        for name in sorted(files):
            if name == MANIFEST_FILE or name.endswith((".tmp", ".lock")):
                # .lock: artifact-mutation flock files (index/durability
                # .py) are coordination state, not census-able content
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, gen_dir)
            try:
                artifacts.append(
                    ArtifactEntry(
                        name=rel, sha256=sha256_file(full), bytes=os.path.getsize(full)
                    )
                )
            except (FileNotFoundError, OSError):
                # blue-green GC can reap a superseded generation between
                # the walk and the hash (found racing seal vs census) —
                # a vanished file is simply not part of this census
                continue
    return GenerationManifest(
        generation_id=generation_id,
        commit_seq=commit_seq,
        created_at=time.time(),
        artifacts=artifacts,
        embedders=dict(embedders or {}),
        quantization=quantization,
        doc_count=doc_count,
        golden=list(golden),
    )


def refresh_manifest(gen_dir: str) -> "GenerationManifest | None":
    """Re-census the artifacts after a mutating flow (compaction, seal,
    WAL rebuild): hashes are recomputed, identities/conformance/extra
    carry over, commit_seq bumps monotonically (anti-rollback floors
    keep holding). No-op when the dir has no manifest."""
    path = os.path.join(gen_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    old = read_manifest(gen_dir)
    fresh = build_manifest(
        gen_dir,
        generation_id=old.generation_id,
        commit_seq=old.commit_seq + 1,
        embedders=old.embedders,
        doc_count=old.doc_count,
        quantization=old.quantization,
        golden=old.golden,
    )
    fresh.extra = dict(old.extra)
    write_manifest(gen_dir, fresh)
    return fresh


def write_manifest(gen_dir: str, manifest: GenerationManifest) -> str:
    path = os.path.join(gen_dir, MANIFEST_FILE)
    # UNIQUE tmp name: two concurrent refreshers sharing one tmp path
    # race replace-vs-replace and the loser's os.replace hits a vanished
    # source (found racing seal against itself); last-writer-wins on the
    # final replace is fine — both censuses are valid
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(manifest.to_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # disk-full (or any mid-write failure) must not leak the staged
        # tmp: a partial manifest is garbage, the old one keeps serving
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return path


def read_manifest(gen_dir: str) -> GenerationManifest:
    path = os.path.join(gen_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        raise IndexCorrupted(f"no manifest in {gen_dir}")
    with open(path, encoding="utf-8") as f:
        return GenerationManifest.from_json(f.read())


@dataclass(frozen=True)
class VerificationReport:
    ok: bool
    missing: tuple[str, ...] = ()
    corrupted: tuple[str, ...] = ()
    unexpected: tuple[str, ...] = ()


def verify_generation(gen_dir: str, manifest: GenerationManifest) -> VerificationReport:
    """Verify every artifact hash (fail-closed activation precondition)."""
    missing, corrupted = [], []
    expected = set()
    for a in manifest.artifacts:
        expected.add(a.name)
        full = os.path.join(gen_dir, a.name)
        if not os.path.exists(full):
            missing.append(a.name)
        elif sha256_file(full) != a.sha256:
            corrupted.append(a.name)
    unexpected = []
    for dirpath, _, files in os.walk(gen_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), gen_dir)
            if (rel != MANIFEST_FILE and not rel.endswith((".tmp", ".lock"))
                    and rel not in expected):
                unexpected.append(rel)
    return VerificationReport(
        ok=not missing and not corrupted,
        missing=tuple(missing),
        corrupted=tuple(corrupted),
        unexpected=tuple(unexpected),
    )
