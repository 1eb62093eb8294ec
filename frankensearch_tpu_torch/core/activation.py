"""Generation activation: verify -> invariants -> atomic pointer swap.

Parity target: reference crates/frankensearch-core/src/activation.rs —
``GenerationController``: verify artifacts against the manifest, check
activation invariants (anti-rollback commit-seq floor, required
embedder identities), atomically swap the generation pointer, support
rollback to any retained generation that still satisfies the floor.
"""

from __future__ import annotations

from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

import os
from dataclasses import dataclass, field

from frankensearch_tpu_torch.core.generation import (
    GenerationManifest,
    read_manifest,
    verify_generation,
)

CURRENT_POINTER = "CURRENT_GENERATION"
FLOOR_FILE = "COMMIT_FLOOR"


@dataclass(frozen=True)
class ActivationInvariants:
    """Preconditions for activation (generation.rs activation invariants)."""

    min_commit_seq: int = 0
    required_fast_embedder: str | None = None
    required_quality_embedder: str | None = None
    require_semantic: bool = False

    def check(self, manifest: GenerationManifest) -> list[str]:
        violations = []
        if manifest.commit_seq < self.min_commit_seq:
            violations.append(
                f"anti-rollback: commit_seq {manifest.commit_seq} < floor {self.min_commit_seq}"
            )
        fast = manifest.embedders.get("fast", {})
        if self.required_fast_embedder and fast.get("embedder_id") != self.required_fast_embedder:
            violations.append(
                f"fast embedder {fast.get('embedder_id')!r} != required {self.required_fast_embedder!r}"
            )
        quality = manifest.embedders.get("quality", {})
        if (
            self.required_quality_embedder
            and quality.get("embedder_id") != self.required_quality_embedder
        ):
            violations.append(
                f"quality embedder {quality.get('embedder_id')!r} != required "
                f"{self.required_quality_embedder!r}"
            )
        if self.require_semantic and not fast.get("is_semantic", False):
            violations.append("generation is non-semantic but semantic is required")
        return violations


@dataclass
class ActivationResult:
    activated: bool
    generation_id: str
    violations: list[str] = field(default_factory=list)
    verification_ok: bool = True


class GenerationController:
    """Manages <root>/generations/<gen-id>/ directories + CURRENT pointer."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(os.path.join(root, "generations"), exist_ok=True)

    def generation_dir(self, generation_id: str) -> str:
        return os.path.join(self.root, "generations", generation_id)

    # -- pointer ------------------------------------------------------------

    def current_generation(self) -> str | None:
        path = os.path.join(self.root, CURRENT_POINTER)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read().strip() or None

    def _swap_pointer(self, generation_id: str) -> None:
        path = os.path.join(self.root, CURRENT_POINTER)
        atomic_write_text(path, generation_id)

    # -- anti-rollback floor -----------------------------------------------------

    def commit_floor(self) -> int:
        path = os.path.join(self.root, FLOOR_FILE)
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return int(f.read().strip() or 0)

    def _raise_floor(self, seq: int) -> None:
        if seq <= self.commit_floor():
            return
        path = os.path.join(self.root, FLOOR_FILE)
        atomic_write_text(path, str(seq))

    # -- activation -------------------------------------------------------------

    def activate(
        self,
        generation_id: str,
        invariants: ActivationInvariants | None = None,
        *,
        verify: bool = True,
    ) -> ActivationResult:
        gen_dir = self.generation_dir(generation_id)
        manifest = read_manifest(gen_dir)
        inv = invariants or ActivationInvariants(min_commit_seq=self.commit_floor())
        # always enforce the persisted floor even with custom invariants
        floor = max(inv.min_commit_seq, self.commit_floor())
        inv = ActivationInvariants(
            min_commit_seq=floor,
            required_fast_embedder=inv.required_fast_embedder,
            required_quality_embedder=inv.required_quality_embedder,
            require_semantic=inv.require_semantic,
        )
        violations = inv.check(manifest)
        if violations:
            return ActivationResult(
                activated=False, generation_id=generation_id, violations=violations
            )
        if verify:
            report = verify_generation(gen_dir, manifest)
            if not report.ok:
                return ActivationResult(
                    activated=False,
                    generation_id=generation_id,
                    violations=[
                        f"verification failed: missing={list(report.missing)} "
                        f"corrupted={list(report.corrupted)}"
                    ],
                    verification_ok=False,
                )
        self._swap_pointer(generation_id)
        self._raise_floor(manifest.commit_seq)
        return ActivationResult(activated=True, generation_id=generation_id)

    def rollback(self, generation_id: str) -> ActivationResult:
        """Roll back to a retained generation. The anti-rollback floor still
        applies: a generation below the floor can never be re-activated
        (generation.rs anti-rollback contract)."""
        return self.activate(generation_id)

    def list_generations(self) -> list[str]:
        gens = os.path.join(self.root, "generations")
        return sorted(
            g for g in os.listdir(gens) if os.path.isdir(os.path.join(gens, g))
        )
