"""EmbedderStack: fast + optional quality embedder with auto-detection.

Parity target: reference crates/frankensearch-embed/src/auto_detect.rs
(:110, :249, :304) — ``EmbedderStack`` pairs a fast embedder with an
optional quality embedder; ``auto_detect_with`` probes model directories
and degrades to the hash embedder with a typed availability report
(hash-built generations are permanently non-semantic,
frankensearch/src/index_builder.rs:311-323).

A model directory is skipped with a warning when loading it raises what a
malformed directory or a missing loader library raises on the host
(``OSError``, ``ValueError``, ``KeyError``, ``ImportError``, a typed
``SearchError``); any other fault (a CUDA out-of-memory while the table
goes onto the card) propagates, so a root is never built on another
embedder than the one found.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from frankensearch_tpu_torch.core.errors import SearchError
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder
from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder


@dataclass(frozen=True)
class TwoTierAvailability:
    """Typed degradation report (auto_detect.rs TwoTierAvailability)."""

    fast_available: bool
    quality_available: bool
    fast_source: str  # "model2vec" | "hash"
    quality_source: str | None  # "minilm" | None
    warnings: tuple[str, ...] = ()

    @property
    def is_semantic(self) -> bool:
        return self.fast_source != "hash"


@dataclass
class EmbedderStack:
    fast: Embedder
    quality: Embedder | None = None
    availability: TwoTierAvailability = field(
        default_factory=lambda: TwoTierAvailability(True, False, "hash", None)
    )

    @property
    def has_quality(self) -> bool:
        return self.quality is not None

    @classmethod
    def auto_detect(
        cls,
        data_dir: str | None = None,
        *,
        device,
        fast_dim: int = 256,
        allow_quality: bool = True,
    ) -> "EmbedderStack":
        """Probe ``data_dir`` for model layouts; degrade to HashEmbedder.

        Layout probed (mirrors the reference's model registry dirs):
            <data_dir>/models/<name>/tokenizer.json + model.safetensors
        A directory whose name contains "potion" or "m2v"/"model2vec"
        becomes the fast tier; one containing "minilm"/"quality" becomes
        the quality tier (loaded lazily by the rerank layer's encoder).
        Both models load onto ``device`` (a :class:`torch.device`).
        """
        warnings: list[str] = []
        fast: Embedder | None = None
        quality: Embedder | None = None
        fast_source = "hash"
        quality_source: str | None = None

        models_root = os.path.join(data_dir, "models") if data_dir else None
        if models_root and os.path.isdir(models_root):
            for name in sorted(os.listdir(models_root)):
                d = os.path.join(models_root, name)
                if not os.path.isdir(d):
                    continue
                lowered = name.lower()
                try:
                    if fast is None and any(
                        tag in lowered for tag in ("potion", "m2v", "model2vec")
                    ):
                        fast = Model2VecEmbedder.from_dir(d, device=device)
                        fast_source = "model2vec"
                    elif (
                        allow_quality
                        and quality is None
                        and any(tag in lowered for tag in ("minilm", "quality", "bert"))
                    ):
                        from frankensearch_tpu_torch.rerank.encoder import (
                            load_encoder_embedder,
                        )

                        quality = load_encoder_embedder(d, device=device)
                        quality_source = "minilm"
                except (OSError, ValueError, KeyError, ImportError, SearchError) as e:
                    # a malformed model directory or a missing loader,
                    # found on the host; a device fault propagates
                    warnings.append(f"model dir {name}: {type(e).__name__}: {e}")

        if fast is None:
            fast = HashEmbedder(dim=fast_dim)
            warnings.append(
                "no fast model found; degraded to hash embedder "
                "(non-semantic: results will never be admitted as semantic)"
            )
        availability = TwoTierAvailability(
            fast_available=True,
            quality_available=quality is not None,
            fast_source=fast_source,
            quality_source=quality_source,
            warnings=tuple(warnings),
        )
        return cls(fast=fast, quality=quality, availability=availability)
