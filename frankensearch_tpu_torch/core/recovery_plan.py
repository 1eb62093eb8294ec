"""Typed semantic-readiness planner.

Parity target: reference crates/frankensearch-core/src/recovery_plan.rs —
``RecoveryPlan``: maps (model state, index state, requested mode) to a
truthful next action instead of serving silently-degraded results, plus
the model-acquisition authorization schema (downloads require explicit
consent).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class SearchMode(enum.Enum):
    FULL = "full"  # lexical + fast + quality
    FAST_ONLY = "fast_only"  # lexical + fast
    LEXICAL_ONLY = "lexical_only"


class ModelState(enum.Enum):
    PRESENT_VERIFIED = "present_verified"
    PRESENT_UNVERIFIED = "present_unverified"
    MISSING = "missing"
    CORRUPT = "corrupt"


class IndexState(enum.Enum):
    READY_SEMANTIC = "ready_semantic"
    READY_NON_SEMANTIC = "ready_non_semantic"  # hash-built generation
    MISSING = "missing"
    CORRUPT = "corrupt"
    IDENTITY_MISMATCH = "identity_mismatch"


class NextAction(enum.Enum):
    SERVE = "serve"
    SERVE_DEGRADED = "serve_degraded"  # with explicit mode downgrade
    VERIFY_MODEL = "verify_model"
    ACQUIRE_MODEL = "acquire_model"  # requires authorization
    REBUILD_INDEX = "rebuild_index"
    REPAIR_INDEX = "repair_index"
    REFUSE = "refuse"


@dataclass(frozen=True)
class ModelAcquisitionAuthorization:
    """Explicit consent record for acquiring model artifacts
    (recovery_plan.rs authorization schema; downloads never implicit)."""

    model_id: str
    revision: str
    authorized_by: str
    reason: str = ""


@dataclass(frozen=True)
class RecoveryPlan:
    requested_mode: SearchMode
    effective_mode: SearchMode | None
    action: NextAction
    reasons: tuple[str, ...] = ()
    requires_authorization: bool = False

    @property
    def can_serve(self) -> bool:
        return self.action in (NextAction.SERVE, NextAction.SERVE_DEGRADED)

    def to_dict(self) -> dict:
        """Wire form (schemas/recovery-plan-v1.schema.json)."""
        return {
            "v": 1,
            "requested_mode": self.requested_mode.value,
            "effective_mode": self.effective_mode.value if self.effective_mode else None,
            "action": self.action.value,
            "reasons": list(self.reasons),
            "requires_authorization": self.requires_authorization,
            "can_serve": self.can_serve,
        }


def plan_recovery(
    requested: SearchMode,
    *,
    fast_model: ModelState,
    quality_model: ModelState,
    index: IndexState,
    lexical_available: bool = True,
    authorization: ModelAcquisitionAuthorization | None = None,
) -> RecoveryPlan:
    """Truthful next-action mapping (the README:557-563 mode contract:
    FULL/FAST_ONLY require an admitted semantic generation + a real fast
    embedder before Initial; LEXICAL_ONLY bypasses)."""
    reasons: list[str] = []

    if index is IndexState.CORRUPT:
        return RecoveryPlan(requested, None, NextAction.REPAIR_INDEX,
                            ("index artifacts failed verification",))
    if index is IndexState.MISSING:
        return RecoveryPlan(requested, None, NextAction.REBUILD_INDEX,
                            ("no index generation present",))

    if requested is SearchMode.LEXICAL_ONLY:
        if lexical_available:
            return RecoveryPlan(requested, SearchMode.LEXICAL_ONLY, NextAction.SERVE)
        return RecoveryPlan(requested, None, NextAction.REBUILD_INDEX,
                            ("lexical arm unavailable",))

    # semantic modes require identity-admitted semantic generation
    if index is IndexState.IDENTITY_MISMATCH:
        reasons.append("index embedder identity does not match available model")
        if lexical_available:
            return RecoveryPlan(requested, SearchMode.LEXICAL_ONLY,
                                NextAction.SERVE_DEGRADED, tuple(reasons))
        return RecoveryPlan(requested, None, NextAction.REBUILD_INDEX, tuple(reasons))
    if index is IndexState.READY_NON_SEMANTIC:
        reasons.append("generation was built with a non-semantic (hash) embedder")
        if lexical_available:
            return RecoveryPlan(requested, SearchMode.LEXICAL_ONLY,
                                NextAction.SERVE_DEGRADED, tuple(reasons))
        return RecoveryPlan(requested, None, NextAction.REBUILD_INDEX, tuple(reasons))

    if fast_model is ModelState.CORRUPT:
        return RecoveryPlan(requested, None, NextAction.VERIFY_MODEL,
                            ("fast model failed verification",))
    if fast_model is ModelState.PRESENT_UNVERIFIED:
        return RecoveryPlan(requested, None, NextAction.VERIFY_MODEL,
                            ("fast model present but unverified",))
    if fast_model is ModelState.MISSING:
        authorized = authorization is not None
        return RecoveryPlan(
            requested,
            SearchMode.LEXICAL_ONLY if lexical_available else None,
            NextAction.ACQUIRE_MODEL if authorized else NextAction.REFUSE,
            ("fast model missing" + ("" if authorized else "; acquisition not authorized"),),
            requires_authorization=not authorized,
        )

    if requested is SearchMode.FULL:
        if quality_model is ModelState.PRESENT_VERIFIED:
            return RecoveryPlan(requested, SearchMode.FULL, NextAction.SERVE)
        reasons.append(f"quality model {quality_model.value}")
        return RecoveryPlan(requested, SearchMode.FAST_ONLY,
                            NextAction.SERVE_DEGRADED, tuple(reasons))
    return RecoveryPlan(requested, SearchMode.FAST_ONLY, NextAction.SERVE)
