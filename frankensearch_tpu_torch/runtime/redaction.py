"""Deterministic redaction + retention policy engine.

Parity target: reference crates/frankensearch-fsfs/src/redaction.rs +
privacy.rs — telemetry/evidence payloads pass through a deterministic
redaction policy before leaving the process: configured fields are
dropped or replaced by stable salted digests (so correlation survives,
content doesn't), free text is trimmed to a budget, and retention
classes bound how long records may be kept.
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass, field
from typing import Any, Mapping


class FieldAction(enum.Enum):
    KEEP = "keep"
    DROP = "drop"
    HASH = "hash"  # stable salted digest
    TRUNCATE = "truncate"


class RetentionClass(enum.Enum):
    EPHEMERAL = "ephemeral"  # in-memory only
    SHORT = "short"  # days
    STANDARD = "standard"  # weeks
    AUDIT = "audit"  # long-lived, must be fully redacted


@dataclass(frozen=True)
class RedactionPolicy:
    #: exact field-name rules; unlisted fields follow default_action
    rules: Mapping[str, FieldAction] = field(default_factory=dict)
    default_action: FieldAction = FieldAction.KEEP
    #: fields matching these substrings are always hashed (queries, paths)
    sensitive_markers: tuple[str, ...] = ("query", "path", "content", "text", "preview")
    truncate_chars: int = 64
    salt: str = "fs-tpu"
    retention: RetentionClass = RetentionClass.SHORT

    def action_for(self, key: str) -> FieldAction:
        if key in self.rules:
            return self.rules[key]
        lowered = key.lower()
        if any(m in lowered for m in self.sensitive_markers):
            return FieldAction.HASH
        return self.default_action

    def _digest(self, value: str) -> str:
        return hashlib.blake2b(
            (self.salt + value).encode("utf-8"), digest_size=8
        ).hexdigest()

    def redact(self, payload: Mapping[str, Any]) -> dict[str, Any]:
        """Deterministic: same input + policy -> same output."""
        out: dict[str, Any] = {}
        for key, value in payload.items():
            action = self.action_for(key)
            if action is FieldAction.DROP:
                continue
            if isinstance(value, Mapping):
                out[key] = self.redact(value)
                continue
            if action is FieldAction.HASH and isinstance(value, str):
                out[key] = f"redacted:{self._digest(value)}"
            elif action is FieldAction.TRUNCATE and isinstance(value, str):
                out[key] = value[: self.truncate_chars]
            else:
                out[key] = value
        return out


STRICT_POLICY = RedactionPolicy(
    default_action=FieldAction.HASH,
    rules={
        "kind": FieldAction.KEEP,
        "at": FieldAction.KEEP,
        "correlation_id": FieldAction.KEEP,
        "latency_ms": FieldAction.KEEP,
        "count": FieldAction.KEEP,
    },
    retention=RetentionClass.AUDIT,
)
