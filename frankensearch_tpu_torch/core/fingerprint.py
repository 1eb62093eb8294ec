"""Document fingerprints + semantic-change thresholds for re-embedding.

Parity target: reference crates/frankensearch-core/src/fingerprint.rs —
cheap content fingerprint (hash + length + token stats) and a decision
function for whether a change is big enough to warrant re-embedding
(small edits keep the old vector; the reference's re-embed policy).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class DocumentFingerprint:
    content_hash: str
    length: int
    token_count: int
    head_hash: str  # first 256 chars — catches prepend-heavy edits

    @staticmethod
    def of(text: str) -> "DocumentFingerprint":
        tokens = text.split()
        return DocumentFingerprint(
            content_hash=hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest(),
            length=len(text),
            token_count=len(tokens),
            head_hash=hashlib.blake2b(
                text[:256].encode("utf-8"), digest_size=8
            ).hexdigest(),
        )


@dataclass(frozen=True)
class ReembedPolicy:
    """Decide if a content change warrants re-embedding.

    identical hash -> never; length delta above ``length_change_ratio``
    or head change (prepends move everything) -> always; otherwise a
    token-count drift check.
    """

    length_change_ratio: float = 0.1
    token_change_ratio: float = 0.15

    def should_reembed(
        self, old: DocumentFingerprint, new: DocumentFingerprint
    ) -> bool:
        if old.content_hash == new.content_hash:
            return False
        if old.head_hash != new.head_hash:
            return True
        base_len = max(old.length, 1)
        if abs(new.length - old.length) / base_len > self.length_change_ratio:
            return True
        base_tok = max(old.token_count, 1)
        return abs(new.token_count - old.token_count) / base_tok > self.token_change_ratio
