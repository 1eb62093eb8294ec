"""Corpus privacy preflight: deterministic dry-run rule matrix.

Parity target: reference docs/fsfs-corpus-privacy-preflight.md
(`bd-pkl0.7`) — prevent sensitive or low-value content from entering
the semantic/vector stores. Before indexing, every document passes a
deterministic rule matrix (credential/token-like content, private keys,
generated artifacts, oversized binaries, sensitive paths, personal
data); each rule carries a stable ``privacy.*`` reason code, a default
include/skip/defer decision, and redacted evidence (a salted digest of
the matched span — never the content). Overrides are honored only for
rules that explicitly opt in.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Iterable

#: content longer than this with no newline is minified/generated
_MINIFIED_LINE_CHARS = 5_000
#: content above this is an oversized blob regardless of looks
_OVERSIZED_CHARS = 2_000_000
#: personal-data density floor: fewer matches than this is incidental
_PERSONAL_MIN_HITS = 3

_RE_PRIVATE_KEY = re.compile(r"-----BEGIN [A-Z ]*PRIVATE KEY-----")
_RE_CREDENTIAL = re.compile(
    r"AKIA[0-9A-Z]{16}"  # AWS access key id
    r"|ghp_[A-Za-z0-9]{36}"  # GitHub PAT
    r"|xox[bap]-[A-Za-z0-9-]{10,}"  # Slack tokens
    r"|(?i:(?:api[_-]?key|secret|token|passwd|password)\s*[:=]\s*['\"]?[A-Za-z0-9+/_\-]{12,})"
)
_RE_EMAIL = re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]{2,}\b")
_RE_SSN = re.compile(r"\b\d{3}-\d{2}-\d{4}\b")
_RE_GENERATED = re.compile(r"@generated\b|DO NOT EDIT", re.IGNORECASE)

_SENSITIVE_PATH_PARTS = {
    ".ssh", ".aws", ".gnupg", ".kube", ".netrc", ".env", "id_rsa",
    "id_ed25519", "credentials", "secrets",
}
_GENERATED_BASENAMES = {
    "package-lock.json", "yarn.lock", "cargo.lock", "poetry.lock",
    "pnpm-lock.yaml", "composer.lock",
}


@dataclass(frozen=True)
class Finding:
    doc_id: str
    reason_code: str  # privacy.credential | .private_key | .generated | ...
    decision: str  # skip | defer
    overridable: bool
    evidence_digest: str  # salted digest of the matched span, never content

    def to_dict(self) -> dict:
        return {
            "doc_id": self.doc_id,
            "reason_code": self.reason_code,
            "decision": self.decision,
            "overridable": self.overridable,
            "evidence_digest": self.evidence_digest,
        }


@dataclass
class PreflightReport:
    scanned: int = 0
    included: int = 0
    findings: list[Finding] = field(default_factory=list)

    def decisions(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.decision] = out.get(f.decision, 0) + 1
        return out

    def by_reason(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.reason_code] = out.get(f.reason_code, 0) + 1
        return out

    def excluded_ids(self, overrides: frozenset[str] = frozenset()) -> set[str]:
        """Doc ids a privacy-enforcing build must not index: every skip,
        plus defers whose rule was NOT overridden."""
        out = set()
        for f in self.findings:
            if f.overridable and f.reason_code in overrides:
                continue
            out.add(f.doc_id)
        return out

    def to_dict(self) -> dict:
        return {
            "v": 1,
            "dry_run": True,
            "scanned": self.scanned,
            "included": self.included,
            "decisions": self.decisions(),
            "by_reason": self.by_reason(),
            "findings": [f.to_dict() for f in self.findings],
        }


def _digest(span: str) -> str:
    return "sha256:" + hashlib.sha256(b"fs-preflight|" + span.encode("utf-8", "ignore")).hexdigest()[:16]


def evaluate(doc_id: str, content: str) -> Finding | None:
    """First matching rule wins, ordered by severity. Returns None when
    the document is clean (include)."""
    m = _RE_PRIVATE_KEY.search(content)
    if m:
        return Finding(doc_id, "privacy.private_key", "skip", False, _digest(m.group(0)))
    m = _RE_CREDENTIAL.search(content)
    if m:
        return Finding(doc_id, "privacy.credential", "skip", False, _digest(m.group(0)))
    parts = set(re.split(r"[\\/]", doc_id.lower()))
    hit = parts & _SENSITIVE_PATH_PARTS
    if hit:
        return Finding(doc_id, "privacy.sensitive_path", "skip", False,
                       _digest(sorted(hit)[0]))
    if "\x00" in content or len(content) > _OVERSIZED_CHARS:
        return Finding(doc_id, "privacy.oversized_binary", "skip", False,
                       _digest(f"len={len(content)}"))
    base = doc_id.rsplit("/", 1)[-1].lower()
    if (base in _GENERATED_BASENAMES or _RE_GENERATED.search(content[:2000])
            or ("\n" not in content and len(content) > _MINIFIED_LINE_CHARS)):
        return Finding(doc_id, "privacy.generated", "defer", True, _digest(base))
    personal = len(_RE_EMAIL.findall(content)) + len(_RE_SSN.findall(content))
    if personal >= _PERSONAL_MIN_HITS:
        return Finding(doc_id, "privacy.personal", "defer", True,
                       _digest(f"hits={personal}"))
    return None


def preflight(docs: Iterable) -> PreflightReport:
    """docs: iterable of IndexableDocument (doc_id + content)."""
    rep = PreflightReport()
    for d in docs:
        rep.scanned += 1
        f = evaluate(d.doc_id, d.content or "")
        if f is None:
            rep.included += 1
        else:
            rep.findings.append(f)
    return rep
