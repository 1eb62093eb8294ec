"""Text canonicalization applied before embedding/indexing.

Parity target: reference crates/frankensearch-core/src/canonicalize.rs:1-13 —
document pipeline: NFC normalize -> markdown strip -> code-block collapse
(keep first 20 + last 10 lines) -> whitespace collapse -> low-signal filter
-> truncate to 2000 chars. Queries only get NFC + trim.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass

MAX_DOCUMENT_CHARS = 2000
CODE_BLOCK_HEAD_LINES = 20
CODE_BLOCK_TAIL_LINES = 10

_MD_HEADING = re.compile(r"^#{1,6}\s+", re.MULTILINE)
_MD_EMPHASIS = re.compile(r"(\*\*|__|\*|_|~~)(?=\S)(.+?)(?<=\S)\1", re.DOTALL)
_MD_LINK = re.compile(r"\[([^\]]*)\]\(([^)]*)\)")
_MD_IMAGE = re.compile(r"!\[([^\]]*)\]\(([^)]*)\)")
_MD_INLINE_CODE = re.compile(r"`([^`]*)`")
_MD_BLOCKQUOTE = re.compile(r"^>\s?", re.MULTILINE)
_MD_HR = re.compile(r"^[ \t]*([-*_][ \t]*){3,}$", re.MULTILINE)
_FENCE = re.compile(r"```[^\n]*\n(.*?)```", re.DOTALL)
_WS = re.compile(r"[ \t\f\v]+")
_MANY_NEWLINES = re.compile(r"\n{3,}")


@dataclass(frozen=True)
class CanonicalizeStats:
    original_chars: int
    canonical_chars: int
    truncated: bool
    low_signal: bool


class DefaultCanonicalizer:
    """Document/query canonicalizer with the reference's pipeline shape."""

    def __init__(self, max_chars: int = MAX_DOCUMENT_CHARS) -> None:
        self.max_chars = max_chars

    #: queries beyond this carry no additional retrieval signal (the
    #: lexical arms already truncate at 10k, fts5_adapter
    #: MAX_QUERY_LENGTH); an uncapped query made every arm pay O(len) —
    #: a 6 MB serve query cost 8.7 s of embed/tokenize work (probed)
    MAX_QUERY_CHARS = 10_000

    def canonicalize_query(self, query: str) -> str:
        """Queries: NFC normalize + trim + length cap
        (canonicalize.rs contract; cap matches the lexical arms')."""
        return unicodedata.normalize("NFC", query[: self.MAX_QUERY_CHARS]).strip()

    def canonicalize_document(self, text: str) -> str:
        return self.canonicalize_document_with_stats(text)[0]

    def canonicalize_document_with_stats(self, text: str) -> tuple[str, CanonicalizeStats]:
        original_chars = len(text)
        out = unicodedata.normalize("NFC", text)
        out = _FENCE.sub(lambda m: _collapse_code_block(m.group(1)), out)
        out = _strip_markdown(out)
        out = _collapse_whitespace(out)
        low_signal = _is_low_signal(out)
        if low_signal:
            out = ""
        truncated = len(out) > self.max_chars
        if truncated:
            out = out[: self.max_chars]
        return out, CanonicalizeStats(
            original_chars=original_chars,
            canonical_chars=len(out),
            truncated=truncated,
            low_signal=low_signal,
        )


def _collapse_code_block(body: str) -> str:
    """Keep first 20 + last 10 lines of a fenced code block
    (canonicalize.rs: code-block collapse)."""
    lines = body.splitlines()
    keep = CODE_BLOCK_HEAD_LINES + CODE_BLOCK_TAIL_LINES
    if len(lines) <= keep:
        return body
    head = lines[:CODE_BLOCK_HEAD_LINES]
    tail = lines[-CODE_BLOCK_TAIL_LINES:]
    return "\n".join(head + ["…"] + tail) + "\n"


def _strip_markdown(text: str) -> str:
    out = _MD_IMAGE.sub(r"\1", text)
    out = _MD_LINK.sub(r"\1", out)
    out = _MD_HEADING.sub("", out)
    out = _MD_BLOCKQUOTE.sub("", out)
    out = _MD_HR.sub("", out)
    out = _MD_EMPHASIS.sub(r"\2", out)
    out = _MD_INLINE_CODE.sub(r"\1", out)
    return out


def _collapse_whitespace(text: str) -> str:
    out = _WS.sub(" ", text)
    out = _MANY_NEWLINES.sub("\n\n", out)
    out = "\n".join(line.strip() for line in out.split("\n"))
    return out.strip()


def _is_low_signal(text: str) -> bool:
    """Filter out documents with almost no alphanumeric content."""
    if not text:
        return True
    if len(text) < 3:
        return True
    alnum = sum(1 for c in text if c.isalnum())
    return alnum / len(text) < 0.15
