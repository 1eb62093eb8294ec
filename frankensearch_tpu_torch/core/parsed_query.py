"""Negation query syntax: ``-term`` and ``NOT "phrase"``.

Parity target: reference crates/frankensearch-core/src/parsed_query.rs —
splits a raw query into positive terms (what gets embedded / lexically
matched) and negative terms (post-retrieval exclusion filters).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_TOKEN = re.compile(
    r"""
    NOT\s+"(?P<not_phrase>[^"]*)"   # NOT "some phrase"
  | NOT\s+(?P<not_term>\S+)         # NOT term
  | -"(?P<neg_phrase>[^"]*)"        # -"some phrase"
  | (?<!\S)-(?P<neg_term>[^\s"][^\s]*)  # -term (not mid-word hyphen)
  | "(?P<phrase>[^"]*)"             # "positive phrase"
  | (?P<term>\S+)                   # positive term
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class ParsedQuery:
    """Positive/negative split of a query string."""

    positive: str
    positive_terms: tuple[str, ...] = ()
    negative_terms: tuple[str, ...] = ()
    #: boolean/phrase tree (lexical.query.ParsedBooleanQuery) attached by
    #: the searcher when the raw query carries quoted phrases or explicit
    #: AND/OR/NOT syntax; None on plain term bags. Excluded from eq/hash
    #: (a derived view of the same raw string, not identity).
    boolean_query: object | None = field(default=None, compare=False)

    @property
    def has_negations(self) -> bool:
        return bool(self.negative_terms)

    @staticmethod
    def parse(raw: str) -> "ParsedQuery":
        positive_parts: list[str] = []
        negative: list[str] = []
        for m in _TOKEN.finditer(raw):
            if m.group("not_phrase") is not None:
                if m.group("not_phrase"):
                    negative.append(m.group("not_phrase"))
            elif m.group("not_term") is not None:
                negative.append(m.group("not_term"))
            elif m.group("neg_phrase") is not None:
                if m.group("neg_phrase"):
                    negative.append(m.group("neg_phrase"))
            elif m.group("neg_term") is not None:
                negative.append(m.group("neg_term"))
            elif m.group("phrase") is not None:
                if m.group("phrase"):
                    positive_parts.append(m.group("phrase"))
            else:
                positive_parts.append(m.group("term"))
        return ParsedQuery(
            positive=" ".join(positive_parts),
            positive_terms=tuple(positive_parts),
            negative_terms=tuple(t.lower() for t in negative),
        )

    def excludes(self, text: str) -> bool:
        """True if ``text`` matches any negative term (case-insensitive
        substring match, the reference's post-retrieval filter contract)."""
        if not self.negative_terms:
            return False
        lowered = text.lower()
        return any(term in lowered for term in self.negative_terms)


@dataclass
class NegationFilter:
    """Post-retrieval filter over hydrated result text."""

    parsed: ParsedQuery
    dropped: int = 0
    checked: list[str] = field(default_factory=list)

    def admit(self, doc_id: str, text: str | None) -> bool:
        if text is None:
            return True
        if self.parsed.excludes(text):
            self.dropped += 1
            return False
        return True
