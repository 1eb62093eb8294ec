"""Heuristic query classification for adaptive retrieval budgets.

Parity target: reference crates/frankensearch-core/src/query_class.rs:47 —
classes Empty / Identifier / ShortKeyword / NaturalLanguage, with per-class
lexical/semantic candidate-budget multipliers.

Behavior contract (validated against the reference's documented heuristics):
- empty/whitespace            -> EMPTY (zero budgets, return empty result)
- single token containing path separators, '.', '::', '_', mixed case that
  isn't one Capitalized word, or a ticket pattern ``prefix-123``; or a
  string starting with "fn " / "struct " / "impl "  -> IDENTIFIER
- otherwise 1-3 words -> SHORT_KEYWORD; 4+ words -> NATURAL_LANGUAGE
"""

from __future__ import annotations

import enum


class QueryClass(enum.Enum):
    EMPTY = "empty"
    IDENTIFIER = "identifier"
    SHORT_KEYWORD = "short_keyword"
    NATURAL_LANGUAGE = "natural_language"

    @staticmethod
    def classify(query: str) -> "QueryClass":
        trimmed = query.strip()
        if not trimmed:
            return QueryClass.EMPTY
        if _looks_like_identifier(trimmed):
            return QueryClass.IDENTIFIER
        word_count = len(trimmed.split()[:4])
        if word_count <= 3:
            return QueryClass.SHORT_KEYWORD
        return QueryClass.NATURAL_LANGUAGE

    def lexical_budget_multiplier(self) -> float:
        """Multiplier applied to TwoTierConfig.candidate_multiplier for the
        lexical arm (query_class.rs:197)."""
        return {
            QueryClass.EMPTY: 0.0,
            QueryClass.IDENTIFIER: 2.0,
            QueryClass.SHORT_KEYWORD: 1.0,
            QueryClass.NATURAL_LANGUAGE: 0.5,
        }[self]

    def semantic_budget_multiplier(self) -> float:
        """Multiplier for the semantic (vector) arm (query_class.rs:208)."""
        return {
            QueryClass.EMPTY: 0.0,
            QueryClass.IDENTIFIER: 0.5,
            QueryClass.SHORT_KEYWORD: 1.0,
            QueryClass.NATURAL_LANGUAGE: 2.0,
        }[self]

    def rrf_k_adjustment(self, base_k: int) -> int:
        """Per-class RRF K: identifiers sharpen rank discrimination (smaller
        K rewards exact lexical top hits); natural language flattens it."""
        if self is QueryClass.IDENTIFIER:
            return max(10, base_k // 2)
        if self is QueryClass.NATURAL_LANGUAGE:
            return base_k
        return base_k


def _looks_like_identifier(s: str) -> bool:
    has_ws = any(c.isspace() for c in s)
    if not has_ws:
        if "/" in s or "\\" in s or "." in s or "::" in s:
            return True
        if "_" in s:
            return True
        # camelCase / PascalCase: mixed case that isn't a single
        # Capitalized word.
        has_lower = False
        has_upper = False
        first_upper = False
        rest_lower = True
        for i, c in enumerate(s):
            is_lower = c.islower()
            is_upper = c.isupper()
            has_lower |= is_lower
            has_upper |= is_upper
            if i == 0:
                first_upper = is_upper
            elif not is_lower:
                rest_lower = False
        if has_lower and has_upper and not (first_upper and rest_lower):
            return True
        # ticket id: prefix-123 where prefix is [alnum_-]+
        prefix, sep, suffix = s.rpartition("-")
        if sep and prefix and suffix and suffix.isascii() and suffix.isdigit():
            if all(c.isascii() and (c.isalnum() or c in "-_") for c in prefix):
                return True
    for code_prefix in ("fn ", "struct ", "impl "):
        if s.startswith(code_prefix):
            return True
    return False
