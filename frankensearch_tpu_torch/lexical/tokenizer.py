"""Lexical tokenizers.

Parity target: reference crates/frankensearch-quill/src/scribe.rs —
``FrankensearchTokenizer`` = Tantivy SimpleTokenizer (alphanumeric runs)
+ LowerCaser, with a 40-char token truncation guard; ``CassAnalyzer``
adds hyphen splitting + CJK handling (cass compat lane, not ported).
"""

from __future__ import annotations

MAX_TOKEN_LEN = 40


def simple_tokenize(text: str) -> list[str]:
    """Alphanumeric-run tokenizer + lowercase (Tantivy SimpleTokenizer +
    LowerCaser semantics: a token is a maximal run of unicode alphanumeric
    chars; tokens longer than 40 chars are dropped, as Tantivy's
    RemoveLongFilter(40) default in the reference schema)."""
    tokens: list[str] = []
    start = -1
    for i, c in enumerate(text):
        if c.isalnum():
            if start < 0:
                start = i
        else:
            if start >= 0:
                tok = text[start:i]
                if len(tok) <= MAX_TOKEN_LEN:
                    tokens.append(tok.lower())
                start = -1
    if start >= 0:
        tok = text[start:]
        if len(tok) <= MAX_TOKEN_LEN:
            tokens.append(tok.lower())
    return tokens
