"""Lexical tokenizers.

Parity target: reference crates/frankensearch-quill/src/scribe.rs —
``FrankensearchTokenizer`` = Tantivy SimpleTokenizer (alphanumeric runs)
+ LowerCaser, with a 40-char token truncation guard; ``CassAnalyzer``
adds hyphen splitting + CJK handling (cass compat lane, not ported).
"""

from __future__ import annotations

import re

MAX_TOKEN_LEN = 40
_ALNUM_RUN = re.compile(r"[^\W_]+")


def simple_tokenize(text: str) -> list[str]:
    """Alphanumeric-run tokenizer + lowercase (Tantivy SimpleTokenizer +
    LowerCaser semantics: a token is a maximal run of unicode alphanumeric
    chars; tokens longer than 40 chars are dropped, as Tantivy's
    RemoveLongFilter(40) default in the reference schema). ``[^\\W_]``
    is exactly ``str.isalnum``: a word character other than ``_``."""
    return [t.lower() for t in _ALNUM_RUN.findall(text) if len(t) <= MAX_TOKEN_LEN]
