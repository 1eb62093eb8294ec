"""Fieldnorm (document length) quantization: Lucene SmallFloat byte4.

Parity target: reference crates/frankensearch-quill/src/contract.rs —
the 256-entry FIELD_NORMS_TABLE vendored from Tantivy 0.26.1
(src/fieldnorm/code.rs). Rank-exact BM25 requires identical quantization:
per-document |d| is decoded through this table while avgdl stays the raw
total_tokens / total_docs (averaging decoded buckets is NOT conformant).

Rather than vendoring the 256 numbers, the table is generated from its
definition (Lucene SmallFloat byte4): ids 0..=40 decode exactly; after
that, 8-entry groups whose step doubles each group (2, 4, 8, ...). The
generated table is strictly increasing and ends at 2_013_265_944 —
asserted in tests against the documented endpoints.
"""

from __future__ import annotations

import bisect
from functools import lru_cache


@lru_cache(maxsize=1)
def field_norms_table() -> tuple[int, ...]:
    table = list(range(41))  # 0..=40 exact
    step = 2
    val = 40
    while len(table) < 256:
        for _ in range(8):
            val += step
            table.append(val)
            if len(table) == 256:
                break
        step *= 2
    return tuple(table)


def id_to_fieldnorm(norm_id: int) -> int:
    """Decode a fieldnorm byte to a document length bucket."""
    return field_norms_table()[norm_id & 0xFF]


def fieldnorm_to_id(fieldnorm: int) -> int:
    """Encode a document length to its bucket id (floor semantics:
    largest id whose decoded value <= fieldnorm)."""
    table = field_norms_table()
    if fieldnorm >= table[-1]:
        return 255
    # bisect_right gives first idx with table[idx] > fieldnorm
    return max(bisect.bisect_right(table, fieldnorm) - 1, 0)
