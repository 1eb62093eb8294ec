"""BM25 scoring math, pinned to the Tantivy 0.26.1 contract.

Parity target: reference crates/frankensearch-quill/src/contract.rs
(BM25_K1 = 1.2, BM25_B = 0.75) and src/argus.rs (Bm25FieldSnapshot with
the 256-entry tf_cache per field keyed by fieldnorm id).

Formula (Tantivy/Lucene BM25):

    idf(term)  = ln(1 + (N - n + 0.5) / (n + 0.5))
    norm(id)   = k1 * (1 - b + b * decode(id) / avgdl)     [256-entry cache]
    score      = idf * (k1 + 1) * tf / (tf + norm(id))

All arithmetic in f32 to match the pinned op order (numpy f32 here and in
the device scorer).
"""

from __future__ import annotations

import numpy as np

from frankensearch_tpu_torch.lexical.fieldnorm import field_norms_table

BM25_K1 = np.float32(1.2)
BM25_B = np.float32(0.75)


def idf(doc_count: int, doc_freq: int) -> np.float32:
    n = np.float32(doc_freq)
    big_n = np.float32(doc_count)
    return np.float32(np.log1p((big_n - n + np.float32(0.5)) / (n + np.float32(0.5))))


def tf_norm_cache(avgdl: float) -> np.ndarray:
    """256-entry per-field cache: norm[id] = k1*(1 - b + b*len(id)/avgdl)
    (argus.rs tf_cache)."""
    table = np.asarray(field_norms_table(), dtype=np.float32)
    avg = np.float32(avgdl) if avgdl > 0 else np.float32(1.0)
    return (BM25_K1 * (np.float32(1.0) - BM25_B + BM25_B * table / avg)).astype(np.float32)


def bm25_term_score(
    tf: np.ndarray | np.float32,
    fieldnorm_id: np.ndarray | int,
    idf_value: np.float32,
    norm_cache: np.ndarray,
) -> np.ndarray:
    """Vectorized per-posting score; inputs may be arrays over postings."""
    tf32 = np.asarray(tf, dtype=np.float32)
    norm = norm_cache[np.asarray(fieldnorm_id, dtype=np.int64)]
    weight = idf_value * (BM25_K1 + np.float32(1.0))
    return (weight * tf32 / (tf32 + norm)).astype(np.float32)
