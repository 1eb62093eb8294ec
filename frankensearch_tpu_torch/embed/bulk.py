"""Bulk corpus embedding via the native tokenizer — the ingest fast lane
(PyTorch).

Port of frankensearch_tpu/embed/bulk.py. Static-embedding mean pooling is
order-invariant — ``mean(emb[tok] for tok in doc) == sum(tf_t * emb[t]) /
sum(tf_t)`` — so corpus embedding has the shape of device BM25: the native
C++ tokenizer accumulates flat postings (term, doc, tf), one vocabulary
remap follows, and the device sums tf-weighted embedding rows per doc.

The per-doc sum is deterministic: the reference's ``segment_sum`` would
become a float ``index_add_``, whose atomics add in another order on every
run on CUDA. Instead the postings are sorted by doc (stably, so each doc
keeps its terms in posting order) and summed by a doc-major slot loop,
``lexical/device_bm25.build_doc_steps``' plan: step j adds the j-th
posting of every doc that has one. A doc's sum is then the same sequence
of f32 adds as the reference's CPU scatter, on any device.

Scope: word-level tokenizers (``SimpleWordTokenizer`` vocabularies). Docs
longer than the embedder's ``max_tokens`` differ from the padded path only
in that the bag uses ALL tokens (no truncation).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.embed.model2vec import (
    Model2VecEmbedder,
    SimpleWordTokenizer,
    normalize_rows,
)
from frankensearch_tpu_torch.lexical.device_bm25 import build_doc_steps


def _bag_pool(
    emb: torch.Tensor,
    term_ids: np.ndarray,
    doc_ids: np.ndarray,
    tf: np.ndarray,
    *,
    n_docs: int,
) -> torch.Tensor:
    """(n_docs, D) f32 unit rows: per doc, the tf-weighted sum of its terms'
    rows over the sum of its tf, normalized. Docs without postings stay
    zero."""
    device = emb.device
    steps = build_doc_steps(doc_ids, tf, n_docs, device)
    term_t = torch.from_numpy(np.ascontiguousarray(term_ids, dtype=np.int64)).to(device)
    tf_t = torch.from_numpy(np.ascontiguousarray(tf, dtype=np.float32)).to(device)
    acc = torch.zeros((n_docs, emb.shape[1]), dtype=torch.float32, device=device)
    count = torch.zeros((n_docs, 1), dtype=torch.float32, device=device)
    for j in range(len(steps.bounds) - 1):
        p = steps.posts[steps.bounds[j] : steps.bounds[j + 1]]
        w = tf_t[p, None]
        acc[: p.shape[0]] += emb[term_t[p]].to(torch.float32) * w
        count[: p.shape[0]] += w
    pooled = torch.empty_like(acc)
    pooled[steps.doc_of_slot] = acc / torch.clamp(count, min=1.0)
    return normalize_rows(pooled)


def bag_embed_corpus(
    embedder: Model2VecEmbedder,
    texts: Sequence[str],
    *,
    chunk_docs: int = 16_384,
    wire_dtype: str = "f32",
) -> np.ndarray | None:
    """Embed a corpus through the native bag-of-words lane on the
    embedder's device, ``chunk_docs`` docs per pass.

    Returns None when the lane does not apply (non-word tokenizer, no
    native kernel) — the caller falls back to ``embed_batch``. Rows with
    zero in-vocabulary tokens come back as zero vectors, matching
    ``embed_batch``. ``wire_dtype="bf16"`` rounds the rows to bf16 before
    they leave the device (half the transfer; a bf16 slab rounds them so
    anyway)."""
    tok = embedder._tokenizer
    if not isinstance(tok, SimpleWordTokenizer):
        return None
    from frankensearch_tpu_torch import native

    texts = list(texts)
    if not texts:
        return np.zeros((0, embedder.dim), dtype=np.float32)

    out = np.zeros((len(texts), embedder.dim), dtype=np.float32)
    vocab_get = tok.vocab.get
    unk = tok.unk_id if tok.unk_id is not None else -1
    for start in range(0, len(texts), chunk_docs):
        chunk = texts[start : start + chunk_docs]
        if tok.lowercase:
            chunk = [t.lower() for t in chunk]
        bp = native.build_postings_native(chunk)
        if bp is None:
            return None
        # one vocabulary remap per unique term in the chunk
        term_vocab = np.fromiter(
            (vocab_get(t, unk) for t in bp.terms), dtype=np.int64, count=len(bp.terms)
        )
        vids = term_vocab[bp.post_term]
        keep = vids >= 0
        pooled = _bag_pool(
            embedder._emb, vids[keep], bp.post_doc[keep].astype(np.int64),
            bp.post_tf[keep].astype(np.float32), n_docs=len(chunk),
        )
        if wire_dtype == "bf16":
            pooled = pooled.to(torch.bfloat16)
        out[start : start + len(chunk)] = pooled.cpu().to(torch.float32).numpy()
    return out


def embed_corpus(
    embedder, texts: Sequence[str], *, batch: int = 2048, wire_dtype: str = "f32"
) -> np.ndarray:
    """Fastest valid corpus-embed lane: native bag-of-words when the
    embedder and corpus qualify, else chunked ``embed_batch``.
    ``wire_dtype`` as in :func:`bag_embed_corpus`."""
    if isinstance(embedder, Model2VecEmbedder):
        via_bag = bag_embed_corpus(embedder, texts, wire_dtype=wire_dtype)
        if via_bag is not None:
            return via_bag
    return embed_batches(embedder, texts, batch=batch)


def embed_batches(embedder, texts: Sequence[str], *, batch: int = 2048) -> np.ndarray:
    """``embed_batch`` over ``batch``-text chunks, concatenated."""
    texts = list(texts)
    if not texts:
        return np.zeros((0, embedder.dim), dtype=np.float32)
    parts = [embedder.embed_batch(texts[s : s + batch]) for s in range(0, len(texts), batch)]
    return np.concatenate(parts, axis=0)
