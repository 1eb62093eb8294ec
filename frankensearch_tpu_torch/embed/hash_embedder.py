"""Hash embedder: FNV-1a token hashing + xorshift JL projection.

Parity target: reference crates/frankensearch-embed/src/hash_embedder.rs
(:1-70, :202-245) — the always-available dependency-free fallback and CI
test double. Explicitly NOT semantic (``is_semantic() == False``); never
admitted as a semantic result downstream.

Two modes, as in the reference:
- ``bow``: signed feature hashing — token -> FNV-1a -> (bucket, sign).
- ``jl`` (default): per-token Johnson–Lindenstrauss-style pseudo-random
  ±1 row generated by xorshift64* seeded from the token hash; rows are
  accumulated with sqrt(tf) weighting and the sum is L2-normalized.

Deterministic across platforms/runs (pure integer arithmetic).
"""

from __future__ import annotations

import re
from itertools import chain
from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.embed.base import Embedder, l2_normalize_rows

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def fnv1a_64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def _xorshift64star(seed: int, n: int) -> np.ndarray:
    """n pseudo-random u64s from xorshift64*; vectorized via precomputed
    state chain (state updates are sequential, output mix is elementwise)."""
    out = np.empty(n, dtype=np.uint64)
    x = seed & _MASK64 or 0x9E3779B97F4A7C15
    for i in range(n):
        x ^= (x >> 12) & _MASK64
        x = (x ^ (x << 25)) & _MASK64
        x ^= (x >> 27) & _MASK64
        out[i] = (x * 0x2545F4914F6CDD1D) & _MASK64
    return out


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def _counts(tokens: list[str]) -> dict[str, int]:
    """Each token's count, in the order of its first appearance."""
    counts: dict[str, int] = {}
    for t in tokens:
        counts[t] = counts.get(t, 0) + 1
    return counts


class HashEmbedder(Embedder):
    """Deterministic non-semantic embedding (256d default, as the
    reference's alt config; 384d available)."""

    def __init__(self, dim: int = 256, mode: str = "jl") -> None:
        if mode not in ("jl", "bow"):
            raise ValueError(f"unknown HashEmbedder mode {mode!r}")
        self._dim = dim
        self.mode = mode
        self._token_cache: dict[str, np.ndarray] = {}

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def embedder_id(self) -> str:
        return f"hash-{self.mode}-{self._dim}"

    @property
    def revision(self) -> str:
        return "1"

    @property
    def is_semantic(self) -> bool:
        return False

    def _token_row(self, token: str) -> np.ndarray:
        row = self._token_cache.get(token)
        if row is not None:
            return row
        h = fnv1a_64(token.encode("utf-8"))
        if self.mode == "bow":
            row = np.zeros(self._dim, dtype=np.float32)
            bucket = h % self._dim
            sign = 1.0 if (h >> 63) & 1 else -1.0
            row[bucket] = sign
        else:
            bits = _xorshift64star(h, (self._dim + 63) // 64)
            unpacked = np.unpackbits(bits.view(np.uint8))[: self._dim]
            row = (unpacked.astype(np.float32) * 2.0 - 1.0) / np.sqrt(self._dim)
        if len(self._token_cache) < 65536:
            self._token_cache[token] = row
        return row

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Each text's rows ``row(token) * sqrt(tf)`` summed in the order
        of the tokens' first appearance, then L2-normalized. The sums run
        as one vector add per token position across the batch's texts
        (longest first), each add the same rounding as a per-text loop's
        ``acc += row * sqrt(tf)``."""
        n = len(texts)
        counts = [_counts(tokenize(text)) for text in texts]
        lens = np.fromiter(map(len, counts), dtype=np.int64, count=n)
        flat_tok = list(chain.from_iterable(counts))
        flat_tf = np.fromiter(chain.from_iterable(c.values() for c in counts), dtype=np.int64,
                              count=len(flat_tok))
        slot = {tok: j for j, tok in enumerate(dict.fromkeys(flat_tok))}  # token -> row of the table
        flat_slot = np.fromiter(map(slot.__getitem__, flat_tok), dtype=np.int64, count=len(flat_tok))
        table = np.stack([self._token_row(tok) for tok in slot]) if slot else np.zeros((0, self._dim))
        # the dtype of ``row * np.sqrt(float(tf))``: the row's under numpy
        # 1's value-based casting, f64 under numpy 2's
        product = (table[:1] * np.sqrt(1.0)).dtype
        table = table.astype(product, copy=False)
        scale = np.sqrt(flat_tf.astype(np.float64)).astype(product)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if n else lens
        order = np.argsort(-lens, kind="stable")
        sorted_lens, sorted_starts = lens[order], starts[order]
        acc = np.zeros((n, self._dim), dtype=np.float32)
        for t in range(int(sorted_lens[0]) if n else 0):
            m = int(np.searchsorted(-sorted_lens, -t, side="left"))  # texts with more than t tokens
            at = sorted_starts[:m] + t
            np.add(acc[:m], table[flat_slot[at]] * scale[at, None], out=acc[:m], casting="same_kind")
        out = np.empty_like(acc)
        out[order] = acc
        return l2_normalize_rows(out)
