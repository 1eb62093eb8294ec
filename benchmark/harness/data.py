"""The inputs of a run, made from its seed: doc vectors, the static
embedding table and queries.

Both sides take their inputs from here: the system under test gets them
in the form it serves them (a padded bf16 slab, a table, texts), and the
reference makes them again after the window from the same seed. Every
draw runs in fixed-size calls in a fixed order, so one seed gives the same
bits on every run.

Words are ``w`` and six digits (``w000000`` is the commonest), so every
word is one token for the embedder's word tokenizer (and for an
alphanumeric one), and a text of ``n`` words is ``8 n - 1``
characters long.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: rows drawn per call: the draw of a row depends on this, so it is fixed
CHUNK_ROWS = 1 << 20
WORD_CHARS = 7  # "w" + six digits


def sub_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed and the
    stream's name (any whole number, negative or past 64 bits included)."""
    words = [seed % (1 << 64), seed // (1 << 64) % (1 << 64)]
    for tag in tags:
        words.extend(tag.encode())
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def unit_rows(seed: int, tag: str, n: int, dim: int, device, dtype=torch.bfloat16):
    """Yield (first row, rows) for ``n`` seeded unit rows of width ``dim``,
    drawn on ``device`` in f32 (``CHUNK_ROWS`` at a time), normalized in
    f32 and cast to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    for r0 in range(0, n, CHUNK_ROWS):
        x = torch.randn((min(CHUNK_ROWS, n - r0), dim), generator=gen, device=device, dtype=torch.float32)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        yield r0, x.to(dtype)


def word(i: int) -> str:
    return f"w{i:06d}"


def vocabulary(n: int) -> list[str]:
    return [word(i) for i in range(n)]


def doc_id(i: int) -> str:
    return f"d{i:07d}"


def doc_ids(n: int) -> list[str]:
    return [f"d{i:07d}" for i in range(n)]


def row_of_doc(doc: str) -> int:
    return int(doc[1:])


class ZipfWords:
    """Word ranks 0..n-1 drawn with P(rank r) proportional to (r + 1)^-s,
    by the inverse of the cumulative distribution."""

    def __init__(self, exponent: float, n: int) -> None:
        w = np.arange(1, n + 1, dtype=np.float64) ** -float(exponent)
        self.cdf = np.cumsum(w) / w.sum()
        self.n = n

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random(size), side="right")
        return np.minimum(idx, self.n - 1).astype(np.int32)


@dataclass
class Texts:
    """Ragged word-id lists: ``words[offsets[i]:offsets[i + 1]]`` is text i."""

    words: np.ndarray  # int32
    offsets: np.ndarray  # int64, len n + 1

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def ids(self, i: int) -> np.ndarray:
        return self.words[self.offsets[i] : self.offsets[i + 1]]

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def strings(self) -> list[str]:
        """Each text as space-separated words, built from one decoded
        buffer of fixed-width words."""
        w = self.words.astype(np.int64)
        cells = np.empty((len(w), WORD_CHARS + 1), dtype=np.uint8)
        cells[:, 0] = ord("w")
        for p in range(6):
            cells[:, 6 - p] = ord("0") + (w // 10**p) % 10
        cells[:, WORD_CHARS] = ord(" ")
        big = cells.tobytes().decode("ascii")
        step = WORD_CHARS + 1
        off = self.offsets
        return [big[step * off[i] : step * off[i + 1] - 1] for i in range(len(off) - 1)]


def texts_of_lengths(rng: np.random.Generator, lengths: np.ndarray, zipf: ZipfWords) -> Texts:
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Texts(zipf.draw(rng, int(offsets[-1])), offsets)


def poisson_lengths(rng: np.random.Generator, mean_words: float, n: int) -> np.ndarray:
    """1 + Poisson(mean_words - 1) words each: at least one, ``mean_words``
    on average."""
    return 1 + rng.poisson(float(mean_words) - 1.0, size=n)


def queries(seed: int, stream: str, spec: dict, n: int) -> Texts:
    """``n`` queries of 1 + Poisson(``mean_words`` - 1) words, zipf(``zipf``)
    over the first ``vocab`` words. The multiset of lengths is the same for
    every seed (drawn from the stream's name alone) and the seed orders it,
    so seeds change which words are asked, not how many."""
    lengths = poisson_lengths(np.random.default_rng(sub_seed(0, "lengths", stream)), spec["mean_words"], n)
    rng = np.random.default_rng(sub_seed(seed, "queries", stream))
    return texts_of_lengths(rng, rng.permutation(lengths), ZipfWords(spec["zipf"], spec["vocab"]))
