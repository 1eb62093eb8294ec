"""Model2Vec embedder: static token embeddings + mean pool, on a device
(PyTorch).

Port of frankensearch_tpu/embed/model2vec.py, the fast tier
(potion-multilingual-128M class): tokenizer -> per-token row gather from a
(vocab x dim) table -> mean pool -> L2 normalize. The table lives on an
explicit device, in bf16 by default, and the pool accumulates in f32.
``gather_pool_normalize`` is plain PyTorch: the reference runs it as XLA,
with no Pallas kernel behind it.

The pool's sums run in a fixed order made of elementwise adds (token by
token, then a halving tree over the dimensions for the norm), so a row's
bits depend neither on its batchmates, nor on the padded token length, nor
on the device: a query embedded alone and in a batch gets the same vector
on the CPU and on the card. The reference's XLA reductions take an order
of their own, so the two agree within 1e-6 relative.

Model loading: a directory holding ``tokenizer.json`` (HF tokenizers) and
``model.safetensors`` (key ``embeddings``) in the model2vec layout. For
tests and model-free operation, construct with an explicit vocab + matrix.
"""

from __future__ import annotations

import json
import os
import re
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.embed.base import Embedder, l2_normalize_rows

_WORD_RE = re.compile(r"[\w']+|[^\w\s]", re.UNICODE)

_LENGTH_BUCKETS = (16, 32, 64, 128, 256, 512)


def _bucket_len(n: int) -> int:
    for b in _LENGTH_BUCKETS:
        if n <= b:
            return b
    return _LENGTH_BUCKETS[-1]


def normalize_rows(pooled: torch.Tensor) -> torch.Tensor:
    """Rows of (B, D) f32 divided by their L2 norm where it exceeds 1e-12
    (others, e.g. zero rows, kept). The sum of squares is a halving tree of
    elementwise adds over D padded to a power of two: a fixed order, the
    same on every device and at every batch size."""
    sq = pooled * pooled
    width = 1 << max(sq.shape[1] - 1, 0).bit_length()
    if width != sq.shape[1]:
        sq = torch.nn.functional.pad(sq, (0, width - sq.shape[1]))
    while sq.shape[1] > 1:
        half = sq.shape[1] // 2
        sq = sq[:, :half] + sq[:, half:]
    norm = torch.sqrt(sq)
    return torch.where(norm > 1e-12, pooled / norm, pooled)


def gather_pool_normalize(emb: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(V, D) table x (B, T) token ids and 0/1 mask -> (B, D) f32 unit rows:
    the masked mean of the gathered rows, f32 sums token by token, then
    :func:`normalize_rows`. Rows with no token stay zero."""
    rows = emb[ids.to(torch.int64)].to(torch.float32)  # (B, T, D)
    m = mask.to(torch.float32)
    acc = rows[:, 0] * m[:, :1]
    count = m[:, :1]
    for t in range(1, ids.shape[1]):
        acc = acc + rows[:, t] * m[:, t : t + 1]
        count = count + m[:, t : t + 1]
    return normalize_rows(acc / torch.clamp(count, min=1.0))


class SimpleWordTokenizer:
    """Whitespace/punct word tokenizer over an explicit vocab (test/default
    path; real deployments load an HF ``tokenizer.json``)."""

    def __init__(self, vocab: dict[str, int], unk_id: int | None = None, lowercase: bool = True):
        self.vocab = vocab
        self.unk_id = unk_id
        self.lowercase = lowercase

    def encode(self, text: str) -> list[int]:
        if self.lowercase:
            text = text.lower()
        ids = []
        for tok in _WORD_RE.findall(text):
            i = self.vocab.get(tok)
            if i is None:
                i = self.unk_id
            if i is not None:
                ids.append(i)
        return ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]


class HfTokenizerWrapper:
    """Adapter over the ``tokenizers`` package (no specials, as model2vec)."""

    def __init__(self, path: str) -> None:
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        """The tokenizer's own batch encode (parallel in Rust)."""
        return [e.ids for e in self._tok.encode_batch(list(texts), add_special_tokens=False)]


class Model2VecEmbedder(Embedder):
    """Static-embedding fast tier; the table lives on ``device``."""

    def __init__(
        self,
        embeddings: np.ndarray,
        tokenizer,
        *,
        device: torch.device,
        embedder_id: str = "model2vec",
        revision: str = "",
        max_tokens: int = 512,
        param_dtype: str = "bf16",
    ) -> None:
        embeddings = np.asarray(embeddings, dtype=np.float32)
        self._dim = int(embeddings.shape[1])
        self._vocab_size = int(embeddings.shape[0])
        dt = torch.bfloat16 if param_dtype == "bf16" else torch.float32
        self._emb = torch.from_numpy(np.ascontiguousarray(embeddings)).to(device, dt)
        self.device = self._emb.device  # indexed (cuda:0), as the index's device
        self._tokenizer = tokenizer
        self._id = embedder_id
        self._revision = revision
        self.max_tokens = max_tokens

    # -- identity --

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def embedder_id(self) -> str:
        return self._id

    @property
    def revision(self) -> str:
        return self._revision

    # -- loading --

    @classmethod
    def from_dir(cls, model_dir: str, **kwargs) -> "Model2VecEmbedder":
        """Load the model2vec layout: tokenizer.json + model.safetensors
        (key 'embeddings'), config.json optional. ``kwargs`` go to the
        constructor (``device`` among them)."""
        tok_path = os.path.join(model_dir, "tokenizer.json")
        st_path = os.path.join(model_dir, "model.safetensors")
        if not (os.path.exists(tok_path) and os.path.exists(st_path)):
            raise EmbeddingFailed(f"model2vec layout not found in {model_dir}")
        try:
            from safetensors.numpy import load_file
        except ImportError as e:  # pragma: no cover
            raise EmbeddingFailed("safetensors unavailable") from e
        tensors = load_file(st_path)
        key = "embeddings" if "embeddings" in tensors else next(iter(tensors))
        emb = tensors[key]
        rev = ""
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                rev = str(json.load(f).get("model_revision", ""))
        return cls(
            emb,
            HfTokenizerWrapper(tok_path),
            embedder_id=os.path.basename(os.path.normpath(model_dir)),
            revision=rev,
            **kwargs,
        )

    # -- embedding --

    def tokenize_batch(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Host-side half of embed_batch: (B, T) padded token ids + mask,
        T the smallest length bucket that holds the longest text. Exposed
        so the fused phase-1 pass (ops/hybrid_phase1.py) can run the
        gather-pool on the device beside the scan."""
        batch_encode = getattr(self._tokenizer, "encode_batch", None)
        if batch_encode is not None:
            encoded = [e[: self.max_tokens] for e in batch_encode(texts)]
        else:
            encoded = [self._tokenizer.encode(t)[: self.max_tokens] for t in texts]
        max_len = max((len(e) for e in encoded), default=1)
        t_pad = _bucket_len(max(max_len, 1))
        ids = np.zeros((len(texts), t_pad), dtype=np.int32)
        mask = np.zeros((len(texts), t_pad), dtype=np.int32)
        for i, e in enumerate(encoded):
            if e:
                ids[i, : len(e)] = e
                mask[i, : len(e)] = 1
        return ids, mask

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self._dim), dtype=np.float32)
        ids, mask = self.tokenize_batch(texts)
        out = gather_pool_normalize(
            self._emb, torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
        )
        result = out.cpu().numpy().astype(np.float32, copy=False)
        # rows with zero tokens stay zero vectors (caller treats as degenerate)
        return l2_normalize_rows(result)


def random_model2vec(
    vocab: Sequence[str], dim: int = 64, seed: int = 0, **kwargs
) -> Model2VecEmbedder:
    """Deterministic random static embeddings over a vocab (the reference's
    numpy draw, so both packages get the same table from one seed).
    ``kwargs`` go to the constructor (``device`` among them)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((len(vocab), dim)).astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    tok = SimpleWordTokenizer({w: i for i, w in enumerate(vocab)})
    return Model2VecEmbedder(emb, tok, embedder_id=f"random-m2v-{dim}", revision="test", **kwargs)
