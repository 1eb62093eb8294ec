"""Cross-encoder reranker (ms-marco-MiniLM class) on PyTorch.

Port of frankensearch_tpu/rerank/cross_encoder.py: a
BertForSequenceClassification forward over (query, document) pairs, CLS
pooler + sigmoid relevance in [0, 1], batches chunked by token budget
(MAX_BATCH_TOKENS = 2048), 512-token pairs at most, optional int8
weights over the f32 substrate. The weights live on an explicit device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.rerank.bert import (
    Bert,
    BertConfig,
    init_params,
    load_hf_bert,
    quantize_linear_weights,
)
from frankensearch_tpu_torch.rerank.tokenizer import (
    WordPieceTokenizer,
    load_hf_wordpiece,
    tiny_test_vocab,
)

MAX_BATCH_TOKENS = 2048
MAX_PAIR_TOKENS = 512

_LENGTH_BUCKETS = (32, 64, 128, 256, 512)


def _bucket(n: int) -> int:
    for b in _LENGTH_BUCKETS:
        if n <= b:
            return b
    return _LENGTH_BUCKETS[-1]


@dataclass(frozen=True)
class RerankScore:
    doc_id: str
    score: float


class CrossEncoderReranker:
    def __init__(
        self,
        params,
        cfg: BertConfig,
        tokenizer,
        *,
        device: torch.device,
        reranker_id: str = "cross-encoder-minilm",
        int8: bool = False,
        max_pair_tokens: int = MAX_PAIR_TOKENS,
        max_batch_tokens: int = MAX_BATCH_TOKENS,
    ) -> None:
        self.cfg = cfg
        self.params = quantize_linear_weights(params) if int8 else params
        self.model = Bert(cfg, self.params, device=device)
        self.device = self.model.device
        self.tokenizer = tokenizer
        self.reranker_id = reranker_id
        self.max_pair_tokens = max_pair_tokens
        self.max_batch_tokens = max_batch_tokens

    @classmethod
    def from_dir(cls, model_dir: str, *, device: torch.device, int8: bool = False, **kw) -> "CrossEncoderReranker":
        params, cfg = load_hf_bert(model_dir)
        return cls(
            params, cfg, load_hf_wordpiece(model_dir), device=device,
            reranker_id=os.path.basename(os.path.normpath(model_dir)), int8=int8, **kw,
        )

    def score_pairs(self, query: str, docs: Sequence[tuple[str, str]]) -> list[RerankScore]:
        """Score (doc_id, text) pairs against the query. Batches are chunked
        by token budget so one long doc can't blow the device program."""
        if not docs:
            return []
        encs = [
            (doc_id, self.tokenizer.encode_pair(query, text, max_len=self.max_pair_tokens))
            for doc_id, text in docs
        ]
        out: list[RerankScore] = []
        chunk: list[tuple[str, object]] = []
        chunk_max = 0
        for doc_id, e in encs:
            n = len(e.input_ids)
            projected = max(chunk_max, n) * (len(chunk) + 1)
            if chunk and projected > self.max_batch_tokens:
                out.extend(self._score_chunk(chunk))
                chunk, chunk_max = [], 0
            chunk.append((doc_id, e))
            chunk_max = max(chunk_max, n)
        if chunk:
            out.extend(self._score_chunk(chunk))
        return out

    def _score_chunk(self, chunk) -> list[RerankScore]:
        t_pad = _bucket(max(len(e.input_ids) for _, e in chunk))
        n = len(chunk)
        ids = np.zeros((n, t_pad), dtype=np.int64)
        mask = np.zeros((n, t_pad), dtype=np.int32)
        types = np.zeros((n, t_pad), dtype=np.int64)
        for i, (_, e) in enumerate(chunk):
            ln = len(e.input_ids)
            ids[i, :ln] = e.input_ids
            mask[i, :ln] = e.attention_mask
            types[i, :ln] = e.token_type_ids
        dev = self.device
        scores = self.model.cross_encoder_forward(
            torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), torch.from_numpy(types).to(dev)
        )
        host = scores.cpu().numpy().astype(np.float32, copy=False)
        return [RerankScore(doc_id, float(s)) for (doc_id, _), s in zip(chunk, host)]


def random_cross_encoder(
    corpus_words: list[str], *, device: torch.device, hidden: int = 64, layers: int = 2, heads: int = 4,
    seed: int = 0, int8: bool = False,
) -> CrossEncoderReranker:
    """Test helper: tiny random cross-encoder; the weights come from a
    ``torch.Generator`` seeded with ``seed``."""
    vocab = tiny_test_vocab(corpus_words)
    cfg = BertConfig(
        vocab_size=len(vocab) + 8, hidden=hidden, layers=layers, heads=heads,
        intermediate=hidden * 4, max_position=128, num_labels=1,
    )
    return CrossEncoderReranker(
        init_params(cfg, torch.Generator().manual_seed(seed)), cfg, WordPieceTokenizer(vocab, max_len=128),
        device=device, reranker_id=f"random-ce-{hidden}", int8=int8, max_pair_tokens=128,
    )
