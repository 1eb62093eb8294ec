"""WordPiece tokenization for the BERT encoder.

Production path: HF ``tokenizers`` (tokenizer.json or vocab.txt in the
model dir). Test path: a tiny self-contained WordPiece implementation over
an explicit vocab, so encoder tests need no model files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

CLS, SEP, PAD, UNK = "[CLS]", "[SEP]", "[PAD]", "[UNK]"


@dataclass
class EncodedPair:
    input_ids: list[int]
    attention_mask: list[int]
    token_type_ids: list[int]


class WordPieceTokenizer:
    """Minimal BERT-style WordPiece: lowercase, whitespace+punct split,
    greedy longest-match-first subwords with '##' continuation."""

    def __init__(self, vocab: dict[str, int], max_len: int = 512) -> None:
        self.vocab = vocab
        self.max_len = max_len
        for tok in (CLS, SEP, PAD, UNK):
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]

    @staticmethod
    def _basic_tokens(text: str) -> list[str]:
        out: list[str] = []
        word = []
        for c in text.lower():
            if c.isalnum():
                word.append(c)
            else:
                if word:
                    out.append("".join(word))
                    word = []
                if not c.isspace():
                    out.append(c)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> list[int]:
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode_text(self, text: str) -> list[int]:
        ids: list[int] = []
        for w in self._basic_tokens(text):
            ids.extend(self._wordpiece(w))
        return ids

    def encode(self, text: str, max_len: int | None = None) -> EncodedPair:
        max_len = max_len or self.max_len
        body = self.encode_text(text)[: max_len - 2]
        ids = [self.cls_id] + body + [self.sep_id]
        return EncodedPair(
            input_ids=ids,
            attention_mask=[1] * len(ids),
            token_type_ids=[0] * len(ids),
        )

    def encode_pair(self, a: str, b: str, max_len: int | None = None) -> EncodedPair:
        """[CLS] a [SEP] b [SEP] with type ids 0/1 (cross-encoder input)."""
        max_len = max_len or self.max_len
        ta = self.encode_text(a)
        tb = self.encode_text(b)
        # budget split: query keeps up to 1/4, doc gets the rest (the
        # reference truncates at 512 total, rerank/native.rs:46-56)
        budget = max_len - 3
        qa = ta[: max(budget // 4, 1)]
        db = tb[: budget - len(qa)]
        ids = [self.cls_id] + qa + [self.sep_id] + db + [self.sep_id]
        types = [0] * (len(qa) + 2) + [1] * (len(db) + 1)
        return EncodedPair(
            input_ids=ids, attention_mask=[1] * len(ids), token_type_ids=types
        )


def load_hf_wordpiece(model_dir: str, max_len: int = 512):
    """Load tokenizer.json via the `tokenizers` package, or vocab.txt into
    the built-in WordPiece."""
    tok_json = os.path.join(model_dir, "tokenizer.json")
    vocab_txt = os.path.join(model_dir, "vocab.txt")
    if os.path.exists(tok_json):
        from tokenizers import Tokenizer

        return HfPairTokenizer(Tokenizer.from_file(tok_json), max_len)
    if os.path.exists(vocab_txt):
        vocab = {}
        with open(vocab_txt, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return WordPieceTokenizer(vocab, max_len)
    raise FileNotFoundError(f"no tokenizer in {model_dir}")


class HfPairTokenizer:
    """Adapter exposing encode/encode_pair over a `tokenizers.Tokenizer`."""

    def __init__(self, tok, max_len: int = 512) -> None:
        self._tok = tok
        self.max_len = max_len

    def encode(self, text: str, max_len: int | None = None) -> EncodedPair:
        e = self._tok.encode(text)
        n = max_len or self.max_len
        return EncodedPair(e.ids[:n], e.attention_mask[:n], e.type_ids[:n])

    def encode_pair(self, a: str, b: str, max_len: int | None = None) -> EncodedPair:
        e = self._tok.encode(a, b)
        n = max_len or self.max_len
        return EncodedPair(e.ids[:n], e.attention_mask[:n], e.type_ids[:n])


def tiny_test_vocab(corpus_words: list[str]) -> dict[str, int]:
    """Build a minimal WordPiece vocab: specials + single chars + words."""
    vocab = {PAD: 0, UNK: 1, CLS: 2, SEP: 3}
    chars = sorted({c for w in corpus_words for c in w.lower()})
    for c in chars:
        vocab.setdefault(c, len(vocab))
        vocab.setdefault("##" + c, len(vocab))
    for w in corpus_words:
        vocab.setdefault(w.lower(), len(vocab))
    return vocab
