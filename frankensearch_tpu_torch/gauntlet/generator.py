"""Deterministic, content-addressed corpus and query generators.

Parity target: reference gauntlet/src/generator.rs — seeded generators
whose output is a pure function of (seed, shape parameters), so a
campaign is reproducible from its parameters alone.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from frankensearch_tpu_torch.core.types import IndexableDocument

_WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel",
    "india", "juliet", "kilo", "lima", "mike", "november", "oscar", "papa",
    "quebec", "romeo", "sierra", "tango", "uniform", "victor", "whiskey",
    "xray", "yankee", "zulu", "search", "vector", "index", "query", "token",
    "kernel", "matrix", "shard", "fusion", "tier", "lexical", "semantic",
]


@dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 100
    min_len: int = 5
    max_len: int = 80
    vocab_size: int = len(_WORDS)
    zipf_a: float = 1.3  # term frequency skew (real corpora are zipfian)
    title_every: int = 4
    seed: int = 0

    def fingerprint(self) -> str:
        raw = f"{self.n_docs}:{self.min_len}:{self.max_len}:{self.vocab_size}:{self.zipf_a}:{self.title_every}:{self.seed}"
        return hashlib.blake2b(raw.encode(), digest_size=8).hexdigest()


def generate_corpus(spec: CorpusSpec) -> list[IndexableDocument]:
    rng = np.random.default_rng(spec.seed)
    vocab = _WORDS[: spec.vocab_size]
    # zipf-ranked sampling over the vocab
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    probs = ranks ** (-spec.zipf_a)
    probs /= probs.sum()
    docs = []
    for i in range(spec.n_docs):
        length = int(rng.integers(spec.min_len, spec.max_len + 1))
        words = rng.choice(vocab, size=length, p=probs)
        title = None
        if spec.title_every and i % spec.title_every == 0:
            title = " ".join(rng.choice(vocab, size=2, p=probs))
        docs.append(
            IndexableDocument(
                doc_id=f"doc-{spec.fingerprint()}-{i:05d}",
                content=" ".join(words),
                title=title,
            )
        )
    return docs


@dataclass(frozen=True)
class QuerySpec:
    n_queries: int = 50
    min_terms: int = 1
    max_terms: int = 4
    seed: int = 1


def generate_queries(spec: QuerySpec, corpus: list[IndexableDocument]) -> list[str]:
    """Queries sampled from corpus terms (guaranteed non-trivial hits) plus
    a tail of vocabulary misses."""
    rng = np.random.default_rng(spec.seed)
    all_terms = sorted({t for d in corpus for t in d.content.split()})
    queries = []
    for i in range(spec.n_queries):
        if i % 10 == 9:
            queries.append(f"zzz-miss-{i}")  # guaranteed-miss lane
            continue
        n = int(rng.integers(spec.min_terms, spec.max_terms + 1))
        queries.append(" ".join(rng.choice(all_terms, size=n)))
    return queries
