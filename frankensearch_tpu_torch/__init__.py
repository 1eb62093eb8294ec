"""frankensearch-tpu on PyTorch + CUDA: the port of ``frankensearch_tpu``.

The JAX package stays the reference; this package does the same work with
PyTorch on an NVIDIA Hopper GPU (hand-written CUDA kernels where the
reference had Pallas kernels) or on the CPU (their plain PyTorch twins).
It imports neither jax nor anything of ``frankensearch_tpu``: the host
modules it needs (core types and config, FTVI/WAL formats, durability and
recall certificates, embedders, host fusion, the lexical CPU oracle and
tokenizer, the native ingest binding) are its own copies, at the same
relative paths, and write byte-compatible artifacts.

Ported so far: the progressive two-tier search — ``TwoTierSearcher.search``
streams Initial, Refined (a BERT quality tier, ``rerank/``) and Reranked (a
cross-encoder), with boolean/phrase queries — and batched hybrid search
with the Refined phase — ``TwoTierSearcher.search_batch`` over
``TwoTierIndex`` (fast and quality tiers) and
``DeviceBm25Index`` at any lexical scale (dense lane; blocked flat,
pruned and DAAT lanes from 2,097,152 postings) — and the fast tier's
``scan_mode`` lanes ``"int8"`` (the int8 capacity slab) and ``"pallas"``
(the per-tile top-k scan), behind the recall-certificate gate. A
``Model2VecEmbedder`` fast tier runs its embed inside the fused phase-1
pass (``embed_corpus`` embeds a corpus through the native bag lane), and
``ops/ab_primitives.scan_topk_hierarchical_ab`` keeps the reference's
retired A/B scan lanes, the per-tile group candidates kernel among them.
``IndexBuilder(root).build()`` writes a root (FTVI tiers, the JSON lexical
oracle and its packed FLXB arm, the SQLite metadata store, sidecars and the
generation manifest) and ``open_hybrid(root)`` serves it, the packed arm
behind the lease-bounded delta (writes searchable before a seal,
incremental seals as a segment stack). The product CLI
(``python -m frankensearch_tpu_torch.cli``) runs ``index``, ``search``,
``serve`` and the commands around them on the card (``--device cpu`` for
the CPU).
"""

from frankensearch_tpu_torch.core.config import TwoTierConfig, TwoTierMetrics
from frankensearch_tpu_torch.core.types import FusedHit, IndexableDocument, ScoredResult, VectorHit

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "TwoTierConfig",
    "TwoTierMetrics",
    "ScoredResult",
    "VectorHit",
    "FusedHit",
    "IndexableDocument",
    "IndexBuilder",
    "open_hybrid",
    "EmbedderStack",
    "resolve_device",
    "TwoTierSearcher",
    "TwoTierIndex",
    "DeviceVectorIndex",
    "DeviceBm25Index",
    "BulkDeviceBm25Index",
    "HashEmbedder",
    "Model2VecEmbedder",
    "SimpleWordTokenizer",
    "random_model2vec",
    "embed_corpus",
    "MemoryLexicalIndex",
]


def __getattr__(name):
    """Lazy facade re-exports (importing the package loads no torch code)."""
    if name in ("IndexBuilder", "open_hybrid"):
        from frankensearch_tpu_torch import builder

        return getattr(builder, name)
    if name == "EmbedderStack":
        from frankensearch_tpu_torch.embed.stack import EmbedderStack

        return EmbedderStack
    if name == "resolve_device":
        from frankensearch_tpu_torch.device import resolve_device

        return resolve_device
    if name == "TwoTierSearcher":
        from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher

        return TwoTierSearcher
    if name == "TwoTierIndex":
        from frankensearch_tpu_torch.index.two_tier import TwoTierIndex

        return TwoTierIndex
    if name == "DeviceVectorIndex":
        from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex

        return DeviceVectorIndex
    if name in ("DeviceBm25Index", "BulkDeviceBm25Index"):
        from frankensearch_tpu_torch.lexical import device_bm25

        return getattr(device_bm25, name)
    if name == "HashEmbedder":
        from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder

        return HashEmbedder
    if name in ("Model2VecEmbedder", "SimpleWordTokenizer", "random_model2vec"):
        from frankensearch_tpu_torch.embed import model2vec

        return getattr(model2vec, name)
    if name == "embed_corpus":
        from frankensearch_tpu_torch.embed.bulk import embed_corpus

        return embed_corpus
    if name == "MemoryLexicalIndex":
        from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

        return MemoryLexicalIndex
    raise AttributeError(name)
