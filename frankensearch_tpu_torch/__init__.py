"""frankensearch-tpu on PyTorch + CUDA: the port of ``frankensearch_tpu``.

The JAX package stays the reference; this package does the same work with
PyTorch on an NVIDIA Hopper GPU (hand-written CUDA kernels where the
reference had Pallas kernels) or on the CPU (their plain PyTorch twins).
It never imports jax; it reuses the reference's jax-free host modules
(core types and config, FTVI/WAL formats, embedders, host fusion, the
lexical CPU oracle and tokenizer).

Ported so far: batched hybrid search through the Initial phase —
``TwoTierSearcher.search_batch`` over ``TwoTierIndex`` (fast tier) and the
dense-lane ``DeviceBm25Index``.
"""

from frankensearch_tpu.core.config import TwoTierConfig, TwoTierMetrics
from frankensearch_tpu.core.types import FusedHit, IndexableDocument, ScoredResult, VectorHit

__all__ = [
    "TwoTierConfig",
    "TwoTierMetrics",
    "ScoredResult",
    "VectorHit",
    "FusedHit",
    "IndexableDocument",
    "resolve_device",
    "TwoTierSearcher",
    "TwoTierIndex",
    "DeviceVectorIndex",
    "DeviceBm25Index",
    "BulkDeviceBm25Index",
    "HashEmbedder",
    "MemoryLexicalIndex",
]


def __getattr__(name):
    """Lazy facade re-exports (importing the package loads no torch code)."""
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
        from frankensearch_tpu.embed.hash_embedder import HashEmbedder

        return HashEmbedder
    if name == "MemoryLexicalIndex":
        from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex

        return MemoryLexicalIndex
    raise AttributeError(name)
