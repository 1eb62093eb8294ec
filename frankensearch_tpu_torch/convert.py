"""Carry device state across from the JAX package without importing jax.

Both functions take plain numpy arrays — the caller pulls them out of the
reference's objects with ``np.asarray(...)`` — so the port holds exactly the
reference's state: the same padded slab and mask bits, the same postings.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from frankensearch_tpu.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.array(x, copy=True, order="C")  # owned and writable
    if x.dtype.name == "bfloat16":  # numpy's bfloat16 extension type
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def device_index_from_arrays(
    slab: np.ndarray,
    base_mask: np.ndarray,
    doc_ids: Sequence[str],
    identity: EmbeddingIdentity,
    *,
    device: torch.device,
) -> DeviceVectorIndex:
    """A :class:`DeviceVectorIndex` over a padded (n_pad, d_pad) slab and
    its (n_pad,) additive mask, as a reference index holds them."""
    return DeviceVectorIndex.from_padded(
        _to_tensor(slab).to(device),
        _to_tensor(np.asarray(base_mask, dtype=np.float32)).to(device),
        doc_ids,
        identity,
    )


def bm25_from_arrays(
    post_term: np.ndarray,
    post_doc: np.ndarray,
    post_tf: np.ndarray,
    arms: Mapping,
    doc_ids: Sequence[str],
    vocab_size: int,
    *,
    device: torch.device,
) -> DeviceBm25Index:
    """A :class:`DeviceBm25Index` over the reference's postings arrays and
    query arms (field name -> term ids, idf table, base); the postings
    count picks the lane as it does for the reference."""
    return DeviceBm25Index.from_postings(
        np.asarray(post_term), np.asarray(post_doc), np.asarray(post_tf),
        dict(arms), list(doc_ids), int(vocab_size), device=device,
    )
