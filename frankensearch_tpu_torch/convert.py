"""Carry device state across from the JAX package without importing jax.

Every function takes plain numpy arrays — the caller pulls them out of the
reference's objects with ``np.asarray(...)`` — so the port holds exactly the
reference's state: the same padded slab and mask bits, the same int8 arm,
the same postings, the same Model2Vec table. Identities, query arms and
tokenizers are rebuilt as the port's own types from their fields.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index, _FieldArm


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.array(x, copy=True, order="C")  # owned and writable
    if x.dtype.name == "bfloat16":  # numpy's bfloat16 extension type
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def device_index_from_arrays(
    slab: np.ndarray,
    base_mask: np.ndarray,
    doc_ids: Sequence[str],
    identity,
    *,
    device: torch.device,
    int8: tuple[np.ndarray, np.ndarray] | None = None,
) -> DeviceVectorIndex:
    """A :class:`DeviceVectorIndex` over a padded (n_pad, d_pad) slab and
    its (n_pad,) additive mask, as a reference index holds them.
    ``identity`` is any object with EmbeddingIdentity's fields; ``int8`` is
    the reference's int8 arm (``_int8``) as numpy: the padded (n_pad,
    d_pad) int8 values and the (d_pad,) f32 scale."""
    index = DeviceVectorIndex.from_padded(
        _to_tensor(slab).to(device),
        _to_tensor(np.asarray(base_mask, dtype=np.float32)).to(device),
        doc_ids,
        EmbeddingIdentity(
            embedder_id=identity.embedder_id,
            embedder_revision=identity.embedder_revision,
            dim=identity.dim,
            is_semantic=identity.is_semantic,
        ),
    )
    if int8 is not None:
        values, scale = int8
        index._int8 = (
            _to_tensor(np.asarray(values, dtype=np.int8)).to(device),
            _to_tensor(np.asarray(scale, dtype=np.float32)).to(device),
        )
    return index


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
    count picks the lane as it does for the reference. Each arm is any
    object with ``_FieldArm``'s fields."""
    port_arms = {
        name: _FieldArm(dict(a.term_ids), np.asarray(a.idf_host), a.boost, a.base)
        for name, a in arms.items()
    }
    return DeviceBm25Index.from_postings(
        np.asarray(post_term), np.asarray(post_doc), np.asarray(post_tf),
        port_arms, list(doc_ids), int(vocab_size), device=device,
    )


def model2vec_from_arrays(
    embeddings: np.ndarray,
    vocab: Mapping[str, int],
    *,
    device: torch.device,
    unk_id: int | None = None,
    lowercase: bool = True,
    **kwargs,
):
    """A :class:`Model2VecEmbedder` over a reference embedder's table (its
    ``_emb`` as numpy, bf16 or f32) and word vocabulary (its tokenizer's
    ``vocab``, ``unk_id`` and ``lowercase``). The table is stored as given
    (bf16 by default, so a bf16 table keeps its bits); ``kwargs`` go to the
    constructor (``embedder_id``, ``revision``, ``max_tokens``,
    ``param_dtype``)."""
    from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder, SimpleWordTokenizer

    table = np.asarray(embeddings)
    if table.dtype.name == "bfloat16":  # numpy's bfloat16 extension type
        table = _to_tensor(table).to(torch.float32).numpy()
    tokenizer = SimpleWordTokenizer(dict(vocab), unk_id=unk_id, lowercase=lowercase)
    return Model2VecEmbedder(np.asarray(table, dtype=np.float32), tokenizer, device=device, **kwargs)


def bert_params_from_arrays(flat: Mapping[str, np.ndarray], cfg) -> dict[str, torch.Tensor]:
    """The port's BERT state (rerank/bert.py names, CPU tensors) from the
    reference's parameters as numpy, keyed by jax's ``keystr`` paths
    (``"['layers'][0]['q']['w']"``, the keys of an ``ftenc.v1`` artifact's
    ``params.npz``). f32 and int8 layouts both map; every parameter that
    ``cfg`` needs must be there, in its shape."""
    from frankensearch_tpu_torch.rerank.bert import check_state, port_name

    state = {port_name(key): torch.from_numpy(np.array(value, copy=True)) for key, value in flat.items()}
    check_state(cfg, state)
    return state
