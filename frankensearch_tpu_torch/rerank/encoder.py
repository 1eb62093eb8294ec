"""Quality-tier transformer embedder (MiniLM class) over the PyTorch encoder.

Port of frankensearch_tpu/rerank/encoder.py: the BERT mean-pool + L2
embedder on an explicit device, its ``ftenc.v1`` artifacts (params.npz
keyed by the reference's parameter paths, encoder.json with the config,
WordPiece vocab, identity and a golden-vector certificate) and the
fail-closed certificate check at load: the sha of the probe vectors first,
then, off the saving platform, the stored vectors within 1e-3.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from frankensearch_tpu_torch.core.atomic_io import atomic_write_text
from frankensearch_tpu_torch.embed.base import Embedder
from frankensearch_tpu_torch.rerank.bert import (
    Bert,
    BertConfig,
    init_params,
    load_hf_bert,
    quantize_linear_weights,
    reference_key,
)
from frankensearch_tpu_torch.rerank.tokenizer import (
    WordPieceTokenizer,
    load_hf_wordpiece,
    tiny_test_vocab,
)

_LENGTH_BUCKETS = (16, 32, 64, 128, 256, 512)


def _bucket(n: int) -> int:
    for b in _LENGTH_BUCKETS:
        if n <= b:
            return b
    return _LENGTH_BUCKETS[-1]


class TransformerEmbedder(Embedder):
    """Batched BERT mean-pool embedder; the weights live on ``device``.
    A batch pads every text to the length bucket of its longest one."""

    def __init__(
        self,
        params,
        cfg: BertConfig,
        tokenizer,
        *,
        device: torch.device,
        embedder_id: str = "minilm-l6",
        revision: str = "",
        max_tokens: int = 256,
        int8: bool = False,
        compute: str | None = None,
    ) -> None:
        # "bf16" runs the matmuls on bf16 inputs with f32 sums; certificates
        # stay on the exact f32 path (load_artifact switches after the check)
        if compute is not None:
            cfg = dataclasses.replace(cfg, compute=compute)
        self.cfg = cfg
        self.params = quantize_linear_weights(params) if int8 else params
        self.model = Bert(cfg, self.params, device=device)
        self.device = self.model.device
        self.tokenizer = tokenizer
        self._id = embedder_id
        self._revision = revision
        self.max_tokens = max_tokens

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    @property
    def embedder_id(self) -> str:
        return self._id

    @property
    def revision(self) -> str:
        return self._revision

    @classmethod
    def from_dir(cls, model_dir: str, *, device: torch.device, int8: bool = False, **kw) -> "TransformerEmbedder":
        params, cfg = load_hf_bert(model_dir)
        return cls(
            params, cfg, load_hf_wordpiece(model_dir), device=device,
            embedder_id=os.path.basename(os.path.normpath(model_dir)), int8=int8, **kw,
        )

    def tokenize_batch(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """(B, T) padded token ids and attention mask, T the length bucket
        of the longest text."""
        encs = [self.tokenizer.encode(t, max_len=self.max_tokens) for t in texts]
        t_pad = _bucket(max(len(e.input_ids) for e in encs))
        ids = np.zeros((len(texts), t_pad), dtype=np.int32)
        mask = np.zeros((len(texts), t_pad), dtype=np.int32)
        for i, e in enumerate(encs):
            n = len(e.input_ids)
            ids[i, :n] = e.input_ids
            mask[i, :n] = e.attention_mask
        return ids, mask

    def forward_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Enqueue the forward for ``texts``; returns the (B, H) f32 device
        tensor without waiting for it."""
        ids, mask = self.tokenize_batch(texts)
        dev = self.device
        return self.model.embed_forward(
            torch.from_numpy(ids).to(dev, torch.int64), torch.from_numpy(mask).to(dev)
        )

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return self.forward_device(texts).cpu().numpy().astype(np.float32, copy=False)

    def embed_prefetch(self, text: str):
        """Enqueue the forward now; the returned closure waits for it and
        copies the vector to the host, so the device runs while the caller
        does host work."""
        out = self.forward_device([text])
        return lambda: out.cpu().numpy().astype(np.float32, copy=False)[0]


def load_encoder_embedder(model_dir: str, **kw) -> TransformerEmbedder:
    """Entry point used by EmbedderStack.auto_detect."""
    return TransformerEmbedder.from_dir(model_dir, **kw)


# -- trained-encoder artifacts -------------------------------------------------

ARTIFACT_META = "encoder.json"
ARTIFACT_PARAMS = "params.npz"


def _flat_params(embedder: TransformerEmbedder) -> dict[str, np.ndarray]:
    """The weights keyed by the reference's parameter paths."""
    return {reference_key(name): value for name, value in embedder.model.state_arrays().items()}


def save_artifact(embedder: TransformerEmbedder, out_dir: str) -> None:
    """Persist a TransformerEmbedder as a self-contained ``ftenc.v1``
    artifact: params.npz + encoder.json carrying the config, WordPiece
    vocab, identity, a golden-vector certificate over the conformance
    probes and the probe vectors themselves."""
    import json

    from frankensearch_tpu_torch.core.generation import CONFORMANCE_PROBES, GoldenVectorCertificate

    if not isinstance(embedder.tokenizer, WordPieceTokenizer):
        raise ValueError(
            "save_artifact requires the self-contained WordPiece tokenizer "
            "(HF-tokenizer models are already directories; keep using them)"
        )
    if embedder.cfg.compute != "f32":
        raise ValueError(
            "artifacts pin the exact f32 embedding space; save with the "
            "f32 embedder and pass compute='bf16' at LOAD time instead"
        )
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, ARTIFACT_PARAMS), **_flat_params(embedder))
    probe_vecs = np.asarray(embedder.embed_batch(list(CONFORMANCE_PROBES)), dtype=np.float32)
    golden = GoldenVectorCertificate.compute(embedder.embedder_id, CONFORMANCE_PROBES, probe_vecs)
    meta = {
        "format": "ftenc.v1",
        "embedder_id": embedder.embedder_id,
        "revision": embedder.revision,
        "max_tokens": embedder.max_tokens,
        "cfg": dataclasses.asdict(embedder.cfg),
        "vocab": embedder.tokenizer.vocab,
        "tokenizer_max_len": embedder.tokenizer.max_len,
        "golden": golden.to_dict(),
        # another platform's reduction order moves low-order bits, so a
        # load there falls back from the sha to these vectors within 1e-3
        "golden_vectors": [[float(x) for x in row] for row in probe_vecs],
    }
    atomic_write_text(os.path.join(out_dir, ARTIFACT_META), json.dumps(meta))


def load_artifact(
    artifact_dir: str, *, device: torch.device, verify: bool = True, compute: str | None = None
) -> TransformerEmbedder:
    """Load a ``save_artifact`` directory onto ``device``. With ``verify``
    (default) the probe vectors are recomputed in f32 and the certificate
    checked fail-closed: the sha first; where it differs, every stored
    probe vector within 1e-3 (tampered or corrupted weights move them by
    far more). ``compute="bf16"`` switches serving to bf16 products only
    after that check."""
    import json

    from frankensearch_tpu_torch.convert import bert_params_from_arrays
    from frankensearch_tpu_torch.core.errors import IndexCorrupted
    from frankensearch_tpu_torch.core.generation import CONFORMANCE_PROBES, GoldenVectorCertificate
    from frankensearch_tpu_torch.rerank.bert import param_shapes

    with open(os.path.join(artifact_dir, ARTIFACT_META), encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("format") != "ftenc.v1":
        raise IndexCorrupted(f"unsupported encoder artifact {meta.get('format')!r}")
    cfg = BertConfig(**meta["cfg"])
    tok = WordPieceTokenizer(
        {str(k): int(v) for k, v in meta["vocab"].items()},
        max_len=int(meta["tokenizer_max_len"]),
    )
    blob = np.load(os.path.join(artifact_dir, ARTIFACT_PARAMS))
    keys = [reference_key(name) for name in param_shapes(cfg)]
    missing = [k for k in keys if k not in blob.files]
    if missing:
        raise IndexCorrupted(f"encoder artifact missing params: {missing[:3]}")
    state = bert_params_from_arrays({k: blob[k] for k in keys}, cfg)
    ident = {"embedder_id": meta["embedder_id"], "revision": meta.get("revision", ""),
             "max_tokens": int(meta.get("max_tokens", 256))}
    emb = TransformerEmbedder(state, cfg, tok, device=device, **ident)
    if verify:
        got_vecs = np.asarray(emb.embed_batch(list(CONFORMANCE_PROBES)), dtype=np.float32)
        got = GoldenVectorCertificate.compute(emb.embedder_id, CONFORMANCE_PROBES, got_vecs)
        want = meta["golden"]
        if got.vectors_sha256 != want["vectors_sha256"]:
            stored = meta.get("golden_vectors")
            ok = False
            if stored is not None:
                ref = np.asarray(stored, dtype=np.float32)
                ok = ref.shape == got_vecs.shape and bool(np.max(np.abs(ref - got_vecs)) <= 1e-3)
            if not ok:
                raise IndexCorrupted(
                    f"golden-vector certificate mismatch for {emb.embedder_id}: "
                    f"runtime produces a different embedding space than at save "
                    f"time ({got.vectors_sha256[:12]} != {want['vectors_sha256'][:12]})"
                )
    if compute is not None:
        emb = TransformerEmbedder(emb.model.state_dict(), cfg, tok, device=device, compute=compute, **ident)
    return emb


def random_transformer_embedder(
    corpus_words: list[str],
    *,
    device: torch.device,
    hidden: int = 64,
    layers: int = 2,
    heads: int = 4,
    seed: int = 0,
    int8: bool = False,
) -> TransformerEmbedder:
    """Test helper: tiny random BERT + tiny WordPiece vocab; the weights
    come from a ``torch.Generator`` seeded with ``seed``."""
    vocab = tiny_test_vocab(corpus_words)
    cfg = BertConfig(
        vocab_size=len(vocab) + 8,
        hidden=hidden,
        layers=layers,
        heads=heads,
        intermediate=hidden * 4,
        max_position=128,
    )
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    tok = WordPieceTokenizer(vocab, max_len=128)
    return TransformerEmbedder(
        params, cfg, tok, device=device, embedder_id=f"random-bert-{hidden}", revision="test",
        int8=int8, max_tokens=128,
    )
