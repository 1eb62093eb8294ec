"""BERT encoder (MiniLM-L6 class) on PyTorch, with an int8-Linear option.

Port of frankensearch_tpu/rerank/bert.py: 6 layers, H=384, 12 heads,
exact GELU, LayerNorm eps 1e-12, CLS pooler (tanh) + classifier + sigmoid
for the cross-encoder, mean-pool + L2 head for the embedder. Each
operation keeps the reference's order: LayerNorm is the mean, then the
mean of squared deviations, then ``rsqrt``; attention is logits x
1/sqrt(d_h) plus the -1e9 additive mask, softmax, then probs . V, written
as explicit products (a fused attention backend would reorder the sums
that the artifact certificate and the parity tests hold).

The weights are a flat state: names such as ``layers.0.q.w`` (the
reference's ``['layers'][0]['q']['w']``, see :func:`port_name`), held as
buffers of a :class:`Bert` module on an explicit device. A dense layer has
three forms (the reference's ``_linear``):

* f32: f32 inputs and weights, f32 sums (TF32 stays off);
* ``compute="bf16"``: bf16 inputs and weights, f32 sums and output, f32
  bias (on CUDA ``torch.mm(..., out_dtype=torch.float32)``; on the CPU the
  bf16 values widened to f32, whose products are exact);
* int8 (:func:`quantize_linear_weights`): per-row dynamic int8
  activations times per-output-channel int8 weights with exact int32 sums
  (``torch._int_mm`` on CUDA, zero-padded to its shape rules; an int32
  product on the CPU), then the two scales and the bias in f32.

The forwards are functions over a weights object, under the reference's
names (``embed_tokens``, ``transformer_layer``, ``encoder_forward``): a
:class:`Bert` serves through them, and :func:`state_view` lays a flat
state's tensors out for them without a copy, so that training
(parallel/train.py) and the pipeline's stages run the same operations with
autograd reaching the state. There a dense layer is :class:`Dense` over the
state's tensors or its tensor-parallel form :class:`ShardedDense`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from types import SimpleNamespace
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from frankensearch_tpu_torch.ops.vector_math import int8_matmul, mm_bf16_f32


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_position: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    num_labels: int = 1  # cross-encoder head
    #: matmul activation dtype: "f32" (exact: certificates, the parity
    #: paths) or "bf16" (bf16 inputs, f32 sums; LayerNorm, softmax, GELU and
    #: the residual stay f32). int8 weights override it per layer.
    compute: str = "f32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


DENSE_NAMES = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")
LN_NAMES = ("attn_ln_scale", "attn_ln_bias", "ffn_ln_scale", "ffn_ln_bias")
EMB_NAMES = ("word", "position", "token_type", "ln_scale", "ln_bias")

_KEY_PART = re.compile(r"\['([^']+)'\]|\[(\d+)\]")


def port_name(keystr: str) -> str:
    """The reference's leaf path (``"['layers'][0]['q']['w']"``, jax's
    ``keystr``) -> the port's state name (``"layers.0.q.w"``)."""
    parts = [a or b for a, b in _KEY_PART.findall(keystr)]
    if not parts or "".join(f"['{p}']" if not p.isdigit() else f"[{p}]" for p in parts) != keystr:
        raise KeyError(f"not a parameter path: {keystr!r}")
    return ".".join(parts)


def reference_key(name: str) -> str:
    """The inverse of :func:`port_name`."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split("."))


def param_shapes(cfg: BertConfig) -> dict[str, tuple[int, ...]]:
    """State name -> shape of every f32 parameter of ``cfg``'s model."""
    h, f = cfg.hidden, cfg.intermediate
    shapes: dict[str, tuple[int, ...]] = {
        "embeddings.word": (cfg.vocab_size, h),
        "embeddings.position": (cfg.max_position, h),
        "embeddings.token_type": (cfg.type_vocab, h),
        "embeddings.ln_scale": (h,),
        "embeddings.ln_bias": (h,),
    }
    dense = {"q": (h, h), "k": (h, h), "v": (h, h), "attn_out": (h, h), "ffn_in": (h, f), "ffn_out": (f, h)}
    for i in range(cfg.layers):
        for name, (fi, fo) in dense.items():
            shapes[f"layers.{i}.{name}.w"] = (fi, fo)
            shapes[f"layers.{i}.{name}.b"] = (fo,)
        for name in LN_NAMES:
            shapes[f"layers.{i}.{name}"] = (h,)
    for name, fo in (("pooler", h), ("classifier", cfg.num_labels)):
        shapes[f"{name}.w"] = (h, fo)
        shapes[f"{name}.b"] = (fo,)
    return shapes


def check_state(cfg: BertConfig, state: Mapping[str, Any]) -> None:
    """Raise KeyError unless ``state`` holds every parameter of ``cfg``'s
    model in its shape (a dense weight as ``.w`` or as ``.w_int8``)."""
    for name, shape in param_shapes(cfg).items():
        key = name[:-2] + ".w_int8" if name.endswith(".w") and name not in state else name
        got = tuple(torch.as_tensor(state[key]).shape) if key in state else None
        if got != shape:
            raise KeyError(f"parameter {key}: {got}, config wants {shape}")


def init_params(cfg: BertConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random model (tests, model-free operation): normal(0, 0.02)
    embeddings and dense weights, zero biases, unit LayerNorm scales, drawn
    from ``generator`` on the CPU."""
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("ln_scale", "attn_ln_scale", "ffn_ln_scale"):
            out[name] = torch.ones(shape)
        elif leaf in ("b", "ln_bias", "attn_ln_bias", "ffn_ln_bias"):
            out[name] = torch.zeros(shape)
        else:
            out[name] = torch.randn(shape, generator=generator) * 0.02
    return out


# ---------------------------------------------------------------------------
# int8 weight quantization (per-output-channel weights)
# ---------------------------------------------------------------------------


def quantize_linear_weights(state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Replace every dense ``.w`` with int8 values (``.w_int8``) and a
    per-output-channel f32 scale (``.w_scale``), computed in numpy as the
    reference computes them. Biases, LayerNorm and embeddings stay f32."""
    out: dict[str, torch.Tensor] = {}
    for name, value in state.items():
        if not name.endswith(".w"):
            out[name] = torch.as_tensor(value)
            continue
        w = torch.as_tensor(value).detach().cpu().numpy().astype(np.float32)
        scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
        wi8 = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out[name[:-2] + ".w_int8"] = torch.from_numpy(wi8)
        out[name[:-2] + ".w_scale"] = torch.from_numpy(scale.astype(np.float32))
    return out


class Dense(nn.Module):
    """One dense layer in f32 (``w``, ``b``) or int8 (``w_int8``,
    ``w_scale``, ``b``) form."""

    def __init__(self, params: Mapping[str, torch.Tensor], device: torch.device) -> None:
        super().__init__()
        self.is_int8 = "w_int8" in params
        names = ("w_int8", "w_scale", "b") if self.is_int8 else ("w", "b")
        dtypes = {"w_int8": torch.int8}
        for name in names:
            t = torch.as_tensor(params[name]).to(device=device, dtype=dtypes.get(name, torch.float32))
            self.register_buffer(name, t.contiguous())

    def forward(self, x: torch.Tensor, compute: str = "f32") -> torch.Tensor:
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        if self.is_int8:
            # per-row dynamic activation quantization, exact int32 sums
            amax = torch.clamp(x2.abs().amax(dim=-1, keepdim=True), min=1e-6)
            x_i8 = torch.clamp(torch.round(x2 / amax * 127.0), -127, 127).to(torch.int8)
            acc = int8_matmul(x_i8, self.w_int8).to(torch.float32)
            y = acc * (amax / 127.0) * self.w_scale + self.b
        elif compute == "bf16":
            y = mm_bf16_f32(x2.to(torch.bfloat16), self.w.to(torch.bfloat16)) + self.b
        else:
            y = torch.matmul(x2, self.w) + self.b
        return y.reshape(*lead, y.shape[-1])


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


class _Buffers(nn.Module):
    def __init__(self, params: Mapping[str, torch.Tensor], names, device: torch.device) -> None:
        super().__init__()
        for name in names:
            self.register_buffer(name, torch.as_tensor(params[name]).to(device, torch.float32).contiguous())


class Layer(nn.Module):
    """One post-LN transformer block's weights."""

    def __init__(self, params: Mapping[str, Any], device: torch.device) -> None:
        super().__init__()
        for name in DENSE_NAMES:
            setattr(self, name, Dense(params[name], device))
        for name in LN_NAMES:
            self.register_buffer(name, torch.as_tensor(params[name]).to(device, torch.float32).contiguous())


def _nest(state: Mapping[str, Any]) -> dict:
    """Flat state names -> nested dicts (list indices stay strings)."""
    root: dict = {}
    for name, value in state.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return root


# ---------------------------------------------------------------------------
# The forwards, over any weights object
# ---------------------------------------------------------------------------
#
# A weights object has ``embeddings`` (``word``, ``position``, ``token_type``,
# ``ln_scale``, ``ln_bias``) and ``layers``, each with the six dense layers as
# callables ``(x, compute) -> y`` and the four LayerNorm tensors: a
# :class:`Bert` module (the serving weights, its buffers) or a
# :func:`state_view` over a flat state's tensors (training: autograd reaches
# them).


def embed_tokens(weights, input_ids: torch.Tensor, token_type_ids: torch.Tensor | None, *, cfg: BertConfig) -> torch.Tensor:
    """Embedding sum + LayerNorm (the pre-pipeline stage)."""
    emb = weights.embeddings
    t = input_ids.shape[1]
    positions = torch.arange(t, device=input_ids.device)[None, :]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    # F.embedding gathers the same rows as indexing does; its backward sums
    # a repeated id's gradients in a fixed order on the card as well
    x = (F.embedding(input_ids, emb.word) + F.embedding(positions, emb.position)
         + F.embedding(token_type_ids, emb.token_type))
    return _layer_norm(x, emb.ln_scale, emb.ln_bias, cfg.ln_eps)


def transformer_layer(x: torch.Tensor, layer, amask: torch.Tensor, *, cfg: BertConfig) -> torch.Tensor:
    """One post-LN block: x (B, T, H), amask (B, 1, 1, T) additive. The unit
    that the sequential encoder and each pipeline stage apply."""
    b, t = x.shape[0], x.shape[1]
    nh, hd = cfg.heads, cfg.head_dim
    cd = cfg.compute
    scale = 1.0 / math.sqrt(hd)

    def heads(y):  # (B, T, H) -> (B * heads, T, head_dim)
        return y.reshape(b, t, nh, hd).permute(0, 2, 1, 3).reshape(b * nh, t, hd)

    q, k, v = (heads(getattr(layer, n)(x, cd)) for n in ("q", "k", "v"))
    if cd == "bf16":
        logits = mm_bf16_f32(q.to(torch.bfloat16), k.to(torch.bfloat16).transpose(1, 2))
    else:
        logits = torch.matmul(q, k.transpose(1, 2))
    logits = logits.reshape(b, nh, t, t) * scale + amask
    probs = torch.softmax(logits, dim=-1).reshape(b * nh, t, t)
    if cd == "bf16":
        ctx = mm_bf16_f32(probs.to(torch.bfloat16), v.to(torch.bfloat16))
    else:
        ctx = torch.matmul(probs, v)
    ctx = ctx.reshape(b, nh, t, hd).permute(0, 2, 1, 3).reshape(b, t, cfg.hidden)
    x = _layer_norm(x + layer.attn_out(ctx, cd), layer.attn_ln_scale, layer.attn_ln_bias, cfg.ln_eps)
    h = _exact_gelu(layer.ffn_in(x, cd))
    return _layer_norm(x + layer.ffn_out(h, cd), layer.ffn_ln_scale, layer.ffn_ln_bias, cfg.ln_eps)


def _split_sequence(x: torch.Tensor, devices) -> tuple[torch.Tensor, ...]:
    if devices is None:
        return (x,)
    return tuple(p.to(d) for p, d in zip(torch.tensor_split(x, len(devices), dim=1), devices))


def encoder_forward(
    weights,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: torch.Tensor | None = None,
    *,
    cfg: BertConfig,
    remat: bool = False,
    sequence_devices=None,
) -> torch.Tensor:
    """Token-level hidden states (B, T, H), f32, on ``input_ids``' device.

    ``remat`` runs each block under ``torch.utils.checkpoint`` (the
    non-reentrant form): the backward pass recomputes a block's internals
    instead of keeping them, as ``jax.checkpoint`` does. ``sequence_devices``
    is sequence parallelism: between blocks the residual stream's T axis is
    cut over these devices (the tensor-parallel axis's), and each block
    gathers it back; with ``remat``, those pieces are what the backward pass
    keeps of the stream. Neither changes a value."""
    x = embed_tokens(weights, input_ids, token_type_ids, cfg=cfg)
    amask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
    home = x.device

    def block(layer, *parts):
        h = torch.cat([p.to(home) for p in parts], dim=1) if len(parts) > 1 else parts[0].to(home)
        return transformer_layer(h, layer, amask, cfg=cfg)

    parts = _split_sequence(x, sequence_devices)
    for layer in weights.layers:
        if remat:
            x = checkpoint(block, layer, *parts, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(layer, *parts)
        parts = _split_sequence(x, sequence_devices)
    return x


def mean_pool_l2(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """The embedder's head: the mask-weighted mean over T, then L2 (B, H)."""
    m = attention_mask.to(torch.float32)[..., None]
    pooled = torch.sum(hidden * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1e-9)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return torch.where(norm > 1e-12, pooled / norm, pooled)


# ---------------------------------------------------------------------------
# Weights over a flat state's tensors (training, the pipeline's stages)
# ---------------------------------------------------------------------------


class ShardedDense:
    """The tensor-parallel form of a dense layer over the devices of a tp
    axis (Megatron's split), in f32. ``split="out"`` is column-parallel (q,
    k, v, ffn_in): ``w`` and ``b`` are cut on the output dim, one block a
    device, and the blocks' outputs are copied back to x's device and
    concatenated. ``split="in"`` is row-parallel (attn_out, ffn_out): ``w``
    is cut on the input dim and x with it, each device's partial product is
    copied back and the parts are added in shard order, then the replicated
    bias. Every copy is differentiable, so each shard's gradient reaches
    ``w`` and ``b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, devices, split: str) -> None:
        if split not in ("out", "in"):
            raise ValueError(f"split must be 'out' or 'in', not {split!r}")
        self.devices, self.split = tuple(devices), split
        n = len(self.devices)
        self.w = [p.to(d) for p, d in zip(torch.tensor_split(w, n, dim=1 if split == "out" else 0), self.devices)]
        self.b = [p.to(d) for p, d in zip(torch.tensor_split(b, n), self.devices)] if split == "out" else b

    def __call__(self, x: torch.Tensor, compute: str = "f32") -> torch.Tensor:
        if compute != "f32":
            raise ValueError(f"the tensor-parallel dense layer runs in f32, not {compute!r}")
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        if self.split == "out":
            y = torch.cat([(torch.matmul(x2.to(d), w) + b).to(x.device)
                           for d, w, b in zip(self.devices, self.w, self.b)], dim=1)
        else:
            y = None
            for d, xs, w in zip(self.devices, torch.tensor_split(x2, len(self.devices), dim=1), self.w):
                part = torch.matmul(xs.to(d), w).to(x.device)
                y = part if y is None else y + part
            y = y + self.b
        return y.reshape(*lead, y.shape[-1])


def _dense(name: str, w: torch.Tensor, b: torch.Tensor) -> Dense:
    # f32 tensors on their device are taken as they are: autograd reaches them
    return Dense({"w": w, "b": b}, w.device)


def layer_view(tensors: Mapping[str, torch.Tensor], dense=_dense) -> SimpleNamespace:
    """One block's weights over ``tensors`` (keys ``q.w``, ``q.b``, ...,
    ``ffn_ln_bias``, no copy); ``dense(name, w, b)`` makes each dense layer
    (default :class:`Dense` over the f32 tensors)."""
    view = SimpleNamespace(**{n: tensors[n] for n in LN_NAMES})
    for n in DENSE_NAMES:
        setattr(view, n, dense(n, tensors[f"{n}.w"], tensors[f"{n}.b"]))
    return view


def state_view(state: Mapping[str, torch.Tensor], dense=_dense) -> SimpleNamespace:
    """A weights object for the forwards over a flat f32 state's tensors
    (no copy: autograd reaches them): its embeddings and each ``layers.i``
    it holds; ``dense`` as in :func:`layer_view`."""
    per_layer: dict[int, dict[str, torch.Tensor]] = {}
    for name, value in state.items():
        parts = name.split(".", 2)
        if parts[0] == "layers":
            per_layer.setdefault(int(parts[1]), {})[parts[2]] = value
    emb = SimpleNamespace(**{n: state[f"embeddings.{n}"] for n in EMB_NAMES})
    return SimpleNamespace(embeddings=emb, layers=[layer_view(per_layer[i], dense) for i in range(len(per_layer))])


class Bert(nn.Module):
    """The encoder's weights on ``device`` and its serving forwards
    (inference only). ``state`` maps state names to arrays or tensors, in f32
    form or as :func:`quantize_linear_weights` left it."""

    def __init__(self, cfg: BertConfig, state: Mapping[str, Any], *, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        check_state(cfg, state)
        tree = _nest(state)
        self.embeddings = _Buffers(tree["embeddings"], EMB_NAMES, device)
        self.layers = nn.ModuleList(Layer(tree["layers"][str(i)], device) for i in range(cfg.layers))
        self.pooler = Dense(tree["pooler"], device)
        self.classifier = Dense(tree["classifier"], device)
        self.device = device

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The state as host numpy arrays, by state name."""
        return {name: t.detach().cpu().numpy() for name, t in self.state_dict().items()}

    # -- forwards --------------------------------------------------------

    def encoder_forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, token_type_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Token-level hidden states (B, T, H), f32."""
        return encoder_forward(self, input_ids, attention_mask, token_type_ids, cfg=self.cfg)

    @torch.inference_mode()
    def embed_forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Mean-pool + L2 head: (B, H) f32."""
        return mean_pool_l2(self.encoder_forward(input_ids, attention_mask), attention_mask)

    @torch.inference_mode()
    def cross_encoder_forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, token_type_ids: torch.Tensor
    ) -> torch.Tensor:
        """CLS pooler (tanh) -> classifier -> sigmoid relevance (B,). The
        head's two dense layers run in f32 (or int8) whatever ``compute``
        says, as in the reference."""
        hidden = self.encoder_forward(input_ids, attention_mask, token_type_ids)
        pooled = torch.tanh(self.pooler(hidden[:, 0, :]))
        return torch.sigmoid(self.classifier(pooled)[:, 0])


# ---------------------------------------------------------------------------
# HuggingFace checkpoint loading
# ---------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
}


def load_hf_bert(model_dir: str, cfg: BertConfig | None = None) -> tuple[dict[str, np.ndarray], BertConfig]:
    """Map a local HF BERT safetensors checkpoint (BertModel or
    BertForSequenceClassification layout) into the flat state. A missing
    pooler or classifier is drawn at random (seeds 0 and 1)."""
    import json

    from safetensors.numpy import load_file

    cfg_path = os.path.join(model_dir, "config.json")
    if cfg is None and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
        cfg = BertConfig(
            vocab_size=hf.get("vocab_size", 30522),
            hidden=hf.get("hidden_size", 384),
            layers=hf.get("num_hidden_layers", 6),
            heads=hf.get("num_attention_heads", 12),
            intermediate=hf.get("intermediate_size", 1536),
            max_position=hf.get("max_position_embeddings", 512),
            type_vocab=hf.get("type_vocab_size", 2),
            ln_eps=hf.get("layer_norm_eps", 1e-12),
            num_labels=len(hf.get("id2label", {0: ""})) or 1,
        )
    assert cfg is not None
    t = load_file(os.path.join(model_dir, "model.safetensors"))

    def get(name: str) -> np.ndarray:
        for prefix in ("", "bert.", "model."):
            if prefix + name in t:
                return t[prefix + name]
        raise KeyError(name)

    state: dict[str, np.ndarray] = {}

    def dense(ours: str, theirs: str, source=get) -> None:
        state[f"{ours}.w"] = source(f"{theirs}.weight").T.astype(np.float32)  # HF stores (out, in)
        state[f"{ours}.b"] = source(f"{theirs}.bias").astype(np.float32)

    for ours, theirs in (("word", "word_embeddings.weight"), ("position", "position_embeddings.weight"),
                         ("token_type", "token_type_embeddings.weight"), ("ln_scale", "LayerNorm.weight"),
                         ("ln_bias", "LayerNorm.bias")):
        state[f"embeddings.{ours}"] = get(f"embeddings.{theirs}")
    for i in range(cfg.layers):
        base = f"encoder.layer.{i}"
        for ours, theirs in _HF_LAYER_MAP.items():
            dense(f"layers.{i}.{ours}", f"{base}.{theirs}")
        state[f"layers.{i}.attn_ln_scale"] = get(f"{base}.attention.output.LayerNorm.weight")
        state[f"layers.{i}.attn_ln_bias"] = get(f"{base}.attention.output.LayerNorm.bias")
        dense(f"layers.{i}.ffn_in", f"{base}.intermediate.dense")
        dense(f"layers.{i}.ffn_out", f"{base}.output.dense")
        state[f"layers.{i}.ffn_ln_scale"] = get(f"{base}.output.LayerNorm.weight")
        state[f"layers.{i}.ffn_ln_bias"] = get(f"{base}.output.LayerNorm.bias")
    heads = {"pooler": ("pooler.dense", get, 0), "classifier": ("classifier", t.__getitem__, 1)}
    for ours, (theirs, source, seed) in heads.items():
        try:
            dense(ours, theirs, source)
        except KeyError:
            drawn = init_params(cfg, torch.Generator().manual_seed(seed))
            state[f"{ours}.w"] = drawn[f"{ours}.w"].numpy()
            state[f"{ours}.b"] = drawn[f"{ours}.b"].numpy()
    return state, cfg
