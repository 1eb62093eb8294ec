"""Pipeline parallelism for the transformer encoder, GPipe schedule (PyTorch).

Port of frankensearch_tpu/parallel/pipeline.py: for encoders too large for
one device, the layers split over a ``"pp"`` mesh axis, each stage holding
L/S contiguous layers on its device, and microbatching fills the pipeline
(bubble fraction (S-1)/(M+S-1)).

Mechanics (one controller): the embeddings run on the lead device (the
pre-pipeline stage), then a tick loop of M + S - 1 ticks: at tick t stage s
applies its layers (:func:`~frankensearch_tpu_torch.rerank.bert.
transformer_layer`, the sequential encoder's block) to microbatch t - s,
stage 0 ingesting microbatch t while t < M, and hands the activation and
its mask to stage s + 1's device (the reference's ``ppermute``); the last
stage's outputs are copied to the lead device. Kernels on different cards
overlap as CUDA runs each card's queue on its own. Parity with the
sequential encoder holds within f32 rounding (a microbatch's products may
take other GEMM shapes).
"""

from __future__ import annotations

from typing import Mapping

import torch

from frankensearch_tpu_torch.parallel.mesh import Mesh
from frankensearch_tpu_torch.rerank.bert import (
    BertConfig,
    embed_tokens,
    layer_view,
    mean_pool_l2,
    state_view,
    transformer_layer,
)


def stack_layer_params(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A flat state's per-layer tensors stacked on a leading L axis:
    ``layers.i.q.w`` for every i -> ``q.w`` of shape (L, ...)."""
    per_leaf: dict[str, dict[int, torch.Tensor]] = {}
    for name, value in state.items():
        parts = name.split(".", 2)
        if parts[0] == "layers":
            per_leaf.setdefault(parts[2], {})[int(parts[1])] = torch.as_tensor(value)
    return {leaf: torch.stack([by_layer[i] for i in range(len(by_layer))]) for leaf, by_layer in per_leaf.items()}


def shard_stacked_layers(stacked: Mapping[str, torch.Tensor], mesh: Mesh) -> list[dict[str, torch.Tensor]]:
    """The stacked layers' L axis split over the mesh's "pp" axis: one dict
    per stage, its L/S contiguous layers on the stage's device."""
    devices = mesh.shard_devices("pp")
    n_layers = len(next(iter(stacked.values())))
    if n_layers % len(devices):
        raise ValueError(f"{n_layers} layers not divisible into {len(devices)} pipeline stages")
    per = n_layers // len(devices)
    return [{leaf: x[s * per:(s + 1) * per].to(dev) for leaf, x in stacked.items()}
            for s, dev in enumerate(devices)]


def pipeline_encoder_forward(
    params: Mapping[str, torch.Tensor],  # the flat state; its layers are ignored for ``stacked_layers``
    stacked_layers: list[dict[str, torch.Tensor]],  # shard_stacked_layers' stages
    input_ids: torch.Tensor,  # (B, T)
    attention_mask: torch.Tensor,  # (B, T)
    *,
    cfg: BertConfig,
    mesh: Mesh,
    microbatches: int,
    n_stages: int,
) -> torch.Tensor:
    """(B, T, H) hidden states == the sequential ``encoder_forward``,
    computed with the layers pipelined over the "pp" axis, on the lead
    device. B % microbatches == 0."""
    b, t = input_ids.shape
    m = microbatches
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    devices = mesh.shard_devices("pp")
    if n_stages != len(devices) or len(stacked_layers) != n_stages:
        raise ValueError(f"n_stages {n_stages} != mesh pp axis {len(devices)} ({len(stacked_layers)} stages)")
    lead = devices[0]
    stages = [[layer_view({leaf: x[i] for leaf, x in stage.items()}) for i in range(len(next(iter(stage.values()))))]
              for stage in stacked_layers]

    # the pre-pipeline stage: embeddings and the additive mask, on the lead
    ids, mask = input_ids.to(lead), attention_mask.to(lead)
    emb = {n: params[n].to(lead) for n in params if n.startswith("embeddings.")}
    x = embed_tokens(state_view(emb), ids, None, cfg=cfg)
    amask = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
    x_mb, amask_mb = torch.split(x, b // m), torch.split(amask, b // m)

    outputs: list[torch.Tensor | None] = [None] * m
    held: list[tuple | None] = [None] * n_stages  # each stage's input for this tick
    for tick in range(m + n_stages - 1):
        if tick < m:
            held[0] = (x_mb[tick].to(devices[0]), amask_mb[tick].to(devices[0]))
        passed: list[tuple | None] = [None] * n_stages
        for s in range(n_stages):
            if held[s] is None:
                continue
            h, a = held[s]
            for layer in stages[s]:
                h = transformer_layer(h, layer, a, cfg=cfg)
            if s == n_stages - 1:
                outputs[tick - (n_stages - 1)] = h.to(lead)
            else:
                passed[s + 1] = (h.to(devices[s + 1]), a.to(devices[s + 1]))
        held = passed
    return torch.cat(outputs)


def pipeline_embed_forward(
    params: Mapping[str, torch.Tensor],
    stacked_layers: list[dict[str, torch.Tensor]],
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    cfg: BertConfig,
    mesh: Mesh,
    microbatches: int = 4,
) -> torch.Tensor:
    """Mean-pool + L2 head over the pipelined encoder (``embed_forward``
    parity), (B, H) on the lead device."""
    hidden = pipeline_encoder_forward(
        params, stacked_layers, input_ids, attention_mask,
        cfg=cfg, mesh=mesh, microbatches=microbatches, n_stages=mesh.shape["pp"],
    )
    return mean_pool_l2(hidden, attention_mask.to(hidden.device))
