"""Sharded contrastive training of the transformer embedder (PyTorch).

Port of frankensearch_tpu/parallel/train.py: fine-tuning the quality tier
with a symmetric in-batch InfoNCE loss between the query and document
towers (one shared encoder), over a ("dp", "tp") mesh:

- dp: each dp row of the mesh embeds its slice of the batch on its own
  devices, and the row's query and document embeddings are copied to the
  lead device, where the loss takes its logits over the global batch (row
  i's negatives are every other row on every dp shard, as in the
  reference);
- tp: in each dp row, q, k, v and ffn_in are column-parallel and attn_out
  and ffn_out row-parallel over the row's tp devices
  (:class:`~frankensearch_tpu_torch.rerank.bert.ShardedDense`);
- sequence parallelism: between blocks the residual stream's T axis is cut
  over the same tp devices (only where the mesh has a "tp" axis);
- the optimizer is ``torch.optim.AdamW`` with optax.adamw's settings
  (betas 0.9 / 0.999, eps 1e-8, decay on every leaf).

One controller, as the reference (one ``jax.jit`` over a ``Mesh``) and the
port's serving mesh: a step is one autograd graph over the mesh's devices,
with no ``torch.distributed``. The master copy of the weights (a flat state
of leaf tensors) and the optimizer's moments live whole on the lead device
(the mesh's first); each step makes every dp replica and tp shard of them as
a differentiable copy, so autograd sums each replica's gradient into the
master's, which is the gradient all-reduce. Shards may share a card.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from frankensearch_tpu_torch.parallel.mesh import Mesh
from frankensearch_tpu_torch.rerank.bert import (
    BertConfig,
    ShardedDense,
    check_state,
    encoder_forward,
    init_params,
    mean_pool_l2,
    param_shapes,
    state_view,
)

#: column-parallel (the output dim over tp) and row-parallel (the input dim
#: over tp) dense layers
COLUMN_PARALLEL = ("q", "k", "v", "ffn_in")
ROW_PARALLEL = ("attn_out", "ffn_out")


def param_specs(cfg: BertConfig) -> dict[str, tuple]:
    """State name -> the reference's PartitionSpec as a tuple: column-
    parallel weights ``(None, "tp")`` and biases ``("tp",)``; row-parallel
    weights ``("tp", None)`` with a replicated bias; embeddings, LayerNorm,
    pooler and classifier replicated (``()``)."""
    specs = {}
    for name in param_shapes(cfg):
        parts = name.split(".")
        dense = parts[2] if parts[0] == "layers" and len(parts) == 4 else None
        if dense in COLUMN_PARALLEL:
            specs[name] = (None, "tp") if parts[3] == "w" else ("tp",)
        elif dense in ROW_PARALLEL:
            specs[name] = ("tp", None) if parts[3] == "w" else ()
        else:
            specs[name] = ()
    return specs


def mesh_rows(mesh: Mesh) -> list[list[torch.device]]:
    """The mesh's devices as dp rows, each the row's tp devices (one where
    the mesh has no "tp" axis)."""
    axes = mesh.axis_names
    if "dp" not in axes or set(axes) - {"dp", "tp"}:
        raise ValueError(f"a training mesh has a 'dp' axis and at most a 'tp' axis, not {axes}")
    grid = mesh.devices if "tp" in axes else mesh.devices[:, None]
    if axes == ("tp", "dp"):
        grid = grid.T
    return [list(row) for row in grid]


def lead_device(mesh: Mesh) -> torch.device:
    """Where the master copy, the optimizer's moments and the loss live."""
    return mesh_rows(mesh)[0][0]


def _leaves(state: Mapping, cfg: BertConfig, device: torch.device) -> dict[str, torch.Tensor]:
    check_state(cfg, state)
    missing = [n for n in param_shapes(cfg) if n not in state]
    if missing:
        raise ValueError(f"training needs the f32 weights; missing {missing[:3]}")
    return {n: torch.as_tensor(state[n]).detach().to(device, torch.float32).clone().requires_grad_(True)
            for n in param_shapes(cfg)}


def shard_params(params: Mapping, mesh: Mesh, cfg: BertConfig) -> dict[str, torch.Tensor]:
    """The master copy for ``mesh``: every parameter of ``cfg``'s model as
    a leaf tensor (f32, requiring grad) on the lead device. The dp replicas
    and tp shards that :func:`param_specs` names are made from it in each
    step."""
    return _leaves(params, cfg, lead_device(mesh))


def _as_index(x) -> torch.Tensor:
    return x.long() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).long()


def _embed_views(params: Mapping[str, torch.Tensor], mesh: Mesh | None, sequence_parallel: bool):
    """(home device, weights view, sequence devices) for each dp row."""
    if mesh is None:
        return [(next(iter(params.values())).device, state_view(params), None)]
    rows = []
    for devs in mesh_rows(mesh):
        home = devs[0]
        replica = {n: p.to(home) for n, p in params.items()}
        if len(devs) > 1:
            view = state_view(replica, lambda name, w, b, devs=devs: ShardedDense(
                w, b, devs, "out" if name in COLUMN_PARALLEL else "in"))
        else:
            view = state_view(replica)
        seq = devs if sequence_parallel and "tp" in mesh.axis_names else None
        rows.append((home, view, seq))
    return rows


def _embed(rows, ids, mask, *, cfg: BertConfig, remat: bool, lead: torch.device) -> torch.Tensor:
    """The batch's unit embeddings (B, H) on ``lead``: dp row r embeds the
    r-th slice of the batch on its own devices."""
    outs = []
    for (home, view, seq), ids_r, mask_r in zip(rows, torch.tensor_split(ids, len(rows)),
                                                torch.tensor_split(mask, len(rows))):
        ids_r, mask_r = ids_r.to(home), mask_r.to(home)
        hidden = encoder_forward(view, ids_r, mask_r, cfg=cfg, remat=remat, sequence_devices=seq)
        outs.append(mean_pool_l2(hidden, mask_r).to(lead))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def info_nce_loss(
    params: Mapping[str, torch.Tensor],
    q_ids,
    q_mask,
    d_ids,
    d_mask,
    *,
    cfg: BertConfig,
    temperature: float = 0.05,
    mesh: Mesh | None = None,
    sequence_parallel: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Symmetric in-batch InfoNCE (row i's positive is column i), a 0-d
    tensor on the lead device (``params``' device without a mesh). Each
    cross entropy is optax's: the log-normaliser less the label's logit,
    averaged."""
    lead = lead_device(mesh) if mesh is not None else next(iter(params.values())).device
    rows = _embed_views(params, mesh, sequence_parallel)
    q = _embed(rows, _as_index(q_ids), _as_index(q_mask), cfg=cfg, remat=remat, lead=lead)
    d = _embed(rows, _as_index(d_ids), _as_index(d_mask), cfg=cfg, remat=remat, lead=lead)
    logits = torch.matmul(q, d.T) / temperature
    diag = logits.diagonal()
    loss_qd = (torch.logsumexp(logits, dim=1) - diag).mean()
    loss_dq = (torch.logsumexp(logits, dim=0) - diag).mean()
    return 0.5 * (loss_qd + loss_dq)


class AdamW:
    """optax.adamw(learning_rate, weight_decay=...) on ``torch.optim.AdamW``
    (betas 0.9 / 0.999, eps 1e-8, decay on every leaf). The state is a flat
    dict of tensors, optax's fields by state name: ``count`` (the step, an
    f32 scalar on the CPU, where torch keeps it), ``mu.<name>`` and
    ``nu.<name>`` (the moments, beside each parameter). The torch optimizer
    is built once for a (params, state) pair, its moments being the state's
    tensors; a restore that copies into them is seen through ``count``."""

    def __init__(self, learning_rate: float, weight_decay: float = 0.01) -> None:
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self._bound = None  # (opt_state, params' leaves, torch optimizer)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        state = {"count": torch.zeros((), dtype=torch.float32)}
        for n, p in params.items():
            state[f"mu.{n}"] = torch.zeros_like(p, requires_grad=False)
            state[f"nu.{n}"] = torch.zeros_like(p, requires_grad=False)
        self._bind(params, state)
        return state

    def _bind(self, params: Mapping[str, torch.Tensor], opt_state: dict[str, torch.Tensor]):
        leaves = list(params.values())
        opt = torch.optim.AdamW(leaves, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)
        for n, p in params.items():
            # each parameter its own step tensor: torch adds one to each
            opt.state[p] = {"step": opt_state["count"].clone(), "exp_avg": opt_state[f"mu.{n}"],
                            "exp_avg_sq": opt_state[f"nu.{n}"]}
        self._bound = (opt_state, leaves, opt)
        return opt

    def update(self, params: Mapping[str, torch.Tensor], opt_state: dict[str, torch.Tensor]) -> None:
        """One step, in place, from each parameter's ``.grad``. A parameter
        that received no gradient gets zeros, as ``jax.grad`` gives: its
        moments decay and weight decay still applies, as in optax."""
        bound = self._bound
        leaves = list(params.values())
        if bound is not None and bound[0] is opt_state and len(bound[1]) == len(leaves) and all(
                a is b for a, b in zip(bound[1], leaves)):
            opt = bound[2]
        else:
            opt = self._bind(params, opt_state)
        count = opt_state["count"]
        steps = [opt.state[p]["step"] for p in leaves]
        if not torch.equal(steps[0], count):  # the state was restored in place
            for s in steps:
                s.copy_(count)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        count.copy_(steps[0])


def make_train_state(
    cfg: BertConfig,
    mesh: Mesh,
    *,
    seed: int = 0,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.01,
):
    """(params, opt_state, optimizer) on ``mesh``'s lead device (the card
    unless the mesh is the CPU's): a random model drawn from ``seed`` (the
    port's ``init_params``, not the reference's values)."""
    params = shard_params(init_params(cfg, torch.Generator().manual_seed(seed)), mesh, cfg)
    optimizer = AdamW(learning_rate, weight_decay=weight_decay)
    return params, optimizer.init(params), optimizer


def make_train_step(
    cfg: BertConfig, mesh: Mesh | None, optimizer: AdamW, *,
    sequence_parallel: bool = True, remat: bool = True,
):
    """A full (forward + backward + update) step over ``mesh`` (``None``:
    the params' one device): ``step(params, opt_state, q_ids, q_mask, d_ids,
    d_mask) -> (params, opt_state, loss)``, updating the state in place (the
    reference donates it). ``sequence_parallel`` cuts the residual stream
    over the tp axis (where the mesh has one); ``remat`` recomputes each
    block in the backward pass."""

    def step(params, opt_state, q_ids, q_mask, d_ids, d_mask):
        for p in params.values():
            p.grad = None
        loss = info_nce_loss(params, q_ids, q_mask, d_ids, d_mask, cfg=cfg, mesh=mesh,
                             sequence_parallel=sequence_parallel, remat=remat)
        loss.backward()
        optimizer.update(params, opt_state)
        return params, opt_state, loss.detach()

    return step


def encode_batch(tokenizer, texts, t_pad: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """The fine-tune's batch: every text's token ids and mask padded (or
    cut) to ``t_pad``, (B, t_pad) int32 each."""
    ids = np.zeros((len(texts), t_pad), dtype=np.int32)
    mask = np.zeros((len(texts), t_pad), dtype=np.int32)
    for i, t in enumerate(texts):
        e = tokenizer.encode(t, max_len=t_pad)
        n = min(len(e.input_ids), t_pad)
        ids[i, :n] = e.input_ids[:n]
        mask[i, :n] = e.attention_mask[:n]
    return ids, mask


def finetune_quality_tier(
    embedder,  # rerank.encoder.TransformerEmbedder
    pairs: list[tuple[str, str]],
    *,
    steps: int = 50,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    seed: int = 0,
    mesh: Mesh | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
):
    """Contrastive fine-tuning of a TransformerEmbedder on (query, doc)
    pairs. Returns (a new TransformerEmbedder with the trained weights,
    the losses). It trains on the embedder's device, or over ``mesh``. Each
    text pads to 32 tokens; step i's batch is drawn by
    ``np.random.default_rng([seed, i])``, so a run resumed from
    ``checkpoint_dir`` (saved every ``checkpoint_every`` steps) replays the
    remaining batches. The tuned embedder's id gains ``-tuned`` and its
    revision ``+ft``."""
    from frankensearch_tpu_torch.rerank.encoder import TransformerEmbedder

    cfg, tok = embedder.cfg, embedder.tokenizer
    optimizer = AdamW(learning_rate, weight_decay=0.01)
    state = embedder.model.state_dict()
    params = shard_params(state, mesh, cfg) if mesh is not None else _leaves(state, cfg, embedder.device)
    opt_state = optimizer.init(params)
    start_step = 0
    if checkpoint_dir is not None:
        from frankensearch_tpu_torch.parallel.checkpoint import latest_step, restore_train_state

        if latest_step(checkpoint_dir) is not None:
            params, opt_state, start_step = restore_train_state(checkpoint_dir, params, opt_state, cfg=cfg, mesh=mesh)
    train_step = make_train_step(cfg, mesh, optimizer, sequence_parallel=False, remat=False)

    losses: list[float] = []
    for step_i in range(steps):
        # the batch schedule is a pure function of (seed, step index), so
        # a resumed run replays the exact remaining trajectory
        step_rng = np.random.default_rng([seed, step_i])
        batch_idx = step_rng.choice(len(pairs), size=min(batch_size, len(pairs)), replace=False)
        if step_i < start_step:
            continue
        q_ids, q_mask = encode_batch(tok, [pairs[i][0] for i in batch_idx])
        d_ids, d_mask = encode_batch(tok, [pairs[i][1] for i in batch_idx])
        params, opt_state, loss = train_step(params, opt_state, q_ids, q_mask, d_ids, d_mask)
        losses.append(float(loss))
        if checkpoint_dir is not None and (step_i + 1) % checkpoint_every == 0:
            from frankensearch_tpu_torch.parallel.checkpoint import save_train_state

            save_train_state(checkpoint_dir, params, opt_state, step=step_i + 1, cfg=cfg, mesh=mesh)
    tuned = TransformerEmbedder(
        {n: p.detach().clone() for n, p in params.items()}, cfg, tok, device=embedder.device,
        embedder_id=embedder.embedder_id + "-tuned",
        revision=embedder.revision + "+ft",
        max_tokens=embedder.max_tokens,
    )
    return tuned, losses
