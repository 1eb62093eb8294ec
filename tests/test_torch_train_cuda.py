"""The training path on an NVIDIA GPU, at the 384-wide quality encoder's
shape (vocab 396, H 384, 6 layers, 12 heads, FFN 1536, max_position 128;
``data/quality_encoder_384``'s config) from the port's random init, batch
16 x 32 tokens:

* two identical steps on the card are bitwise equal (loss and weights): the
  backward pass has no order-dependent sums (the embedding gather's
  gradient sums repeated ids in a fixed order);
* a step on a (dp 2, tp 2) mesh of four shards of the card, with sequence
  parallelism and remat, matches the step on a mesh of one: the loss
  within 1e-5 relative, each gradient within 1e-4 of its leaf's largest
  entry plus 1e-6 of the largest entry of all (row-parallel partial sums
  and cuBLAS's choice of GEMM by shape move f32 rounding; the key bias's
  gradient is zero but for rounding, as softmax ignores a shift shared by
  a row's logits), and one AdamW update from the mesh of one's gradients
  gives each mesh's master copy the same weights within 1e-7 plus one f32
  ulp of the weight (the same elementwise arithmetic; a wrong update moves
  a weight by about lr);
* a checkpoint of card state restores onto the card's shards, and the next
  step from it is bitwise the uninterrupted run's.

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch

from frankensearch_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from frankensearch_tpu_torch.parallel.mesh import Mesh
from frankensearch_tpu_torch.parallel.train import AdamW, info_nce_loss, make_train_step, shard_params
from frankensearch_tpu_torch.rerank.bert import BertConfig, init_params

pytestmark = pytest.mark.cuda

CFG = BertConfig(vocab_size=396, hidden=384, layers=6, heads=12, intermediate=1536, max_position=128)
LR = 5e-4
B, T = 16, 32


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from frankensearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.fixture(scope="module")
def state():
    return init_params(CFG, torch.Generator().manual_seed(11))


def batch(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, CFG.vocab_size, size=(B, T))
    d = rng.integers(1, CFG.vocab_size, size=(B, T))
    mask = np.ones((B, T), np.int64)
    mask[:, 12:] = rng.integers(0, 2, size=(B, T - 12))
    return q, mask, d, mask


def mesh_of(dev, dp, tp):
    return Mesh(np.array([dev] * (dp * tp), dtype=object).reshape(dp, tp), ("dp", "tp"))


def one_step(state, mesh, **kw):
    params = shard_params(state, mesh, CFG)
    optimizer = AdamW(LR)
    opt_state = optimizer.init(params)
    params, opt_state, loss = make_train_step(CFG, mesh, optimizer, **kw)(params, opt_state, *batch())
    return params, opt_state, float(loss)


def test_two_identical_steps_are_bitwise_equal(cuda_device, state):
    mesh = mesh_of(cuda_device, 1, 1)
    a, _, la = one_step(state, mesh)
    b, _, lb = one_step(state, mesh)
    assert la == lb
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_mesh_step_matches_the_mesh_of_one(cuda_device, state):
    grads, losses = [], []
    for dp, tp in ((1, 1), (2, 2)):
        mesh = mesh_of(cuda_device, dp, tp)
        params = shard_params(state, mesh, CFG)
        loss = info_nce_loss(params, *batch(), cfg=CFG, mesh=mesh, sequence_parallel=True, remat=True)
        loss.backward()
        losses.append(float(loss))
        grads.append({n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()})
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), losses
    floor = 1e-6 * max(float(g.abs().max()) for g in grads[0].values())
    for name, g in grads[0].items():
        assert float((grads[1][name] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + floor, name
    updated = []
    for dp, tp in ((1, 1), (2, 2)):
        params = shard_params(state, mesh_of(cuda_device, dp, tp), CFG)
        optimizer = AdamW(LR)
        opt_state = optimizer.init(params)
        for name, p in params.items():
            p.grad = grads[0][name].clone()
        optimizer.update(params, opt_state)
        updated.append({n: p.detach() for n, p in params.items()})
    for name, want in updated[0].items():
        assert bool(((updated[1][name] - want).abs() <= 1e-7 + 2.0**-23 * want.abs()).all()), name
    assert all(not torch.equal(w, state[n].to(cuda_device)) for n, w in updated[0].items() if n.endswith(".w"))


def test_checkpoint_restores_onto_the_cards_shards(cuda_device, state, tmp_path):
    mesh = mesh_of(cuda_device, 2, 2)
    params = shard_params(state, mesh, CFG)
    optimizer = AdamW(LR)
    opt_state = optimizer.init(params)
    step = make_train_step(CFG, mesh, optimizer)
    params, opt_state, _ = step(params, opt_state, *batch(0))
    save_train_state(str(tmp_path), params, opt_state, step=1, cfg=CFG, mesh=mesh)
    p_ref, _, loss_ref = step(params, opt_state, *batch(1))
    p_ref = {n: p.detach().clone() for n, p in p_ref.items()}
    like = shard_params(init_params(CFG, torch.Generator().manual_seed(3)), mesh, CFG)
    like_opt = optimizer.init(like)
    got, got_opt, at = restore_train_state(str(tmp_path), like, like_opt, cfg=CFG, mesh=mesh)
    assert at == 1 and all(t.device == cuda_device for t in got.values())
    assert all(t.device == cuda_device for n, t in got_opt.items() if n != "count")
    p_res, _, loss_res = step(got, got_opt, *batch(1))
    assert float(loss_ref) == float(loss_res)
    for name, value in p_ref.items():
        assert torch.equal(value, p_res[name].detach()), name
