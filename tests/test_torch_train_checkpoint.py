"""The port's training checkpoint (``parallel/checkpoint.py``) on the CPU:
the reference's tests/test_train_checkpoint.py (a bitwise resume, the
fail-closed errors, the fine-tune resume) on the port, and its manifest
against the reference's.

The manifest's ``step``, ``config`` and ``mesh`` fields equal the
reference's JSON for the same config and mesh; its fingerprints are over
the port's state names (a declared divergence), so the port refuses the
reference's manifest with a "drift" error, and the reference's own
fingerprint of its state differs from the port's manifest's, which its
restore checks before it reads a tensor (reference checkpoint.py:127).
A resume is bitwise: the resumed run's losses and weights equal the
uninterrupted run's exactly.
"""

import dataclasses
import json
import os

import numpy as np
import optax
import pytest
import torch

from frankensearch_tpu.parallel import checkpoint as rckpt
from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.rerank import bert as rbert
from frankensearch_tpu_torch.core.errors import InvalidConfig
from frankensearch_tpu_torch.parallel.checkpoint import (
    MANIFEST,
    latest_step,
    restore_train_state,
    save_train_state,
)
from frankensearch_tpu_torch.parallel.mesh import make_mesh
from frankensearch_tpu_torch.parallel.train import finetune_quality_tier, make_train_state, make_train_step
from frankensearch_tpu_torch.rerank.bert import BertConfig
from frankensearch_tpu_torch.rerank.encoder import random_transformer_embedder

CPU = torch.device("cpu")
SHAPE = dict(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64, max_position=16)
CFG = BertConfig(**SHAPE)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These shapes are tiny: one intra-op thread keeps them from spinning
    the cores that the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, b=4, t=8):
    ids = rng.integers(0, 64, size=(b, t)).astype(np.int32)
    return ids, np.ones((b, t), dtype=np.int32)


def dp_tp():
    return make_mesh(8, axes=("dp", "tp"), device="cpu")


def test_save_restore_resume_bitwise(tmp_path, rng):
    mesh = dp_tp()
    params, opt_state, optimizer = make_train_state(CFG, mesh)
    step = make_train_step(CFG, mesh, optimizer)
    ids, m = _batch(rng)
    params, opt_state, _ = step(params, opt_state, ids, m, ids, m)
    save_train_state(str(tmp_path), params, opt_state, step=1, cfg=CFG, mesh=mesh)
    ids2, m2 = _batch(rng)
    p_ref, _, loss_ref = step(params, opt_state, ids2, m2, ids2, m2)
    p_ref = {n: p.detach().clone() for n, p in p_ref.items()}

    params2, opt2, _ = make_train_state(CFG, mesh, seed=99)
    params2, opt2, at = restore_train_state(str(tmp_path), params2, opt2, cfg=CFG, mesh=mesh)
    assert at == 1 and float(opt2["count"]) == 1.0
    p_res, _, loss_res = step(params2, opt2, ids2, m2, ids2, m2)
    assert float(loss_ref) == float(loss_res)  # exact resume
    for name, value in p_ref.items():
        assert torch.equal(value, p_res[name].detach()), name
    assert latest_step(str(tmp_path)) == 1


def test_fail_closed_on_config_and_mesh_drift(tmp_path):
    mesh = dp_tp()
    params, opt_state, _ = make_train_state(CFG, mesh)
    save_train_state(str(tmp_path), params, opt_state, step=3, cfg=CFG, mesh=mesh)
    other_cfg = dataclasses.replace(CFG, hidden=64, intermediate=128)
    with pytest.raises(InvalidConfig, match="config mismatch"):
        restore_train_state(str(tmp_path), params, opt_state, cfg=other_cfg, mesh=mesh)
    with pytest.raises(InvalidConfig, match="mesh layout mismatch"):
        restore_train_state(str(tmp_path), params, opt_state, cfg=CFG, mesh=make_mesh(8, device="cpu"))
    with pytest.raises(InvalidConfig, match="no training manifest"):
        restore_train_state(str(tmp_path / "empty"), params, opt_state, cfg=CFG)
    assert latest_step(str(tmp_path / "empty")) is None


def test_corrupt_manifest_fails_closed(tmp_path):
    mesh = dp_tp()
    params, opt_state, _ = make_train_state(CFG, mesh)
    save_train_state(str(tmp_path), params, opt_state, step=1, cfg=CFG, mesh=mesh)
    mpath = os.path.join(str(tmp_path), MANIFEST)
    for field in ("params_fingerprint", "opt_fingerprint"):
        with open(mpath) as f:
            m = json.load(f)
        good, m[field] = m[field], "deadbeef"
        with open(mpath, "w") as f:
            json.dump(m, f)
        with pytest.raises(InvalidConfig, match="drift"):
            restore_train_state(str(tmp_path), params, opt_state, cfg=CFG, mesh=mesh)
        m[field] = good
        with open(mpath, "w") as f:
            json.dump(m, f)
    # a target with another structure is refused too
    del params["pooler.b"]
    with pytest.raises(InvalidConfig, match="drift"):
        restore_train_state(str(tmp_path), params, opt_state, cfg=CFG, mesh=mesh)


def test_manifest_fields_equal_reference_and_each_refuses_the_other(tmp_path):
    """The reference's manifest for its state on its (4, 2) mesh, as its
    ``save_train_state`` writes it (reference checkpoint.py:93-99; the
    orbax directories beside it are not needed: a restore checks the
    manifest first)."""
    rcfg = rbert.BertConfig(**SHAPE)
    rmesh = jmesh.make_mesh(axes=("dp", "tp"))
    rparams = rbert.init_params(rcfg, seed=0)
    ropt = optax.adamw(2e-5, weight_decay=0.01).init(rparams)
    want = {"step": 2, "config": dataclasses.asdict(rcfg), "mesh": rckpt._mesh_layout(rmesh),
            "params_fingerprint": rckpt._tree_fingerprint(rparams), "opt_fingerprint": rckpt._tree_fingerprint(ropt)}
    ref_root = str(tmp_path / "ref")
    os.makedirs(ref_root)
    with open(os.path.join(ref_root, rckpt.MANIFEST), "w") as f:
        json.dump(want, f)
    mesh = dp_tp()
    params, opt_state, _ = make_train_state(CFG, mesh)
    port_root = str(tmp_path / "port")
    save_train_state(port_root, params, opt_state, step=2, cfg=CFG, mesh=mesh)
    with open(os.path.join(port_root, MANIFEST)) as f:
        got = json.load(f)
    assert {k: got[k] for k in ("step", "config", "mesh")} == {k: want[k] for k in ("step", "config", "mesh")}
    assert got["params_fingerprint"] != want["params_fingerprint"]
    assert got["opt_fingerprint"] != want["opt_fingerprint"]
    with pytest.raises(InvalidConfig, match="drift"):
        restore_train_state(ref_root, params, opt_state, cfg=CFG, mesh=mesh)


def test_restore_lands_on_the_targets_devices(tmp_path):
    mesh = dp_tp()
    params, opt_state, _ = make_train_state(CFG, mesh)
    save_train_state(str(tmp_path), params, opt_state, step=1, cfg=CFG, mesh=mesh)
    like, like_opt, _ = make_train_state(CFG, mesh, seed=5)
    ids = {n: id(t) for n, t in like.items()}
    got, got_opt, _ = restore_train_state(str(tmp_path), like, like_opt, cfg=CFG, mesh=mesh)
    assert {n: id(t) for n, t in got.items()} == ids  # restored into the targets
    for name, value in params.items():
        assert torch.equal(got[name].detach(), value.detach()) and got[name].requires_grad
    assert got_opt["count"].device == CPU and all(t.device == mesh.devices.flat[0] for t in got.values())


WORDS = ["query", "document", "alpha", "beta"] + [str(i) for i in range(16)]
PAIRS = [(f"query {i} alpha", f"document {i} alpha beta") for i in range(16)]


@pytest.mark.parametrize("mesh_shards", [0, 4])
def test_finetune_resumes_exact_trajectory(tmp_path, mesh_shards):
    """TestFinetuneResume on the port, on one device and on a (2, 2) mesh:
    bitwise, where the reference holds 1e-6."""
    emb = random_transformer_embedder(WORDS, device=CPU, hidden=32, layers=2, heads=2, seed=0)
    mesh = make_mesh(mesh_shards, axes=("dp", "tp"), device="cpu") if mesh_shards else None
    ck = str(tmp_path / "ck")
    full, ref_losses = finetune_quality_tier(emb, PAIRS, steps=6, batch_size=4, seed=5, mesh=mesh)
    finetune_quality_tier(emb, PAIRS, steps=3, batch_size=4, seed=5, mesh=mesh, checkpoint_dir=ck,
                          checkpoint_every=3)
    resumed, tail_losses = finetune_quality_tier(emb, PAIRS, steps=6, batch_size=4, seed=5, mesh=mesh,
                                                 checkpoint_dir=ck, checkpoint_every=3)
    assert len(tail_losses) == 3 and tail_losses == ref_losses[3:]
    assert latest_step(ck) == 6
    for name, value in full.model.state_dict().items():
        assert torch.equal(value, resumed.model.state_dict()[name]), name
