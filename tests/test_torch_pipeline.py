"""The port's GPipe pipeline (``parallel/pipeline.py``) on the CPU: the
reference's TestPipelineParallel and TestPipelineFaults
(tests/test_parallel.py) on the port, and the port's pipeline against the
reference's.

The weights are the reference's ``init_params``, carried across. Each
stage's layers run ``transformer_layer``, the sequential encoder's block,
on microbatches, so the pipeline equals the port's sequential
``encoder_forward`` and ``embed_forward`` within 2e-5 (the reference's
tolerance; a microbatch's products may take other GEMM shapes), and the
reference's pipeline within the same 2e-5 (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.parallel import pipeline as rpipe
from frankensearch_tpu.rerank import bert as rbert
from frankensearch_tpu_torch.convert import bert_params_from_arrays
from frankensearch_tpu_torch.parallel.mesh import Mesh, make_mesh
from frankensearch_tpu_torch.parallel.pipeline import (
    pipeline_embed_forward,
    pipeline_encoder_forward,
    shard_stacked_layers,
    stack_layer_params,
)
from frankensearch_tpu_torch.rerank.bert import Bert, BertConfig

CPU = torch.device("cpu")
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These shapes are tiny: one intra-op thread keeps them from spinning
    the cores that the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree) -> dict:
    return {keystr(path): np.asarray(leaf) for path, leaf in tree_flatten_with_path(tree)[0]}


def carried(shape: dict, seed: int):
    ref = rbert.init_params(rbert.BertConfig(**shape), seed=seed)
    cfg = BertConfig(**shape)
    return ref, cfg, bert_params_from_arrays(flat(ref), cfg)


def batch(rng, b, t, vocab, ragged=True):
    ids = rng.integers(0, vocab, size=(b, t))
    mask = (rng.random((b, t)) > 0.2).astype(np.int64) if ragged else np.ones((b, t), np.int64)
    mask[:, 0] = 1  # at least one live token per row
    return ids, mask


def test_pipeline_matches_sequential_encoder_and_reference(rng):
    shape = dict(vocab_size=128, hidden=32, layers=8, heads=2, intermediate=64, max_position=16)
    ref, cfg, state = carried(shape, 0)
    mesh = make_mesh(8, axes=("pp",), device="cpu")
    stacked = shard_stacked_layers(stack_layer_params(state), mesh)
    ids, mask = batch(rng, 8, 16, 128)
    tid, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        piped = pipeline_encoder_forward(state, stacked, tid, tmask, cfg=cfg, mesh=mesh, microbatches=4, n_stages=8)
        model = Bert(cfg, state, device=CPU)
        np.testing.assert_allclose(piped.numpy(), model.encoder_forward(tid, tmask).numpy(), rtol=0, atol=TOL)
        pe = pipeline_embed_forward(state, stacked, tid, tmask, cfg=cfg, mesh=mesh, microbatches=4)
        np.testing.assert_allclose(pe.numpy(), model.embed_forward(tid, tmask).numpy(), rtol=0, atol=TOL)
    rmesh = jmesh.make_mesh(axes=("pp",))
    rstacked = rpipe.shard_stacked_layers(rpipe.stack_layer_params(ref["layers"]), rmesh)
    with rmesh:
        want = rpipe.pipeline_encoder_forward(ref, rstacked, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                                              cfg=rbert.BertConfig(**shape), mesh=rmesh, microbatches=4,
                                              n_stages=len(jax.devices()))
    np.testing.assert_allclose(piped.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("stages,layers_per_stage", [(4, 2), (2, 3), (1, 4)])
def test_pipeline_multiple_layers_per_stage(rng, stages, layers_per_stage):
    shape = dict(vocab_size=64, hidden=32, layers=stages * layers_per_stage, heads=2, intermediate=64,
                 max_position=8)
    _, cfg, state = carried(shape, 1)
    # a ("pp", "r") mesh with a replica axis, as the reference's test folds
    # extra devices into one
    mesh = Mesh(np.array([CPU] * (stages * 2), dtype=object).reshape(stages, 2), ("pp", "r"))
    stacked = shard_stacked_layers(stack_layer_params(state), mesh)
    assert len(stacked) == stages and all(len(s["q.w"]) == layers_per_stage for s in stacked)
    ids, mask = batch(rng, 4, 8, 64, ragged=False)
    tid, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        piped = pipeline_encoder_forward(state, stacked, tid, tmask, cfg=cfg, mesh=mesh, microbatches=2,
                                         n_stages=stages)
        want = Bert(cfg, state, device=CPU).encoder_forward(tid, tmask)
    np.testing.assert_allclose(piped.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_stack_layer_params_stacks_each_leaf():
    _, cfg, state = carried(dict(vocab_size=32, hidden=32, layers=3, heads=2, intermediate=64, max_position=8), 0)
    stacked = stack_layer_params(state)
    assert set(stacked) == {k.split(".", 2)[2] for k in state if k.startswith("layers.0.")}
    assert tuple(stacked["ffn_in.w"].shape) == (3, 32, 64)
    assert torch.equal(stacked["q.b"][2], state["layers.2.q.b"])


def test_pipeline_faults():
    shape = dict(vocab_size=32, hidden=32, layers=8, heads=2, intermediate=64, max_position=8)
    _, cfg, state = carried(shape, 0)
    mesh = make_mesh(8, axes=("pp",), device="cpu")
    stacked = shard_stacked_layers(stack_layer_params(state), mesh)
    ids, mask = torch.zeros((5, 8), dtype=torch.int64), torch.ones((5, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="divisible"):  # 5 % 2 != 0
        pipeline_encoder_forward(state, stacked, ids, mask, cfg=cfg, mesh=mesh, microbatches=2, n_stages=8)
    with pytest.raises(ValueError, match="n_stages"):
        pipeline_encoder_forward(state, stacked, ids[:4], mask[:4], cfg=cfg, mesh=mesh, microbatches=2, n_stages=4)
    with pytest.raises(ValueError, match="divisible"):  # 8 layers over 3 stages
        shard_stacked_layers(stack_layer_params(state), make_mesh(3, axes=("pp",), device="cpu"))
