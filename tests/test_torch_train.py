"""The port's training step (``parallel/train.py``) against the JAX reference,
on the CPU.

Each state is the reference's ``init_params`` (and its optax adamw state)
carried across with ``convert.train_state_from_arrays``; the port's own
``init_params`` draws other values (a declared divergence). Sizes are the
reference tests': hidden 32, 2 layers, 2 heads; the mesh is (dp 4, tp 2)
of CPU shards, as conftest's 8 virtual devices give the reference.
Tolerances, port vs reference on the same state and batch:

* the InfoNCE loss within 1e-6 relative (f32 sums in other orders, then
  logits scaled by 1 / 0.05);
* gradients within 1e-6 absolute on every layer's leaves; the embedding
  tables within 5e-6 of each table's largest entry, since a row's gradient
  sums every token that reads it (token_type's row 0: all B x T tokens);
* with ``remat`` the port's gradients are bitwise its plain ones;
* one and two mesh steps (lr 1e-3): the first step's loss within 1e-6
  relative, the second's (after an update from gradients that differ by
  f32 rounding) within 1e-5, params within 1e-5 (Adam's first steps move
  each weight by about lr times the sign of its gradient, so rounding noise
  in a gradient near zero would show as a jump of order lr; none does at
  these seeds);
* ``sequence_parallel`` on equals off bit for bit (the cut stream is
  copied, never summed);
* the optimizer's update from identical gradients within 1e-7 of optax's,
  or one f32 ulp where a weight is near 1 (the LayerNorm scales; optax adds
  the decay to the update, torch scales the weight first);
* ``finetune_quality_tier``'s first 6 losses within 1e-5 relative.
"""

import functools

import numpy as np
import optax
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path
import jax
import jax.numpy as jnp

from frankensearch_tpu.parallel import mesh as jmesh
from frankensearch_tpu.parallel import train as rtrain
from frankensearch_tpu.rerank import bert as rbert
from frankensearch_tpu.rerank import encoder as renc
from frankensearch_tpu_torch.convert import bert_params_from_arrays, train_state_from_arrays
from frankensearch_tpu_torch.parallel import train as ptrain
from frankensearch_tpu_torch.parallel.mesh import make_mesh
from frankensearch_tpu_torch.rerank.bert import BertConfig, port_name
from frankensearch_tpu_torch.rerank.encoder import TransformerEmbedder, random_transformer_embedder
from frankensearch_tpu_torch.rerank.tokenizer import WordPieceTokenizer

CPU = torch.device("cpu")
SHAPE = dict(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64, max_position=16)
RCFG, PCFG = rbert.BertConfig(**SHAPE), BertConfig(**SHAPE)
LOSS_RTOL = 1e-6
GRAD_ATOL, EMB_GRAD_REL = 1e-6, 5e-6


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


def batch(seed=42, b=8, t=8):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 64, size=(b, t)).astype(np.int32)
    d = rng.integers(0, 64, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[:, 5:] = rng.integers(0, 2, size=(b, t - 5))
    return q, mask, d, mask


@pytest.fixture(scope="module")
def ref_params():
    return rbert.init_params(RCFG, seed=0)


def port_leaves(ref_params, mesh):
    return ptrain.shard_params(bert_params_from_arrays(flat(ref_params), PCFG), mesh, PCFG)


def grads_of(params) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy() for n, p in params.items()}


def test_param_specs_equal_reference():
    for shape in (SHAPE, dict(SHAPE, layers=3)):
        ref = flat_specs = {keystr(path): tuple(spec) for path, spec in tree_flatten_with_path(
            rtrain.param_specs(rbert.BertConfig(**shape)), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        got = ptrain.param_specs(BertConfig(**shape))
        assert {port_name(k): v for k, v in flat_specs.items()} == got and len(got) == len(ref)


@pytest.fixture(scope="module")
def ref_loss_grads(ref_params):
    args = tuple(jnp.asarray(x) for x in batch())
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(rtrain.info_nce_loss, cfg=RCFG)))(ref_params, *args)
    return float(loss), flat(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_reference(ref_params, ref_loss_grads, remat):
    mesh = make_mesh(1, axes=("dp",), device="cpu")
    params = port_leaves(ref_params, mesh)
    loss = ptrain.info_nce_loss(params, *batch(), cfg=PCFG, mesh=mesh, remat=remat)
    loss.backward()
    want_loss, want_grads = ref_loss_grads
    loss = float(loss)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    got = grads_of(params)
    for key, want in want_grads.items():
        name = port_name(key)
        tol = EMB_GRAD_REL * float(np.abs(want).max()) if name.startswith("embeddings.") else GRAD_ATOL
        np.testing.assert_allclose(got[name], want, rtol=0, atol=tol, err_msg=name)


def test_remat_gradients_are_bitwise_the_plain_ones(ref_params):
    mesh = make_mesh(8, axes=("dp", "tp"), device="cpu")
    out = []
    for remat in (False, True):
        params = port_leaves(ref_params, mesh)
        ptrain.info_nce_loss(params, *batch(), cfg=PCFG, mesh=mesh, sequence_parallel=True, remat=remat).backward()
        out.append(grads_of(params))
    for name in out[0]:
        np.testing.assert_array_equal(out[0][name], out[1][name], err_msg=name)


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's (4, 2) mesh state and its two make_train_step steps."""
    mesh = jmesh.make_mesh(axes=("dp", "tp"))
    with mesh:
        params, opt_state, optimizer = rtrain.make_train_state(RCFG, mesh, learning_rate=1e-3)
        start = (flat(params), flat(opt_state[0].mu), flat(opt_state[0].nu), int(opt_state[0].count))
        step = rtrain.make_train_step(RCFG, mesh, optimizer)
        # the optimizer's count replicated over the mesh (as the reference's
        # restore places it) and each step's outputs put back on its inputs'
        # shardings, so the second step reuses the first one's program
        replicated = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        opt_state = jax.tree.map(lambda x: x if isinstance(x.sharding, jax.sharding.NamedSharding)
                                 else jax.device_put(x, replicated), opt_state)
        placed = lambda new, old: jax.tree.map(lambda n, o: jax.device_put(n, o.sharding), new, old)
        losses, after = [], []
        for _ in range(2):
            new_params, new_opt, loss = step(params, opt_state, *batch())
            params, opt_state = placed(new_params, params), placed(new_opt, opt_state)
            losses.append(float(loss))
            after.append(flat(params))
    return start, losses, after


def port_steps(start, *, sequence_parallel=True, remat=True, shards=8):
    mesh = make_mesh(shards, axes=("dp", "tp"), device="cpu")
    state, opt_state = train_state_from_arrays(*start, PCFG, device=CPU)
    params = ptrain.shard_params(state, mesh, PCFG)
    optimizer = ptrain.AdamW(1e-3)
    step = ptrain.make_train_step(PCFG, mesh, optimizer, sequence_parallel=sequence_parallel, remat=remat)
    losses, after = [], []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, *batch())
        losses.append(float(loss))
        after.append({n: p.detach().numpy().copy() for n, p in params.items()})
    assert float(opt_state["count"]) == 2.0
    return losses, after


def test_mesh_steps_match_reference(ref_steps):
    start, want_losses, want_after = ref_steps
    losses, after = port_steps(start)
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[1], want_losses[1], rtol=1e-5)
    for got, want in zip(after, want_after):
        for key, value in want.items():
            np.testing.assert_allclose(got[port_name(key)], value, rtol=0, atol=1e-5, err_msg=key)


def test_sequence_parallel_and_mesh_shape_change_no_bits(ref_steps):
    start = ref_steps[0]
    on = port_steps(start, sequence_parallel=True, remat=False)
    off = port_steps(start, sequence_parallel=False, remat=False)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # a mesh of 1 sums the same gradients in fewer parts: within f32 rounding
    one = port_steps(start, shards=1)
    np.testing.assert_allclose(one[0], on[0], rtol=1e-5)


def test_optimizer_update_matches_optax(ref_params):
    rng = np.random.default_rng(7)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01 for k, v in flat(ref_params).items()}
    grads[next(iter(grads))][:] = 0.0  # a leaf without gradient still decays
    opt = optax.adamw(1e-4, weight_decay=0.01)
    ref = ref_params
    ref_state = opt.init(ref)
    ref_update = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(*opt.update(g, st, p)))
    tree_grads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(ref),
                                              [jnp.asarray(grads[keystr(p)]) for p, _ in tree_flatten_with_path(ref)[0]])
    mesh = make_mesh(1, axes=("dp",), device="cpu")
    params = port_leaves(ref_params, mesh)
    adamw = ptrain.AdamW(1e-4, weight_decay=0.01)
    opt_state = adamw.init(params)
    for _ in range(3):
        ref, ref_state = ref_update(tree_grads, ref_state, ref)
        for key, g in grads.items():
            params[port_name(key)].grad = torch.from_numpy(g.copy())
        adamw.update(params, opt_state)
        for key, want in flat(ref).items():
            np.testing.assert_allclose(params[port_name(key)].detach().numpy(), want, rtol=2.0**-23, atol=1e-7,
                                       err_msg=key)
    assert float(opt_state["count"]) == int(ref_state[0].count) == 3
    for key, want in flat(ref_state[0].mu).items():
        np.testing.assert_allclose(opt_state[f"mu.{port_name(key)}"].numpy(), want, rtol=1e-6, atol=1e-12)


def test_train_state_carried_across(ref_params):
    opt_state = optax.adamw(1e-3).init(ref_params)[0]
    state, opt = train_state_from_arrays(flat(ref_params), flat(opt_state.mu), flat(opt_state.nu),
                                         opt_state.count, PCFG, device=CPU)
    assert set(opt) == {"count"} | {f"mu.{n}" for n in state} | {f"nu.{n}" for n in state}
    assert opt["count"].dtype == torch.float32 and float(opt["count"]) == 0.0
    with pytest.raises(KeyError, match="differ from the params"):
        train_state_from_arrays(flat(ref_params), {}, flat(opt_state.nu), 0, PCFG, device=CPU)


WORDS = ["query", "document", "alpha", "beta"] + [str(i) for i in range(16)]
PAIRS = [(f"query {i} alpha", f"document {i} alpha beta") for i in range(16)]


def port_embedder(ref_emb) -> TransformerEmbedder:
    """The reference embedder's weights, vocabulary and identity, in the port."""
    cfg = BertConfig(**{f: getattr(ref_emb.cfg, f) for f in BertConfig.__dataclass_fields__})
    tok = WordPieceTokenizer(dict(ref_emb.tokenizer.vocab), max_len=ref_emb.tokenizer.max_len)
    return TransformerEmbedder(bert_params_from_arrays(flat(ref_emb.params), cfg), cfg, tok, device=CPU,
                               embedder_id=ref_emb.embedder_id, revision=ref_emb.revision,
                               max_tokens=ref_emb.max_tokens)


def test_finetune_losses_match_reference():
    ref_emb = renc.random_transformer_embedder(WORDS, hidden=32, layers=1, heads=2, seed=0)
    _, want = rtrain.finetune_quality_tier(ref_emb, PAIRS, steps=6, batch_size=4, seed=5)
    tuned, got = ptrain.finetune_quality_tier(port_embedder(ref_emb), PAIRS, steps=6, batch_size=4, seed=5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tuned.embedder_id == ref_emb.embedder_id + "-tuned" and tuned.revision == ref_emb.revision + "+ft"
    assert tuned.max_tokens == ref_emb.max_tokens and tuned.device == CPU


FT_WORDS = ["red", "blue", "green", "cat", "dog", "bird", "fast", "slow", "big", "small"]
FT_PAIRS = [
    ("red cat", "the red cat sat"),
    ("blue dog", "a blue dog ran"),
    ("green bird", "green bird flying high"),
    ("fast cat", "fast cat chasing"),
    ("slow dog", "slow dog sleeping"),
    ("big bird", "big bird watching"),
    ("small cat", "small cat hiding"),
    ("red dog", "red dog barking"),
]


def test_finetune_loss_decreases_and_retrieval_improves():
    """tests/test_finetune.py on the port."""
    base = random_transformer_embedder(
        FT_WORDS + ["the", "sat", "a", "ran", "flying", "high", "chasing", "sleeping", "watching", "hiding",
                    "barking"],
        device=CPU, hidden=32, layers=1, heads=2, seed=4,
    )
    tuned, losses = ptrain.finetune_quality_tier(base, FT_PAIRS, steps=60, batch_size=8, learning_rate=3e-3, seed=0)
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert tail < head * 0.9, (head, tail)
    assert tuned.embedder_id.endswith("-tuned")
    queries, docs = [q for q, _ in FT_PAIRS], [d for _, d in FT_PAIRS]

    def accuracy(emb):
        sims = emb.embed_batch(queries) @ emb.embed_batch(docs).T
        return float(np.mean(np.argmax(sims, axis=1) == np.arange(len(FT_PAIRS))))

    assert accuracy(tuned) >= accuracy(base)
    assert accuracy(tuned) >= 0.5


def test_finetune_on_a_mesh_matches_one_device():
    emb = random_transformer_embedder(WORDS, device=CPU, hidden=32, layers=2, heads=2, seed=0)
    _, one = ptrain.finetune_quality_tier(emb, PAIRS, steps=3, batch_size=8, seed=5)
    mesh = make_mesh(4, axes=("dp", "tp"), device="cpu")
    tuned, meshed = ptrain.finetune_quality_tier(emb, PAIRS, steps=3, batch_size=8, seed=5, mesh=mesh)
    np.testing.assert_allclose(meshed, one, rtol=LOSS_RTOL)
    assert tuned.device == CPU


def test_dryrun_multichip_on_cpu_shards():
    from frankensearch_tpu_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert np.isfinite(out["train_loss"]) and out["pipeline_max_abs_err"] <= 2e-5


def test_entry_embeds_and_scans():
    from frankensearch_tpu_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    res = fn(*args)
    assert tuple(res.scores.shape) == (8, 10) and (res.indices >= 0).all()
