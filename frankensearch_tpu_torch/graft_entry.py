"""A compile-and-run check of the flagship path and a multi-device dry run.

Port of the repository's ``__graft_entry__.py`` (a module of the port's
package; it runs on the card unless the caller asks for the CPU).

``entry()`` -> (fn, example_args): the flagship forward, a MiniLM-shape
query embedding (6 layers, H 384, 12 heads, vocab 30522; random weights)
then the plain scan and top-k over a 2,048-row bf16 slab.

``dryrun_multichip(n_devices)`` exercises every parallelism mode the port
ships over a mesh of ``n_devices`` shards of one device (shards share it):

1. the contrastive training step over a ("dp", "tp") mesh: data-parallel
   batch, column/row tensor-parallel weights and sequence parallelism;
2. the GPipe pipeline-parallel encoder forward over a ("pp",) mesh, held to
   the sequential encoder within 2e-5;
3. the document-sharded scan over a ("d",) mesh with its exact top-k merge;
4. the block-sharded BM25 arm over the same mesh, equal to the single-device
   arm;
5. the serving path on the mesh: the sharded fused phase 1 (the sharded
   scan and the sharded BM25 arm) with the device RRF tail, (doc_id, score)
   equal to the single-device searcher's on the plain scan lane (as the
   reference holds its sharded lane to ``use_pallas=False``).

The reference re-executes its dry run in a child process to provision
virtual CPU devices before jax starts; shards of one device need no such
step here.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(search_forward, (model, input_ids, attention_mask, slab)) on
    ``device``: ``search_forward(*args)`` embeds 8 queries of 64 tokens and
    returns their top 10 rows of the slab."""
    from frankensearch_tpu_torch.device import resolve_device
    from frankensearch_tpu_torch.ops.topk_scan import scan_topk_xla
    from frankensearch_tpu_torch.rerank.bert import Bert, BertConfig, init_params

    dev = resolve_device(device)
    cfg = BertConfig()
    model = Bert(cfg, init_params(cfg, torch.Generator().manual_seed(0)), device=dev)
    rng = np.random.default_rng(0)
    n_docs, b, t, k = 2048, 8, 64, 10
    slab = rng.standard_normal((n_docs, cfg.hidden)).astype(np.float32)
    slab /= np.linalg.norm(slab, axis=1, keepdims=True)
    slab_dev = torch.from_numpy(slab).to(dev, torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, t))).to(dev)
    mask = torch.ones((b, t), dtype=torch.int64, device=dev)

    def search_forward(model, input_ids, attention_mask, slab):
        """Flagship forward: embed the queries on the device, scan the slab, top-k."""
        q = model.embed_forward(input_ids, attention_mask)
        return scan_topk_xla(slab, q, k)

    return search_forward, (model, ids, mask, slab_dev)


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """Run the five parts over meshes of ``n_devices`` shards of
    ``device``; any failed check raises. Returns the training loss and each
    part's seconds."""
    import time

    from frankensearch_tpu_torch.device import resolve_device
    from frankensearch_tpu_torch.parallel.mesh import Mesh

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out: dict = {}

    # 1. the training step over a (dp, tp) mesh
    from frankensearch_tpu_torch.parallel.train import make_train_state, make_train_step
    from frankensearch_tpu_torch.rerank.bert import BertConfig

    t0 = time.perf_counter()
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = Mesh(np.array([dev] * n_devices, dtype=object).reshape(n_devices // tp, tp), ("dp", "tp"))
    cfg = BertConfig(vocab_size=256, hidden=64, layers=2, heads=4, intermediate=128, max_position=32)
    params, opt_state, optimizer = make_train_state(cfg, mesh)
    step = make_train_step(cfg, mesh, optimizer)
    b, t = mesh.shape["dp"] * 2, 16
    ids = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    m = np.ones((b, t), dtype=np.int32)
    params, opt_state, loss = step(params, opt_state, ids, m, ids, m)
    out["train_loss"] = float(loss)
    if not np.isfinite(out["train_loss"]):
        raise AssertionError(f"the mesh training step's loss is {out['train_loss']}")
    out["train_s"] = time.perf_counter() - t0

    # 2. the pipeline-parallel encoder forward over a ("pp",) mesh
    from frankensearch_tpu_torch.parallel.pipeline import (
        pipeline_encoder_forward,
        shard_stacked_layers,
        stack_layer_params,
    )
    from frankensearch_tpu_torch.rerank.bert import Bert, init_params

    t0 = time.perf_counter()
    pp_mesh = Mesh([dev] * n_devices, ("pp",))
    pp_cfg = BertConfig(vocab_size=128, hidden=32, layers=n_devices, heads=2, intermediate=64, max_position=16)
    pp_params = {n: p.to(dev) for n, p in init_params(pp_cfg, torch.Generator().manual_seed(1)).items()}
    stacked = shard_stacked_layers(stack_layer_params(pp_params), pp_mesh)
    ids_pp = torch.from_numpy(rng.integers(0, 128, size=(4, 16))).to(dev)
    mask_pp = torch.ones((4, 16), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        piped = pipeline_encoder_forward(pp_params, stacked, ids_pp, mask_pp, cfg=pp_cfg, mesh=pp_mesh,
                                         microbatches=2, n_stages=n_devices)
        ref = Bert(pp_cfg, pp_params, device=dev).encoder_forward(ids_pp, mask_pp)
    err = float((piped - ref).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"the pipeline-parallel forward is {err:.3e} from the sequential encoder")
    out["pipeline_max_abs_err"] = err
    out["pipeline_s"] = time.perf_counter() - t0

    # 3. the document-sharded scan over a ("d",) mesh
    from frankensearch_tpu_torch.parallel.sharded_scan import shard_slab, sharded_scan_topk

    t0 = time.perf_counter()
    scan_mesh = Mesh([dev] * n_devices, ("d",))
    n_docs, d, bq, k = n_devices * 64, 128, 4, 5
    slab = rng.standard_normal((n_docs, d)).astype(np.float32)
    slab /= np.linalg.norm(slab, axis=1, keepdims=True)
    slab_sh, mask_sh = shard_slab(slab, scan_mesh.shard_devices("d"))
    q = slab[:bq] + 0.01 * rng.standard_normal((bq, d)).astype(np.float32)
    res = sharded_scan_topk(slab_sh, mask_sh, torch.from_numpy(q).to(dev), k)
    if not (res.indices[:, 0].cpu().numpy() == np.arange(bq)).all():
        raise AssertionError("the sharded top-1 missed a perturbed source row")
    out["sharded_scan_s"] = time.perf_counter() - t0

    # 4. the block-sharded BM25 arm over the same mesh
    from frankensearch_tpu_torch.core.types import IndexableDocument
    from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
    from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index

    t0 = time.perf_counter()
    words = ["alpha", "beta", "gamma", "delta", "epsilon"]
    docs = [IndexableDocument(doc_id=f"d{i:03d}", content=" ".join(rng.choice(words, size=8)) + f" tag{i % 7}")
            for i in range(96)]
    single_arm = BulkDeviceBm25Index(docs, device=dev)
    sharded_arm = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(docs, device=dev), scan_mesh)
    for query in ("alpha beta", "gamma tag3"):
        got = [(c.doc_id, round(c.score, 5)) for c in sharded_arm.search_candidates(query, 5)]
        want = [(c.doc_id, round(c.score, 5)) for c in single_arm.search_candidates(query, 5)]
        if got != want:
            raise AssertionError(f"sharded BM25 diverged on {query!r}: {got} != {want}")
    out["sharded_bm25_s"] = time.perf_counter() - t0

    # 5. the serving path on the mesh: the sharded fused phase 1 with the
    #    device RRF tail, against the single-device searcher on the plain
    #    scan lane (scan_mode "xla": no hand-written scan kernel)
    import tempfile

    from frankensearch_tpu_torch.core.config import TwoTierConfig
    from frankensearch_tpu_torch.embed.hash_embedder import HashEmbedder
    from frankensearch_tpu_torch.fusion.searcher import TwoTierSearcher
    from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
    from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

    t0 = time.perf_counter()
    emb = HashEmbedder(dim=64)
    vecs = emb.embed_batch([doc.content for doc in docs])
    with tempfile.TemporaryDirectory() as root:
        TwoTierIndex.create(root, vecs, [doc.doc_id for doc in docs], emb.identity(), device=dev)
        plain_s = TwoTierSearcher(TwoTierIndex.open(root, device=dev), emb, lexical=single_arm,
                                  config=TwoTierConfig(fast_only=True, scan_mode="xla"))
        sharded_fast = ShardedDeviceVectorIndex(vecs, [doc.doc_id for doc in docs], emb.identity(), mesh=scan_mesh)
        fused_s = TwoTierSearcher(TwoTierIndex(sharded_fast), emb, lexical=sharded_arm,
                                  config=TwoTierConfig(fast_only=True))
        queries = ["alpha beta", "gamma tag3"]
        outs = fused_s.search_batch(queries, k=5)
        if fused_s.last_phase1_lex_lane != "sharded" or fused_s.last_fusion_path != "device":
            raise AssertionError(f"the batch took lane {fused_s.last_phase1_lex_lane!r}, fusion "
                                 f"{fused_s.last_fusion_path!r}, not the sharded fused lane with the device RRF")
        for query, o in zip(queries, outs):
            want = [(r.doc_id, r.score) for r in plain_s.search(query, k=5).results]
            got = [(r.doc_id, r.score) for r in o.results]
            if got != want:
                raise AssertionError(f"the sharded fused lane diverged on {query!r}: {got} != {want}")
        fused_s.close()
        plain_s.close()
    out["fused_phase1_s"] = time.perf_counter() - t0
    return out
