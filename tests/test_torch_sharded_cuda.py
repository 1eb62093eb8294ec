"""The mesh-sharded serving path on an NVIDIA GPU: four shards on one card.

A ``ShardedDeviceVectorIndex`` over a mesh of the one card four times
holds 100,000 x 256 seeded unit rows (4 x 32,768 padded rows, each shard
8192-row aligned) and serves ``auto`` (K1 + K2 per shard) at B = 256, 8
and 1: rows and score bits equal the single-device index's on the same
rows, and each scan launches K1 and K2 once per shard. The int8 lane (K4 +
K2-i8 per shard) scores every row both indexes return with the same bits,
and its top-k is at least the single-device lane's (each shard's group
overfetch covers the global top groups that lie in it). The block-sharded
BM25 arm on the card equals its CPU twin and the card's single-device
pruned lane (a one-shard mesh) bit for bit, and the sharded fused lane's
device RRF equals the host RRF oracle.

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sharded_cuda.py
"""

import numpy as np
import pytest
import torch

from frankensearch_tpu_torch import BulkDeviceBm25Index, HashEmbedder, TwoTierConfig, TwoTierSearcher
from frankensearch_tpu_torch.core.types import IndexableDocument
from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity
from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
from frankensearch_tpu_torch.lexical import device_bm25 as tbm
from frankensearch_tpu_torch.ops import topk_scan
from frankensearch_tpu_torch.parallel.mesh import Mesh
from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

pytestmark = pytest.mark.cuda

ROWS, DIM, SHARDS, K = 100_000, 256, 4, 10


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from frankensearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def unit(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, DIM), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def pair(cuda_device):
    vecs = unit(ROWS, 1)
    ids = [f"d{i}" for i in range(ROWS)]
    identity = EmbeddingIdentity(embedder_id="seeded", dim=DIM)
    mesh = Mesh([cuda_device] * SHARDS, ("d",))
    sharded = ShardedDeviceVectorIndex(vecs, ids, identity, mesh=mesh)
    single = DeviceVectorIndex(vecs, ids, identity, device=cuda_device)
    assert sharded.n_pad == SHARDS * 32_768 and sharded.local_rows % 8192 == 0
    assert all(s.data_ptr() == sharded.slab[i * sharded.local_rows:].data_ptr()
               for i, s in enumerate(sharded._slab_shards))  # views, no copies
    return sharded, single, vecs


@pytest.mark.parametrize("b", [256, 8, 1])
def test_bf16_bitwise_single_device(pair, b):
    sharded, single, _ = pair
    q = unit(b, 2 + b)
    topk_scan.group_max.launches = topk_scan.gather_rescore.launches = 0
    got = sharded.search_batch(q, K)
    torch.cuda.synchronize()
    assert (topk_scan.group_max.launches, topk_scan.gather_rescore.launches) == (SHARDS, SHARDS)
    want = single.search_batch(q, K)
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32))


@pytest.mark.parametrize("b", [256, 8])
def test_int8_rows_score_the_same_bits(pair, b):
    sharded, single, vecs = pair
    q = unit(b, 40 + b)
    topk_scan.group_max_int8.launches = topk_scan.gather_rescore_i8.launches = 0
    got = sharded.search_batch(q, K, mode="int8")
    torch.cuda.synchronize()
    assert (topk_scan.group_max_int8.launches, topk_scan.gather_rescore_i8.launches) == (SHARDS, SHARDS)
    want = single.search_batch(q, K, mode="int8")
    gs, gi, ws, wi = (t.cpu().numpy() for t in (got.scores, got.indices, want.scores, want.indices))
    assert (gs >= ws).all()  # a superset of the single-device candidates
    for r in range(b):
        common = {int(i): s for i, s in zip(gi[r], gs[r])}
        for i, s in zip(wi[r], ws[r]):
            if int(i) in common:
                assert np.float32(common[int(i)]).view(np.uint32) == np.float32(s).view(np.uint32)
    exact = (q @ vecs.T).argsort(axis=1)[:, ::-1][:, :K]
    recall = np.mean([len(set(gi[r]) & set(exact[r])) / K for r in range(b)])
    assert recall >= 0.97, recall


def corpus(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(600)]
    p = 1.0 / np.arange(1, 601) ** 1.1
    p /= p.sum()
    return [IndexableDocument(doc_id=f"doc-{i:05d}", content=" ".join(rng.choice(vocab, size=int(rng.integers(3, 30)), p=p)))
            for i in range(n)]


QUERIES = ["w1 w2", "w5", "w100 w3 w7", "w42 w43 w44", "w0 w0 w1", "w599", "nothing", "w7 w1 w300"]


def test_bm25_arm_equals_cpu_and_own_pruned_lane(cuda_device):
    docs = corpus()
    card = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(docs, device=cuda_device), Mesh([cuda_device] * SHARDS, ("d",)))
    cpu = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(docs, device=torch.device("cpu")),
                                     Mesh([torch.device("cpu")] * SHARDS, ("d",)))
    one = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(docs, device=cuda_device), Mesh([cuda_device], ("d",)))

    def bits(rows):
        return [[(c.doc_id, np.float32(c.score).view(np.uint32)) for c in r] for r in rows]

    for k in (1, 30):
        got = card.search_candidates_batch(QUERIES, k)
        assert bits(got) == bits(cpu.search_candidates_batch(QUERIES, k))
        assert bits(got) == bits(one.search_candidates_batch(QUERIES, k))
        assert card.last_blocks_skipped >= 0 and any(got)
    assert tbm.BLOCKED_THRESHOLD_POSTINGS > sum(len(d.content.split()) for d in docs)


def test_sharded_fused_lane_device_rrf_equals_host_oracle(cuda_device, tmp_path):
    docs = corpus(3000, seed=9)
    emb = HashEmbedder(dim=DIM)
    idx = TwoTierIndex.create(str(tmp_path), emb.embed_batch([d.content for d in docs]), [d.doc_id for d in docs],
                              emb.identity(), device=cuda_device)
    mesh = Mesh([cuda_device] * SHARDS, ("d",))
    idx.fast = ShardedDeviceVectorIndex(idx.fast.vectors_f32(), idx.fast.doc_ids, emb.identity(), mesh=mesh,
                                        normalize=False)
    lex = ShardedBulkDeviceBm25Index(BulkDeviceBm25Index(docs, device=cuda_device), mesh)
    s = TwoTierSearcher(idx, emb, lexical=lex, config=TwoTierConfig(fast_only=True))
    topk_scan.group_max.launches = 0
    outs = s.search_batch(QUERIES, k=K)
    assert s.last_phase1_lex_lane == "sharded" and s.last_fusion_path == "device"
    assert topk_scan.group_max.launches == SHARDS
    s._device_rrf_tail = lambda *a: (None, None)
    oracle = s.search_batch(QUERIES, k=K)
    assert s.last_fusion_path == "host_vectorized"
    assert [[(r.doc_id, r.score) for r in o.results] for o in outs] == \
        [[(r.doc_id, r.score) for r in o.results] for o in oracle]
