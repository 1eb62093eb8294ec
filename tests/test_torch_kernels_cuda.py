"""The port on an NVIDIA GPU: kernels K1/K2 against their plain twins, and
the deterministic lanes (dense BM25, device RRF) bitwise against the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1/K2 vs twin 1e-5 relative (bf16 products are exact; the
tensor-core and warp sums run in another order than the twins'); the BM25
and RRF lanes are order-pinned f32 adds, so GPU and CPU agree bit for bit.
"""

import numpy as np
import pytest
import torch

from frankensearch_tpu.core.types import IndexableDocument
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index
from frankensearch_tpu_torch.ops import device_rrf, topk_scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from frankensearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b", [1, 8, 70])
def test_kernels_match_twins(cuda_device, b, dtype):
    gen = torch.Generator(device="cpu").manual_seed(b)
    slab = torch.randn(16384, 256, generator=gen)
    slab = (slab / slab.norm(dim=1, keepdim=True)).to(cuda_device, dtype)
    q = torch.randn(b, 256, generator=gen).to(cuda_device)
    mask = torch.zeros(16384, device=cuda_device)
    mask[16000:] = float("-inf")
    launches = (topk_scan.group_max.launches, topk_scan.gather_rescore.launches)
    gm, gp = topk_scan.group_max(slab, q, mask), topk_scan.group_max_plain(slab, q, mask)
    torch.testing.assert_close(gm, gp, rtol=1e-5, atol=1e-5)
    groups = torch.topk(gm, 12, dim=1).indices.to(torch.int32)
    r = topk_scan.gather_rescore(slab, q, groups)
    torch.testing.assert_close(r, topk_scan.gather_rescore_plain(slab, q, groups), rtol=1e-5, atol=1e-5)
    assert (topk_scan.group_max.launches, topk_scan.gather_rescore.launches) == (
        launches[0] + 1, launches[1] + 1,
    )
    hier = topk_scan.scan_topk_hierarchical(slab, q, 10, mask)
    plain = topk_scan.scan_topk_xla(slab, q, 10, mask)
    torch.testing.assert_close(hier.scores, plain.scores, rtol=1e-5, atol=1e-5)


def test_kernels_reject_unsupported_operands(cuda_device):
    slab = torch.zeros(256, 64, device=cuda_device)  # f32 slab
    with pytest.raises(NotImplementedError):
        topk_scan.group_max(slab, torch.zeros(1, 64, device=cuda_device), torch.zeros(256, device=cuda_device))


def test_dense_bm25_bitwise_cpu_vs_gpu(cuda_device):
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(200)]
    p = 1.0 / np.arange(1, 201) ** 1.1
    p /= p.sum()
    docs = [
        IndexableDocument(doc_id=f"d{i:04d}", content=" ".join(rng.choice(words, size=30, p=p)))
        for i in range(300)
    ]
    queries = ["w1 w2", "w3", "w50 w7 w9", "w0 w11 w12 w13"]
    cpu = BulkDeviceBm25Index(docs, device=torch.device("cpu"))
    gpu = BulkDeviceBm25Index(docs, device=cuda_device)
    want = [[(c.doc_id, c.score) for c in r] for r in cpu.search_candidates_batch(queries, 25)]
    got = [[(c.doc_id, c.score) for c in r] for r in gpu.search_candidates_batch(queries, 25)]
    assert got == want


def test_device_rrf_bitwise_cpu_vs_gpu(cuda_device):
    rng = np.random.default_rng(5)
    b, kl, kv, n = 16, 30, 30, 400
    lex_i = np.stack([rng.choice(n, kl, replace=False) for _ in range(b)]).astype(np.int32)
    lex_s = np.sort(rng.uniform(0.1, 9.0, (b, kl)).astype(np.float32), axis=1)[:, ::-1].copy()
    lex_s[:, -3:] = 0.0
    vec_i = np.stack([rng.choice(n, kv, replace=False) for _ in range(b)]).astype(np.int32)
    row_map = np.arange(n, dtype=np.int32)
    cl, cv = device_rrf.make_contrib_tables(np.full(b, 60.0), kl, kv, 1.0, np.full(b, 1.0))
    parts = (*device_rrf.split_f64(cl), *device_rrf.split_f64(cv))

    def run(dev):
        t = [torch.from_numpy(x).to(dev) for x in (lex_i, lex_s, vec_i, row_map, *parts)]
        return [x.cpu() for x in device_rrf.rrf_tail(*t, limit=10)]

    for got, want in zip(run(cuda_device), run(torch.device("cpu"))):
        assert torch.equal(got, want)
