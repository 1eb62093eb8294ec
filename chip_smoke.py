#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one CUDA card).

Phases:
  0. the card (nvidia-smi name + power limit), torch version, kernel build;
  1. kernels K1 (group max) and K2 (gather + rescore) against their plain
     PyTorch twins, on each cell's slab and mask (phase 2's is 1,007,616 x
     256 bf16), at every batch size B and group count kk the main path gave
     them (B = 256, 8 and 1 here; kk as the searcher's candidate budget
     sets it). It runs inside phases 2 and 3, after their main-path runs,
     so that it knows those shapes;
  2. semantic serving at 1M docs: ``TwoTierIndex.create`` + fast-only
     ``TwoTierSearcher.search_batch`` (256 queries, then 8 singletons),
     recall@10 against an exact f32 scan, index sets against the plain scan;
  3. hybrid serving at the dense BM25 lane's ceiling (~60k docs, just under
     2,097,152 postings): the fused phase-1 lane with the on-device RRF tail,
     held bitwise to the host RRF oracle on the same arm outputs.

The kernels' launch counters are zeroed right before each phase drives the
main path and read right after; the kernel checks and the other comparison
runs come later and do not count.
Any failed check raises. The last stdout line is the result JSON; the line
before it is the card's name and power limit. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 20261016
N_DOCS = 1_000_000
DIM = 256
K = 10
HYBRID_DOCS = 60_000
HYBRID_VOCAB = 50_000
POSTINGS_RANGE = (1_500_000, 2_097_152)
REL_TOL = 1e-5  # kernel vs twin: bf16 products are exact, f32 sums differ in order


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_median_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of ``fn`` in ms, one CUDA event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(got, want, what: str) -> float:
    """max |got - want| over finite entries; -inf must match exactly."""
    import torch

    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{what}: finite pattern differs from the twin")
    err = (got[fin] - want[fin]).abs()
    bound = REL_TOL * torch.clamp(want[fin].abs(), min=1.0)
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} over tolerance")
    return float(err.max().item()) if err.numel() else 0.0


def unit_rows(gen, n: int, d: int, device):
    import torch

    x = torch.randn(n, d, generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def check_kernels(cell: str, slab, mask, shapes: set) -> list[dict]:
    """Phase 1 for one cell: K1/K2 against their plain twins on the cell's
    slab and mask, at each shape in ``shapes`` (as :func:`drive` noted them:
    ("group_max", B, 0) and ("gather_rescore", B, kk)), with seeded unit
    queries; K2 rescores the top-kk groups of K1's output, sorted as the
    scan sorts them. Times are CUDA-event medians."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for name in ("group_max", "gather_rescore"):
        if not any(s[0] == name for s in shapes):
            raise AssertionError(f"phase1 {cell}: the main path gave {name} no shape")
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 1)
    n, d = slab.shape
    recs = []
    for b in sorted({s[1] for s in shapes if s[0] == "group_max"}, reverse=True):
        q = unit_rows(gen, b, d, slab.device)
        gm = ts.group_max(slab, q, mask)
        err = check_close(gm, ts.group_max_plain(slab, q, mask), f"phase1 {cell} K1 B={b}")
        ms = cuda_median_ms(lambda: ts.group_max(slab, q, mask))
        plain_ms = cuda_median_ms(lambda: ts.group_max_plain(slab, q, mask))
        recs.append({"kernel": "group_max", "cell": cell, "n": n, "b": b, "kk": None,
                     "ms": ms, "plain_ms": plain_ms, "max_abs_err": err})
        for kk in sorted(s[2] for s in shapes if s[0] == "gather_rescore" and s[1] == b):
            _, groups = ts.topk_desc_rowasc(gm, kk)
            groups = torch.sort(groups.to(torch.int32), dim=1).values
            r = ts.gather_rescore(slab, q, groups)
            err = check_close(r, ts.gather_rescore_plain(slab, q, groups),
                              f"phase1 {cell} K2 B={b} kk={kk}")
            ms = cuda_median_ms(lambda: ts.gather_rescore(slab, q, groups))
            plain_ms = cuda_median_ms(lambda: ts.gather_rescore_plain(slab, q, groups))
            recs.append({"kernel": "gather_rescore", "cell": cell, "n": n, "b": b, "kk": kk,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": err})
    for r in recs:
        log(f"phase1 {cell} {r['kernel']} N={r['n']} B={r['b']}"
            + (f" kk={r['kk']}" if r["kk"] is not None else "")
            + f": {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}) max abs err {r['max_abs_err']:.3e}"
            f" (tolerance {REL_TOL:g} x max(1, |twin|))")
    return recs


def drive(fn, shapes: set):
    """Run ``fn`` with the kernels' launch counters zeroed; returns
    (result, (K1 launches, K2 launches)) of that run alone. Adds the kernel
    shapes of every hierarchical scan in the run to ``shapes``: each scan
    runs K1 at ("group_max", B, 0) and K2 at ("gather_rescore", B, kk)."""
    from frankensearch_tpu_torch.ops import topk_scan as ts

    scan = ts.scan_topk_hierarchical

    def scan_noted(slab, queries, k, mask=None):
        b = queries.shape[0]
        shapes.add(("group_max", b, 0))
        shapes.add(("gather_rescore", b, min(k, slab.shape[0] // ts.GROUP)))
        return scan(slab, queries, k, mask)

    ts.group_max.launches = 0
    ts.gather_rescore.launches = 0
    ts.scan_topk_hierarchical = scan_noted
    try:
        result = fn()
    finally:
        ts.scan_topk_hierarchical = scan
    return result, (ts.group_max.launches, ts.gather_rescore.launches)


def timed(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


def query_texts(rng, vocab, probs, n: int) -> list[str]:
    lens = rng.integers(1, 5, size=n)
    return [" ".join(vocab[i] for i in rng.choice(len(vocab), size=int(m), p=probs)) for m in lens]


def semantic_cell(dev, tmp: str):
    """The semantic-1M cell: 1M seeded unit vectors in a ``TwoTierIndex``,
    a fast-only searcher, 256 query texts. Returns (searcher, index,
    embedder, vectors, queries)."""
    import numpy as np

    from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, TwoTierIndex, TwoTierSearcher

    rng = np.random.default_rng(SEED + 2)
    vecs = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"doc-{i:07d}" for i in range(N_DOCS)]
    emb = HashEmbedder(dim=DIM)
    t0 = time.perf_counter()
    index = TwoTierIndex.create(os.path.join(tmp, "semantic"), vecs, ids, emb.identity(), device=dev)
    log(f"semantic-1M index build {time.perf_counter() - t0:.1f} s ({N_DOCS} docs, "
        f"slab {tuple(index.fast.slab.shape)})")
    searcher = TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True))
    vocab = [f"w{i}" for i in range(5000)]
    probs = 1.0 / np.arange(1, len(vocab) + 1); probs /= probs.sum()
    return searcher, index, emb, vecs, query_texts(rng, vocab, probs, 256)


def phase2_semantic(dev, tmp: str) -> tuple[dict, tuple[int, int], list[dict]]:
    import numpy as np
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    searcher, index, emb, vecs, queries = semantic_cell(dev, tmp)
    singles = queries[:8]
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up: host caches, allocator

    def main_path():
        batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        single_ms = [timed(lambda q=q: searcher.search_batch([q], k=K))[1] for q in singles]
        return batch, batch_ms, single_ms

    (batch, batch_ms, single_ms), launches = drive(main_path, shapes)
    log(f"phase2 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + " ms")
    if min(launches) < 1:
        raise AssertionError(f"phase2: kernel launches on the main path {launches}")
    kernels = check_kernels("semantic-1M", index.fast.slab, index.fast._effective_mask(None, None), shapes)

    # checks (comparison runs; not counted)
    qv = emb.embed_batch(queries)
    exact_ids = ts.scan_topk_xla(
        torch.from_numpy(vecs).to(dev), torch.from_numpy(qv).to(dev), K, precise=True
    ).indices.cpu().numpy()
    recalls = []
    for j, out in enumerate(batch):
        got = {int(r.doc_id[4:]) for r in out.results}
        if len(out.results) != K:
            raise AssertionError(f"phase2: query {j} returned {len(out.results)} results")
        recalls.append(len(got & set(exact_ids[j].tolist())) / K)
    recall = float(np.mean(recalls))
    log(f"phase2 recall@10 vs exact f32 scan: {recall:.4f}")
    if recall < 0.99:
        raise AssertionError(f"phase2: recall@10 {recall} < 0.99")
    hier = index.fast.search_batch(qv, K, mode="hierarchical")
    plain = index.fast.search_batch(qv, K, mode="xla")
    off = 0
    for j in range(len(queries)):
        hs, ps = set(hier.indices[j].tolist()), set(plain.indices[j].tolist())
        if hs != ps:
            kth = float(plain.scores[j, -1])
            for row in hs ^ ps:  # a differing row must tie the k-th score
                s = float(torch.from_numpy(qv[j]).to(dev).to(torch.bfloat16).float()
                          @ index.fast.slab[row, :DIM].float())
                if abs(s - kth) > REL_TOL:
                    raise AssertionError(f"phase2: query {j} row {row} differs from the plain scan")
            off += 1
    for j, out in enumerate(batch):
        top = [int(r.doc_id[4:]) for r in out.results]
        if top != hier.indices[j].tolist()[: len(top)]:
            raise AssertionError(f"phase2: query {j} results differ from the index scan")
    log(f"phase2 index sets vs plain bf16 scan: {len(queries) - off} equal, {off} differ only at ties")
    del index, searcher, hier, plain
    torch.cuda.empty_cache()
    return {"recall_at_10": recall, "batch_ms": batch_ms, "single_ms": single_ms}, launches, kernels


def hybrid_corpus(rng):
    import numpy as np

    from frankensearch_tpu_torch import IndexableDocument

    vocab = [f"w{i}" for i in range(HYBRID_VOCAB)]
    probs = np.arange(1, HYBRID_VOCAB + 1) ** -1.07
    probs /= probs.sum()
    lens = rng.integers(9, 63, size=HYBRID_DOCS)
    toks = rng.choice(HYBRID_VOCAB, size=int(lens.sum()), p=probs)
    titles = rng.choice(HYBRID_VOCAB, size=(HYBRID_DOCS, 2), p=probs)
    docs, pos = [], 0
    for i, m in enumerate(lens):
        words = toks[pos : pos + m]
        pos += m
        docs.append(IndexableDocument(
            doc_id=f"src-{i:06d}",
            content=" ".join(vocab[t] for t in words),
            title=" ".join(vocab[t] for t in titles[i]),
        ))
    return docs, vocab, probs


def hybrid_cell(dev, tmp: str):
    """The hybrid-60k cell: a seeded zipf corpus just under the dense BM25
    lane's ceiling, its HashEmbedder vectors in a ``TwoTierIndex``, a
    fast-only hybrid searcher, 256 query texts. Returns (searcher, index,
    BM25 index, queries)."""
    import numpy as np

    from frankensearch_tpu_torch import (
        DeviceBm25Index,
        HashEmbedder,
        MemoryLexicalIndex,
        TwoTierConfig,
        TwoTierIndex,
        TwoTierSearcher,
    )

    rng = np.random.default_rng(SEED + 3)
    docs, vocab, probs = hybrid_corpus(rng)
    t0 = time.perf_counter()
    bm25 = DeviceBm25Index(MemoryLexicalIndex.bulk_build(docs), device=dev)
    log(f"hybrid-60k BM25 build {time.perf_counter() - t0:.1f} s: {bm25.n_docs} docs, "
        f"{bm25.posting_count} postings, vocab {bm25.vocab_size}")
    if not POSTINGS_RANGE[0] <= bm25.posting_count < POSTINGS_RANGE[1]:
        raise AssertionError(f"hybrid-60k: {bm25.posting_count} postings outside {POSTINGS_RANGE}")
    emb = HashEmbedder(dim=DIM)
    t0 = time.perf_counter()
    index = TwoTierIndex.create(
        os.path.join(tmp, "hybrid"), emb.embed_batch([d.content for d in docs]),
        [d.doc_id for d in docs], emb.identity(), device=dev,
    )
    log(f"hybrid-60k vector index build {time.perf_counter() - t0:.1f} s")
    searcher = TwoTierSearcher(index, emb, lexical=bm25, config=TwoTierConfig(fast_only=True))
    return searcher, index, bm25, query_texts(rng, vocab, probs, 256)


def phase3_hybrid(dev, tmp: str) -> tuple[dict, tuple[int, int], list[dict]]:
    searcher, index, bm25, queries = hybrid_cell(dev, tmp)
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up

    def main_path():
        batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        single_ms = [timed(lambda q=q: searcher.search_batch([q], k=K))[1] for q in queries[:8]]
        return batch, batch_ms, single_ms

    (batch, batch_ms, single_ms), launches = drive(main_path, shapes)
    log(f"phase3 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + " ms")
    if min(launches) < 1:
        raise AssertionError(f"phase3: kernel launches on the main path {launches}")
    kernels = check_kernels("hybrid-60k", index.fast.slab, index.fast._effective_mask(None, None), shapes)
    if not all(o.metrics.phase1_fused for o in batch):
        raise AssertionError("phase3: the fused phase-1 lane did not run")
    if not all(len(o.results) == K for o in batch):
        raise AssertionError("phase3: a query returned fewer than k results")
    if searcher.last_fusion_path != "device":
        raise AssertionError(f"phase3: fusion path {searcher.last_fusion_path!r}, not device")

    # the device RRF against the host oracle (the reference's vectorized
    # rrf_fuse_batch_rows) on the same arm outputs: with the device tail
    # switched off, the searcher fuses the identical arm bits on the host
    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    if searcher.last_fusion_path != "host_vectorized":
        raise AssertionError(f"phase3: oracle fusion path {searcher.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(batch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase3: query {j} differs from the host RRF oracle")
    log("phase3 fused rows and scores bitwise equal to the host RRF oracle")
    return {"batch_ms": batch_ms, "single_ms": single_ms, "postings": bm25.posting_count}, launches, kernels


def main() -> int:
    sys.modules["jax"] = None  # the port must not reach jax, even indirectly
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from frankensearch_tpu_torch.device import resolve_device
        from frankensearch_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    card = gpu_line()
    log(f"phase0 card: {card}")
    log(f"phase0 torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    lib = _build.library_path()
    log(f"phase0 kernel build {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib)}")

    with tempfile.TemporaryDirectory(prefix="fs_chip_smoke_") as tmp:
        sem, l2, k2 = phase2_semantic(dev, tmp)
        hyb, l3, k3 = phase3_hybrid(dev, tmp)

    sources = {
        "group_max": ("frankensearch_tpu_torch/ops/csrc/group_max.cu",
                      "frankensearch_tpu/ops/topk_scan.py:220", 0),
        "gather_rescore": ("frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
                           "frankensearch_tpu/ops/topk_scan.py:362", 1),
    }
    kernels = []
    for name, (src, replaces, slot) in sources.items():
        recs = [r for r in k2 + k3 if r["kernel"] == name]
        # headline: the 1M-doc cell's largest batch (and largest kk)
        head = max((r for r in recs if r["cell"] == "semantic-1M"), key=lambda r: (r["b"], r["kk"] or 0))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": l2[slot] + l3[slot],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "shapes": [{k: r[k] for k in ("cell", "n", "b", "kk", "ms", "plain_ms", "max_abs_err")}
                       for r in recs],
        })
    log(json.dumps({"semantic": sem, "hybrid": hyb}))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
