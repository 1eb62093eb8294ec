#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one CUDA card).

Phases:
  0. the card (nvidia-smi name + power limit), torch version, kernel build;
  1. kernels K1 (group max) and K2 (gather + rescore) against their plain
     PyTorch twins, on each cell's slab and mask (phase 2's is 1,007,616 x
     256 bf16), at every batch size B and group count kk the main path gave
     them (B = 256, 8 and 1 here; kk as the searcher's candidate budget
     sets it), and K3 (flat tail scores) against its twin, bitwise, on every
     length class of phase 4's layout at every (B, T) the flat lane gave
     it. It runs inside phases 2-4, after their main-path runs, so that it
     knows those shapes;
  2. semantic serving at 1M docs: ``TwoTierIndex.create`` + fast-only
     ``TwoTierSearcher.search_batch`` (256 queries, then 8 singletons),
     recall@10 against an exact f32 scan, index sets against the plain scan;
  3. hybrid serving at the dense BM25 lane's ceiling (~60k docs, just under
     2,097,152 postings): the fused phase-1 lane with the on-device RRF tail,
     held bitwise to the host RRF oracle on the same arm outputs; then the
     same corpus with the blocked threshold lowered and the hot arm off, the
     pruned lane, held to the dense lane's candidates;
  4. hybrid serving at 1M docs (the reference's tools/bench_hybrid_1m.py
     corpus: 14 zipf(1.35) words over 50,000, ~10M postings) over phase 2's
     vectors: the split lexical layout (hot arm, flat lane on K3, packed
     DAAT), the daat, blocked and mixed lanes, lexical top-k against an
     exact f64 host BM25, singleton bits against their batch rows, and the
     device RRF bitwise against the host oracle.

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
LEX_REL_TOL = 1e-6  # pruned vs dense lane: the same f32 terms summed in another order
H1M_DOCS = 1_000_000  # tools/bench_hybrid_1m.py: 1M docs of 14 zipf(1.35) words
H1M_VOCAB = 50_000
H1M_WORDS = 14
H1M_ZIPF = 1.35
H1M_MIN_POSTINGS = 1 << 21  # the blocked layout's threshold
ORACLE_REL_TOL = 1e-5  # f32 device BM25 vs the exact f64 host sum


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


def check_kernels(cell: str, slab, mask, shapes: set, done: set = frozenset()) -> list[dict]:
    """Phase 1 for one cell: K1/K2 against their plain twins on the cell's
    slab and mask, at each shape in ``shapes`` (as :func:`drive` noted them:
    ("group_max", B, 0) and ("gather_rescore", B, kk)) not already checked on
    the same slab (``done``), with seeded unit queries; K2 rescores the
    top-kk groups of K1's output, sorted as the scan sorts them. Times are
    CUDA-event medians."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for name in ("group_max", "gather_rescore"):
        if not any(s[0] == name for s in shapes):
            raise AssertionError(f"phase1 {cell}: the main path gave {name} no shape")
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 1)
    n, d = slab.shape
    recs = []
    todo = shapes - set(done)
    for b in sorted({s[1] for s in shapes if s[0] == "group_max"}, reverse=True):
        q = unit_rows(gen, b, d, slab.device)
        gm = ts.group_max(slab, q, mask)
        if ("group_max", b, 0) in todo:
            err = check_close(gm, ts.group_max_plain(slab, q, mask), f"phase1 {cell} K1 B={b}")
            ms = cuda_median_ms(lambda: ts.group_max(slab, q, mask))
            plain_ms = cuda_median_ms(lambda: ts.group_max_plain(slab, q, mask))
            recs.append({"kernel": "group_max", "cell": cell, "n": n, "b": b, "kk": None,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": err})
        for kk in sorted(s[2] for s in todo if s[0] == "gather_rescore" and s[1] == b):
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


def drive(fn, shapes: set, flat_inputs: dict | None = None):
    """Run ``fn`` with the kernels' launch counters zeroed; returns
    (result, (K1 launches, K2 launches, K3 launches)) of that run alone.
    Adds the kernel shapes of every hierarchical scan in the run to
    ``shapes``: each scan runs K1 at ("group_max", B, 0) and K2 at
    ("gather_rescore", B, kk). ``flat_inputs`` collects, for each (B, T) at
    which the flat lane ran K3, a copy of the first query rows it got."""
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops import topk_scan as ts

    scan = ts.scan_topk_hierarchical
    flat = bm._graded_scan_flat

    def scan_noted(slab, queries, k, mask=None):
        b = queries.shape[0]
        shapes.add(("group_max", b, 0))
        shapes.add(("gather_rescore", b, min(k, slab.shape[0] // ts.GROUP)))
        return scan(slab, queries, k, mask)

    def flat_noted(classes, q_ids, q_w, *args, **kw):
        if flat_inputs is not None:
            flat_inputs.setdefault(tuple(q_ids.shape), (q_ids.clone(), q_w.clone()))
        return flat(classes, q_ids, q_w, *args, **kw)

    ts.group_max.launches = 0
    ts.gather_rescore.launches = 0
    bm.flat_class_scores.launches = 0
    ts.scan_topk_hierarchical = scan_noted
    bm._graded_scan_flat = flat_noted
    try:
        result = fn()
    finally:
        ts.scan_topk_hierarchical = scan
        bm._graded_scan_flat = flat
    return result, (ts.group_max.launches, ts.gather_rescore.launches, bm.flat_class_scores.launches)


def need_launches(phase: str, launches, names=("K1", "K2")) -> None:
    """Fail unless every named kernel launched on the phase's main path."""
    for name, n in zip(names, launches):
        if n < 1:
            raise AssertionError(f"{phase}: {name} was not launched on the main path ({launches})")


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


def phase2_semantic(dev, tmp: str) -> tuple[dict, tuple[int, int, int], list[dict], tuple]:
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
    need_launches("phase2", launches)
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
    del searcher, hier, plain
    torch.cuda.empty_cache()
    # phase 4 serves its lexical corpus over this index (same doc ids)
    return ({"recall_at_10": recall, "batch_ms": batch_ms, "single_ms": single_ms},
            launches, kernels, (index, emb, shapes))


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


def phase3_hybrid(dev, tmp: str) -> tuple[dict, tuple[int, int, int], list[dict]]:
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
    need_launches("phase3", launches)
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
    del searcher._device_rrf_tail
    pruned = phase3_pruned(dev, bm25, queries[:64])
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "postings": bm25.posting_count,
             "pruned": pruned}, launches, kernels)


def same_ranking(got, want, rel: float, what: str) -> None:
    """Two candidate lists of one query: scores equal position by position
    within ``rel``, and the same docs, except that docs whose score lies
    within ``rel`` of the last kept score may be swapped for each other."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} candidates, want {len(want)}")
    for (gd, gs), (wd, ws) in zip(got, want):
        if abs(gs - ws) > rel * abs(ws):
            raise AssertionError(f"{what}: score {gs!r} vs {ws!r}")
    if not want:
        return
    kth = want[-1][1]
    edge = {d for d, s in got + want if abs(s - kth) <= rel * abs(kth)}
    if {d for d, _ in got} - edge != {d for d, _ in want} - edge:
        raise AssertionError(f"{what}: candidate sets differ away from the k-th score")


def phase3_pruned(dev, bm25, queries) -> dict:
    """The hybrid-60k corpus once more with the blocked threshold lowered and
    the hot arm off: the pruned lane (block-max skipping, exact 8-term FMA
    chunks) against the dense lane's candidates on the same queries."""
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.lexical import hot_arm

    saved = bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS
    bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS = 1, 1 << 62
    try:
        t0 = time.perf_counter()
        pruned = bm.DeviceBm25Index(bm25._source, device=dev)
        build_s = time.perf_counter() - t0
    finally:
        bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS = saved
    if pruned._blocked is None or pruned._hot is not None:
        raise AssertionError("phase3: the pruned layout was not built")
    pruned.daat_mode = "blocked"
    want, _ = timed(lambda: bm25.search_candidates_batch(queries, 30))
    got, ms = timed(lambda: pruned.search_candidates_batch(queries, 30))
    if pruned.last_lane != "blocked":
        raise AssertionError(f"phase3: pruned lane {pruned.last_lane!r}")
    for j, (g, w) in enumerate(zip(got, want)):
        same_ranking([(c.doc_id, c.score) for c in g], [(c.doc_id, c.score) for c in w],
                     LEX_REL_TOL, f"phase3 pruned query {j}")
    skipped = pruned.last_blocks_skipped
    single_ms, solo_skips = [], []
    for q in queries[:8]:
        g, t = timed(lambda q=q: pruned.search_candidates_batch([q], 30))
        single_ms.append(t)
        solo_skips.append(pruned.last_blocks_skipped)
        same_ranking([(c.doc_id, c.score) for c in g[0]],
                     [(c.doc_id, c.score) for c in bm25.search_candidates_batch([q], 30)[0]],
                     LEX_REL_TOL, f"phase3 pruned singleton {q!r}")
    n_blk = pruned._blocked.n_blk
    log(f"phase3 pruned lane ({n_blk} blocks, build {build_s:.1f} s): "
        f"{len(queries)} queries' candidates equal to the dense lane's within {LEX_REL_TOL:g}; "
        f"B={len(queries)} {ms:.2f} ms, {skipped} blocks skipped; singletons skipped {solo_skips}")
    return {"n_blocks": n_blk, "batch_ms": ms, "blocks_skipped": skipped,
            "single_ms": single_ms, "single_blocks_skipped": solo_skips}


def hybrid1m_docs(rng):
    """tools/bench_hybrid_1m.py's corpus: H1M_DOCS docs of H1M_WORDS words
    drawn zipf(H1M_ZIPF) over w00000..w49999, content only; doc ids match
    phase 2's vector index. Returns (docs, vocab)."""
    import numpy as np

    from frankensearch_tpu_torch import IndexableDocument

    vocab = np.array([f"w{i:05d}" for i in range(H1M_VOCAB)])
    words = vocab[(rng.zipf(H1M_ZIPF, size=(H1M_DOCS, H1M_WORDS)) - 1) % H1M_VOCAB]
    docs = [IndexableDocument(doc_id=f"doc-{i:07d}", content=" ".join(row)) for i, row in enumerate(words)]
    return docs, vocab


def hybrid1m_queries(rng, vocab, bm25) -> tuple[list[str], list[str]]:
    """256 queries of 1-4 zipf words; the 8 singletons are the batch's
    first six, a pure-tail query of one rare word (the DAAT lane) and a
    query of the two commonest words (the hot arm), placed at batch rows 6
    and 7."""
    import numpy as np

    lens = rng.integers(1, 5, size=256)
    queries = [" ".join(vocab[(rng.zipf(H1M_ZIPF, size=int(m)) - 1) % H1M_VOCAB]) for m in lens]
    arm = bm25._arms["content"]
    df = np.bincount(bm25._cold_host[0].astype(np.int64), minlength=bm25.vocab_size)
    rare = [w for w in vocab[-5000:] if (t := arm.term_ids.get(str(w))) is not None
            and 2 <= df[t] <= 20 and bm25._hot.hot_row_of[t] < 0]
    if not rare:
        raise AssertionError("phase4: no rare tail word in the corpus")
    queries[6] = str(rare[0])
    queries[7] = f"{vocab[0]} {vocab[1]}"
    return queries, queries[:8]


def check_flat_kernel(cell: str, classes, flat_inputs: dict) -> list[dict]:
    """Phase 1 for K3: the kernel against its twin, bitwise, on every length
    class at every (B, T) the flat lane ran it with, on the query rows the
    lane gave it there. Times are CUDA-event medians."""
    import torch

    from frankensearch_tpu_torch.lexical import device_bm25 as bm

    if not flat_inputs:
        raise AssertionError(f"phase1 {cell}: the main path gave the flat lane no query rows")
    recs = []
    for (b, t_q), (q_ids, q_w) in sorted(flat_inputs.items(), reverse=True):
        for c, cls in enumerate(classes):
            n_c, l_c, d_pad = cls.term_t.shape
            got = bm.flat_class_scores(cls.term_t, cls.tf_t, q_ids, q_w)
            want = bm.flat_class_scores_plain(cls.term_t, cls.tf_t, q_ids, q_w)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                err = (got - want).abs().max().item()
                raise AssertionError(f"phase1 {cell} K3 class {c} B={b} T={t_q}: not bitwise (max err {err:.3e})")
            ms = cuda_median_ms(lambda: bm.flat_class_scores(cls.term_t, cls.tf_t, q_ids, q_w), iters=10)
            plain_ms = cuda_median_ms(
                lambda: bm.flat_class_scores_plain(cls.term_t, cls.tf_t, q_ids, q_w), warmup=1, iters=5
            )
            recs.append({"kernel": "flat_score", "cell": cell, "class": c, "n_c": n_c, "l": l_c,
                         "d_pad": d_pad, "b": b, "t": t_q, "ms": ms, "plain_ms": plain_ms,
                         "max_abs_err": 0.0})
            log(f"phase1 {cell} flat_score class {c} ({n_c} x {l_c} x {d_pad}) B={b} T={t_q}: "
                f"{ms:.4f} ms (plain {plain_ms:.4f}), bitwise equal")
            del got, want
    return recs


def lexical_oracle_check(bm25, queries: list[str], k: int) -> int:
    """The device lanes' top-k against an exact f64 host BM25 (a scipy
    sparse product over all postings, hot and tail): equal doc sets up to
    ties within ORACLE_REL_TOL at the k-th score, scores within it too.
    Returns how many queries' sets were equal outright."""
    import numpy as np
    from scipy import sparse

    terms, docs, tfs = bm25._post_host
    x = sparse.csr_matrix(
        (tfs.astype(np.float64), (docs.astype(np.int64), terms.astype(np.int64))),
        shape=(bm25.n_docs, bm25.vocab_size),
    )
    q = np.zeros((bm25.vocab_size, len(queries)), np.float64)
    for j, text in enumerate(queries):
        for tid, w in bm25._query_terms(text):
            q[tid, j] = np.float32(w)
    exact = np.asarray(x @ q)  # (N, Q)
    got = bm25.search_candidates_batch(queries, k)
    outright = 0
    for j, cands in enumerate(got):
        col = exact[:, j]
        pos = np.flatnonzero(col > 0.0)
        top = pos[np.argsort(-col[pos], kind="stable")][:k]
        want = {bm25.doc_ids[r] for r in top}
        have = {c.doc_id for c in cands}
        for c in cands:
            e = col[bm25._row_of[c.doc_id]]
            if abs(c.score - e) > ORACLE_REL_TOL * e:
                raise AssertionError(f"phase4 oracle query {j}: {c.doc_id} scored {c.score}, exact {e}")
        if len(have) != len(want):
            raise AssertionError(f"phase4 oracle query {j}: {len(have)} docs, exact top-k has {len(want)}")
        if have == want:
            outright += 1
            continue
        kth = col[top[-1]]
        for d in have ^ want:
            if abs(col[bm25._row_of[d]] - kth) > ORACLE_REL_TOL * kth:
                raise AssertionError(f"phase4 oracle query {j}: {d} differs away from the k-th score")
    return outright


def hybrid1m_cell(dev, index, emb):
    """The hybrid-1M cell over a 1M-doc vector index with phase 2's doc ids:
    the corpus, its BM25 arm (split layout, packed term-major copy), a
    fast-only hybrid searcher and the traffic. Returns (searcher, BM25
    index, queries, singletons, layout record)."""
    import numpy as np

    from frankensearch_tpu_torch import BulkDeviceBm25Index, TwoTierConfig, TwoTierSearcher

    if index.fast.n_rows != H1M_DOCS:
        raise AssertionError(f"hybrid-1M: the vector index holds {index.fast.n_rows} docs, not {H1M_DOCS}")
    rng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    docs, vocab = hybrid1m_docs(rng)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm25 = BulkDeviceBm25Index(docs, device=dev)  # raises if the native ingest cannot load
    build_s = time.perf_counter() - t0
    del docs
    t0 = time.perf_counter()
    tm = bm25._term_major()
    tm_s = time.perf_counter() - t0
    hot = bm25._hot
    layout = {
        "postings": bm25.posting_count, "tail_postings": bm25.cold_posting_count,
        "hot_terms": None if hot is None else hot.n_hot,
        "classes": None if hot is None else [tuple(c.term_t.shape) for c in bm25._blocked.classes],
        "cold_docs": None if hot is None else int((hot.cold_rows >= 0).sum().item()),
        "daat_packed": None if tm is None else tm.packed,
        "corpus_s": gen_s, "build_s": build_s, "term_major_s": tm_s,
    }
    log(f"hybrid-1M BM25: " + json.dumps(layout))
    if bm25.posting_count < H1M_MIN_POSTINGS:
        raise AssertionError(f"hybrid-1M: {bm25.posting_count} postings < {H1M_MIN_POSTINGS}")
    if hot is None or tm is None or not tm.packed:
        raise AssertionError("hybrid-1M: the split layout with a hot arm and a packed term-major copy was not built")
    searcher = TwoTierSearcher(index, emb, lexical=bm25, config=TwoTierConfig(fast_only=True))
    queries, singles = hybrid1m_queries(rng, vocab, bm25)
    return searcher, bm25, queries, singles, layout


def phase4_hybrid1m(dev, semantic) -> tuple[dict, tuple[int, int, int], list[dict]]:
    """The hybrid-1M cell over phase 2's vector index."""
    import torch

    index, emb, done_shapes = semantic
    searcher, bm25, queries, singles, layout = hybrid1m_cell(dev, index, emb)
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    lanes: list[str] = []
    flat_inputs: dict = {}

    def main_path():
        batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        lanes.append(searcher.last_phase1_lex_lane)
        solo, single_ms = [], []
        for q in singles:
            out, t = timed(lambda q=q: searcher.search_batch([q], k=K))
            solo.append(out[0])
            single_ms.append(t)
            lanes.append(searcher.last_phase1_lex_lane)
        return batch, batch_ms, solo, single_ms

    (batch, batch_ms, solo, single_ms), launches = drive(main_path, shapes, flat_inputs)
    log(f"phase4 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + f" ms; lanes {lanes}")
    need_launches("phase4", launches, ("K1", "K2", "K3"))
    if not {"daat", "blocked", "mixed"} <= set(lanes):
        raise AssertionError(f"phase4: lanes {sorted(set(lanes))}, want daat, blocked and mixed")
    if not all(o.metrics.phase1_fused for o in batch) or searcher.last_fusion_path != "device":
        raise AssertionError("phase4: the fused phase-1 lane or the device fusion did not run")
    if sum(1 for o in batch if o.results) < len(batch) // 2:
        raise AssertionError("phase4: most queries returned nothing")

    def rows(out):
        return [(r.doc_id, r.score, r.lexical_score, r.fast_score) for r in out.results]

    for j, one in enumerate(solo):
        if rows(one) != rows(batch[j]):
            raise AssertionError(f"phase4: singleton {singles[j]!r} differs from its batch row")
    log("phase4 singletons bitwise equal to their batch rows (fused, lexical and vector scores)")

    kernels = check_kernels("hybrid-1M", index.fast.slab, index.fast._effective_mask(None, None),
                            shapes, done_shapes)
    kernels += check_flat_kernel("hybrid-1M", bm25._blocked.classes, flat_inputs)

    t0 = time.perf_counter()
    outright = lexical_oracle_check(bm25, queries[:32], K)
    log(f"phase4 lexical top-{K} of 32 queries vs exact f64 host BM25: {outright} equal, "
        f"{32 - outright} differ only at ties within {ORACLE_REL_TOL:g} ({time.perf_counter() - t0:.1f} s)")

    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    if searcher.last_fusion_path != "host_vectorized":
        raise AssertionError(f"phase4: oracle fusion path {searcher.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(batch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase4: query {j} differs from the host RRF oracle")
    log("phase4 fused rows and scores bitwise equal to the host RRF oracle")
    del searcher, bm25
    torch.cuda.empty_cache()
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "lanes": lanes, "layout": layout,
             "oracle_equal": outright}, launches, kernels)


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

    wall = {}
    with tempfile.TemporaryDirectory(prefix="fs_chip_smoke_") as tmp:
        t0 = time.perf_counter()
        sem, l2, k2, semantic = phase2_semantic(dev, tmp)
        wall["phase2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hyb, l3, k3 = phase3_hybrid(dev, tmp)
        wall["phase3_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        h1m, l4, k4 = phase4_hybrid1m(dev, semantic)
        wall["phase4_s"] = time.perf_counter() - t0
        del semantic
        log("phase wall times: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))

    sources = {
        "group_max": ("frankensearch_tpu_torch/ops/csrc/group_max.cu",
                      "frankensearch_tpu/ops/topk_scan.py:220", 0),
        "gather_rescore": ("frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
                           "frankensearch_tpu/ops/topk_scan.py:362", 1),
    }
    kernels = []
    for name, (src, replaces, slot) in sources.items():
        recs = [r for r in k2 + k3 + k4 if r["kernel"] == name]
        # headline: the 1M-doc cell's largest batch (and largest kk)
        head = max((r for r in recs if r["cell"] == "semantic-1M"), key=lambda r: (r["b"], r["kk"] or 0))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": l2[slot] + l3[slot] + l4[slot],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "shapes": [{k: r[k] for k in ("cell", "n", "b", "kk", "ms", "plain_ms", "max_abs_err")}
                       for r in recs],
        })
    recs = [r for r in k4 if r["kernel"] == "flat_score"]
    # headline: the widest batch tile, summed over the classes (one flat scan)
    b_top = max(r["b"] for r in recs)
    t_top = max(r["t"] for r in recs if r["b"] == b_top)
    head = [r for r in recs if (r["b"], r["t"]) == (b_top, t_top)]
    kernels.append({
        "name": "flat_score", "route": "cuda",
        "source": "frankensearch_tpu_torch/ops/csrc/flat_score.cu",
        "replaces": "frankensearch_tpu/lexical/device_bm25.py:405",
        "launches": l4[2], "max_abs_err": 0.0,
        "ms": sum(r["ms"] for r in head), "plain_ms": sum(r["plain_ms"] for r in head),
        "shapes": [{k: r[k] for k in ("cell", "class", "n_c", "l", "d_pad", "b", "t", "ms", "plain_ms")}
                   for r in recs],
    })
    log(json.dumps({"semantic": sem, "hybrid": hyb, "hybrid_1m": h1m, "wall_s": wall}))
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
