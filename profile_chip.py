#!/usr/bin/env python3
"""Where the time goes: profile the PyTorch port's main path on one NVIDIA GPU.

Usage: ``python3 profile_chip.py [OUT_DIR [CELL ...]]`` (or ``--kernels
[ROOT]``, below) from the root of a checkout (one CUDA card). OUT_DIR,
where the reports go, defaults to ``build/profile``; naming CELLs profiles
only those.

Builds the cells of ``chip_smoke.py`` (semantic-1M, semantic-1M-pallas:
the same index served with ``scan_mode="pallas"`` (K5), hybrid-60k,
hybrid-1M: the 1M-doc BM25 arm over the semantic cell's vectors,
semantic-1M-int8: the semantic cell's vectors in an int8 ``TwoTierIndex``
served with ``scan_mode="int8"``, and hybrid-1M-m2v: the same BM25 arm with
a Model2Vec fast tier, its docs embedded through the bag lane and its
queries embedded inside the fused phase-1 pass, and hybrid-1M-quality:
hybrid-1M with phase 8's 1M x 384 quality tier and the trained 384
encoder (``data/quality_encoder_384``), served through the Refined phase
with the query-embedding cache off, so that every call runs the encoder;
semantic-1M-f32: the semantic cell's vectors as an f32 slab (K1 and K2's
f32 forms); semantic-1M-f32-pallas: the same served with
``scan_mode="pallas"`` (K5's f32 form); semantic-1M-mrl: the semantic cell with
``mrl_search_dims=64``; semantic-1M-ivf: chip_smoke's clustered 1M corpus
with its IVF arm, ``scan_mode="ivf"`` at the default nprobe 8;
built-1M-m2v: hybrid-1M-m2v's docs and table through ``IndexBuilder`` and
``open_hybrid``, the packed lexical arm behind its delta; cli-1M: the same
docs as a JSONL corpus through the CLI's ``index`` (the default stack,
HashEmbedder(256)), opened as ``cli serve`` opens it, so that its
``search_batch`` is the call a coalesced serve batch makes) and, for
each at B = 256 and B = 1 (the cell's first query), after three warm-up calls
of ``TwoTierSearcher.search_batch``:

  * host ms: ``REPS`` calls on the host clock, each ending in a device sync,
    with no profiler attached (median, min, max);
  * device ms: one call under ``torch.profiler``, the sum of the device
    time of its device events (kernels and copies; the path runs on one
    stream, so they do not overlap). It is the table's "Self CUDA time
    total": the aten ops' rows repeat their kernels' time and are left out;
  * idle share: 1 - device ms / median host ms;
  * the host ms of the call under ``torch.profiler`` and of one under
    cProfile. Both profilers inflate host time: use them for the split, not
    for the total.

Prints one line per (cell, B), then the card's name and power limit, then a
JSON summary as the last line. More than one cell runs as a process per
cell, and each trace is checked against the port's launch counters (see
``traced``): a row whose trace missed a launch says so. The profiler table and the cProfile listing
of each (cell, B) go to ``OUT_DIR/profile_<cell>_b<B>.txt``.

``python3 profile_chip.py --kernels [ROOT]`` times the flat lane's class
step, K5, K1, K2, K6, K4 and K2-i8 instead, from the port package under ROOT
(default: this checkout), so that an earlier tree unpacked elsewhere
(``git archive <commit> frankensearch_tpu_torch native``) is timed on the
same inputs: hybrid-1M's lexical arm (``chip_smoke.hybrid1m_lexical``), the
first 64-row flat tile its 256 queries give, each class's step (K3 with its
post-pass where the tree has one) and the whole ``_graded_scan_flat``; K5
(``tile_topk``) on a seeded 1,007,616 x 256 bf16 slab of unit rows at the
phase-5 shapes, then K1 (``group_max``) at B = 256, 8, 1, K2
(``gather_rescore``, the wrapper with its counting sort) at kk = 60, 30
over each batch's top groups by K1, and K6 (``group_candidates``, 8192-row
tiles) at t = 60, 30, on the same slab; then K4 (``group_max_int8``) at
B = 256, 8, 1 on a seeded 1,007,616 x 256 int8 slab and K2-i8
(``gather_rescore_i8``, the wrapper with its counting sort where the tree
has one) at kk = 60, 30 over each batch's top groups by K4, with its
bound; where the tree has K2-i8's group order, also at B = 8 ... 256,
kk = 60, forced into pair order and into group order (the crossover);
last, semantic-1M-int8's ``search_batch`` at B = 256 and 1 (the lane
end to end: its device time, K4's, K2-i8's and the plan's).
CUDA-event medians of back-to-back calls, which include the host's
enqueue wherever the card waits on it (K2's groups at B = 1 stay in L2
between calls); K1, K2, K6, K4 and K2-i8 also get their device time
(``device_ms``: torch.profiler's self device time of every kernel of one
call of the wrapper). The last line is a JSON summary.

``python3 profile_chip.py --k5-split [ROOT]`` splits K5-f32 (the per-tile
top-k on an f32 slab, 1,007,616 x 256, kk = 60, B = 256, 8, 1) of the
tree under ROOT into its scan and its selection: it times the kernel as it
is and two scratch builds of it made under ``build/k5split/`` (one without
the selection, one whose scan is replaced by hashed scores; see
``K5_SPLIT_PATCHES``), each in a process of its own, and prints the ptxas
report of the list entry's instances and K5 (bf16) at B = 256 beside it.

``python3 profile_chip.py --ivf-layout`` times K2-ivf (the IVF probe's
kernel, ``topk_scan.ivf_probe_topk``) on chip_smoke's clustered 1M arm at
``IVF_LAYOUT_SHAPES``: as ``topk_scan._ivf_probe_layout`` cuts the work,
and with each of its choices flipped in turn (pair order or the counting
sort, one run a cluster or one a group, a query tile of 8 or 16). Device
ms a call of the wrapper and of its kernel (``device_split``), three runs
each; the last line is a JSON summary.

``python3 profile_chip.py --pool`` times the Model2Vec pool's kernel and
its plain twin on chip_smoke's 500,000 x 256 bf16 table at
``chip_smoke.POOL_SHAPES``, on ``chip_smoke.pool_inputs``: device ms a call
(``device_split``; the twin's kernels and copies summed) and CUDA-event
medians of each wrapper (at these sizes the host's enqueue). The last line
is a JSON summary.

``python3 profile_chip.py --open OUT_DIR TREE [TREE ...]`` times a 1M-doc
open: it builds chip_smoke's cli-1M root (phase 4's 1M docs through ``cli
index`` of this checkout) and runs ``cli watch`` into it once (phase 12's
first run: 768 docs and an incremental seal, so that the open folds a
delta snapshot), then, for each TREE in turn, in a process of its own
importing the port package under TREE, times ``open_hybrid(root)`` twice on
the host clock (the card synchronized after) and ``load_lexical(root)``
alone; one more open under cProfile goes to
``OUT_DIR/open_<i>_<tree>.txt`` (by total and by own time). Give a tree
twice, interleaved with another (parent, this, this, parent), to compare
them on one host. The last line is a JSON summary.
"""

from __future__ import annotations

import cProfile
import hashlib
import io
import json
import os
import pstats
import statistics
import sys
import tempfile
import time

REPS = 10
HERE = os.path.dirname(os.path.abspath(__file__))


#: the port's kernels as their names begin in a trace, by the launch
#: counters (chip_smoke.launch_counters) whose launches run them: K6 runs
#: K1's kernel, then its own
TRACED_KERNELS = (
    (("K1", "K4", "K6"), ("group_max_kernel<", "group_max_f32_kernel<")),
    (("K2", "K2-i8"), ("gather_rescore_kernel<", "gather_rescore_i8_kernel<")),
    (("K3",), ("flat_fused_kernel",)),
    (("K5",), ("tile_topk_kernel<", "tile_topk_f32_kernel<", "tile_topk_wide_kernel<")),
    (("K6",), ("tile_select_kernel",)),
    (("K2-ivf",), ("ivf_probe_kernel<",)),
    (("pool",), ("embed_pool_kernel<",)),
)
#: the idle seconds around the calls in each profiler run a call gets
#: before its trace counts as incomplete
TRACE_PADS = (0.0, 0.05, 0.5)


def traced(fn, iters: int = 1):
    """``iters`` calls of ``fn`` under torch.profiler, ending in a device
    sync: (profiler, host ms of the calls, missing, pad) for the first run
    whose trace holds a kernel event for every launch the port's wrappers
    counted in it; ``missing`` names the kernels that the last run's trace
    still lacked. Traces taken late in a process have missed the
    first long kernel of a call (K1-f32, K4, K5-f32) while holding the
    rest, so each retry idles longer inside the profiled run before and
    after the calls (TRACE_PADS)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    counters = cs.launch_counters()
    for pad in TRACE_PADS:
        before = {name: w.launches for name, w in counters.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1000.0
            time.sleep(pad)
        launched = {name: w.launches - before[name] for name, w in counters.items()}
        names = [e.name for e in prof.events() if e.device_type != DeviceType.CPU]
        missing = [kernels[0] for wrappers, kernels in TRACED_KERNELS
                   if sum(any(k in n for k in kernels) for n in names) < sum(launched[w] for w in wrappers)]
        if not missing:
            break
    return prof, host_ms, missing, pad


def profile_once(fn, path: str) -> tuple[float, float, float, list, float]:
    """(device ms, host ms under torch.profiler, host ms under cProfile,
    kernels the trace missed, the run's idle pad) of one call each (see
    :func:`traced`); writes both reports to ``path``."""
    import torch
    from torch.autograd import DeviceType

    prof, torch_prof_ms, missing, pad = traced(fn)
    events = prof.key_averages()
    device_ms = sum(
        e.self_device_time_total for e in events if e.device_type != DeviceType.CPU
    ) / 1000.0

    cprof = cProfile.Profile()
    t0 = time.perf_counter()
    cprof.enable()
    fn()
    torch.cuda.synchronize()
    cprof.disable()
    cprofile_ms = (time.perf_counter() - t0) * 1000.0

    listing = io.StringIO()
    pstats.Stats(cprof, stream=listing).sort_stats("cumulative").print_stats(30)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
        f.write(f"\ncProfile ({cprofile_ms:.2f} ms host):\n{listing.getvalue()}")
    return device_ms, torch_prof_ms, cprofile_ms, missing, pad


def device_split(fn, iters: int = 10) -> tuple[float, dict]:
    """Device time of one call of ``fn``: the self device time of all its
    kernels and copies under torch.profiler, over ``iters`` calls (a trace
    that holds all the port's launches, see :func:`traced`, else
    RuntimeError); and the same per kernel name."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    prof, _, missing, _ = traced(fn, iters)
    if missing:
        raise RuntimeError(f"torch.profiler's trace missed launches of {missing} in {len(TRACE_PADS)} profiled runs")
    by_name = {e.key: e.self_device_time_total / iters / 1000.0
               for e in prof.key_averages() if e.device_type != DeviceType.CPU}
    return sum(by_name.values()), by_name


def device_ms(fn, iters: int = 10) -> float:
    return device_split(fn, iters)[0]


def int8_cell(cs, dev, tmp: str):
    """semantic-1M-int8: semantic-1M's vectors in an int8 ``TwoTierIndex``
    served with ``scan_mode="int8"``; (searcher, queries)."""
    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher

    _, index, emb, vecs, queries = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
    index8 = TwoTierIndex.create(
        tempfile.mkdtemp(dir=tmp), vecs, index.fast.doc_ids, emb.identity(),
        device=dev, slab_dtype="int8",
    )
    del index
    return TwoTierSearcher(index8, emb, config=TwoTierConfig(fast_only=True, scan_mode="int8")), queries


#: (B, kk) at which ``--kernels`` times K5 and K2 (K1 at each B): the serve
#: batch, the fused lane's pad and a singleton at the searcher's two
#: candidate budgets
K5_SHAPES = ((256, 60), (256, 30), (8, 60), (8, 30), (1, 60), (1, 30))
#: batches at which ``--kernels`` times K2-i8 in pair order and in group
#: order (kk = 60), to place ``GATHER_I8_GROUP_MIN_B``
CROSSOVER_BS = (8, 16, 32, 64, 128, 192, 256)
#: per-dim dequant scale of the seeded int8 queries K2-i8 rescores with
I8_SCALE = 1.0 / 127.0


#: (B, nprobe) at which ``--ivf-layout`` times K2-ivf: phase 9's shapes, the
#: calibration's widest, and batches around the pair-order and run thresholds
IVF_LAYOUT_SHAPES = ((1, 8), (1, 32), (8, 8), (8, 32), (32, 8), (64, 8), (256, 8), (256, 32), (256, 256),
                     (8, 2000))


def ivf_layouts() -> int:
    """``--ivf-layout``: K2-ivf's device ms at each layout choice."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from frankensearch_tpu_torch.index import ivf
    from frankensearch_tpu_torch.ops import topk_scan as ts

    dev = torch.device("cuda")
    x, _ = cs.clustered_cell(np.random.default_rng(cs.SEED + 9))
    arm = ivf.IvfDeviceIndex(x, device=dev)
    gpc = arm.groups_per_cluster
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    chosen = ts._ivf_probe_layout
    rows = []
    try:
        for b, nprobe in IVF_LAYOUT_SHAPES:
            nprobe = min(nprobe, arm.n_clusters)
            picks = torch.randint(0, arm.slab.shape[0], (b,), generator=gen, device=dev)
            q = arm.slab[picks].to(torch.float32) + 0.02 * torch.randn(b, x.shape[1], generator=gen, device=dev)
            probe = ivf.probe_clusters(arm.centroids, q, nprobe=nprobe)
            base = chosen(b, nprobe, arm.n_clusters, gpc, cs.K, sms)
            variants = {"chosen": base, "pair order flipped": (not base[0], *base[1:]),
                        "runs flipped": (base[0], gpc if base[1] == 1 else 1, *base[2:]),
                        "query tile flipped": (*base[:2], 16 if base[2] == 8 else 8, base[3])}
            for name, layout in variants.items():
                ts._ivf_probe_layout = lambda *a, layout=layout: layout
                runs = []
                for _ in range(3):
                    total, by_name = device_split(lambda: ts.ivf_probe_topk(arm.slab, q, arm.mask, probe, k=cs.K,
                                                                            gpc=gpc))
                    runs.append((total, sum(v for k, v in by_name.items() if "ivf_probe_kernel" in k)))
                rows.append({"b": b, "nprobe": nprobe, "variant": name, "layout": list(layout),
                             "device_ms": [t for t, _ in runs], "kernel_ms": [k for _, k in runs]})
                cs.log(f"K2-ivf B={b} nprobe={nprobe} {name} (pair order, runs, query tile, list) {layout}: "
                       f"device ms {' '.join(f'{t:.4f}' for t, _ in runs)}, its kernel "
                       f"{' '.join(f'{k:.4f}' for _, k in runs)}")
    finally:
        ts._ivf_probe_layout = chosen
    cs.log(cs.gpu_line())
    print(json.dumps({"ivf_layout": rows}), flush=True)
    return 0


def pool_times() -> int:
    """``--pool``: the Model2Vec pool's kernel and its twin, device ms and
    CUDA events, at each of chip_smoke's POOL_SHAPES."""
    import chip_smoke as cs
    from frankensearch_tpu_torch.device import resolve_device
    from frankensearch_tpu_torch.embed import model2vec

    emb = cs.m2v_embedder(resolve_device("cuda"))._emb
    rows = []
    for b, t, ids, mask in cs.pool_inputs(emb):
        kernel, twin = (lambda: model2vec.gather_pool_normalize(emb, ids, mask),
                        lambda: model2vec.gather_pool_normalize_plain(emb, ids, mask))
        (ms, split), (plain_ms, _) = device_split(kernel), device_split(twin)
        row = {"b": b, "t": t, "device_ms": ms, "kernel_ms": sum(v for k, v in split.items() if "embed_pool" in k),
               "plain_device_ms": plain_ms, "wrapper_ms": cs.cuda_median_ms(kernel),
               "plain_wrapper_ms": cs.cuda_median_ms(twin)}
        print(f"pool {tuple(emb.shape)} B={b} T={t}: {ms:.4f} device ms (its kernel {row['kernel_ms']:.4f}; twin "
              f"{plain_ms:.4f}); CUDA events {row['wrapper_ms']:.4f} (twin {row['plain_wrapper_ms']:.4f})", flush=True)
        rows.append(row)
    print(cs.gpu_line())
    print(json.dumps({"pool": rows}))
    return 0


def time_kernels(root: str) -> int:
    """``--kernels``: the flat class step and K5 of the package under
    ``root``, on seeded inputs built the same way for any tree."""
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from frankensearch_tpu_torch.device import resolve_device
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops import topk_scan as ts

    dev = resolve_device("cuda")
    fused = hasattr(bm, "flat_class_fused")
    bm25, queries, _, _, _ = cs.hybrid1m_lexical(dev)
    seen = []
    flat = bm._graded_scan_flat

    def flat_noted(classes, q_ids, q_w, s_phys, dmap_groups, **kw):
        if not seen or q_ids.shape[0] > seen[0][1].shape[0]:  # the widest tile
            seen[:] = [(classes, q_ids.clone(), q_w.clone(), s_phys.clone(), dmap_groups, kw["k"])]
        return flat(classes, q_ids, q_w, s_phys, dmap_groups, **kw)

    bm._graded_scan_flat = flat_noted
    try:
        bm25.search_candidates_batch(queries, 30)
    finally:
        bm._graded_scan_flat = flat
    classes, q_ids, q_w, s_phys, dmap_groups, k = seen[0]
    steps = []
    off = goff = 0
    for cls in classes:
        n_c, l_c, d_pad = cls.term_t.shape
        gc = d_pad // 128
        dmap = dmap_groups[goff : goff + n_c * gc].reshape(n_c, d_pad)
        if fused:
            step = lambda c=cls, o=off, dm=dmap: bm.flat_class_fused(c.term_t, c.tf_t, q_ids, q_w, s_phys, o, dm)
        else:
            step = lambda c=cls, o=off, dm=dmap: bm._flat_class_poststats(
                bm.flat_class_scores(c.term_t, c.tf_t, q_ids, q_w), s_phys, o, dm)
        steps.append({"shape": [n_c, l_c, d_pad], "ms": cs.cuda_median_ms(step, iters=20)})
        off += n_c * d_pad
        goff += n_c * gc
    lane_ms = cs.cuda_median_ms(lambda: flat(classes, q_ids, q_w, s_phys, dmap_groups, k=k), iters=20)
    cs.log(f"{root}: flat class steps at B={q_ids.shape[0]} T={q_ids.shape[1]} ({'fused K3' if fused else 'K3 + post-pass'}): "
           + ", ".join(f"{st['shape']} {st['ms']:.4f}" for st in steps)
           + f" ms; one flat scan {sum(st['ms'] for st in steps):.4f} ms; _graded_scan_flat {lane_ms:.4f} ms")
    del bm25, classes, s_phys
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
    n = 1_007_616  # semantic-1M's padded row count
    slab = cs.unit_rows(gen, n, cs.DIM, dev).to(torch.bfloat16)
    mask = torch.zeros(n, device=dev)
    mask[cs.N_DOCS :] = float("-inf")
    k5 = []
    for b, kk in K5_SHAPES:
        q = cs.unit_rows(gen, b, cs.DIM, dev)
        k5.append({"b": b, "kk": kk, "ms": cs.cuda_median_ms(lambda: ts.tile_topk(slab, q, mask, kk), iters=20)})
    cs.log(f"{root}: K5 at N={n}: " + ", ".join(f"B={r['b']} kk={r['kk']} {r['ms']:.4f}" for r in k5) + " ms")
    k1, k2 = [], []
    for b in sorted({b for b, _ in K5_SHAPES}, reverse=True):
        q = cs.unit_rows(gen, b, cs.DIM, dev)
        k1_call = lambda: ts.group_max(slab, q, mask)
        k1.append({"b": b, "ms": cs.cuda_median_ms(k1_call, iters=20), "device_ms": device_ms(k1_call)})
        gm = ts.group_max(slab, q, mask)
        for kk in sorted({kk for bb, kk in K5_SHAPES if bb == b}, reverse=True):
            groups = torch.sort(ts.topk_desc_rowasc(gm, kk)[1].to(torch.int32), dim=1).values  # as the scan gives them
            k2_call = lambda: ts.gather_rescore(slab, q, groups)
            k2.append({"b": b, "kk": kk, "ms": cs.cuda_median_ms(k2_call, iters=20), "device_ms": device_ms(k2_call)})
    k6 = []
    for b in sorted({b for b, _ in K5_SHAPES}, reverse=True):
        q = cs.unit_rows(gen, b, cs.DIM, dev)
        for t in sorted({kk for bb, kk in K5_SHAPES if bb == b}, reverse=True):
            k6_call = lambda: ts.group_candidates(slab, q, mask, t, cs.AB_TILE)
            k6.append({"b": b, "kk": t, "ms": cs.cuda_median_ms(k6_call, iters=20), "device_ms": device_ms(k6_call)})
    del slab
    torch.cuda.empty_cache()
    slab_i8 = torch.randint(-127, 128, (n, cs.DIM), generator=gen, device=dev, dtype=torch.int8)
    k4, k2i8, k2i8_modes = [], [], []
    for b in sorted({b for b, _ in K5_SHAPES}, reverse=True):
        q_i8 = torch.randint(-127, 128, (b, cs.DIM), generator=gen, device=dev, dtype=torch.int8)
        k4_call = lambda: ts.group_max_int8(slab_i8, q_i8, mask)
        k4.append({"b": b, "ms": cs.cuda_median_ms(k4_call, iters=20), "device_ms": device_ms(k4_call)})
        gm = ts.group_max_int8(slab_i8, q_i8, mask)
        q_scaled = q_i8.to(torch.float32) * I8_SCALE
        for kk in sorted({kk for bb, kk in K5_SHAPES if bb == b}, reverse=True):
            groups = torch.sort(ts.topk_desc_rowasc(gm, kk)[1].to(torch.int32), dim=1).values  # as the lane gives them
            call = lambda: ts.gather_rescore_i8(slab_i8, q_scaled, groups)
            k2i8.append({"b": b, "kk": kk, "ms": cs.cuda_median_ms(call, iters=20), "device_ms": device_ms(call),
                         "bound_ms": cs.bound(cs.gathered_bytes(slab_i8, groups) + cs.nbytes(q_scaled, groups)
                                              + b * kk * ts.GROUP * 4, 2 * b * kk * ts.GROUP * cs.DIM, "f32")[0]})
    from frankensearch_tpu_torch.ops import _build

    if hasattr(_build.library(), "fs_gather_rescore_i8_sorted"):  # the tree has K2-i8's group order
        min_b = ts.GATHER_I8_GROUP_MIN_B
        for b in CROSSOVER_BS:
            q_i8 = torch.randint(-127, 128, (b, cs.DIM), generator=gen, device=dev, dtype=torch.int8)
            q_scaled = q_i8.to(torch.float32) * I8_SCALE
            groups = torch.sort(ts.topk_desc_rowasc(ts.group_max_int8(slab_i8, q_i8, mask), 60)[1].to(torch.int32),
                                dim=1).values
            call = lambda: ts.gather_rescore_i8(slab_i8, q_scaled, groups)
            rec = {"b": b, "kk": 60}
            for mode, threshold in (("pair", b + 1), ("group", b)):
                ts.GATHER_I8_GROUP_MIN_B = threshold
                rec[mode] = {"ms": cs.cuda_median_ms(call, iters=20), "device_ms": device_ms(call)}
            ts.GATHER_I8_GROUP_MIN_B = min_b
            k2i8_modes.append(rec)
        cs.log(f"{root}: K2-i8 pair order / group order at kk=60 (CUDA events / device): " + ", ".join(
            f"B={r['b']} {r['pair']['ms']:.4f} / {r['pair']['device_ms']:.4f} vs "
            f"{r['group']['ms']:.4f} / {r['group']['device_ms']:.4f}" for r in k2i8_modes) + " ms")
    del slab_i8
    torch.cuda.empty_cache()
    lane = []
    with tempfile.TemporaryDirectory(prefix="fs_kernels_") as tmp:
        searcher, queries = int8_cell(cs, dev, tmp)
        for b in (256, 1):
            call = lambda: searcher.search_batch(queries[:b], k=cs.K)
            for _ in range(3):
                call()
            total, by_name = device_split(call)
            part = lambda word: sum(ms for key, ms in by_name.items() if word in key)
            lane.append({"b": b, "device_ms": total, "k4_ms": part("group_max_kernel"),
                         "k2i8_ms": part("gather_rescore_i8_kernel"), "plan_ms": part("gather_plan")})
        del searcher
    cs.log(f"{root}: semantic-1M-int8 search_batch, device ms: " + ", ".join(
        f"B={r['b']} {r['device_ms']:.4f} (K4 {r['k4_ms']:.4f}, K2-i8 {r['k2i8_ms']:.4f}, plan {r['plan_ms']:.4f})"
        for r in lane))
    for name, recs in (("K1", k1), ("K2", k2), ("K6 (t as kk)", k6), ("K4", k4), ("K2-i8", k2i8)):
        cs.log(f"{root}: {name} at N={n} (CUDA events / device): "
               + ", ".join(f"B={r['b']}" + (f" kk={r['kk']}" if "kk" in r else "") + f" {r['ms']:.4f} / {r['device_ms']:.4f}"
                           for r in recs) + " ms")
    cs.log(cs.gpu_line())
    print(json.dumps({"root": root, "flat_fused": fused, "flat_steps": steps, "flat_scan_ms": sum(st["ms"] for st in steps),
                      "graded_scan_flat_ms": lane_ms, "flat_b": q_ids.shape[0], "flat_t": q_ids.shape[1],
                      "tile_topk": k5, "group_max": k1, "gather_rescore": k2, "group_candidates": k6,
                      "group_max_int8": k4, "gather_rescore_i8": k2i8, "gather_rescore_i8_modes": k2i8_modes,
                      "int8_lane": lane}),
          flush=True)
    return 0


#: (B, kk) at which ``--k5-split`` times K5-f32: the serve batch, the
#: fused lane's pad and a singleton at the searcher's budget
K5_SPLIT_SHAPES = ((256, 60), (8, 60), (1, 60))

#: Scratch builds of K5-f32's list entry for ``--k5-split``, as textual
#: patches of a tree's ``tile_topk.cu`` (the first form whose old strings
#: all appear): "nosel" skips the selection after each group's scan,
#: "noscan" replaces the scan with hashed scores in [-0.5, 0.5) (what the
#: selection meets on random rows: as many survivors), written as the
#: scan's epilogue would write them. None is a kernel of the port.
_HASH_SCORE = ("__device__ __forceinline__ float split_hash(long long r, int c) {\n"
               "  unsigned h = static_cast<unsigned>(r) * 2654435761u ^ static_cast<unsigned>(c) * 40503u;\n"
               "  h ^= h >> 13; h *= 0x5bd1e995u; h ^= h >> 15;\n"
               "  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f) - 0.5f;\n}\n")
K5_SPLIT_PATCHES = {
    "first port (one role, the selection after each group)": {
        "nosel": [("    const int col0 = lg * kGroup;\n    if (lg == 0) {",
                   "    if (kKind == kF32) continue;  // scratch: no selection\n"
                   "    const int col0 = lg * kGroup;\n    if (lg == 0) {")],
        "noscan": [("// The scores of one group (score_group_with, or its f32 form) into epi.",
                    _HASH_SCORE + "// The scores of one group (score_group_with, or its f32 form) into epi."),
                   ("    fs_scan_f32::score_group_f32_with<kQTile / 8>(static_cast<const float*>(q), "
                    "static_cast<const float*>(slab),\n"
                    "                                                  mask, row0, q0, b, d, sm.u.gf, epi);",
                    "    for (int i = threadIdx.x; i < kGroup; i += kThreads) sm.u.gf.mask[i] = mask[row0 + i];\n"
                    "    __syncthreads();\n"
                    "    float acc[2][kQTile / 8][4];\n"
                    "    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;\n"
                    "#pragma unroll\n    for (int mt = 0; mt < 2; ++mt)\n"
                    "#pragma unroll\n      for (int nt = 0; nt < kQTile / 8; ++nt)\n"
                    "#pragma unroll\n        for (int c = 0; c < 4; ++c)\n"
                    "          acc[mt][nt][c] = split_hash(row0 + w * 32 + mt * 16 + (l >> 2) + (c >> 1) * 8,\n"
                    "                                      q0 + nt * 8 + 2 * (l & 3) + (c & 1));\n"
                    "    epi(acc);")],
    },
    "two roles (8 scan warps beside the selection warps)": {
        "nosel": [("    const ScoreRow* staged = scores[buf];\n    if (grp == 0) {",
                   "    const ScoreRow* staged = scores[buf];\n    if (grp >= 0) {  // scratch: no selection\n"
                   "    } else if (grp == 0) {")],
        # nosel with the query loads (8 of a scan thread's 12 a step) once a
        # stage: wrong scores, the scan's time with a third of its loads
        "nosel_hoisted": [("    const ScoreRow* staged = scores[buf];\n    if (grp == 0) {",
                           "    const ScoreRow* staged = scores[buf];\n    if (grp >= 0) {  // scratch: no selection\n"
                           "    } else if (grp == 0) {"),
                          ("(&qs[(c0 + nt * 8 + 2 * t + j) * ldq + k]);",
                           "(&qs[(c0 + nt * 8 + 2 * t + j) * ldq + 0]);  // scratch: hoisted")],
        "noscan": [("// The scan role (warps 0-7)", _HASH_SCORE + "// The scan role (warps 0-7)"),
                   ("    for (int kc = 0; kc < n_ch; ++kc) {\n      const int it = grp * n_ch + kc;",
                    "#pragma unroll\n    for (int mt = 0; mt < kMT; ++mt)\n"
                    "#pragma unroll\n      for (int nt = 0; nt < kWN; ++nt)\n"
                    "#pragma unroll\n        for (int c = 0; c < 4; ++c)\n"
                    "          acc[mt][nt][c] = split_hash(row_base + grp * kGroup + r0 + mt * 16 + g + 8 * (c >> 1),\n"
                    "                                      q0 + c0 + nt * 8 + 2 * t + (c & 1));\n"
                    "    for (int kc = n_ch; kc < n_ch; ++kc) {  // scratch: no scan\n"
                    "      const int it = grp * n_ch + kc;")],
    },
}


def k5_split(root: str) -> int:
    """``--k5-split [ROOT]``: K5-f32's list entry of the tree under ROOT at
    K5_SPLIT_SHAPES on a seeded 1,007,616 x 256 f32 slab, as it is ("full")
    and as the two scratch builds of K5_SPLIT_PATCHES, each copy of the
    package under ``build/k5split/`` and timed in a process of its own (all
    three built first, in parallel); with the ptxas report of the kernel's
    f32 instances. Scan share = noscan's complement: full - noscan is the
    time the scan adds, full - nosel the time the selection adds."""
    import shutil
    import subprocess

    src = open(os.path.join(root, "frankensearch_tpu_torch", "ops", "csrc", "tile_topk.cu")).read()
    form, patches = next((f, p) for f, p in K5_SPLIT_PATCHES.items()
                         if all(old in src for pairs in p.values() for old, _ in pairs))
    base = os.path.join(HERE, "build", "k5split", hashlib.sha256(src.encode()).hexdigest()[:12])
    roots = {}
    for variant, pairs in [("full", [])] + list(patches.items()):
        vroot = os.path.join(base, variant)
        shutil.rmtree(vroot, ignore_errors=True)
        os.makedirs(vroot)
        for part in ("frankensearch_tpu_torch", "native", "chip_smoke.py"):
            path = os.path.join(root, part)
            if os.path.isdir(path):
                shutil.copytree(path, os.path.join(vroot, part), ignore=shutil.ignore_patterns("__pycache__"))
            elif os.path.exists(path):
                shutil.copy(path, vroot)
        text = src
        for old, new in pairs:
            text = text.replace(old, new, 1)
        with open(os.path.join(vroot, "frankensearch_tpu_torch", "ops", "csrc", "tile_topk.cu"), "w") as f:
            f.write(text)
        roots[variant] = vroot
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--k5-time", r, "build"]) for r in roots.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a K5-f32 split build failed")
    out = {"root": root, "form": form, "variants": {}}
    for variant, vroot in roots.items():
        run = subprocess.run([sys.executable, me, "--k5-time", vroot], capture_output=True, text=True, check=True)
        out["variants"][variant] = json.loads(run.stdout.strip().splitlines()[-1])
    for variant, rec in out["variants"].items():
        load = rec["b256_under_load"]
        print(f"{root} K5-f32 {variant}: " + ", ".join(f"B={r['b']} kk={r['kk']} {r['ms']:.4f} ms"
                                                       for r in rec["times"])
              + f"; K5 bf16 B=256 kk=60 {rec['bf16_b256_kk60_ms']:.4f} ms; at B=256 the SM clock "
              f"{load['sm_mhz']:.0f} MHz, {load['power_w']:.1f} W ({load['samples']} samples)", flush=True)
        for line in rec["ptxas"]:
            print(f"  {line}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def k5_time(root: str, build_only: bool) -> int:
    """``--k5-time ROOT [build]``: one tree's K5-f32 at K5_SPLIT_SHAPES (the
    worker of ``--k5-split``); the last line is a JSON record."""
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from frankensearch_tpu_torch.ops import _build
    from frankensearch_tpu_torch.ops import topk_scan as ts

    lib = _build.library_path()
    if build_only:
        return 0
    ptxas, entry = [], None
    for line in lib.with_suffix(".log").read_text().splitlines():  # the list entry's f32 instances
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "tile_topk" in line and "wide" not in line else None
        elif entry and ("spill" in line or "Used" in line):
            ptxas.append(f"{entry}: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
    n = 1_007_616
    slab = cs.unit_rows(gen, n, cs.DIM, dev)
    mask = torch.zeros(n, device=dev)
    mask[cs.N_DOCS:] = float("-inf")
    times = []
    for b, kk in K5_SPLIT_SHAPES:
        q = cs.unit_rows(gen, b, cs.DIM, dev)
        times.append({"b": b, "kk": kk, "ms": cs.cuda_median_ms(lambda: ts.tile_topk(slab, q, mask, kk), iters=20)})
    q = cs.unit_rows(gen, 256, cs.DIM, dev)
    clocks = under_load(lambda: ts.tile_topk(slab, q, mask, 60))
    slab = slab.to(torch.bfloat16)  # K5 (bf16) at the serve batch: the selection code it shares
    bf16_ms = cs.cuda_median_ms(lambda: ts.tile_topk(slab, q, mask, 60), iters=20)
    print(json.dumps({"root": root, "times": times, "bf16_b256_kk60_ms": bf16_ms, "ptxas": ptxas,
                      "b256_under_load": clocks, "gpu": cs.gpu_line()}), flush=True)
    return 0


def under_load(fn, seconds: float = 2.0) -> dict:
    """The card's SM clock (MHz) and power draw (W) while ``fn`` runs back
    to back for ``seconds``: medians of nvidia-smi's samples every 100 ms."""
    import subprocess

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    samples = [[float(x) for x in line.split(",")] for line in out.strip().splitlines()[2:] if "," in line]
    return {"sm_mhz": statistics.median(c for c, _ in samples), "power_w": statistics.median(w for _, w in samples),
            "samples": len(samples)}


def time_opens(out_dir: str, trees: list[str]) -> int:
    """``--open OUT_DIR TREE ...``: the watched cli-1M root, then each
    tree's open of it (see the module docstring)."""
    import subprocess

    import numpy as np

    import chip_smoke as cs

    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="fs_open_") as tmp:
        docs, _ = cs.hybrid1m_docs(np.random.default_rng(cs.SEED + 4))
        texts = [d.content for d in docs]
        del docs
        corpus, root = os.path.join(tmp, "cli_corpus.jsonl"), os.path.join(tmp, "cli_root")
        with open(corpus, "w", encoding="utf-8") as f:
            f.writelines(json.dumps({"id": f"doc-{i:07d}", "content": t}) + "\n" for i, t in enumerate(texts))
        t0 = time.perf_counter()
        cs.run_cli(["index", corpus, "--root", root])
        index_s = time.perf_counter() - t0
        live = os.path.join(tmp, "live")
        cs.live_corpus(live, texts)
        run1, ms1 = cs.watch_run(live, root)
        cs.log(f"open: cli index {index_s:.1f} s; watch run 1 {run1['batches']} in {ms1['wall'] / 1e3:.1f} s "
               f"(its open {ms1['open'][0] / 1e3:.1f} s, seal {ms1['seal']} ms); lexical/ "
               + str(sorted(os.listdir(os.path.join(root, "lexical", open(os.path.join(root, "lexical", "CURRENT"))
                                                    .read().strip())))))
        del texts
        rows = []
        for i, tree in enumerate(trees):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--open-time", tree, root,
                                  os.path.join(out_dir, f"open_{i}_{os.path.basename(tree.rstrip('/')) or 'tree'}.txt")],
                                 stdout=subprocess.PIPE, text=True, check=True)
            rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
            cs.log(f"open {i} {tree}: " + json.dumps(rows[-1]))
    cs.log(cs.gpu_line())
    print(json.dumps({"opens": rows, "index_s": index_s}), flush=True)
    return 0


def open_time(tree: str, root: str, report: str) -> int:
    """``--open-time TREE ROOT REPORT``: the worker of ``--open``; the last
    line is a JSON record (seconds)."""
    import torch

    sys.path.insert(0, tree)
    from frankensearch_tpu_torch import builder
    from frankensearch_tpu_torch.lexical import persist

    def timed_open() -> float:
        t0 = time.perf_counter()
        handle = builder.open_hybrid(root)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        handle.close()
        del handle
        torch.cuda.empty_cache()
        return dt

    rec = {"tree": tree, "open_s": [timed_open(), timed_open()]}
    t0 = time.perf_counter()
    oracle = persist.load_lexical(root)
    rec["load_lexical_s"] = time.perf_counter() - t0
    rec["docs"] = oracle.doc_count()
    del oracle
    prof = cProfile.Profile()
    prof.enable()
    rec["open_under_cprofile_s"] = timed_open()
    prof.disable()
    with open(report, "w") as f:
        for key in ("cumulative", "tottime"):
            listing = io.StringIO()
            pstats.Stats(prof, stream=listing).sort_stats(key).print_stats(40)
            f.write(f"by {key}:\n{listing.getvalue()}\n")
    print(json.dumps(rec), flush=True)
    return 0


def main() -> int:
    # the port must reach neither jax nor the JAX package, even indirectly
    sys.modules["jax"] = None
    sys.modules["frankensearch_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        print("profile_chip: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if len(sys.argv) > 1 and sys.argv[1] == "--kernels":
        return time_kernels(os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else HERE)
    if len(sys.argv) > 1 and sys.argv[1] == "--pool":
        return pool_times()
    if len(sys.argv) > 1 and sys.argv[1] == "--ivf-layout":
        return ivf_layouts()
    if len(sys.argv) > 1 and sys.argv[1] == "--k5-split":
        return k5_split(os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else HERE)
    if len(sys.argv) > 3 and sys.argv[1] == "--open":
        return time_opens(sys.argv[2], [os.path.abspath(t) for t in sys.argv[3:]])
    if len(sys.argv) > 4 and sys.argv[1] == "--open-time":
        return open_time(sys.argv[2], sys.argv[3], sys.argv[4])
    if len(sys.argv) > 2 and sys.argv[1] == "--k5-time":
        return k5_time(os.path.abspath(sys.argv[2]), sys.argv[3:] == ["build"])
    import chip_smoke as cs
    from frankensearch_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    def hybrid1m(dev, tmp):
        # its own 1M-doc vector index, in a directory of its own
        _, index, emb, _, _ = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
        searcher, _, queries, _, _, _ = cs.hybrid1m_cell(dev, index, emb)
        return searcher, queries

    def hybrid1m_m2v(dev, tmp):
        from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
        from frankensearch_tpu_torch.embed.bulk import embed_corpus

        bm25, queries, _, _, texts = cs.hybrid1m_lexical(dev)
        m2v = cs.m2v_embedder(dev)
        index = TwoTierIndex.create(
            tempfile.mkdtemp(dir=tmp), embed_corpus(m2v, texts), [f"doc-{i:07d}" for i in range(len(texts))],
            m2v.identity(), device=dev,
        )
        return TwoTierSearcher(index, m2v, lexical=bm25, config=TwoTierConfig(fast_only=True)), queries

    def built1m_m2v(dev, tmp):
        from frankensearch_tpu_torch import EmbedderStack, IndexableDocument, IndexBuilder, TwoTierConfig, open_hybrid

        bm25, queries, _, _, texts = cs.hybrid1m_lexical(dev)
        del bm25
        m2v = cs.m2v_embedder(dev)
        root = tempfile.mkdtemp(dir=tmp)
        IndexBuilder(root, device=dev).with_documents(
            IndexableDocument(doc_id=f"doc-{i:07d}", content=t) for i, t in enumerate(texts)
        ).with_embedder_stack(EmbedderStack(fast=m2v)).build()
        handle = open_hybrid(root, fast_embedder=m2v, config=TwoTierConfig(fast_only=True), device=dev)
        return handle.searcher, queries

    def cli1m(dev, tmp):
        from frankensearch_tpu_torch import open_hybrid

        _, queries, _, _, texts = cs.hybrid1m_lexical(dev)
        corpus, root = os.path.join(tmp, "cli_corpus.jsonl"), tempfile.mkdtemp(dir=tmp)
        with open(corpus, "w", encoding="utf-8") as f:
            f.writelines(json.dumps({"id": f"doc-{i:07d}", "content": t}) + "\n" for i, t in enumerate(texts))
        cs.run_cli(["index", corpus, "--root", root])
        return open_hybrid(root, device=dev).searcher, queries

    def semantic_pallas(dev, tmp):
        from frankensearch_tpu_torch import TwoTierConfig, TwoTierSearcher

        _, index, emb, _, queries = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
        return TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True, scan_mode="pallas")), queries

    def hybrid1m_quality(dev, tmp):
        from frankensearch_tpu_torch import TwoTierSearcher
        from frankensearch_tpu_torch.rerank.encoder import load_artifact

        _, index, emb, _, _ = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
        bm25, queries, _, _, _ = cs.hybrid1m_lexical(dev)
        quality = load_artifact(os.path.join(HERE, cs.QUALITY_ARTIFACT), device=dev)
        index = cs.quality_index(dev, index, quality.identity())
        return TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=quality,
                               cache_query_embeddings=False), queries

    def semantic_f32(dev, tmp, scan_mode="auto"):
        from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
        from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex

        _, index, emb, vecs, queries = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
        f32 = TwoTierIndex(DeviceVectorIndex(vecs, index.fast.doc_ids, emb.identity(), device=dev,
                                             slab_dtype="f32"))
        return TwoTierSearcher(f32, emb, config=TwoTierConfig(fast_only=True, scan_mode=scan_mode)), queries

    def semantic_mrl(dev, tmp):
        from frankensearch_tpu_torch import TwoTierConfig, TwoTierSearcher

        _, index, emb, _, queries = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
        return TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True, mrl_search_dims=cs.MRL_DIMS)), queries

    def semantic_ivf(dev, tmp):
        import numpy as np

        from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher

        _, _, emb, _, queries = cs.semantic_cell(dev, tempfile.mkdtemp(dir=tmp))
        x, _ = cs.clustered_cell(np.random.default_rng(cs.SEED + 9))
        index = TwoTierIndex.create(tempfile.mkdtemp(dir=tmp), x, [f"doc-{i:07d}" for i in range(cs.N_DOCS)],
                                    emb.identity(), device=dev)
        index.fast.enable_ivf()
        return TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True, scan_mode="ivf")), queries

    cells = (("semantic-1M", cs.semantic_cell), ("semantic-1M-pallas", semantic_pallas),
             ("hybrid-60k", cs.hybrid_cell), ("hybrid-1M", hybrid1m),
             ("semantic-1M-int8", lambda dev, tmp: int8_cell(cs, dev, tmp)), ("hybrid-1M-m2v", hybrid1m_m2v),
             ("hybrid-1M-quality", hybrid1m_quality), ("semantic-1M-f32", semantic_f32),
             ("semantic-1M-f32-pallas", lambda dev, tmp: semantic_f32(dev, tmp, "pallas")),
             ("semantic-1M-mrl", semantic_mrl), ("semantic-1M-ivf", semantic_ivf),
             ("built-1M-m2v", built1m_m2v), ("cli-1M", cli1m))
    cells = [(cell, build) for cell, build in cells if len(sys.argv) <= 2 or cell in sys.argv[2:]]
    if len(cells) > 1:
        # a process per cell: a trace taken after another cell's profiled
        # runs has missed launches of the port's kernels, the first cell's
        # traces in a process never did (measured on the H100)
        import subprocess

        for cell, _ in cells:
            run = subprocess.run([sys.executable, os.path.abspath(__file__), out_dir, cell],
                                 stdout=subprocess.PIPE, text=True, check=True)
            lines = run.stdout.strip().splitlines()
            print("\n".join(lines[:-2]), flush=True)  # its log, without its card line and summary
            rows += json.loads(lines[-1])["profile"]
        cs.log(cs.gpu_line())
        print(json.dumps({"profile": rows}), flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix="fs_profile_") as tmp:
        for cell, build in cells:
            built = build(dev, tmp)
            searcher, queries = built[0], built[-1]
            for b in (256, 1):
                batch = queries[:b]

                def call(batch=batch):
                    return searcher.search_batch(batch, k=cs.K)

                for _ in range(3):
                    call()
                host = [cs.timed(call)[1] for _ in range(REPS)]
                device_ms, torch_prof_ms, cprofile_ms, missing, pad = profile_once(
                    call, os.path.join(out_dir, f"profile_{cell}_b{b}.txt")
                )
                row = {
                    "cell": cell, "b": b,
                    "host_ms_median": statistics.median(host),
                    "host_ms_min": min(host), "host_ms_max": max(host),
                    "device_ms": device_ms,
                    "idle_share": 1.0 - device_ms / statistics.median(host),
                    "host_ms_under_torch_profiler": torch_prof_ms,
                    "host_ms_under_cprofile": cprofile_ms,
                    "embed_fused": searcher.last_phase1_embed_fused,
                    "trace_missed": missing,
                    "trace_pad_s": pad,
                }
                rows.append(row)
                cs.log(f"{cell} B={b}: host {row['host_ms_median']:.3f} ms median of {REPS} "
                       f"({row['host_ms_min']:.3f}-{row['host_ms_max']:.3f}); device {device_ms:.3f} ms; "
                       f"idle {row['idle_share']:.3f}; under torch.profiler {torch_prof_ms:.3f} ms, "
                       f"under cProfile {cprofile_ms:.3f} ms; embed in the pass {row['embed_fused']}; "
                       f"trace idle pad {pad} s"
                       + (f"; the trace MISSED {missing}: device ms and idle share are not whole" if missing else ""))
            del built, searcher
            torch.cuda.empty_cache()
    cs.log(cs.gpu_line())
    print(json.dumps({"profile": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
