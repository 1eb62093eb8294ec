#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one CUDA card).

Phases:
  0. the card (nvidia-smi name + power limit), torch version, kernel build;
  1. each kernel against its plain PyTorch twin, at every shape the main
     path gave it (batch sizes B = 256, 8 and 1; group and candidate counts
     kk as the searcher's budget sets them), on the cell's own data: K1
     (group max) and K2 (gather + rescore) within REL_TOL on each cell's
     slab and mask (phase 2's is 1,007,616 x 256 bf16); K3 (one class of
     the flat lane: tail scores, hot partial, padding mask, group maxima
     and rows, in one pass) bitwise on every length class at every (B, T)
     of phases 4 and 7; K4 (int8 group max) bitwise and K2-i8 (int8 gather
     + rescore) within REL_TOL on phase 5's int8 slab, its B=256 call
     (group order) bitwise the concatenation of 32 B=8 calls on the same
     rows (pair order); K5 (per-tile top-k)
     within REL_TOL on phase 2's slab, its first candidates bitwise K1's
     tile maxima, and bitwise on seeded adversarial tiles through both of
     its entries. It runs inside phases 2-7, after their main-path runs, so
     that it knows those shapes;
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
     device RRF bitwise against the host oracle;
  5. the fast tier's other scan modes over phase 2's vectors, through the
     unfused path: ``scan_mode="int8"`` over an int8 ``TwoTierIndex``
     (kernels K4 and K2's int8 form) fast-only and hybrid with phase 4's
     lexical arm (its pools held to phase 4's within 1e-6), certified and
     served behind the recall-certificate gate, then reopened with the
     persisted certificate; ``scan_mode="pallas"`` (kernel K5) over phase
     2's bf16 index, held to the K1/K2 lane. recall@10 against the exact
     f32 scan (int8 >= 0.97, pallas >= 0.99); singletons (four-word
     queries, whose vector budget is the batch's) bitwise equal to their
     batch rows (hybrid: their lexical budget is not the batch's, so the
     lexical and vector score bits of the docs both lists hold);
  6. the A/B scan over phase 2's slab and queries (B = 256, 8, 1; k = 30,
     60): ``scan_topk_hierarchical_ab(emit="tile_topk")``, whose per-tile
     group candidates come from kernel K6, bitwise equal to the K1/K2 route,
     as is ``group_select="iter"``; ``rescore="xla"`` (the f32 query) held
     to the same rescore over K1's groups and to f64 dot products; then K6
     against its twin (values within REL_TOL, group ids equal except where
     two groups' maxima tie, every value K1's maximum for its group, K1's
     time alone beside K6's), and K6's selection bitwise against the argmax
     passes on crafted maxima (ties, both zeros, masked groups and tiles);
  7. hybrid-1M with a Model2Vec fast tier (hybrid-1M-m2v): a seeded
     500,000 x 256 table, phase 4's 1M docs embedded through the bag lane
     (``embed_corpus``, twice: the same bits) into a bf16 index, served with
     phase 4's lexical arm and traffic through the fully fused lane (the
     embed inside the pass): the daat, blocked and mixed lanes, the device
     RRF bitwise against the host oracle, singletons against their batch
     rows, the lexical pools against phase 4's, vector recall@10 against an
     exact f32 scan of the pass's own query vectors, and the results against
     the same batch embedded on the host first;
  8. hybrid-1M with a 1M x 384 quality tier (hybrid-1M-quality): the trained
     encoder, the Refined phase of ``search_batch`` and ``search()`` (aligned
     rescore and rescan, K1/K2 at d = 384), a seeded cross-encoder, and the
     held-out lift against the CPU;
  9. the scan lanes and the write path: semantic-1M-f32 (phase 2's vectors
     as an f32 slab; ``auto`` on K1 and K2's f32 forms and ``pallas`` on
     K5's, B = 256, 8, 1, doc sets against the plain f32 scan up to ties
     within F32_TIE_REL at the k-th score); semantic-1M-mrl (phase 2's
     index with ``mrl_search_dims=64``, recall@10, a B=8 subset against the
     same op on CPU copies); the int4 two-pass scan over phase 2's vectors
     (a B=8 subset against the CPU); semantic-1M-ivf (a clustered 1M
     corpus, its IVF arm built on the card: build time, recall@10 at nprobe
     8 and 32, scanned fraction, full probe against the hierarchical scan up
     to ties within bf16 rounding, K2 at the probe's shapes against its
     twin, a calibrated nprobe certified, persisted, served behind the gate
     and rebound after a reopen); the write path over phase 2's index (10,000
     appends, 1,000 deletes, a WAL sync: each appended doc its own top hit,
     no deleted doc returned, ``mode="ivf"`` refused until ``enable_ivf()``
     runs again, then ``compact()`` and a reopen with the top-10 bitwise
     unchanged).

The kernels line gives each kernel's time, its twin's, and its bound: the
larger of the bytes it must move (each input read once, each output
written once; a gather counts the distinct groups it reads) over 3.35 TB/s
and its operations over the H100's dense peak for their type (integer
compares at the INT32 lanes' rate). K1, K2 and K5 on an f32 slab (their
FFMA forms) and K2 at the IVF probe's shapes have entries of their own.
Each entry is one launch at its headline shape; K3's is the mean over the length classes of one flat scan
at the widest batch tile, the unit its launch count counts.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
#: integer compares: one instruction per lane on the 64 INT32 lanes of each
#: Hopper SM per clock (NVIDIA's Hopper tuning guide, arithmetic throughput
#: of compute capability 9.0), 132 SMs at the 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_OPS_PER_S = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12, "f32": 67e12,  # dense
                  "int32": INT32_OPS_PER_S}
INT8_RECALL_FLOOR = 0.97  # the reference's own recall@10 figure for the int8 lane
AB_BATCHES = (256, 8, 1)  # phase 6: the serve batch, the fused lane's pad, a singleton
AB_KS = (30, 60)  # the searcher's candidate budgets at k = 10
AB_TILE = 8192  # K6's widest tile: 64 groups
M2V_ROWS = 500_000  # of the order of potion-multilingual-128M's 128M parameters over 256 dims
M2V_COS_FLOOR = 0.99999  # bag lane vs embed_batch (tests/test_bulk_embed.py)
#: how far rounding a unit query and a unit doc vector to bf16 (unit
#: roundoff u = 2^-9) can move their dot product: (2u + u^2) |q| |d|, plus
#: f32 sums; two docs closer than twice this may swap against an f32 scan
BF16_DOT_BOUND = 2.0**-8 + 2.0**-18 + 1e-5
LEX_REL_TOL = 1e-6  # pruned vs dense lane: the same f32 terms summed in another order
H1M_DOCS = 1_000_000  # tools/bench_hybrid_1m.py: 1M docs of 14 zipf(1.35) words
H1M_VOCAB = 50_000
H1M_WORDS = 14
H1M_ZIPF = 1.35
H1M_MIN_POSTINGS = 1 << 21  # the blocked layout's threshold
ORACLE_REL_TOL = 1e-5  # f32 device BM25 vs the exact f64 host sum
Q_DIM = 384  # the quality tier's width: data/quality_encoder_384 is MiniLM-L6's H = 384
QUALITY_ARTIFACT = "data/quality_encoder_384"
#: cross-encoder/ms-marco-MiniLM-L-6-v2's config.json (its weights are not
#: in the repository: phase 8 draws them from a seed)
CE_CONFIG = {"vocab_size": 30522, "hidden": 384, "layers": 6, "heads": 12, "intermediate": 1536,
             "max_position": 512}
ENC_BATCHES = (256, 8, 1)  # the serve batch, the fused lane's pad, a singleton
#: card vs CPU, the tolerances tests/test_torch_rerank.py states for the
#: port against the reference: f32 sums in another order (quality vectors,
#: cross-encoder scores), a bf16 rounding landing the other way, int8
#: activations rounded to the neighbouring value (each such step moves a
#: product by 1/127 of its row's largest activation, through six layers)
ENC_F32_TOL = 1e-5
ENC_BF16_TOL = 5e-4
CE_F32_TOL = 1e-5
CE_INT8_TOL = 5e-3
#: a query's quality vector alone (B=1) against its row of the B=256
#: forward, elementwise on unit vectors: the batch pads every query to the
#: length bucket of its longest one, and cuBLAS picks its GEMM by row
#: count, so the f32 sums may run in another order (f32); under bf16
#: compute such a difference can move an intermediate's bf16 rounding (the
#: bf16 tolerance above)
SOLO_BATCH_TOL = {"f32": 1e-5, "bf16": ENC_BF16_TOL}
LIFT_FLOOR = 0.0406  # the recorded held-out lift CI's lower end (tests/test_trained_quality_384.py)
LIFT_TOL = 0.005  # card vs CPU mean lift on the same world
LIFT_SEED = 11  # tools/train_quality_lift.py's world
F32_TIE_REL = 1e-6  # f32 slab lanes vs the plain f32 scan: the same f32 products summed in another order
MRL_DIMS = 64  # semantic-1M-mrl's pass-1 dims (the reference's default search_dims)
MRL_CPU_TOL = 1e-6  # MRL card vs CPU: f32 sums in another order
IVF_CENTRES = 2_000  # the clustered corpus's centres: the IVF arm's default cluster count at 1M docs
IVF_SPREAD = 0.125  # per-dim noise: |noise| ~ 2 at d = 256, as tests/test_ivf.py's 0.25 at d = 64
IVF_QUERY_NOISE = 0.025  # |noise| ~ 0.4 at d = 256, as that test's 0.05 at d = 64
IVF_NPROBES = (8, 32)  # the default ivf_nprobe and a wider probe
#: calibrate_nprobe's target: per-query recall@10 is a multiple of 0.1, and
#: so is the certified recall (a lower quantile of it): 0.9 is the highest
#: target short of every query's full top-10
IVF_TARGET_RECALL = 0.9
#: the nprobe values calibrated: a certified (lower-quantile) recall of 0.9
#: can take hundreds of probes where the capacity-balanced assignment has
#: placed docs away from their nearest clusters
IVF_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
IVF_OWN_HIT_FLOOR = 0.99  # appended docs found first by the rebuilt arm at nprobe 8 (spill can place a doc past its probes)
APPEND_DOCS = 10_000
DELETE_DOCS = 1_000  # half of them appended docs, half phase 2's


#: the kernels line: name, launch counter, source, the TPU kernel it
#: replaces, the cell whose largest shape is the headline
KERNELS = (
    ("group_max", "K1", "frankensearch_tpu_torch/ops/csrc/group_max.cu",
     "frankensearch_tpu/ops/topk_scan.py:220", "semantic-1M"),
    ("gather_rescore", "K2", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M"),
    ("flat_fused", "K3", "frankensearch_tpu_torch/ops/csrc/flat_score.cu",
     "frankensearch_tpu/lexical/device_bm25.py:405", "hybrid-1M"),
    ("group_max_int8", "K4", "frankensearch_tpu_torch/ops/csrc/group_max.cu",
     "frankensearch_tpu/ops/topk_scan.py:240", "semantic-1M-int8"),
    ("gather_rescore_i8", "K2-i8", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M-int8"),
    ("tile_topk", "K5", "frankensearch_tpu_torch/ops/csrc/tile_topk.cu",
     "frankensearch_tpu/ops/topk_scan.py:114", "semantic-1M"),
    ("group_candidates", "K6", "frankensearch_tpu_torch/ops/csrc/group_candidates.cu",
     "frankensearch_tpu/ops/ab_primitives.py:103", "semantic-1M"),
    ("group_max_f32", "K1-f32", "frankensearch_tpu_torch/ops/csrc/group_max.cu",
     "frankensearch_tpu/ops/topk_scan.py:220", "semantic-1M-f32"),
    ("gather_rescore_f32", "K2-f32", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M-f32"),
    ("tile_topk_f32", "K5-f32", "frankensearch_tpu_torch/ops/csrc/tile_topk.cu",
     "frankensearch_tpu/ops/topk_scan.py:114", "semantic-1M-f32"),
    ("gather_rescore_ivf", "K2-ivf", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M-ivf"),
)


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
    kind, form = kernel_form(slab)
    recs = []
    todo = shapes - set(done)
    for b in sorted({s[1] for s in shapes if s[0] == "group_max"}, reverse=True):
        q = unit_rows(gen, b, d, slab.device)
        gm = ts.group_max(slab, q, mask)
        if ("group_max", b, 0) in todo:
            err = check_close(gm, ts.group_max_plain(slab, q, mask), f"phase1 {cell} K1 B={b}")
            ms = cuda_median_ms(lambda: ts.group_max(slab, q, mask))
            plain_ms = cuda_median_ms(lambda: ts.group_max_plain(slab, q, mask))
            recs.append({"kernel": "group_max" + form, "cell": cell, "n": n, "b": b, "kk": None,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                         "bound": bound(nbytes(slab, q, mask, gm), 2 * b * n * d, kind)})
        for kk in sorted(s[2] for s in todo if s[0] == "gather_rescore" and s[1] == b):
            _, groups = ts.topk_desc_rowasc(gm, kk)
            groups = torch.sort(groups.to(torch.int32), dim=1).values
            r = ts.gather_rescore(slab, q, groups)
            err = check_close(r, ts.gather_rescore_plain(slab, q, groups),
                              f"phase1 {cell} K2 B={b} kk={kk}")
            ms = cuda_median_ms(lambda: ts.gather_rescore(slab, q, groups))
            plain_ms = cuda_median_ms(lambda: ts.gather_rescore_plain(slab, q, groups))
            recs.append({"kernel": "gather_rescore" + form, "cell": cell, "n": n, "b": b, "kk": kk,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                         "bound": bound(gathered_bytes(slab, groups) + nbytes(q, groups, r),
                                        2 * r.numel() * d, kind)})
    log_kernel_records(cell, recs)
    return recs


def kernel_form(slab) -> tuple[str, str]:
    """(the operations' type for the bound, the kernels line's name suffix)
    of a slab: bf16/f16 score on the tensor cores, f32 by FFMA (the kernels'
    f32 forms, entries of their own on the kernels line)."""
    import torch

    return {torch.bfloat16: ("bf16", ""), torch.float16: ("f16", ""), torch.float32: ("f32", "_f32")}[slab.dtype]


def log_kernel_records(cell: str, recs: list[dict]) -> None:
    for r in recs:
        log(f"phase1 {cell} {r['kernel']} N={r['n']} B={r['b']}"
            + (f" kk={r['kk']}" if r["kk"] is not None else "")
            + f": {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]})"
            f" max abs err {r['max_abs_err']:.3e} (tolerance {REL_TOL:g} x max(1, |twin|))")


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for a kernel that must
    move ``bytes_moved`` bytes and do ``ops`` operations of type ``kind``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gathered_bytes(slab, groups) -> int:
    """Bytes of the distinct 128-row groups a gather must read."""
    import torch

    return int(torch.unique(groups).numel()) * 128 * slab.shape[1] * slab.element_size()


def launch_counters() -> dict:
    """Kernel name -> its wrapper (each counts its launches)."""
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops import topk_scan as ts

    return {"K1": ts.group_max, "K2": ts.gather_rescore, "K3": bm.flat_class_fused,
            "K4": ts.group_max_int8, "K2-i8": ts.gather_rescore_i8, "K5": ts.tile_topk,
            "K6": ts.group_candidates}


def drive(fn, shapes: set, flat_inputs: dict | None = None, *, dim: int | None = None):
    """Run ``fn`` with the kernels' launch counters zeroed; returns
    (result, {kernel: launches}) of that run alone. Adds to ``shapes`` the
    kernel shapes of every scan in the run (with ``dim``, of every
    hierarchical scan over a slab of that width): a hierarchical scan runs K1 at
    ("group_max", B, 0) and K2 at ("gather_rescore", B, kk), an int8 scan
    K4 at ("group_max_int8", B, 0) and K2-i8 at ("gather_rescore_i8", B,
    kk), a per-tile scan K5 at ("tile_topk", B, kk). ``flat_inputs``
    collects, for each (B, T) at which the flat lane ran K3, a copy of the
    first query rows, hot partial and group-row map it got."""
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops import topk_scan as ts

    scan, scan_i8, scan_tiles = ts.scan_topk_hierarchical, ts.scan_topk_hierarchical_int8, ts.scan_topk_pallas
    flat = bm._graded_scan_flat

    def scan_noted(slab, queries, k, mask=None):
        b = queries.shape[0]
        if dim is None or slab.shape[1] == dim:
            shapes.add(("group_max", b, 0))
            shapes.add(("gather_rescore", b, min(k, slab.shape[0] // ts.GROUP)))
        return scan(slab, queries, k, mask)

    def scan_i8_noted(slab_i8, scale, queries, k, mask=None, *, group_overfetch=1):
        b = queries.shape[0]
        shapes.add(("group_max_int8", b, 0))
        shapes.add(("gather_rescore_i8", b, min(max(k * group_overfetch, k), slab_i8.shape[0] // ts.GROUP)))
        return scan_i8(slab_i8, scale, queries, k, mask, group_overfetch=group_overfetch)

    def tiles_noted(slab, queries, k, mask=None, *, tile_n=ts.TILE_N):
        shapes.add(("tile_topk", queries.shape[0], min(k, tile_n)))
        return scan_tiles(slab, queries, k, mask, tile_n=tile_n)

    def flat_noted(classes, q_ids, q_w, s_phys, dmap_groups, **kw):
        if flat_inputs is not None and tuple(q_ids.shape) not in flat_inputs:
            flat_inputs[tuple(q_ids.shape)] = (q_ids.clone(), q_w.clone(),
                                               None if s_phys is None else s_phys.clone(), dmap_groups)
        return flat(classes, q_ids, q_w, s_phys, dmap_groups, **kw)

    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    ts.scan_topk_hierarchical, ts.scan_topk_hierarchical_int8, ts.scan_topk_pallas = (
        scan_noted, scan_i8_noted, tiles_noted)
    bm._graded_scan_flat = flat_noted
    try:
        result = fn()
    finally:
        ts.scan_topk_hierarchical, ts.scan_topk_hierarchical_int8, ts.scan_topk_pallas = scan, scan_i8, scan_tiles
        bm._graded_scan_flat = flat
    return result, {name: wrapper.launches for name, wrapper in counters.items()}


def need_launches(phase: str, launches: dict, names=("K1", "K2")) -> None:
    """Fail unless every named kernel launched on the phase's main path."""
    for name in names:
        if launches[name] < 1:
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


def phase2_semantic(dev, tmp: str) -> tuple[dict, dict, list[dict], dict]:
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
    # phase 4 serves its lexical corpus over this index (same doc ids);
    # phase 5 its other scan modes over the same vectors and queries
    semantic = {"index": index, "emb": emb, "shapes": shapes, "vecs": vecs, "queries": queries,
                "exact_ids": exact_ids, "rows": [rows_of(out) for out in batch]}
    return ({"recall_at_10": recall, "batch_ms": batch_ms, "single_ms": single_ms},
            launches, kernels, semantic)


def rows_of(out) -> list[tuple]:
    """One outcome's results as (doc id, fused, lexical and vector score)."""
    return [(r.doc_id, r.score, r.lexical_score, r.fast_score) for r in out.results]


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


def phase3_hybrid(dev, tmp: str) -> tuple[dict, dict, list[dict]]:
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


def check_flat_kernel(cell: str, classes, flat_inputs: dict, *, timed: bool = True) -> list[dict]:
    """Phase 1 for K3: the fused kernel against its twin, bitwise (masked
    scores, group maxima and group rows), on every length class at every
    (B, T) the flat lane ran it with, on the query rows, hot partial and
    row map the lane gave it there. Times are CUDA-event medians of one
    launch (one class). The bound counts the bytes (term and tf words, the
    hot slice, the row map and the query rows read once; the three outputs
    written once) against the integer compares this data needs at the INT32
    rate: one filter probe per (l, slot) per query tile, and B * T compares
    for each (l, slot) whose term a query row of the tile holds; the naive
    count, B * T for every (l, slot), is logged beside it."""
    import torch

    from frankensearch_tpu_torch.lexical import device_bm25 as bm

    if not flat_inputs:
        raise AssertionError(f"phase1 {cell}: the main path gave the flat lane no query rows")
    recs = []
    for (b, t_q), (q_ids, q_w, s_phys, dmap_groups) in sorted(flat_inputs.items(), reverse=True):
        off = goff = 0
        for c, cls in enumerate(classes):
            n_c, l_c, d_pad = cls.term_t.shape
            gc = d_pad // 128
            dmap = dmap_groups[goff : goff + n_c * gc].reshape(n_c, d_pad)
            args = (cls.term_t, cls.tf_t, q_ids, q_w, s_phys, off, dmap)
            got = bm.flat_class_fused(*args)
            want = bm.flat_class_fused_plain(*args)
            for what, g, w in zip(("scores", "group maxima", "group rows"), got, want):
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"phase1 {cell} K3 class {c} B={b} T={t_q}: {what} not bitwise")
            off += n_c * d_pad
            goff += n_c * gc
            if not timed:
                continue
            ms = cuda_median_ms(lambda: bm.flat_class_fused(*args), iters=10)
            plain_ms = cuda_median_ms(lambda: bm.flat_class_fused_plain(*args), warmup=1, iters=5)
            slots = cls.term_t.numel()
            hits = int(torch.isin(cls.term_t, q_ids).sum().item())
            row_tiles = -(-b // min(64, 4096 // (t_q | 1)))  # the kernel's query tiles
            compares = slots * row_tiles + hits * b * t_q
            hot_bytes = 0 if s_phys is None else n_c * d_pad * b * 4
            recs.append({"kernel": "flat_fused", "cell": cell, "class": c, "n_c": n_c, "l": l_c,
                         "d_pad": d_pad, "b": b, "t": t_q, "ms": ms, "plain_ms": plain_ms,
                         "max_abs_err": 0.0, "hit_words": hits, "words": slots,
                         "bound": bound(nbytes(cls.term_t, cls.tf_t, q_ids, q_w, dmap, *got) + hot_bytes,
                                        compares, "int32"),
                         "naive_compare_ms": slots * b * t_q / INT32_OPS_PER_S * 1e3})
            r = recs[-1]
            log(f"phase1 {cell} K3 class {c} ({n_c} x {l_c} x {d_pad}) B={b} T={t_q}: {ms:.4f} ms "
                f"(plain {plain_ms:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]}; naive compares "
                f"{r['naive_compare_ms']:.4f} ms; {hits} of {slots} words hit), bitwise equal")
            del got, want
    if not timed:
        log(f"phase1 {cell} K3 bitwise equal to its twin on {len(classes)} classes at (B, T) "
            f"{sorted(flat_inputs)}")
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


def hybrid1m_lexical(dev):
    """The hybrid-1M corpus, its BM25 arm (split layout, packed term-major
    copy) and the traffic. Returns (BM25 index, queries, singletons, layout
    record, the docs' texts)."""
    import numpy as np

    from frankensearch_tpu_torch import BulkDeviceBm25Index

    rng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    docs, vocab = hybrid1m_docs(rng)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm25 = BulkDeviceBm25Index(docs, device=dev)  # raises if the native ingest cannot load
    build_s = time.perf_counter() - t0
    texts = [d.content for d in docs]  # phase 7 embeds them
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
    queries, singles = hybrid1m_queries(rng, vocab, bm25)
    return bm25, queries, singles, layout, texts


def hybrid1m_cell(dev, index, emb):
    """The hybrid-1M cell over a 1M-doc vector index with phase 2's doc ids:
    :func:`hybrid1m_lexical` and a fast-only hybrid searcher. Returns
    (searcher, BM25 index, queries, singletons, layout record, the docs'
    texts)."""
    from frankensearch_tpu_torch import TwoTierConfig, TwoTierSearcher

    if index.fast.n_rows != H1M_DOCS:
        raise AssertionError(f"hybrid-1M: the vector index holds {index.fast.n_rows} docs, not {H1M_DOCS}")
    bm25, queries, singles, layout, texts = hybrid1m_lexical(dev)
    searcher = TwoTierSearcher(index, emb, lexical=bm25, config=TwoTierConfig(fast_only=True))
    return searcher, bm25, queries, singles, layout, texts


def phase4_hybrid1m(dev, semantic) -> tuple[dict, dict, list[dict], dict]:
    """The hybrid-1M cell over phase 2's vector index. Returns its record,
    launches and kernel records, and the lexical arm with the traffic and
    the batch's lexical pools, for phase 5."""
    index, emb, done_shapes = semantic["index"], semantic["emb"], semantic["shapes"]
    searcher, bm25, queries, singles, layout, texts = hybrid1m_cell(dev, index, emb)
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    lanes: list[str] = []
    flat_inputs: dict = {}
    pools: dict = {}
    fill = searcher._fill_fused

    def fill_noted(fused, live, *rest):  # the batch's lexical pools
        if not pools:
            pools.update({i: [(c.doc_id, c.score) for c in fused[1][j]] for j, i in enumerate(live)})
        return fill(fused, live, *rest)

    def main_path():
        searcher._fill_fused = fill_noted
        try:
            batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        finally:
            del searcher._fill_fused
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

    for j, one in enumerate(solo):
        if rows_of(one) != rows_of(batch[j]):
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
    del searcher._device_rrf_tail
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "lanes": lanes, "layout": layout,
             "oracle_equal": outright}, launches, kernels,
            {"bm25": bm25, "queries": queries, "singles": singles, "pools": pools, "texts": texts})


def recall_at_k(batch, exact_ids) -> float:
    """Mean recall@K of the outcomes' doc ids ("doc-%07d") against the
    exact scan's rows; every query must return K results."""
    import numpy as np

    recalls = []
    for j, out in enumerate(batch):
        if len(out.results) != K:
            raise AssertionError(f"query {j} returned {len(out.results)} results")
        recalls.append(len({int(r.doc_id[4:]) for r in out.results} & set(exact_ids[j].tolist())) / K)
    return float(np.mean(recalls))


def four_word_singletons(queries: list[str], n: int = 8) -> list[str]:
    """The batch's first ``n`` four-word queries. Their class (natural
    language) sets the batch's vector budget, so alone they get the same
    budget, and an approximate lane the same candidate pool, as in the
    batch."""
    from frankensearch_tpu_torch.core.query_class import QueryClass

    picked = [q for q in queries if QueryClass.classify(q) is QueryClass.NATURAL_LANGUAGE][:n]
    if len(picked) < n:
        raise AssertionError(f"only {len(picked)} four-word queries in the batch")
    return picked


def serve(searcher, queries: list[str], singles: list[str]):
    """The batch, then each singleton alone: (batch, batch ms, singleton
    outcomes, singleton ms)."""
    batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
    solo, single_ms = [], []
    for q in singles:
        out, t = timed(lambda q=q: searcher.search_batch([q], k=K))
        solo.append(out[0])
        single_ms.append(t)
    return batch, batch_ms, solo, single_ms


def check_singletons(what: str, queries, batch, singles, solo, *, lanes_only: bool = False) -> None:
    """Each singleton equals its batch row bitwise. With ``lanes_only``,
    where the batch's lexical budget (its largest class multiplier)
    differs from the singleton's own, only the lane bits are held: every
    doc in both lists has the same lexical and vector score bits."""
    for q, one in zip(singles, solo):
        want = rows_of(batch[queries.index(q)])
        got = rows_of(one)
        if not lanes_only:
            if got != want:
                raise AssertionError(f"{what}: singleton {q!r} differs from its batch row")
            continue
        lanes = {r[0]: r[2:] for r in want}
        shared = [r for r in got if r[0] in lanes]
        if not shared or any(lanes[r[0]] != r[2:] for r in shared):
            raise AssertionError(f"{what}: singleton {q!r} lane scores differ from its batch row")


def class_budgets(queries: list[str]) -> tuple[float, float]:
    """The (vector, lexical) budget multipliers ``search_batch`` gives a
    batch: the largest over its queries' classes."""
    from frankensearch_tpu_torch.core.canonicalize import DefaultCanonicalizer
    from frankensearch_tpu_torch.core.parsed_query import ParsedQuery
    from frankensearch_tpu_torch.core.query_class import QueryClass

    canon = DefaultCanonicalizer()
    classes = [QueryClass.classify(ParsedQuery.parse(canon.canonicalize_query(q)).positive or q) for q in queries]
    live = [c for c in classes if c is not QueryClass.EMPTY]
    return (max(c.semantic_budget_multiplier() for c in live), max(c.lexical_budget_multiplier() for c in live))


def check_singletons_by_budget(what: str, queries, batch, singles, solo) -> int:
    """Each singleton against its batch row: bitwise, which must hold where
    its class budgets are the batch's; where the batch's pools are deeper,
    a doc may hold a lane score in one list only, and every lane score
    that a doc holds in both has the same bits. Returns how many were
    bitwise."""
    batch_budgets = class_budgets(queries)
    bitwise = 0
    for q, one in zip(singles, solo):
        want = rows_of(batch[queries.index(q)])
        if rows_of(one) == want:
            bitwise += 1
            continue
        if class_budgets([q]) == batch_budgets:
            raise AssertionError(f"{what}: singleton {q!r} differs from its batch row")
        lanes = {r[0]: r[2:] for r in want}
        pairs = [(a, b) for r in rows_of(one) if r[0] in lanes
                 for a, b in zip(r[2:], lanes[r[0]]) if a is not None and b is not None]
        if not pairs or any(a != b for a, b in pairs):
            raise AssertionError(f"{what}: singleton {q!r} lane scores differ from its batch row")
    return bitwise


def check_int8_kernels(cell: str, slab_i8, scale, mask, shapes: set) -> list[dict]:
    """Phase 1 for the int8 lane: K4 against its twin, bitwise, and K2's
    int8 form within REL_TOL, at each (B, kk) ``drive`` noted, with seeded
    unit queries prepared as the lane prepares them. A batch that K2-i8
    takes in group order is also held bitwise to its rows' B=8 calls, taken
    in pair order: a row's scores must not depend on its batchmates."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for name in ("group_max_int8", "gather_rescore_i8"):
        if not any(s[0] == name for s in shapes):
            raise AssertionError(f"phase1 {cell}: the main path gave {name} no shape")
    gen = torch.Generator(device=slab_i8.device).manual_seed(SEED + 5)
    n, d = slab_i8.shape
    recs = []
    for b in sorted({s[1] for s in shapes if s[0] == "group_max_int8"}, reverse=True):
        q = unit_rows(gen, b, d, slab_i8.device)
        q_i8 = ts.prepare_query_int8(q, scale)
        gm = ts.group_max_int8(slab_i8, q_i8, mask)
        want = ts.group_max_int8_plain(slab_i8, q_i8, mask)
        if not torch.equal(gm.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"phase1 {cell} K4 B={b}: not bitwise (max err {(gm - want).abs().max().item():.3e})")
        recs.append({"kernel": "group_max_int8", "cell": cell, "n": n, "b": b, "kk": None,
                     "ms": cuda_median_ms(lambda: ts.group_max_int8(slab_i8, q_i8, mask)),
                     "plain_ms": cuda_median_ms(lambda: ts.group_max_int8_plain(slab_i8, q_i8, mask)),
                     "max_abs_err": 0.0,
                     "bound": bound(nbytes(slab_i8, q_i8, mask, gm), 2 * b * n * d, "int8")})
        q_scaled = q * scale
        for kk in sorted(s[2] for s in shapes if s[0] == "gather_rescore_i8" and s[1] == b):
            _, groups = ts.topk_desc_rowasc(gm, kk)
            groups = torch.sort(groups.to(torch.int32), dim=1).values
            r = ts.gather_rescore_i8(slab_i8, q_scaled, groups)
            err = check_close(r, ts.gather_rescore_i8_plain(slab_i8, q_scaled, groups),
                              f"phase1 {cell} K2-i8 B={b} kk={kk}")
            if b >= ts.GATHER_I8_GROUP_MIN_B:
                eights = torch.cat([ts.gather_rescore_i8(slab_i8, q_scaled[i : i + 8], groups[i : i + 8])
                                    for i in range(0, b, 8)])
                if not torch.equal(r.view(torch.int32), eights.view(torch.int32)):
                    raise AssertionError(f"phase1 {cell} K2-i8 B={b} kk={kk}: the batch's bits differ from its "
                                         f"rows' B=8 calls")
                log(f"phase1 {cell} K2-i8 B={b} kk={kk}: bitwise its {len(range(0, b, 8))} B=8 calls")
            recs.append({"kernel": "gather_rescore_i8", "cell": cell, "n": n, "b": b, "kk": kk,
                         "ms": cuda_median_ms(lambda: ts.gather_rescore_i8(slab_i8, q_scaled, groups)),
                         "plain_ms": cuda_median_ms(lambda: ts.gather_rescore_i8_plain(slab_i8, q_scaled, groups)),
                         "max_abs_err": err,
                         "bound": bound(gathered_bytes(slab_i8, groups) + nbytes(q_scaled, groups, r),
                                        2 * r.numel() * d, "f32")})
    log_kernel_records(cell, recs)
    return recs


def check_tile_rows(slab, q, mask, got_s, got_i, what: str) -> None:
    """Every finite per-tile candidate of K5 names a distinct row of its
    tile whose plain score is the candidate's score within REL_TOL."""
    import torch

    t, kk, b = got_s.shape
    full = q.to(slab.dtype).to(torch.float32) @ slab.to(torch.float32).T + mask[None, :]
    rows = got_i.permute(2, 0, 1).reshape(b, t * kk).to(torch.int64)
    got = got_s.permute(2, 0, 1).reshape(b, t * kk)
    fin = torch.isfinite(got)
    check_close(torch.gather(full, 1, rows)[fin], got[fin], f"{what} (rows)")
    tile_of = torch.arange(t, device=slab.device).repeat_interleave(kk)[None, :] * 2048
    if bool(((rows < tile_of) | (rows >= tile_of + 2048))[fin].any()):
        raise AssertionError(f"{what}: a candidate row lies outside its tile")
    pad = -1 - torch.arange(t * kk, device=slab.device)[None, :]  # distinct stand-ins
    keyed = torch.sort(torch.where(fin, rows, pad).view(b, t, kk), dim=2).values
    if bool((keyed[:, :, 1:] == keyed[:, :, :-1]).any()):
        raise AssertionError(f"{what}: a row appears twice in one tile's candidates")


def check_tile_kernel(cell: str, slab, mask, shapes: set, *, edges: bool = True) -> list[dict]:
    """Phase 1 for K5: the kernel against its twin at each (B, kk)
    ``drive`` noted, with seeded unit queries. The twin's and the kernel's
    f32 sums differ in order, so near ties may swap: the sorted scores of
    each (tile, query) agree within REL_TOL position by position, and every
    candidate row the kernel names is a distinct row of its tile whose
    plain score is the kernel's. The kernel's scores are K1's bits: each
    (tile, query)'s first candidate is bitwise the largest of K1's 16 group
    maxima over the tile. Then, with ``edges``, :func:`check_tile_edges`."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    todo = sorted((s[1], s[2]) for s in shapes if s[0] == "tile_topk")
    if not todo:
        raise AssertionError(f"phase1 {cell}: the main path gave tile_topk no shape")
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 6)
    n, d = slab.shape
    kind, form = kernel_form(slab)
    recs = []
    for b, kk in reversed(todo):
        q = unit_rows(gen, b, d, slab.device)
        got_s, got_i = ts.tile_topk(slab, q, mask, kk)
        want_s, _ = ts.tile_topk_plain(slab, q, mask, kk)
        err = check_close(got_s, want_s, f"phase1 {cell} K5 B={b} kk={kk}")
        check_tile_rows(slab, q, mask, got_s, got_i, f"phase1 {cell} K5 B={b} kk={kk}")
        del want_s
        k1_first = ts.group_max(slab, q, mask).view(b, n // ts.TILE_N, ts.TILE_N // ts.GROUP).amax(dim=2)
        if not torch.equal(got_s[:, 0, :].T.contiguous().view(torch.int32), k1_first.view(torch.int32)):
            raise AssertionError(f"phase1 {cell} K5 B={b} kk={kk}: a first candidate is not K1's tile maximum")
        recs.append({"kernel": "tile_topk" + form, "cell": cell, "n": n, "b": b, "kk": kk,
                     "ms": cuda_median_ms(lambda: ts.tile_topk(slab, q, mask, kk)),
                     "plain_ms": cuda_median_ms(lambda: ts.tile_topk_plain(slab, q, mask, kk), warmup=1, iters=5),
                     "max_abs_err": err,
                     # the selection moves no device memory: bytes and the scan's products
                     "bound": bound(nbytes(slab, q, mask, got_s, got_i), 2 * b * n * d, kind)})
    log_kernel_records(cell, recs)
    log(f"phase1 {cell} K5 first candidates bitwise equal to K1's tile maxima at (B, kk) {todo}")
    if edges:
        check_tile_edges(slab.device)
    return recs


#: the (B, kk) of K5's edge check: a ragged query tile, kk = 1 and 2, the
#: searcher's budgets, the list entry's widest kk and the wide entry's
EDGE_B = 70
EDGE_KKS = (1, 2, 30, 60, 64, 65, 2048)


def adversarial_tile_inputs(n_tiles: int, d: int, b: int, seed: int):
    """Seeded K5 inputs whose every score is exact in f32, so any summation
    order gives the same bits: slab entries are multiples of 1/8 in
    [-1/4, 1/4] and query entries integers in [-2, 2] (both exact in bf16
    and f16). Exact ties: every tile repeats 64 of its rows at 3 other
    columns each, query row 1 is zero (every score of a tile ties), and the
    values are coarse. About 10% of the rows are masked; tile 1 is masked
    whole; tile 2 holds only three finite rows, so kk above 3 reaches the
    -inf column-0 padding. Returns numpy (slab f32 (n_tiles*2048, d),
    queries f32 (b, d), additive mask f32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = n_tiles * 2048
    slab = rng.integers(-2, 3, size=(n, d), dtype=np.int8).astype(np.float32) * np.float32(0.125)
    for t in range(n_tiles):
        for src in rng.choice(2048, 64, replace=False):
            slab[t * 2048 + rng.choice(2048, 3, replace=False)] = slab[t * 2048 + src]
    q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    if b > 1:
        q[1] = 0.0
    mask = np.where(rng.random(n) < 0.1, -np.inf, 0.0).astype(np.float32)
    if n_tiles > 1:
        mask[2048:4096] = -np.inf
    if n_tiles > 2:
        mask[4096:6144] = -np.inf
        mask[4096 + np.array([5, 700, 2047])] = 0.0
    return slab, q, mask


def check_tile_edges(dev) -> None:
    """K5's edge cases on the card: :func:`adversarial_tile_inputs` over 8
    tiles at B = EDGE_B (a full and a ragged 64-query tile), bf16, f16 and
    f32, every kk of EDGE_KKS (both entries of the kernel): rows and score
    bits equal to the twin's, and each first candidate bitwise K1's tile
    maximum."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    slab_np, q_np, mask_np = adversarial_tile_inputs(8, DIM, EDGE_B, SEED + 9)
    q, mask = torch.from_numpy(q_np).to(dev), torch.from_numpy(mask_np).to(dev)
    wide0 = ts.tile_topk.wide_launches
    dtypes = (torch.bfloat16, torch.float16, torch.float32)
    for dtype in dtypes:
        slab = torch.from_numpy(slab_np).to(dev, dtype)
        k1_first = ts.group_max(slab, q, mask).view(EDGE_B, 8, 16).amax(dim=2)
        for kk in EDGE_KKS:
            got_s, got_i = ts.tile_topk(slab, q, mask, kk)
            want_s, want_i = ts.tile_topk_plain(slab, q, mask, kk)
            if not (torch.equal(got_i, want_i) and torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))):
                bad = (got_i != want_i) | (got_s.view(torch.int32) != want_s.view(torch.int32))
                raise AssertionError(f"phase1 K5 edges {dtype} kk={kk}: {int(bad.sum())} entries differ from the twin, "
                                     f"first at {bad.nonzero()[0].tolist()}")
            if not torch.equal(got_s[:, 0, :].T.contiguous().view(torch.int32), k1_first.view(torch.int32)):
                raise AssertionError(f"phase1 K5 edges {dtype} kk={kk}: a first candidate is not K1's tile maximum")
    if ts.tile_topk.wide_launches - wide0 != len(dtypes) * sum(kk > ts.TILE_TOPK_LIST_K for kk in EDGE_KKS):
        raise AssertionError("phase1 K5 edges: the wide entry did not run for every kk above the list entry's")
    log(f"phase1 K5 edges (8 tiles x {DIM}, B={EDGE_B}, ties, masked rows, a masked tile, a 3-row tile; "
        f"kk {list(EDGE_KKS)}, bf16, f16 and f32, list and wide entries): rows and score bits equal to the twin's, "
        "first candidates equal to K1's tile maxima")


def phase5_scan_modes(dev, tmp: str, semantic: dict, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """The int8 capacity lane (fast-only, hybrid, certified and gated,
    reopened) and the per-tile top-k lane, over phase 2's vectors and
    queries and phase 4's lexical arm, through the unfused path."""
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.core.errors import UncertifiedScanMode

    vecs, emb, queries = semantic["vecs"], semantic["emb"], semantic["queries"]
    bm25, h_queries, h_pools = lexical["bm25"], lexical["queries"], lexical["pools"]
    root = os.path.join(tmp, "int8")
    t0 = time.perf_counter()
    index8 = TwoTierIndex.create(root, vecs, [f"doc-{i:07d}" for i in range(N_DOCS)], emb.identity(),
                                 device=dev, slab_dtype="int8")
    build_s = time.perf_counter() - t0
    slab_i8, scale = index8.fast._int8
    log(f"phase5 int8 index build {build_s:.1f} s: int8 slab {nbytes(slab_i8)} bytes beside the "
        f"bf16 slab's {nbytes(index8.fast.slab)}")
    shapes: set = set()
    launches: dict = {}

    def count(phase, got, names):
        need_launches(phase, got, names)
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n

    singles = four_word_singletons(queries)
    rec = {"build_s": build_s, "int8_slab_bytes": nbytes(slab_i8), "bf16_slab_bytes": nbytes(index8.fast.slab)}

    # int8, fast-only
    cfg8 = TwoTierConfig(fast_only=True, scan_mode="int8")
    fast = TwoTierSearcher(index8, emb, config=cfg8)
    drive(lambda: fast.search_batch(queries[:8], k=K), shapes)  # warm-up
    (batch8, ms, solo, single_ms), got = drive(lambda: serve(fast, queries, singles), shapes)
    count("phase5 int8", got, ("K4", "K2-i8"))
    recall8 = recall_at_k(batch8, semantic["exact_ids"])
    log(f"phase5 int8 fast-only B=256: {ms:.2f} ms; singletons: " + ", ".join(f"{t:.2f}" for t in single_ms)
        + f" ms; recall@10 vs exact f32 scan {recall8:.4f}")
    if recall8 < INT8_RECALL_FLOOR:
        raise AssertionError(f"phase5: int8 recall@10 {recall8} < {INT8_RECALL_FLOOR}")
    check_singletons("phase5 int8", queries, batch8, singles, solo)
    rec["int8"] = {"batch_ms": ms, "single_ms": single_ms, "recall_at_10": recall8}

    # int8, hybrid with phase 4's lexical arm (the unfused path)
    hybrid = TwoTierSearcher(index8, emb, lexical=bm25, config=cfg8)
    h_singles = four_word_singletons(h_queries)
    drive(lambda: hybrid.search_batch(h_queries[:8], k=K), shapes)  # warm-up
    pools: dict = {}
    lex_batch = bm25.search_candidates_batch

    def lex_noted(texts, budget):  # the batch's lexical pools
        out = lex_batch(texts, budget)
        if not pools:
            pools.update({j: [(c.doc_id, c.score) for c in row] for j, row in enumerate(out)})
        return out

    bm25.search_candidates_batch = lex_noted
    try:
        (h_batch, h_ms, h_solo, h_single_ms), got = drive(lambda: serve(hybrid, h_queries, h_singles), shapes)
    finally:
        del bm25.search_candidates_batch
    count("phase5 int8 hybrid", got, ("K4", "K2-i8"))
    if any(o.metrics.phase1_fused for o in h_batch) or hybrid.last_fusion_path is not None:
        raise AssertionError("phase5: the int8 hybrid batch did not take the unfused path")
    if len(pools) != len(h_queries) or len(h_pools) != len(h_queries):
        raise AssertionError(f"phase5: {len(pools)} lexical pools here, {len(h_pools)} in phase 4")
    for j in range(len(h_queries)):
        same_ranking(pools[j], h_pools[j], LEX_REL_TOL, f"phase5 lexical pool of query {j}")
    check_singletons("phase5 int8 hybrid", h_queries, h_batch, h_singles, h_solo, lanes_only=True)
    log(f"phase5 int8 hybrid B=256: {h_ms:.2f} ms; singletons: " + ", ".join(f"{t:.2f}" for t in h_single_ms)
        + f" ms; {len(pools)} lexical pools equal to phase 4's within {LEX_REL_TOL:g}")
    rec["int8_hybrid"] = {"batch_ms": h_ms, "single_ms": h_single_ms}

    # certify, serve behind the gate, reopen with the persisted certificate
    t0 = time.perf_counter()
    cert = index8.certify_fast_scan_mode("int8", K, emb.embed_batch(queries))
    cert_s = time.perf_counter() - t0
    # the floor: the 5% quantile of 256 per-query recall@10 values, a
    # multiple of 0.1, sits at 0.9 or 1.0 when the mean is near 0.99; 0.8
    # keeps the check on the gate's mechanics, not on a tuned floor
    gated_cfg = TwoTierConfig(fast_only=True, scan_mode="int8", require_recall_certificate=True,
                              min_certified_recall=0.8)
    refusing = TwoTierSearcher(index8, emb, config=TwoTierConfig(
        fast_only=True, scan_mode="int8", require_recall_certificate=True, min_certified_recall=1.01))
    try:
        refusing.search_batch(queries[:8], k=K)
    except UncertifiedScanMode as e:
        log(f"phase5 gate refuses an unmeetable floor: {e}")
    else:
        raise AssertionError("phase5: the gate served below its floor")
    gated = TwoTierSearcher(index8, emb, config=gated_cfg)
    (g_batch, g_ms), got = drive(lambda: timed(lambda: gated.search_batch(queries, k=K)), shapes)
    count("phase5 int8 gated", got, ("K4", "K2-i8"))
    reopened = TwoTierIndex.open(root, device=dev)
    if reopened.fast.recall_certificate("int8") != cert:
        raise AssertionError("phase5: the reopened index did not rebind the persisted certificate")
    r_batch = TwoTierSearcher(reopened, emb, config=gated_cfg).search_batch(queries, k=K)
    for j, (a, b, c) in enumerate(zip(batch8, g_batch, r_batch)):
        if not rows_of(a) == rows_of(b) == rows_of(c):
            raise AssertionError(f"phase5: gated or reopened query {j} differs from the ungated batch")
    log(f"phase5 certificate ({cert_s:.1f} s): certified recall@{cert.k} {cert.certified_recall:.4f} "
        f"(mean {cert.mean_recall:.4f}) at confidence {cert.confidence}; gated B=256 {g_ms:.2f} ms; "
        "rebound after reopen; gated and reopened results equal to the ungated batch")
    rec["certificate"] = {**cert.to_record(), "certify_s": cert_s, "gated_batch_ms": g_ms}
    del reopened, r_batch

    # the per-tile top-k lane over phase 2's bf16 index
    tiles = TwoTierSearcher(semantic["index"], emb, config=TwoTierConfig(fast_only=True, scan_mode="pallas"))
    drive(lambda: tiles.search_batch(queries[:8], k=K), shapes)  # warm-up
    (p_batch, p_ms, p_solo, p_single_ms), got = drive(lambda: serve(tiles, queries, singles), shapes)
    count("phase5 pallas", got, ("K5",))
    recall_p = recall_at_k(p_batch, semantic["exact_ids"])
    if recall_p < 0.99:
        raise AssertionError(f"phase5: pallas recall@10 {recall_p} < 0.99")
    for j, (out, want) in enumerate(zip(p_batch, semantic["rows"])):
        same_ranking([(r[0], r[3]) for r in rows_of(out)], [(r[0], r[3]) for r in want],
                     REL_TOL, f"phase5 pallas query {j} vs the K1/K2 lane")
    check_singletons("phase5 pallas", queries, p_batch, singles, p_solo)
    log(f"phase5 pallas B=256: {p_ms:.2f} ms; singletons: " + ", ".join(f"{t:.2f}" for t in p_single_ms)
        + f" ms; recall@10 {recall_p:.4f}; top-10 equal to the K1/K2 lane's up to ties within {REL_TOL:g}")
    rec["pallas"] = {"batch_ms": p_ms, "single_ms": p_single_ms, "recall_at_10": recall_p}
    log(f"phase5 launches on the main path: {launches}")

    mask8 = index8.fast._effective_mask(None, None)
    kernels = check_int8_kernels("semantic-1M-int8", slab_i8, scale, mask8, shapes)
    kernels += check_tile_kernel("semantic-1M", semantic["index"].fast.slab,
                                 semantic["index"].fast._effective_mask(None, None), shapes)
    del fast, hybrid, gated, tiles, index8
    torch.cuda.empty_cache()
    return rec, launches, kernels


def check_group_ids(gm, got_g, want_g, what: str) -> int:
    """K6's group ids against its twin's, (T, t, B) each: equal, except
    where the two groups' maxima (``gm``, the twin's (B, n_groups)) tie
    within REL_TOL. Returns how many positions differ."""
    import torch

    diff = got_g != want_g
    if not bool(diff.any()):
        return 0
    q = torch.arange(gm.shape[0], device=gm.device)[None, None, :].expand_as(got_g)[diff]
    a, w = gm[q, got_g[diff].long()], gm[q, want_g[diff].long()]
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(a), fin) or bool(
        ((a - w).abs() > REL_TOL * w.abs().clamp(min=1.0))[fin].any()
    ):
        raise AssertionError(f"{what}: a group id differs from the twin's away from a tie")
    return int(diff.sum())


#: the values crafted K6 maxima take: ties, both zeros, -inf (masked
#: groups) and +inf
SELECT_POOL = (float("-inf"), -1.5, -0.25, -0.0, 0.0, 0.25, 1.0, 3.0, float("inf"))
#: (tile_n, t) at which K6's selection is held to its twin on crafted maxima
SELECT_EDGES = ((8192, 1), (8192, 30), (8192, 60), (8192, 64), (2048, 1), (2048, 7), (2048, 16))


def crafted_maxima(b: int, n_tiles: int, g: int, seed: int):
    """Seeded (b, n_tiles * g) f32 group maxima for K6's selection: each
    row draws from SELECT_POOL with weights of its own, so equal maxima
    share a tile, +0.0 and -0.0 fall in one tie class in either group order
    and -inf groups lie between finite ones; tile 1 is -inf whole (a masked
    tile), tile 2 holds only zeros of both signs, and query 0's tile 0 opens
    with +0.0, -0.0, +0.0, -0.0 (query 1's with the signs swapped).
    Returns numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = np.array(SELECT_POOL, np.float32)
    weights = rng.dirichlet(np.ones(len(pool)), size=b)
    gm = np.stack([pool[rng.choice(len(pool), size=n_tiles * g, p=w)] for w in weights])
    if n_tiles > 1:
        gm[:, g : 2 * g] = -np.inf
    if n_tiles > 2:
        gm[:, 2 * g : 3 * g] = np.where(rng.random((b, g)) < 0.5, np.float32(0.0), np.float32(-0.0))
    if g >= 4:
        gm[0, :4] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
        if b > 1:
            gm[1, :4] = np.array([-0.0, 0.0, -0.0, 0.0], np.float32)
    return gm


def check_select_edges(dev) -> None:
    """K6's selection kernel (``tile_select``) on :func:`crafted_maxima`
    (B = 70 over 4 tiles; every (tile_n, t) of SELECT_EDGES): values and
    group ids bitwise its twin's, the argmax passes."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for i, (tile_n, t) in enumerate(SELECT_EDGES):
        gm = torch.from_numpy(crafted_maxima(70, 4, tile_n // ts.GROUP, SEED + 11 + i)).to(dev)
        got_v, got_g = ts.tile_select(gm, t, tile_n)
        want_v, want_g = ts.tile_select_plain(gm, t, tile_n)
        if not (torch.equal(got_g, want_g) and torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))):
            bad = (got_g != want_g) | (got_v.view(torch.int32) != want_v.view(torch.int32))
            raise AssertionError(f"phase1 K6 selection tile_n={tile_n} t={t}: {int(bad.sum())} entries differ "
                                 f"from the passes, first at {bad.nonzero()[0].tolist()}")
    log(f"phase1 K6 selection on crafted maxima (B=70, 4 tiles: ties, +0.0/-0.0 in both orders, -inf between "
        f"finite groups, a masked tile, a tile of zeros; (tile_n, t) {list(SELECT_EDGES)}): values and group ids "
        "bitwise the argmax passes'")


def check_candidate_kernel(cell: str, slab, mask, q_all, ts_bk: list) -> list[dict]:
    """Phase 1 for K6: the kernel against its twin at each (B, t) phase 6
    ran it with, on phase 6's queries: values within REL_TOL, group ids
    equal except at ties, and every finite value the K1 maximum of its
    group, bit for bit (K6 scores with K1's kernel). Times are CUDA-event
    medians: K6's whole wrapper (K1's scan and the selection), and K1 alone
    at the same B (``k1_ms``), which gives the selection's share."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    n, d = slab.shape
    kind = "bf16" if slab.dtype == torch.bfloat16 else "f16"
    recs = []
    for b, t in sorted(ts_bk, reverse=True):
        q = q_all[:b]
        got_v, got_g = ts.group_candidates(slab, q, mask, t, AB_TILE)
        want_v, want_g = ts.group_candidates_plain(slab, q, mask, t, AB_TILE)
        what = f"phase1 {cell} K6 B={b} t={t}"
        err = check_close(got_v, want_v, what)
        swapped = check_group_ids(ts.group_max_plain(slab, q, mask), got_g, want_g, what)
        gm = ts.group_max(slab, q, mask)
        k1 = gm[torch.arange(b, device=slab.device)[None, None, :].expand_as(got_g), got_g.long()]
        fin = torch.isfinite(got_v)
        if not torch.equal(k1[fin].view(torch.int32), got_v[fin].view(torch.int32)):
            raise AssertionError(f"{what}: a value is not K1's maximum of its group")
        del want_v, want_g, gm, k1
        recs.append({"kernel": "group_candidates", "cell": cell, "n": n, "b": b, "kk": t,
                     "ms": cuda_median_ms(lambda: ts.group_candidates(slab, q, mask, t, AB_TILE)),
                     "plain_ms": cuda_median_ms(lambda: ts.group_candidates_plain(slab, q, mask, t, AB_TILE),
                                                warmup=1, iters=5),
                     "max_abs_err": err, "ids_swapped_at_ties": swapped,
                     "k1_ms": cuda_median_ms(lambda: ts.group_max(slab, q, mask)),
                     # the selection's compares are extra work the bound does not count
                     "bound": bound(nbytes(slab, q, mask, got_v, got_g), 2 * b * n * d, kind)})
    log_kernel_records(cell, recs)
    for r in recs:
        log(f"phase1 {cell} K6 B={r['b']} t={r['kk']}: K1 alone {r['k1_ms']:.4f} ms, the selection "
            f"{r['ms'] - r['k1_ms']:.4f} ms of K6's {r['ms']:.4f}")
    return recs


def phase6_ab_scan(dev, semantic: dict) -> tuple[dict, dict, list[dict]]:
    """The A/B scan lane over phase 2's slab and queries: the K6 route
    (``emit="tile_topk"``) at every (B, k), held bitwise to the K1/K2
    route; ``group_select="iter"`` likewise; ``rescore="xla"`` to the f32
    rescore of K1's groups; then K6 against its twin."""
    import torch

    from frankensearch_tpu_torch.ops import ab_primitives as ab
    from frankensearch_tpu_torch.ops import topk_scan as ts

    fast = semantic["index"].fast
    slab, mask = fast.slab, fast._effective_mask(None, None)
    n_groups = slab.shape[0] // ts.GROUP
    q_all = torch.from_numpy(semantic["emb"].embed_batch(semantic["queries"])).to(dev)
    shapes: set = set()
    cases = [(b, k) for b in AB_BATCHES for k in AB_KS]
    for b, k in cases:
        if (slab.shape[0] // AB_TILE) * min(k, AB_TILE // ts.GROUP) >= n_groups:
            raise AssertionError(f"phase6: B={b} k={k} would not take the narrowing branch")
    ab.scan_topk_hierarchical_ab(slab, q_all[:8], K, mask, emit="tile_topk")  # warm-up

    def main_path():
        return {(b, k): ab.scan_topk_hierarchical_ab(slab, q_all[:b], k, mask, emit="tile_topk")
                for b, k in cases}

    (got, ms), launches = drive(lambda: timed(main_path), shapes)
    log(f"phase6 A/B scan emit=tile_topk over {len(cases)} (B, k): {ms:.2f} ms; launches {launches}")
    need_launches("phase6", launches, ("K6", "K2"))
    if launches["K6"] != len(cases) or launches["K1"] != 0:
        raise AssertionError(f"phase6: the narrowing branch did not run for every case ({launches})")

    # checks (comparison runs; not counted)
    for (b, k), res in got.items():
        q = q_all[:b]
        want = ts.scan_topk_hierarchical(slab, q, k, mask)
        it = ab.scan_topk_hierarchical_ab(slab, q, k, mask, group_select="iter")
        for name, r in (("tile_topk", res), ("iter", it)):
            if not (torch.equal(r.indices, want.indices)
                    and torch.equal(r.scores.view(torch.int32), want.scores.view(torch.int32))):
                raise AssertionError(f"phase6 {name} B={b} k={k}: not bitwise the K1/K2 route")
        x6 = ab.scan_topk_hierarchical_ab(slab, q, k, mask, emit="tile_topk", rescore="xla")
        x1 = ab.scan_topk_hierarchical_ab(slab, q, k, mask, rescore="xla")
        for j in range(b):
            same_ranking(list(zip(x6.indices[j].tolist(), x6.scores[j].tolist())),
                         list(zip(x1.indices[j].tolist(), x1.scores[j].tolist())),
                         1e-6, f"phase6 xla B={b} k={k} query {j}")
        rows = x6.indices.to(torch.int64)
        exact = torch.einsum("bd,bkd->bk", q.double(), slab[rows.clamp(min=0)].double())
        if bool(((x6.scores.double() - exact).abs() > 1e-6 * exact.abs().clamp(min=1.0))[rows >= 0].any()):
            raise AssertionError(f"phase6 xla B={b} k={k}: scores off the f64 dot products")
    log(f"phase6 emit=tile_topk and group_select=iter bitwise equal to the K1/K2 route at "
        f"B={list(AB_BATCHES)}, k={list(AB_KS)}; rescore=xla equal to the f32 rescore of K1's "
        "groups up to 1e-6 ties and within 1e-6 of f64 dot products")
    head_q = q_all[: max(AB_BATCHES)]
    route_ms = {
        "ab_tile_topk": cuda_median_ms(lambda: ab.scan_topk_hierarchical_ab(slab, head_q, max(AB_KS), mask,
                                                                            emit="tile_topk")),
        "k1_k2": cuda_median_ms(lambda: ts.scan_topk_hierarchical(slab, head_q, max(AB_KS), mask)),
    }
    log(f"phase6 scan at B={max(AB_BATCHES)} k={max(AB_KS)}: K6 route {route_ms['ab_tile_topk']:.4f} ms, "
        f"K1/K2 route {route_ms['k1_k2']:.4f} ms")
    # K2 at the (B, kk) this lane gave it that phase 2 did not (K1's groups
    # seed its inputs; K1 itself did not run here)
    k1_shapes = {("group_max", b, 0) for b in AB_BATCHES}
    kernels = check_kernels("semantic-1M", slab, mask, k1_shapes | {("gather_rescore", b, k) for b, k in cases},
                            k1_shapes | semantic["shapes"])
    kernels += check_candidate_kernel("semantic-1M", slab, mask, q_all,
                                      sorted({(b, min(k, AB_TILE // ts.GROUP)) for b, k in cases}))
    check_select_edges(dev)
    torch.cuda.empty_cache()
    return {"batch_ms": ms, "scan_ms_b256_k60": route_ms}, launches, kernels


class HostEmbedder:
    """The Model2Vec embedder behind a plain interface, so the searcher
    embeds on the host (``embed_batch``) and takes the scan + BM25 lane."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.dim, self.embedder_id, self.revision, self.is_semantic = (
            inner.dim, inner.embedder_id, inner.revision, True)

    def identity(self):
        return self._inner.identity()

    def embed_batch(self, texts):
        return self._inner.embed_batch(texts)


def m2v_embedder(dev):
    """hybrid-1M-m2v's fast tier: a seeded M2V_ROWS x DIM Model2Vec table
    (the reference's numpy draw, bf16 on ``dev``) over phase 4's words
    w00000..w49999, then filler words."""
    from frankensearch_tpu_torch.embed.model2vec import random_model2vec

    vocab = [f"w{i:05d}" for i in range(H1M_VOCAB)] + [f"f{i:06d}" for i in range(M2V_ROWS - H1M_VOCAB)]
    return random_model2vec(vocab, dim=DIM, seed=SEED + 7, device=dev)


def phase7_hybrid_m2v(dev, tmp: str, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """hybrid-1M-m2v: phase 4's corpus and lexical arm with a seeded
    Model2Vec fast tier, served through the fully fused lane."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.embed import bulk
    from frankensearch_tpu_torch.embed.model2vec import gather_pool_normalize
    from frankensearch_tpu_torch.ops import topk_scan as ts

    bm25, queries, singles, texts = lexical["bm25"], lexical["queries"], lexical["singles"], lexical["texts"]
    t0 = time.perf_counter()
    m2v = m2v_embedder(dev)
    table_s = time.perf_counter() - t0
    if bulk.bag_embed_corpus(m2v, texts[:8]) is None:
        raise AssertionError("phase7: the bag lane does not apply (no native tokenizer)")
    vecs, embed_s = timed(lambda: bulk.embed_corpus(m2v, texts))
    again, embed2_s = timed(lambda: bulk.embed_corpus(m2v, texts))
    if not np.array_equal(vecs.view(np.uint32), again.view(np.uint32)):
        raise AssertionError("phase7: two embed_corpus runs gave different bits")
    del again
    sample = np.random.default_rng(SEED + 8).choice(len(texts), 4096, replace=False)
    cos = np.sum(vecs[sample] * m2v.embed_batch([texts[i] for i in sample]), axis=1)
    if cos.min() <= M2V_COS_FLOOR:
        raise AssertionError(f"phase7: bag lane vs embed_batch cosine {cos.min()} <= {M2V_COS_FLOOR}")
    docs_per_s = len(texts) / (embed2_s / 1000.0)
    log(f"phase7 Model2Vec table {M2V_ROWS} x {DIM} bf16 ({nbytes(m2v._emb)} bytes, {table_s:.1f} s); "
        f"embed_corpus of {len(texts)} docs {embed_s / 1000:.2f} s then {embed2_s / 1000:.2f} s "
        f"({docs_per_s:.0f} docs/s), the same bits both times; 4096-doc sample vs embed_batch "
        f"cosine >= {cos.min():.7f}")
    t0 = time.perf_counter()
    ids = [f"doc-{i:07d}" for i in range(len(texts))]  # phase 4's doc ids
    index = TwoTierIndex.create(os.path.join(tmp, "m2v"), vecs, ids, m2v.identity(), device=dev)
    build_s = time.perf_counter() - t0
    searcher = TwoTierSearcher(index, m2v, lexical=bm25, config=TwoTierConfig(fast_only=True))
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    lanes: list[str] = []
    embedded: list[bool] = []
    pools: dict = {}
    vec_hits: dict = {}
    fill = searcher._fill_fused

    def fill_noted(fused, live, *rest):  # the batch's lexical pools and vector hits
        if not pools:
            pools.update({i: [(c.doc_id, c.score) for c in fused[1][j]] for j, i in enumerate(live)})
            vec_hits.update({i: fused[0][j] for j, i in enumerate(live)})
        return fill(fused, live, *rest)

    def main_path():
        searcher._fill_fused = fill_noted
        try:
            batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        finally:
            del searcher._fill_fused
        lanes.append(searcher.last_phase1_lex_lane)
        embedded.append(searcher.last_phase1_embed_fused)
        solo, single_ms = [], []
        for q in singles:
            out, t = timed(lambda q=q: searcher.search_batch([q], k=K))
            solo.append(out[0])
            single_ms.append(t)
            lanes.append(searcher.last_phase1_lex_lane)
            embedded.append(searcher.last_phase1_embed_fused)
        return batch, batch_ms, solo, single_ms

    flat_inputs: dict = {}
    (batch, batch_ms, solo, single_ms), launches = drive(main_path, shapes, flat_inputs)
    log(f"phase7 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + f" ms; lanes {lanes}")
    need_launches("phase7", launches, ("K1", "K2", "K3"))
    if not all(embedded) or not all(o.metrics.phase1_fused for o in batch + solo):
        raise AssertionError(f"phase7: the fully fused embed lane did not run every time ({embedded})")
    if not {"daat", "blocked", "mixed"} <= set(lanes):
        raise AssertionError(f"phase7: lanes {sorted(set(lanes))}, want daat, blocked and mixed")
    if searcher.last_fusion_path != "device":
        raise AssertionError(f"phase7: fusion path {searcher.last_fusion_path!r}, not device")
    bitwise = check_singletons_by_budget("phase7", queries, batch, singles, solo)
    if pools != lexical["pools"]:
        raise AssertionError("phase7: the lexical pools differ from phase 4's")
    log(f"phase7 fully fused embed lane for the batch and every singleton; {bitwise} of {len(singles)} "
        "singletons bitwise equal to their batch rows (required where their class budgets are the batch's), "
        "the others in every lane score both lists hold; the 256 lexical pools bitwise equal to phase 4's")

    # the vector arm's top-10 against exact scans of the pass's own query
    # vectors (the pool is batch-independent, so these are its bits): the
    # plain scan at the lane's precision (the query rounded to bf16, the
    # bf16 slab, f32 sums), and the f32 scan of the f32 doc vectors
    tok, msk = m2v.tokenize_batch(queries)
    qv = gather_pool_normalize(m2v._emb, torch.from_numpy(tok).to(dev), torch.from_numpy(msk).to(dev))
    got = [[int(h.doc_id[4:]) for h in vec_hits[j][:K]] for j in range(len(queries))]
    same_prec = ts.scan_topk_xla(index.fast.slab, qv, K, index.fast._effective_mask(None, None)).indices.cpu()
    vecs_dev = torch.from_numpy(vecs).to(dev)
    exact = ts.scan_topk_xla(vecs_dev, qv, K, precise=True).indices.cpu()
    recall_lane = float(np.mean([len(set(g) & set(same_prec[j].tolist())) / K for j, g in enumerate(got)]))
    recall = float(np.mean([len(set(g) & set(exact[j].tolist())) / K for j, g in enumerate(got)]))
    worst_gap = 0.0
    for j, g in enumerate(got):  # every miss against the f32 scan is a bf16 near tie
        missed = sorted(set(exact[j].tolist()) - set(g))
        if missed:
            sc = (vecs_dev[torch.tensor(g + missed, device=dev)].double() @ qv[j].double()).cpu()
            worst_gap = max(worst_gap, float(sc[len(g):].max() - sc[: len(g)].min()))
    log(f"phase7 vector recall@10 vs the plain scan at the lane's precision {recall_lane:.4f}; vs the exact f32 "
        f"scan {recall:.4f}, every miss within {worst_gap:.3e} of the lane's 10th doc's exact score "
        f"(bf16 rounding moves a score by up to {BF16_DOT_BOUND:.3e})")
    if recall_lane < 0.99:
        raise AssertionError(f"phase7: vector recall@10 vs the plain scan {recall_lane} < 0.99")
    if worst_gap > 2 * BF16_DOT_BOUND:
        raise AssertionError(f"phase7: a doc missed against the f32 scan leads by {worst_gap}, past bf16 rounding")
    del vecs_dev

    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    if searcher.last_fusion_path != "host_vectorized":
        raise AssertionError(f"phase7: oracle fusion path {searcher.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(batch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase7: query {j} differs from the host RRF oracle: "
                                 f"{rows_of(out)} vs {rows_of(want)}")
    del searcher._device_rrf_tail
    log("phase7 fused rows and scores bitwise equal to the host RRF oracle")

    # the same batch embedded on the host first: embed_batch renormalizes
    # there, so a query vector may differ in its last bits, and where that
    # moves an element's bf16 rounding the scan scores differ by up to a
    # bf16 step of that element; where it moves none, the scan's inputs
    # are the same bits and so are its results
    q_host = torch.from_numpy(m2v.embed_batch(queries)).to(dev)
    same_q = (q_host.to(torch.bfloat16) == qv.to(torch.bfloat16)).all(dim=1).tolist()
    host = TwoTierSearcher(index, HostEmbedder(m2v), lexical=bm25, config=TwoTierConfig(fast_only=True))
    host_hits: dict = {}
    fill_h = host._fill_fused

    def fill_host(fused, live, *rest):
        host_hits.update({i: fused[0][j] for j, i in enumerate(live)})
        return fill_h(fused, live, *rest)

    host._fill_fused = fill_host
    h_batch = host.search_batch(queries, k=K)
    if host.last_phase1_embed_fused or not all(o.metrics.phase1_fused for o in h_batch):
        raise AssertionError("phase7: the host-embedded batch did not take the scan + BM25 lane")
    moved = 0
    for j in range(len(queries)):
        got_h = [(h.doc_id, h.score) for h in host_hits[j]]
        want_h = [(h.doc_id, h.score) for h in vec_hits[j]]
        if same_q[j]:
            if got_h != want_h or rows_of(h_batch[j]) != rows_of(batch[j]):
                raise AssertionError(f"phase7: query {j} differs from the host-embedded batch")
            continue
        same_ranking(got_h, want_h, BF16_DOT_BOUND, f"phase7 host-embedded vector hits of query {j}")
        moved += 1
    log(f"phase7 host-embedded batch: {len(queries) - moved} queries with the same bf16 query vector give "
        f"bitwise equal vector hits and results; {moved} whose host-normalized vector rounds an element to "
        f"another bf16 value give vector hits equal up to ties within {BF16_DOT_BOUND:.3e}")
    kernels = check_kernels("hybrid-1M-m2v", index.fast.slab, index.fast._effective_mask(None, None), shapes)
    check_flat_kernel("hybrid-1M-m2v", bm25._blocked.classes, flat_inputs, timed=False)
    del searcher, host, index, m2v, vecs
    torch.cuda.empty_cache()
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "lanes": lanes, "recall_at_10": recall,
             "recall_at_10_lane_precision": recall_lane, "f32_miss_max_gap": worst_gap,
             "singletons_bitwise": bitwise,
             "embed_s": [embed_s / 1000.0, embed2_s / 1000.0], "embed_docs_per_s": docs_per_s,
             "table_s": table_s, "index_build_s": build_s, "host_embed_other_bf16_query": moved},
            launches, kernels)


def lift_world(seed: int = LIFT_SEED):
    """tools/train_quality_lift.py's paraphrase world, its held-out half: a
    synonym dictionary (cwNNN <-> syNNN), 90 training topics drawn first
    (only to keep the generator's sequence), then 45 held-out topics of
    four docs each (the exact words, a paraphrase with one canonical
    anchor, a partial match, noise) and a canonical-word query with graded
    judgments. Returns ((doc id, text) list, queries, judgments, every
    word)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dict = 100
    canon_words = [f"cw{i:03d}" for i in range(n_dict)]
    syn_words = [f"sy{i:03d}" for i in range(n_dict)]
    filler = [f"fil{i:03d}" for i in range(150)]

    def draw_topic():
        idx = rng.choice(n_dict, size=4, replace=False)
        return [canon_words[i] for i in idx], [syn_words[i] for i in idx]

    for _ in range(90):  # the training pairs' draws
        draw_topic()
        rng.choice(filler, size=4)

    def pad():
        return " ".join(rng.choice(filler, size=6))

    docs, queries, qrels = [], [], []
    for t in range(45):
        canon, syns = draw_topic()
        docs.append((f"ev{t}-exact", " ".join(canon) + " " + pad()))
        docs.append((f"ev{t}-para", canon[0] + " " + " ".join(syns[1:]) + " " + pad()))
        docs.append((f"ev{t}-part", " ".join(canon[:2]) + " " + pad()))
        other = canon_words[rng.integers(n_dict)]
        docs.append((f"ev{t}-noise", other + " " + pad()))
        queries.append(" ".join(canon))
        qrels.append({f"ev{t}-exact": 3.0, f"ev{t}-para": 2.0, f"ev{t}-part": 1.0})
    return docs, queries, qrels, canon_words + syn_words + filler


def ndcg_at_k(ranked: list[str], qrels: dict, k: int) -> float:
    """nDCG@k with the log2(rank + 1) discount."""
    import math

    def dcg(rels):
        total = 0.0  # added in rank order (sum() would compensate)
        for i, rel in enumerate(rels[:k]):
            total += rel / math.log2(i + 2)
        return total

    ideal = dcg(sorted(qrels.values(), reverse=True))
    return dcg([qrels.get(d, 0.0) for d in ranked]) / ideal if ideal else 0.0


def lift_eval(dev, world, quality, root: str, *, rescan: bool, timeout_ms: float | None = None):
    """The lift world served on ``dev``: the term-identity Model2Vec fast
    tier (128 dims, seed 3), ``quality`` as the quality tier, a
    ``MemoryLexicalIndex``, and ``search()``'s phase stream per query.
    Returns (Initial nDCG@10 per query, Refined nDCG@10 per query, phase-2
    skip reasons)."""
    import numpy as np

    from frankensearch_tpu_torch import (IndexableDocument, MemoryLexicalIndex, Model2VecEmbedder,
                                         SimpleWordTokenizer, TwoTierConfig, TwoTierIndex, TwoTierSearcher)
    from frankensearch_tpu_torch.core.types import PhaseKind

    docs, queries, qrels, words = world
    rng = np.random.default_rng(3)
    table = rng.standard_normal((len(words), 128)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    fast = Model2VecEmbedder(table, SimpleWordTokenizer({w: i for i, w in enumerate(words)}), device=dev,
                             embedder_id="fast-term-id", revision="tl1")
    texts, ids = [t for _, t in docs], [d for d, _ in docs]
    index = TwoTierIndex.create(root, fast.embed_batch(texts), ids, fast.identity(), device=dev,
                                quality_vectors=quality.embed_batch(texts), quality_identity=quality.identity())
    lex = MemoryLexicalIndex()
    for d, t in docs:
        lex.add_document(IndexableDocument(doc_id=d, content=t))
    lex.commit()
    cfg = TwoTierConfig(quality_rescan=rescan)
    if timeout_ms is not None:
        cfg = TwoTierConfig(quality_rescan=rescan, quality_timeout_ms=timeout_ms)
    searcher = TwoTierSearcher(index, fast, lexical=lex, quality_embedder=quality, config=cfg,
                               cache_query_embeddings=False)
    initial, refined, skips = [], [], []
    for q, rel in zip(queries, qrels):
        out = searcher.search(q, k=10)
        by_kind = {p.kind: p for p in out.phases}
        init = by_kind[PhaseKind.INITIAL]
        initial.append(ndcg_at_k([r.doc_id for r in init.results], rel, 10))
        refined.append(ndcg_at_k([r.doc_id for r in by_kind.get(PhaseKind.REFINED, init).results], rel, 10))
        skips.append(out.metrics.phase2_skip_reason)
    searcher.close()
    return initial, refined, skips


def quality_index(dev, fast_index, identity):
    """The fast tier of ``fast_index`` with a quality tier of seeded unit
    rows x Q_DIM, one per doc, in the fast tier's doc order."""
    import torch

    from frankensearch_tpu_torch import DeviceVectorIndex, TwoTierIndex

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    vecs = unit_rows(gen, fast_index.fast.n_rows, Q_DIM, dev).cpu().numpy()
    quality = DeviceVectorIndex(vecs, fast_index.fast.doc_ids, identity, device=dev)
    return TwoTierIndex(fast_index.fast, quality)


def phase_kinds(phases) -> list[str]:
    return [p.kind.value for p in phases]


def check_refined_singleton(what: str, one, want, strict: bool, q_err: float) -> None:
    """A singleton's Refined results against its batch row: equal (doc
    ids, fused, lexical, vector and quality scores) where its candidate
    budgets and quality vector bits are the batch's; otherwise every doc
    both lists hold has the same lexical and vector score bits and a
    quality score within ``q_err`` x sqrt(Q_DIM) (a dot product of a unit
    row with a query vector that moved by at most ``q_err`` per element)."""
    got = [(r.doc_id, r.score, r.lexical_score, r.fast_score, r.quality_score) for r in one.results]
    ref = [(r.doc_id, r.score, r.lexical_score, r.fast_score, r.quality_score) for r in want.results]
    if strict:
        if got != ref:
            raise AssertionError(f"{what}: the singleton differs from its batch row")
        return
    lanes = {r[0]: r for r in ref}
    shared = [r for r in got if r[0] in lanes]
    if not shared:
        raise AssertionError(f"{what}: the singleton shares no doc with its batch row")
    bound = q_err * Q_DIM**0.5 + 1e-7
    for r in shared:
        w = lanes[r[0]]
        if r[2:4] != w[2:4] or (r[4] is None) != (w[4] is None) or (
                r[4] is not None and abs(r[4] - w[4]) > bound):
            raise AssertionError(f"{what}: doc {r[0]} lane scores {r[2:]} vs its batch row's {w[2:]}")


def phase8_quality(dev, tmp: str, semantic: dict, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """hybrid-1M-quality: phase 4's corpus and lexical arm over phase 2's
    fast tier, with a 1M x 384 quality tier and the trained 384 encoder
    (8a), a seeded cross-encoder at ms-marco-MiniLM-L-6-v2's configuration
    (8b), and the held-out lift world on the card against the CPU (8c).
    Returns its record, launches and kernel records."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierSearcher
    from frankensearch_tpu_torch.rerank.bert import BertConfig, init_params
    from frankensearch_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
    from frankensearch_tpu_torch.rerank.encoder import load_artifact
    from frankensearch_tpu_torch.rerank.tokenizer import WordPieceTokenizer

    cpu = torch.device("cpu")
    art = os.path.join(os.path.dirname(os.path.abspath(__file__)), QUALITY_ARTIFACT)
    t0 = time.perf_counter()
    q32 = load_artifact(art, device=dev)  # verify=True: the certificate, fail-closed
    q16 = load_artifact(art, device=dev, compute="bf16")
    c32 = load_artifact(art, device=cpu)
    c16 = load_artifact(art, device=cpu, compute="bf16")
    load_s = time.perf_counter() - t0
    log(f"phase8 {QUALITY_ARTIFACT}: certificate verified on {dev} and on the CPU ({load_s:.1f} s)")
    t0 = time.perf_counter()
    index = quality_index(dev, semantic["index"], q32.identity())
    build_s = time.perf_counter() - t0
    log(f"phase8 quality tier {tuple(index.quality.slab.shape)} {index.quality.slab.dtype} ({build_s:.1f} s)")
    bm25, queries, texts = lexical["bm25"], lexical["queries"], lexical["texts"]
    singles = four_word_singletons(queries)
    emb = semantic["emb"]

    # --- 8a: the encoder alone, then search_batch and search() ---
    rec: dict = {"artifact_load_s": load_s, "quality_index_build_s": build_s}
    tok_t = q32.tokenize_batch(queries)[0].shape[1]
    enc_ms = {}
    for name, q_emb in (("f32", q32), ("bf16", q16)):
        for b in ENC_BATCHES:
            enc_ms[f"{name}_B{b}"] = cuda_median_ms(lambda: q_emb.forward_device(queries[:b]), iters=10)
    rec.update({"encoder_ms": enc_ms, "encoder_t_B256": tok_t})
    log(f"phase8 encoder forward (T={tok_t} at B=256; CUDA events, ms): {json.dumps(enc_ms)}")
    sample = queries[:32]
    for what, card, host, tol in (("f32", q32, c32, ENC_F32_TOL), ("bf16", q16, c16, ENC_BF16_TOL)):
        err = float(np.abs(card.embed_batch(sample) - host.embed_batch(sample)).max())
        rec[f"encoder_card_vs_cpu_{what}"] = err
        if not err <= tol:
            raise AssertionError(f"phase8: {what} quality vectors on the card differ from the CPU's by {err:.3e} > {tol}")
    rows = [queries.index(q) for q in singles]
    solo_batch = {}
    for what, card in (("f32", q32), ("bf16", q16)):
        vb = card.embed_batch(queries)
        solo = np.stack([card.embed_batch([q])[0] for q in singles])
        err = float(np.abs(solo - vb[rows]).max())
        solo_batch[what] = {"bitwise": int(sum(np.array_equal(solo[i], vb[r]) for i, r in enumerate(rows))),
                            "max_abs_diff": err}
        if not err <= SOLO_BATCH_TOL[what]:
            raise AssertionError(f"phase8: {what} B=1 quality vectors differ from their B=256 rows by {err:.3e}")
    rec["solo_vs_batch"] = solo_batch
    log(f"phase8 card vs CPU quality vectors: f32 {rec['encoder_card_vs_cpu_f32']:.3e} (tol {ENC_F32_TOL:g}), "
        f"bf16 {rec['encoder_card_vs_cpu_bf16']:.3e} (tol {ENC_BF16_TOL:g}); B=1 vs B=256 rows: {json.dumps(solo_batch)}")
    q_err = solo_batch["f32"]["max_abs_diff"]

    searchers = {
        rescan: TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=q32,
                                config=TwoTierConfig(quality_rescan=rescan), cache_query_embeddings=False)
        for rescan in (False, True)
    }
    for s in searchers.values():  # warm-up: cuBLAS handles in the phase-2 worker, allocator, host caches
        s.search_batch(queries, k=K)
        for q in singles[:2]:
            s.search(q, k=K)
    shapes: set = set()

    def main_path():
        out = {}
        for rescan, s in searchers.items():
            batch, batch_ms = timed(lambda s=s: s.search_batch(queries, k=K))
            solo = []
            for q in singles:
                seen = []
                one, ms = timed(lambda q=q, s=s: s.search(q, k=K, on_phase=seen.append))
                solo.append((one, seen, ms))
            out[rescan] = (batch, batch_ms, solo)
        return out

    out, launches = drive(main_path, shapes, dim=Q_DIM)
    need_launches("phase8", launches, ("K1", "K2", "K3"))
    if not any(sh[0] == "group_max" for sh in shapes):
        raise AssertionError("phase8: no hierarchical scan ran over the 384-wide quality tier")
    for rescan, (batch, batch_ms, solo) in out.items():
        tag = "rescan" if rescan else "aligned"
        for j, o in enumerate(batch):
            if o.metrics.quality_candidates < 1 or not any(r.quality_score is not None for r in o.results):
                raise AssertionError(f"phase8 {tag}: query {j} carries no quality scores")
        init_ms, ref_ms = [], []
        for q, (one, seen, _ms) in zip(singles, solo):
            kinds = phase_kinds(seen)
            if kinds != ["initial", "refined"] or one.metrics.phase2_skip_reason or one.metrics.phase3_skip_reason:
                raise AssertionError(f"phase8 {tag}: singleton {q!r} phases {kinds}, skip "
                                     f"{one.metrics.phase2_skip_reason!r}/{one.metrics.phase3_skip_reason!r}")
            strict = class_budgets([q]) == class_budgets(queries) and q_err == 0.0
            check_refined_singleton(f"phase8 {tag} {q!r}", one, batch[queries.index(q)], strict, q_err)
            init_ms.append(seen[0].latency_ms)
            ref_ms.append(seen[1].latency_ms)
        rec[tag] = {"batch_ms": batch_ms, "initial_ms": init_ms, "refined_ms": ref_ms,
                    "quality_candidates_mean": float(np.mean([o.metrics.quality_candidates for o in batch]))}
        log(f"phase8 {tag} search_batch B=256 (Refined): {batch_ms:.2f} ms; search() Initial "
            + ", ".join(f"{t:.2f}" for t in init_ms) + " ms; Refined " + ", ".join(f"{t:.2f}" for t in ref_ms) + " ms")
    log(f"phase8 launches {launches}; every singleton reached REFINED with no skip reason (default "
        f"{TwoTierConfig().quality_timeout_ms:g} ms timeout); lanes equal to the batch rows")
    kernels = check_kernels("hybrid-1M-quality", index.quality.slab, index.quality._effective_mask(None, None), shapes)

    # --- 8b: Reranked ---
    ce_cfg = BertConfig(**CE_CONFIG)
    ce_state = init_params(ce_cfg, torch.Generator().manual_seed(SEED + 9))
    ce_tok = WordPieceTokenizer(q32.tokenizer.vocab, max_len=512)

    def text_fn(doc_id):
        return texts[int(doc_id[4:])]

    rerank = {}
    for form in ("f32", "int8"):
        rr = CrossEncoderReranker(ce_state, ce_cfg, ce_tok, device=dev, reranker_id="ms-marco-MiniLM-L-6-v2-seeded",
                                  int8=form == "int8")
        host = CrossEncoderReranker(ce_state, ce_cfg, ce_tok, device=cpu, int8=form == "int8")
        s = TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=q32, reranker=rr,
                            config=TwoTierConfig(rerank_enabled=True), cache_query_embeddings=False, text_fn=text_fn)
        s.search(singles[0], k=K)  # warm-up

        def reranked():
            res = []
            for q in singles:
                seen = []
                res.append((s.search(q, k=K, on_phase=seen.append), seen))
            return res

        res, l8b = drive(reranked, set())
        launches = {n: launches[n] + l8b[n] for n in launches}
        ms, err = [], 0.0
        for q, (one, seen) in zip(singles, res):
            kinds = phase_kinds(seen)
            if kinds != ["initial", "refined", "reranked"] or one.metrics.phase2_skip_reason \
                    or one.metrics.phase3_skip_reason:
                raise AssertionError(f"phase8 rerank {form}: singleton {q!r} phases {kinds}, skip "
                                     f"{one.metrics.phase2_skip_reason!r}/{one.metrics.phase3_skip_reason!r}")
            ms.append(one.metrics.phase3_ms)
            pairs = [(r.doc_id, text_fn(r.doc_id)) for r in seen[1].results]
            got = rr.score_pairs(q, pairs)
            want = host.score_pairs(q, pairs)
            g = np.array([x.score for x in got])
            if not ((g >= 0.0) & (g <= 1.0)).all():
                raise AssertionError(f"phase8 rerank {form}: scores outside [0, 1]")
            err = max(err, float(np.abs(g - np.array([x.score for x in want])).max()))
        tol = CE_F32_TOL if form == "f32" else CE_INT8_TOL
        if not err <= tol:
            raise AssertionError(f"phase8 rerank {form}: card vs CPU scores differ by {err:.3e} > {tol}")
        pairs = [(f"doc-{i:07d}", texts[i]) for i in range(20)]
        rr.score_pairs(singles[0], pairs)
        t_pairs = timed(lambda: rr.score_pairs(singles[0], pairs))[1]
        rerank[form] = {"phase3_ms": ms, "card_vs_cpu": err, "score_20_pairs_ms": t_pairs}
        log(f"phase8 rerank {form}: every singleton reached RERANKED; phase 3 "
            + ", ".join(f"{t:.2f}" for t in ms) + f" ms; 20 pairs {t_pairs:.2f} ms; card vs CPU scores "
            f"{err:.3e} (tol {tol:g})")
        s.close()
    rec["rerank"] = rerank

    # --- 8c: the held-out lift, card against CPU ---
    world = lift_world()
    lift = {}
    for rescan in (False, True):
        tag = "rescan" if rescan else "default"
        i_c, r_c, skips = lift_eval(dev, world, q32, os.path.join(tmp, f"lift-card-{tag}"), rescan=rescan)
        i_h, r_h, _ = lift_eval(cpu, world, c32, os.path.join(tmp, f"lift-cpu-{tag}"), rescan=rescan, timeout_ms=0)
        if any(skips):
            raise AssertionError(f"phase8 lift {tag}: phase-2 skips on the card {sorted(set(skips) - {None})}")
        card = float(np.mean(r_c) - np.mean(i_c))
        host_lift = float(np.mean(r_h) - np.mean(i_h))
        lift[tag] = {"initial": float(np.mean(i_c)), "refined": float(np.mean(r_c)), "lift": card,
                     "cpu_lift": host_lift, "per_query_equal": i_c == i_h and r_c == r_h}
        log(f"phase8 lift {tag}: card Initial {np.mean(i_c):.4f} Refined {np.mean(r_c):.4f} lift {card:+.4f}; "
            f"CPU lift {host_lift:+.4f}")
        if abs(card - host_lift) > LIFT_TOL or card < LIFT_FLOOR:
            raise AssertionError(f"phase8 lift {tag}: {card:+.4f} (CPU {host_lift:+.4f}, floor {LIFT_FLOOR})")
    rec["lift"] = lift
    for s in searchers.values():
        s.close()
    del searchers, index
    torch.cuda.empty_cache()
    return rec, launches, kernels


def serve_sizes(searcher, queries: list[str], texts: list[str] | None = None) -> dict:
    """``search_batch`` at B = 256 (``queries``), 8 (their first 8) and 1
    (each of those alone, or of ``texts``): {size: (outcomes, host ms)}."""
    b256 = timed(lambda: searcher.search_batch(queries, k=K))
    b8 = timed(lambda: searcher.search_batch(queries[:8], k=K))
    solo = [timed(lambda q=q: searcher.search_batch([q], k=K)) for q in (texts or queries[:8])]
    return {"B256": b256, "B8": b8, "B1": ([o[0][0] for o in solo], [o[1] for o in solo])}


def sizes_ms(out: dict) -> dict:
    return {"B256_ms": out["B256"][1], "B8_ms": out["B8"][1], "B1_ms": out["B1"][1]}


def check_sets(what: str, got_rows, want_rows, score_of, kth, tol: float) -> int:
    """Per query, the rows ``got_rows`` names equal ``want_rows``'s, except
    where a differing row's score (``score_of(j, row)``) lies within ``tol``
    (relative, at least absolute) of the query's k-th score ``kth[j]``.
    Returns how many queries differ only at such ties."""
    off = 0
    for j, (got, want) in enumerate(zip(got_rows, want_rows)):
        if set(got) == set(want):
            continue
        for row in set(got) ^ set(want):
            if abs(score_of(j, row) - kth[j]) > tol * max(abs(kth[j]), 1.0):
                raise AssertionError(f"{what}: query {j} row {row} differs from the reference scan")
        off += 1
    return off


def same_topk(got, want, rel: float, what: str) -> None:
    """Two (B, k) top-k results, query by query as :func:`same_ranking`."""
    pairs = [[list(zip(i, s)) for i, s in zip(r.indices.tolist(), r.scores.tolist())] for r in (got, want)]
    for j, (g, w) in enumerate(zip(*pairs)):
        same_ranking(g, w, rel, f"{what} query {j}")


def doc_rows(out) -> list[int]:
    return [int(r.doc_id.split("-")[1]) for r in out.results]


def clustered_cell(rng):
    """The IVF cell's corpus: 1M unit rows around IVF_CENTRES seeded
    centres, and 256 queries near corpus rows (tests/test_ivf.py's
    ``test_high_recall_on_clustered_data`` at full size). Returns (rows,
    queries)."""
    import numpy as np

    centres = rng.standard_normal((IVF_CENTRES, DIM), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    x = centres[np.repeat(np.arange(IVF_CENTRES), N_DOCS // IVF_CENTRES)]
    x += IVF_SPREAD * rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(N_DOCS, size=256, replace=False)] + IVF_QUERY_NOISE * rng.standard_normal((256, DIM), dtype=np.float32)
    return x, q / np.linalg.norm(q, axis=1, keepdims=True)


def check_ivf_kernel(cell: str, arm, shapes: set) -> list[dict]:
    """Phase 1 for K2 at the IVF probe's shapes: at each (B, nprobe) the
    main path ran, the probe's sorted group ids for seeded near-corpus
    queries, K2 against its twin within REL_TOL (the twin in chunks of
    queries where its f32 candidates would pass 4 GB)."""
    import torch

    from frankensearch_tpu_torch.index.ivf import probe_groups
    from frankensearch_tpu_torch.ops import topk_scan as ts

    slab = arm.slab
    d = slab.shape[1]
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 11)
    recs = []
    for b, nprobe in sorted(shapes, reverse=True):
        rows = torch.randint(0, slab.shape[0], (b,), generator=gen, device=slab.device)
        q = slab[rows].to(torch.float32) + 0.02 * torch.randn(b, d, generator=gen, device=slab.device)
        ids = torch.sort(probe_groups(arm.centroids, q, nprobe=nprobe, gpc=arm.groups_per_cluster), dim=1).values
        kk = ids.shape[1]
        step = max(1, int(4e9 // (kk * 128 * d * 4)))

        def plain():
            return torch.cat([ts.gather_rescore_plain(slab, q[i : i + step], ids[i : i + step])
                              for i in range(0, b, step)])

        r = ts.gather_rescore(slab, q, ids)
        err = check_close(r, plain(), f"phase1 {cell} K2 B={b} kk={kk} (nprobe {nprobe})")
        recs.append({"kernel": "gather_rescore_ivf", "cell": cell, "n": slab.shape[0], "b": b, "kk": kk,
                     "ms": cuda_median_ms(lambda: ts.gather_rescore(slab, q, ids)),
                     "plain_ms": cuda_median_ms(plain, warmup=1, iters=5), "max_abs_err": err,
                     "bound": bound(gathered_bytes(slab, ids) + nbytes(q, ids, r), 2 * r.numel() * d, "bf16")})
    log_kernel_records(cell, recs)
    return recs


def phase9_scan_lanes(dev, tmp: str, semantic: dict) -> tuple[dict, dict, list[dict]]:
    """Every scan lane ``TwoTierConfig`` selects, and the live index's write
    path: semantic-1M-f32 (phase 2's vectors as an f32 slab: ``auto`` on K1
    and K2's f32 forms, ``pallas`` on K5's), semantic-1M-mrl (phase 2's bf16
    index, ``mrl_search_dims=64``), semantic-1M-ivf (a clustered 1M corpus,
    its IVF arm built on the card, probed by K2; calibrated, certified and
    served behind the gate), the int4 two-pass scan over phase 2's vectors,
    and appends, deletes, WAL sync, compaction and reopening of phase 2's
    index."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.core.errors import InvalidConfig, UncertifiedScanMode
    from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
    from frankensearch_tpu_torch.index.ivf import calibrate_nprobe
    from frankensearch_tpu_torch.ops import topk_scan as ts
    from frankensearch_tpu_torch.ops.quantize import calibrate_int4

    vecs, emb, queries = semantic["vecs"], semantic["emb"], semantic["queries"]
    ids = [f"doc-{i:07d}" for i in range(N_DOCS)]
    qv = torch.from_numpy(emb.embed_batch(queries)).to(dev)
    rec: dict = {}
    launches: dict = {}
    kernels: list[dict] = []

    def count(phase, got, names, renamed=None):
        need_launches(phase, got, names)
        for name, n in got.items():
            key = (renamed or {}).get(name, name)
            launches[key] = launches.get(key, 0) + n

    # semantic-1M-f32: K1, K2 and K5 in their f32 forms
    t0 = time.perf_counter()
    f32 = TwoTierIndex(DeviceVectorIndex(vecs, ids, emb.identity(), device=dev, slab_dtype="f32"))
    f32_build_s = time.perf_counter() - t0
    slab, mask = f32.fast.slab, f32.fast._effective_mask(None, None)
    exact = ts.scan_topk_xla(slab, qv, K, mask)  # the plain f32 scan on the card
    f32_rows = exact.indices.cpu().tolist()
    f32_kth = exact.scores[:, -1].cpu().tolist()

    def f32_score(j, row):
        return float(qv[j] @ slab[row])

    shapes: set = set()
    f32_rec = {"build_s": f32_build_s, "slab_bytes": nbytes(slab)}
    for mode, names in (("auto", ("K1", "K2")), ("pallas", ("K5",))):
        searcher = TwoTierSearcher(f32, emb, config=TwoTierConfig(fast_only=True, scan_mode=mode))
        drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
        out, got = drive(lambda: serve_sizes(searcher, queries), shapes)
        count(f"phase9 f32 {mode}", got, names, {"K1": "K1-f32", "K2": "K2-f32", "K5": "K5-f32"})
        off = check_sets(f"phase9 f32 {mode} B=256", [doc_rows(o) for o in out["B256"][0]], f32_rows,
                         f32_score, f32_kth, F32_TIE_REL)
        check_sets(f"phase9 f32 {mode} B=8", [doc_rows(o) for o in out["B8"][0]], f32_rows[:8],
                   f32_score, f32_kth, F32_TIE_REL)
        check_sets(f"phase9 f32 {mode} B=1", [doc_rows(o) for o in out["B1"][0]], f32_rows[:8],
                   f32_score, f32_kth, F32_TIE_REL)
        log(f"phase9 f32 {mode}: B=256 {out['B256'][1]:.2f} ms, B=8 {out['B8'][1]:.2f} ms, singletons "
            + ", ".join(f"{t:.2f}" for t in out["B1"][1]) + f" ms; doc sets equal to the plain f32 scan "
            f"({off} of 256 differ only at ties within {F32_TIE_REL:g} of the k-th score)")
        f32_rec[mode] = {**sizes_ms(out), "tie_queries": off}
    rec["f32"] = f32_rec
    kernels += check_kernels("semantic-1M-f32", slab, mask, shapes)
    kernels += check_tile_kernel("semantic-1M-f32", slab, mask, shapes, edges=False)
    del f32, slab, mask, exact, searcher
    torch.cuda.empty_cache()

    # semantic-1M-mrl: phase 2's bf16 index, the first 64 dims, then a rescore
    index = semantic["index"]
    mrl = TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True, mrl_search_dims=MRL_DIMS))
    drive(lambda: mrl.search_batch(queries[:8], k=K), set())  # warm-up
    out, got = drive(lambda: serve_sizes(mrl, queries), set())
    count("phase9 mrl", got, ())
    recall = recall_at_k(out["B256"][0], semantic["exact_ids"])
    fast = index.fast
    slab, mask = fast.slab, fast._effective_mask(None, None)
    card = ts.scan_topk_mrl(slab, qv[:8], K, mask, search_dims=MRL_DIMS)
    cpu = ts.scan_topk_mrl(slab.cpu(), qv[:8].cpu(), K, mask.cpu(), search_dims=MRL_DIMS)
    same_topk(card, cpu, MRL_CPU_TOL, "phase9 mrl B=8 card vs CPU")
    log(f"phase9 mrl (search_dims {MRL_DIMS}): B=256 {out['B256'][1]:.2f} ms, B=8 {out['B8'][1]:.2f} ms, "
        "singletons " + ", ".join(f"{t:.2f}" for t in out["B1"][1]) + f" ms; recall@10 vs exact f32 scan "
        f"{recall:.4f}; B=8 equal to the CPU within {MRL_CPU_TOL:g}")
    rec["mrl"] = {**sizes_ms(out), "recall_at_10": recall, "search_dims": MRL_DIMS}
    del mrl, out

    # int4: phase 2's vectors packed to 4 bits, rescored on phase 2's bf16 slab
    t0 = time.perf_counter()
    padded = np.zeros((fast.n_pad, fast.d_pad), dtype=np.float32)
    padded[:N_DOCS, :DIM] = vecs
    q4 = calibrate_int4(padded)
    del padded
    packed, scale = torch.from_numpy(q4.packed).to(dev), torch.from_numpy(q4.scale).to(dev)
    pack_s = time.perf_counter() - t0
    int4_ms = {}
    for b in (256, 8, 1):
        res, int4_ms[f"B{b}_ms"] = timed(lambda b=b: ts.scan_topk_int4_two_pass(packed, scale, slab, qv[:b], K, mask))
        if b == 256:
            int4_recall = float(np.mean([len(set(r) & set(e.tolist())) / K for r, e in
                                         zip(res.indices.cpu().tolist(), semantic["exact_ids"])]))
    card = ts.scan_topk_int4_two_pass(packed, scale, slab, qv[:8], K, mask)
    cpu = ts.scan_topk_int4_two_pass(packed.cpu(), scale.cpu(), slab.cpu(), qv[:8].cpu(), K, mask.cpu())
    same_topk(card, cpu, REL_TOL, "phase9 int4 B=8 card vs CPU")
    log(f"phase9 int4: packed {nbytes(packed)} bytes in {pack_s:.1f} s; " + ", ".join(
        f"{k} {v:.2f}" for k, v in int4_ms.items()) + f"; recall@10 {int4_recall:.4f}; B=8 equal to the CPU "
        f"within {REL_TOL:g}")
    rec["int4"] = {**int4_ms, "recall_at_10": int4_recall, "packed_bytes": nbytes(packed), "pack_s": pack_s}
    del packed, scale, q4

    # semantic-1M-ivf: a clustered corpus, its IVF arm built on the card
    rng = np.random.default_rng(SEED + 9)
    x, xq = clustered_cell(rng)
    root = os.path.join(tmp, "ivf")
    t0 = time.perf_counter()
    ivf_index = TwoTierIndex.create(root, x, ids, emb.identity(), device=dev)
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf_index.fast.enable_ivf()  # ends in host copies of the preferences: synchronous
    ivf_build_s = time.perf_counter() - t0
    arm = ivf_index.fast._ivf
    ivf_exact = ts.scan_topk_xla(torch.from_numpy(x).to(dev), torch.from_numpy(xq).to(dev), K,
                                 precise=True).indices.cpu().numpy()
    # the index's own exact scan (the arm's bf16 precision): what
    # certify_scan_mode measures the lane against
    lane_exact = ivf_index.fast.search_batch(xq, K, mode="xla").indices.cpu().numpy()
    ivf_shapes: set = set()

    def ivf_path():
        out = {}
        for nprobe in IVF_NPROBES:
            for b in (256, 8, 1):
                ivf_shapes.add((b, nprobe))
                out[(b, nprobe)] = timed(lambda: ivf_index.fast.search_batch(xq[:b], K, mode="ivf", nprobe=nprobe))
        ivf_shapes.add((8, arm.n_clusters))
        out["full"] = timed(lambda: ivf_index.fast.search_batch(xq[:8], K, mode="ivf", nprobe=arm.n_clusters))
        return out

    ivf_index.fast.search_batch(xq[:8], K, mode="ivf")  # warm-up
    out, got = drive(ivf_path, set())
    count("phase9 ivf", got, ("K2",), {"K2": "K2-ivf"})
    ivf_rec = {"create_s": create_s, "build_s": ivf_build_s, "n_clusters": arm.n_clusters, "cap": arm.cap,
               "groups_per_cluster": arm.groups_per_cluster, "arm_slab_bytes": nbytes(arm.slab)}
    def mean_recall(rows, exact):
        return float(np.mean([len(set(r) & set(e)) / K for r, e in zip(rows.tolist(), exact.tolist())]))

    for nprobe in IVF_NPROBES:
        rows = out[(256, nprobe)][0].indices.cpu().numpy()
        ivf_rec[f"nprobe{nprobe}"] = {
            "recall_at_10": mean_recall(rows, ivf_exact),
            "recall_at_10_lane_precision": mean_recall(rows, lane_exact),
            "scanned_fraction": arm.scanned_fraction(nprobe),
            **{f"B{b}_ms": out[(b, nprobe)][1] for b in (256, 8, 1)},
        }
    hier = ivf_index.fast.search_batch(xq[:8], K, mode="hierarchical")
    q8 = torch.from_numpy(xq[:8]).to(dev).to(torch.bfloat16).to(torch.float32)
    ivf_slab = ivf_index.fast.slab
    off = check_sets("phase9 ivf full probe B=8", out["full"][0].indices.cpu().tolist(), hier.indices.cpu().tolist(),
                     lambda j, row: float(q8[j] @ ivf_slab[row].to(torch.float32)),
                     hier.scores[:, -1].cpu().tolist(), BF16_DOT_BOUND)
    ivf_rec["full_probe_ms"] = out["full"][1]
    log(f"phase9 ivf: index {create_s:.1f} s, arm {ivf_build_s:.1f} s ({arm.n_clusters} clusters, cap {arm.cap}); "
        + "; ".join(f"nprobe {p}: recall@10 {ivf_rec[f'nprobe{p}']['recall_at_10']:.4f} (vs the bf16 scan "
                    f"{ivf_rec[f'nprobe{p}']['recall_at_10_lane_precision']:.4f}), scanned "
                    f"{ivf_rec[f'nprobe{p}']['scanned_fraction']:.4f}, B=256/8/1 "
                    + "/".join(f"{ivf_rec[f'nprobe{p}'][f'B{b}_ms']:.2f}" for b in (256, 8, 1)) + " ms"
                    for p in IVF_NPROBES)
        + f"; full probe B=8 {out['full'][1]:.2f} ms, doc sets equal to the hierarchical scan ({off} of 8 "
        f"differ only at ties within {BF16_DOT_BOUND:.3g})")
    kernels += check_ivf_kernel("semantic-1M-ivf", arm, ivf_shapes)

    # calibrate, certify and persist, serve behind the gate, reopen
    t0 = time.perf_counter()
    cal = calibrate_nprobe(arm, xq, lane_exact, k=K, target_recall=IVF_TARGET_RECALL, candidates=IVF_CANDIDATES)
    if cal is None:
        raise AssertionError(f"phase9 ivf: no nprobe in {IVF_CANDIDATES} certifies recall@10 >= {IVF_TARGET_RECALL}")
    nprobe = int(cal.parameter_value)
    cert = ivf_index.certify_fast_scan_mode("ivf", K, xq, nprobe=nprobe)
    cert_s = time.perf_counter() - t0
    gated_cfg = TwoTierConfig(fast_only=True, scan_mode="ivf", ivf_nprobe=nprobe,
                              require_recall_certificate=True, min_certified_recall=0.8)
    try:
        TwoTierSearcher(ivf_index, emb, config=TwoTierConfig(
            fast_only=True, scan_mode="ivf", require_recall_certificate=True,
            min_certified_recall=1.01)).search_batch(queries[:8], k=K)
    except UncertifiedScanMode as e:
        log(f"phase9 ivf gate refuses an unmeetable floor: {e}")
    else:
        raise AssertionError("phase9 ivf: the gate served below its floor")
    gated = TwoTierSearcher(ivf_index, emb, config=gated_cfg)
    (g_batch, g_ms), got = drive(lambda: timed(lambda: gated.search_batch(queries, k=K)), set())
    count("phase9 ivf gated", got, ("K2",), {"K2": "K2-ivf"})
    if not all(len(o.results) == K for o in g_batch):
        raise AssertionError("phase9 ivf: the gated searcher returned short results")
    reopened = TwoTierIndex.open(root, device=dev)
    if reopened.fast.recall_certificate("ivf") != cert:
        raise AssertionError("phase9 ivf: the reopened index did not rebind the persisted certificate")
    log(f"phase9 ivf certificate ({cert_s:.1f} s): calibrated nprobe {nprobe} (certified {cal.certified_recall:.4f}); "
        f"certified recall@{cert.k} {cert.certified_recall:.4f} (mean {cert.mean_recall:.4f}); gated B=256 "
        f"{g_ms:.2f} ms; rebound after reopen")
    ivf_rec["certificate"] = {**cert.to_record(), "calibrated_nprobe": nprobe, "certify_s": cert_s,
                              "gated_batch_ms": g_ms}
    rec["ivf"] = ivf_rec
    del ivf_index, reopened, gated, arm, x, hier, ivf_slab
    torch.cuda.empty_cache()

    # the write path over phase 2's index: append, delete, sync, compact, reopen
    wrng = np.random.default_rng(SEED + 10)
    new = wrng.standard_normal((APPEND_DOCS, DIM), dtype=np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new_ids = [f"new-{i:07d}" for i in range(APPEND_DOCS)]
    gone = new_ids[: DELETE_DOCS // 2] + [ids[i] for i in wrng.choice(N_DOCS, DELETE_DOCS // 2, replace=False)]
    gone_set = set(gone)
    index.wal_sync = "deferred"
    t0 = time.perf_counter()
    index.fast.enable_ivf()
    first_arm_s = time.perf_counter() - t0

    def write_path():
        w = {}
        _, w["append_ms"] = timed(lambda: index.append_fast(new_ids, new))
        try:
            index.fast.search_batch(new[:8], K, mode="ivf")
        except InvalidConfig:
            w["ivf_refused"] = True
        _, w["delete_ms"] = timed(lambda: index.delete(gone))
        _, w["sync_ms"] = timed(index.sync_wal)
        top1, w["own_hit_ms"] = timed(lambda: [index.fast.hydrate(index.fast.search_batch(new[i : i + 1000], 1))
                                             for i in range(0, APPEND_DOCS, 1000)])
        w["top1"] = [h[0].doc_id if h else None for chunk in top1 for h in chunk]
        dq = np.stack([index.fast.vector_for_row(index.fast.row_for(d)) for d in gone])
        w["gone_hits"] = index.fast.hydrate(index.fast.search_batch(dq, K))
        t0 = time.perf_counter()
        index.fast.enable_ivf()
        w["rebuild_arm_s"] = time.perf_counter() - t0
        w["ivf_top1"] = index.fast.hydrate(index.fast.search_batch(new[DELETE_DOCS:DELETE_DOCS + 256], 1,
                                                                   mode="ivf", nprobe=8))
        w["pre"] = index.fast.hydrate(index.fast.search_batch(qv.cpu().numpy(), K))
        t0 = time.perf_counter()
        compacted = index.compact()
        w["compact_s"] = time.perf_counter() - t0
        w["stats"] = {k: v.__dict__ for k, v in compacted.last_vacuum_stats.items()}
        t0 = time.perf_counter()
        reopened = TwoTierIndex.open(index.root, device=dev)
        w["reopen_s"] = time.perf_counter() - t0
        w["post"] = reopened.fast.hydrate(reopened.fast.search_batch(qv.cpu().numpy(), K))
        return w

    w, got = drive(write_path, set())
    count("phase9 write path", got, ("K1", "K2"))
    if not w.get("ivf_refused"):
        raise AssertionError("phase9 write path: mode='ivf' served after an append, before enable_ivf()")
    own = [t == d for t, d in zip(w["top1"], new_ids) if d not in gone_set]
    if not all(own):
        raise AssertionError(f"phase9 write path: {own.count(False)} appended docs are not their own top hit")
    seen = [h.doc_id for hits in (w["gone_hits"] + w["pre"]) for h in hits] + [t for t in w["top1"] if t]
    if gone_set & set(seen):
        raise AssertionError(f"phase9 write path: deleted docs came back: {sorted(gone_set & set(seen))[:5]}")
    ivf_own = float(np.mean([bool(h) and h[0].doc_id == d
                             for h, d in zip(w["ivf_top1"], new_ids[DELETE_DOCS:DELETE_DOCS + 256])]))
    if ivf_own < IVF_OWN_HIT_FLOOR:
        raise AssertionError(f"phase9 write path: the rebuilt IVF arm finds {ivf_own} of the appended docs")
    bitwise = [[(h.doc_id, h.score) for h in a] == [(h.doc_id, h.score) for h in b]
               for a, b in zip(w["pre"], w["post"])]
    if not all(bitwise):
        raise AssertionError(f"phase9 write path: {bitwise.count(False)} queries' top-10 changed across "
                             "compact() and reopen")
    log(f"phase9 write path: append {APPEND_DOCS} {w['append_ms']:.1f} ms, delete {DELETE_DOCS} "
        f"{w['delete_ms']:.1f} ms, sync {w['sync_ms']:.1f} ms; every appended doc its own top hit, no deleted "
        f"doc returned; ivf refused after the append, the rebuilt arm ({w['rebuild_arm_s']:.1f} s, first "
        f"{first_arm_s:.1f} s) finds {ivf_own:.4f} of 256 appended docs first at nprobe 8; compact "
        f"{w['compact_s']:.1f} s, reopen {w['reopen_s']:.1f} s, top-10 of 256 queries bitwise unchanged")
    rec["write_path"] = {k: w[k] for k in ("append_ms", "delete_ms", "sync_ms", "own_hit_ms", "rebuild_arm_s",
                                           "compact_s", "reopen_s", "stats")}
    rec["write_path"].update({"first_arm_s": first_arm_s, "ivf_own_hit": ivf_own})
    log(f"phase9 launches on the main path: {launches}")
    return rec, launches, kernels


def main() -> int:
    # the port must reach neither jax nor the JAX package, even indirectly
    sys.modules["jax"] = None
    sys.modules["frankensearch_tpu"] = None
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
        h1m, l4, k4, lexical = phase4_hybrid1m(dev, semantic)
        wall["phase4_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        modes, l5, k5 = phase5_scan_modes(dev, tmp, semantic, lexical)
        wall["phase5_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ab_rec, l6, k6 = phase6_ab_scan(dev, semantic)
        wall["phase6_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2v_rec, l7, k7 = phase7_hybrid_m2v(dev, tmp, lexical)
        wall["phase7_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        quality_rec, l8, k8 = phase8_quality(dev, tmp, semantic, lexical)
        wall["phase8_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lanes_rec, l9, k9 = phase9_scan_lanes(dev, tmp, semantic)
        wall["phase9_s"] = time.perf_counter() - t0
        del semantic, lexical
        log("phase wall times: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))

    records = k2 + k3 + k4 + k5 + k6 + k7 + k8 + k9
    kernels = []
    for name, key, src, replaces, cell in KERNELS:
        recs = [r for r in records if r["kernel"] == name]
        if name == "flat_fused":
            # headline: one launch (one class) at the widest batch tile, the
            # mean over the classes, the unit of its launch count
            top = max((r["b"], r["t"]) for r in recs)
            head = [r for r in recs if (r["b"], r["t"]) == top]
        else:
            # headline: the 1M-doc cell's largest batch (and largest kk)
            head = [max((r for r in recs if r["cell"] == cell), key=lambda r: (r["b"], r["kk"] or 0))]
        bound_ms = sum(r["bound"][0] for r in head) / len(head)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(l.get(key, 0) for l in (l2, l3, l4, l5, l6, l7, l8, l9)),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in head) / len(head), "plain_ms": sum(r["plain_ms"] for r in head) / len(head),
            "bound_ms": bound_ms,
            "bound_by": max(head, key=lambda r: r["bound"][0])["bound"][1],
            "library_ms": None,  # no single PyTorch call computes any of these functions
            "shapes": [{k: (v if k != "bound" else v[0]) for k, v in r.items() if k != "kernel"} for r in recs],
        })
    log(json.dumps({"semantic": sem, "hybrid": hyb, "hybrid_1m": h1m, "scan_modes": modes, "ab_scan": ab_rec,
                    "hybrid_1m_m2v": m2v_rec, "hybrid_1m_quality": quality_rec, "scan_lanes": lanes_rec,
                    "wall_s": wall}))
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
