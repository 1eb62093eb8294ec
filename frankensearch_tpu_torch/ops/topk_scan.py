"""Exact batched scan + top-k over a device-resident vector slab (PyTorch).

Port of frankensearch_tpu/ops/topk_scan.py: the plain scan
(:func:`scan_topk_xla`), the hierarchical group-max scan
(:func:`scan_topk_hierarchical`), its int8 capacity lane
(:func:`scan_topk_hierarchical_int8`), the per-tile top-k scan
(:func:`scan_topk_pallas`), the plain int8 and packed int4 two-pass scans
(:func:`scan_topk_int8_two_pass`, :func:`scan_topk_int4_two_pass`) and the
Matryoshka two-pass scan (:func:`scan_topk_mrl`). Their TPU kernels become hand-written
Hopper kernels: K1 (:func:`group_max`, csrc/group_max.cu), K2
(:func:`gather_rescore`, csrc/gather_rescore.cu) and its int8 form
(:func:`gather_rescore_i8`, the same source), K4 (:func:`group_max_int8`,
K1's kernel in its int8 form) and K5 (:func:`tile_topk`,
csrc/tile_topk.cu). K6 (:func:`group_candidates`: K1, then
:func:`tile_select` in csrc/group_candidates.cu) is the kernel of the A/B
lane in ops/ab_primitives.py; it lives here beside K1, whose maxima it
selects from.

Each kernel wrapper runs its kernel on a CUDA tensor and its plain PyTorch
twin (same semantics, the analog of Pallas ``interpret=True``) on a CPU
tensor; nothing else chooses between them. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

Ordering contract (the reference's): scores descending, ties broken toward
the lower slab row, +0.0 above -0.0 (``lax.top_k``); masked and padded rows
score -inf and come back as index -1. Indices are int32 at every public
boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")
#: slab rows per group in the hierarchical scan (fixed by both kernels)
GROUP = 128
#: widest dim K1 and K2 take: K1 keeps 8 queries of it resident in 128 KB
#: of shared memory, K2 one row in a lane's 128 registers
MAX_KERNEL_DIM = 8192
#: K2 puts the pairs in group order (a counting sort on the card) from this
#: batch size up. Below it the queries share few of the slab's groups, and
#: the sort's four launches would cost more than the reads they save.
GATHER_GROUP_MIN_B = 64
#: The same for K2's int8 form, whose groups cost half K2's bytes to read
#: again: the smallest measured batch at which group order ties or beats
#: pair order on both clocks. ``profile_chip.py --kernels`` on an NVIDIA
#: H100 80GB HBM3 at 700 W, kk = 60 over the 1M x 256 int8 slab, pair
#: order against group order (plan included), CUDA events / device ms:
#: B=128 0.1059 / 0.0786 against 0.1678 / 0.0826; B=192 0.1429 / 0.1150
#: against 0.1448 / 0.1042; B=256 0.1811 / 0.1506 against 0.1668 / 0.1254.
GATHER_I8_GROUP_MIN_B = 192
#: widest dim K2's int8 form takes (the first port's: its f32 query row
#: filled 48 KB of shared memory)
MAX_I8_RESCORE_DIM = 12288
#: widest dim K2's f32 form takes: a lane holds its 16-byte chunks of a row
#: in at most 128 registers, as K2's widest bf16 row
MAX_F32_RESCORE_DIM = 4096


class TopKResult(NamedTuple):
    scores: torch.Tensor  # (B, k) f32, descending
    indices: torch.Tensor  # (B, k) i32 slab rows; padded/masked rows -> -1


def _apply_additive_mask(scores: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return scores
    return scores + mask[None, :].to(scores.dtype)


def additive_mask(valid: torch.Tensor) -> torch.Tensor:
    """Bool validity vector (N,) -> additive f32 mask (0 / -inf)."""
    return torch.zeros(valid.shape, dtype=torch.float32, device=valid.device).masked_fill(
        ~valid, NEG_INF
    )


def _finalize(scores: torch.Tensor, indices: torch.Tensor) -> TopKResult:
    """Mark never-valid winners (score == -inf) with index -1."""
    indices = torch.where(torch.isfinite(scores), indices, -1)
    return TopKResult(scores.to(torch.float32), indices.to(torch.int32))


def _pad_topk(scores: torch.Tensor, indices: torch.Tensor, k: int):
    pad = k - scores.shape[1]
    if pad > 0:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        indices = torch.nn.functional.pad(indices, (0, pad), value=-1)
    return scores, indices


def float_order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 key whose integer order is the float total order
    (-inf < ... < -0.0 < +0.0 < ... < +inf < NaN)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk_desc_rowasc(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of ``x`` (B, N) f32 in (value desc, column asc)
    order, +0.0 ranked above -0.0 — ``lax.top_k``'s order. ``torch.topk``
    documents no tie order, so each element gets a unique int64 key
    (total-order value bits, then the inverted column) and the key decides.
    Returns (values f32, columns int64)."""
    n = x.shape[1]
    col = torch.arange(n, dtype=torch.int64, device=x.device)
    key = (float_order_key(x) << 32) | (0xFFFFFFFF - col)
    top = torch.topk(key, k, dim=1, largest=True, sorted=True).values
    cols = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return torch.gather(x, 1, cols), cols


# --------------------------------------------------------------------------
# plain scan
# --------------------------------------------------------------------------


def scan_topk_xla(
    slab: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
    *,
    precise: bool = False,
) -> TopKResult:
    """Batched dot-product scan + exact top-k, plain PyTorch.

    slab: (N, D) bf16/f16/f32 rows; queries: (B, D) f32; mask: optional
    (N,) additive f32 mask (0 valid, -inf excluded). Off-f32 slabs score
    the query rounded to the slab dtype (f32 accumulate) unless
    ``precise``."""
    n = slab.shape[0]
    kk = min(k, n)
    if precise or slab.dtype == torch.float32:
        scores = queries.to(torch.float32) @ slab.to(torch.float32).T
    else:
        scores = queries.to(slab.dtype).to(torch.float32) @ slab.to(torch.float32).T
    scores = _apply_additive_mask(scores, mask)
    top_s, top_i = topk_desc_rowasc(scores, kk)
    return _finalize(*_pad_topk(top_s, top_i, k))


# --------------------------------------------------------------------------
# K1: masked per-group maxima
# --------------------------------------------------------------------------


#: the slab dtypes the scan kernels take, as their C entry points' ``kind``
#: argument: bf16 and f16 score on the tensor cores, f32 by FFMA (exact f32
#: products, TF32 stays off)
_KINDS = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}


def _check_kernel_operands(slab: torch.Tensor, queries: torch.Tensor) -> None:
    if slab.dtype not in _KINDS:
        raise ValueError(f"the CUDA scan kernels take bf16/f16/f32 slabs, got {slab.dtype}")
    if slab.dim() != 2 or queries.dim() != 2 or queries.shape[1] != slab.shape[1]:
        raise ValueError(f"shape mismatch: slab {tuple(slab.shape)}, queries {tuple(queries.shape)}")
    if queries.device != slab.device:
        raise ValueError(f"queries on {queries.device}, slab on {slab.device}")
    if not slab.is_contiguous() or slab.data_ptr() % 16:
        raise ValueError("slab must be contiguous and 16-byte aligned")
    if slab.shape[0] % GROUP:
        raise ValueError(f"slab rows {slab.shape[0]} not a multiple of {GROUP}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' 16-byte loads."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def group_max_plain(slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: (B, N/128) maxima of q·slabᵀ + mask, the query
    rounded to the slab dtype, f32 accumulate."""
    b = queries.shape[0]
    q = queries.to(slab.dtype).to(torch.float32)
    scores = q @ slab.to(torch.float32).T + mask[None, :].to(torch.float32)
    return scores.view(b, slab.shape[0] // GROUP, GROUP).amax(dim=2)


def _check_group_max_operands(what: str, slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> None:
    _check_kernel_operands(slab, queries)
    n, d = slab.shape
    if d % 64 or d > MAX_KERNEL_DIM:
        raise ValueError(f"{what} needs dim % 64 == 0 and dim <= {MAX_KERNEL_DIM}, got {d}")
    if mask.shape != (n,) or mask.dtype != torch.float32 or mask.device != slab.device:
        raise ValueError("mask must be (N,) f32 on the slab's device")


def _launch_group_max(slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, out: torch.Tensor) -> None:
    """csrc/group_max.cu's K1 into ``out`` (B, N/128), B >= 1, operands
    checked; counts nothing (its callers count their own kernel)."""
    q = _aligned(queries.to(slab.dtype))  # the kernel reads query rows with TMA
    mask = mask.contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab.device):
        rc = lib.fs_group_max(
            q.data_ptr(), slab.data_ptr(), mask.data_ptr(), out.data_ptr(),
            q.shape[0], slab.shape[1], slab.shape[0], _KINDS[slab.dtype],
            torch.cuda.current_stream(slab.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"group_max kernel launch failed: CUDA error {rc}")


def group_max(slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K1 (replaces ``_group_max_kernel``): (B, N/128) f32 masked group
    maxima. CUDA tensors run csrc/group_max.cu (bf16/f16 on ``wgmma``, f32
    by FFMA on csrc/scan_f32.cuh); CPU tensors the plain twin."""
    if slab.device.type == "cpu":
        return group_max_plain(slab, queries, mask)
    _check_group_max_operands("group_max", slab, queries, mask)
    b = queries.shape[0]
    out = torch.empty((b, slab.shape[0] // GROUP), dtype=torch.float32, device=slab.device)
    if b == 0:
        return out
    _launch_group_max(slab, queries, mask, out)
    group_max.launches += 1
    return out


group_max.launches = 0


# --------------------------------------------------------------------------
# K2: gather + exact rescore of selected groups
# --------------------------------------------------------------------------


def gather_rescore_plain(
    slab: torch.Tensor, queries: torch.Tensor, top_groups: torch.Tensor
) -> torch.Tensor:
    """Plain twin of K2: (B, kk*128) scores of each query against its
    selected groups' rows, the query rounded to the slab dtype, f32
    accumulate."""
    b, kk = top_groups.shape
    d = slab.shape[1]
    q = queries.to(slab.dtype).to(torch.float32)
    cand = slab.view(-1, GROUP, d)[top_groups.to(torch.int64)].to(torch.float32)
    return torch.einsum("bd,bkrd->bkr", q, cand).reshape(b, kk * GROUP)


def _gather_plan_scratch(n_groups: int, total: int, device) -> tuple[torch.Tensor, int, int]:
    """Scratch of ``fs_gather_plan`` (int32 words: counts and starts of the
    n_groups + 1 bins, then the sorted ids, then the pair of each) and the
    addresses of its last two parts."""
    n_bins = n_groups + 1
    plan = torch.empty(2 * n_bins + 1 + 2 * total, dtype=torch.int32, device=device)
    ids = plan.data_ptr() + 4 * (2 * n_bins + 1)
    return plan, ids, ids + 4 * total


def gather_rescore(
    slab: torch.Tensor, queries: torch.Tensor, top_groups: torch.Tensor
) -> torch.Tensor:
    """K2 (replaces ``_gather_rescore_kernel``): (B, kk) group ids ->
    (B, kk*128) f32 scores. CUDA tensors run csrc/gather_rescore.cu (any B
    and kk; bf16/f16 rows, or f32 rows up to ``MAX_F32_RESCORE_DIM``
    dims); CPU tensors the plain twin. From ``GATHER_GROUP_MIN_B``
    queries up, a counting sort on the card first puts the pairs in group
    order, so that each group the batch chose is read once."""
    if slab.device.type == "cpu":
        return gather_rescore_plain(slab, queries, top_groups)
    _check_kernel_operands(slab, queries)
    n, d = slab.shape
    d_max = MAX_F32_RESCORE_DIM if slab.dtype == torch.float32 else MAX_KERNEL_DIM
    if d % 8 or d > d_max:
        raise ValueError(f"gather_rescore needs dim % 8 == 0 and dim <= {d_max}, got {d}")
    b, kk = top_groups.shape
    if b != queries.shape[0] or top_groups.device != slab.device:
        raise ValueError("top_groups must be (B, kk) on the slab's device")
    out = torch.empty((b, kk * GROUP), dtype=torch.float32, device=slab.device)
    if b == 0 or kk == 0:
        return out
    q = _aligned(queries.to(slab.dtype))  # the kernel reads query rows with 16-byte loads
    groups = top_groups.to(torch.int32).contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream(slab.device).cuda_stream
        kind = _KINDS[slab.dtype]
        if b < GATHER_GROUP_MIN_B:
            rc = lib.fs_gather_rescore(q.data_ptr(), slab.data_ptr(), groups.data_ptr(), out.data_ptr(),
                                       b, kk, d, n, kind, stream)
        else:
            plan, ids, pairs = _gather_plan_scratch(n // GROUP, b * kk, slab.device)
            rc = lib.fs_gather_plan(groups.data_ptr(), plan.data_ptr(), b * kk, n // GROUP, stream)
            if rc == 0:
                rc = lib.fs_gather_rescore_sorted(q.data_ptr(), slab.data_ptr(), ids, pairs, out.data_ptr(),
                                                  b, kk, d, n, kind, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rescore kernel launch failed: CUDA error {rc}")
    gather_rescore.launches += 1
    return out


gather_rescore.launches = 0


# --------------------------------------------------------------------------
# int8 lane: query preparation, K4 and K2's int8 form
# --------------------------------------------------------------------------


def prepare_query_int8(queries: torch.Tensor, slab_scale: torch.Tensor) -> torch.Tensor:
    """The int8 lane's prepared query, the reference's f32 ops in its
    order: fold the per-dim scale in, then per-query symmetric int8
    (``q_prep / qmax * 127``, round half to even, clip to [-127, 127])."""
    q_prep = queries.to(torch.float32) * slab_scale.to(torch.float32)
    qmax = torch.clamp(q_prep.abs().amax(dim=1, keepdim=True), min=1e-6)
    return torch.clamp(torch.round(q_prep / qmax * 127.0), -127, 127).to(torch.int8)


def int8_dot(q_i8: torch.Tensor, slab_i8: torch.Tensor) -> torch.Tensor:
    """Exact (B, N) int8 · int8ᵀ sums, as f32. Computed in f64, where every
    partial sum of at most 2^53 is exact, because an int8 ``torch.matmul``
    accumulates in int8 on the CPU and CUDA has no integer matmul; the
    cast to f32 rounds once, like the TPU kernel's int32 -> f32 cast."""
    return (q_i8.to(torch.float64) @ slab_i8.to(torch.float64).T).to(torch.float32)


def group_max_int8_plain(slab_i8: torch.Tensor, q_i8: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4: (B, N/128) maxima of float(q_i8 · slab_i8ᵀ) + mask."""
    b = q_i8.shape[0]
    scores = int8_dot(q_i8, slab_i8) + mask[None, :].to(torch.float32)
    return scores.view(b, slab_i8.shape[0] // GROUP, GROUP).amax(dim=2)


def _check_int8_operands(slab_i8: torch.Tensor, queries: torch.Tensor, query_dtype) -> None:
    if slab_i8.dtype != torch.int8 or queries.dtype != query_dtype:
        raise ValueError(f"want an int8 slab and {query_dtype} queries, got {slab_i8.dtype}, {queries.dtype}")
    if slab_i8.dim() != 2 or queries.dim() != 2 or queries.shape[1] != slab_i8.shape[1]:
        raise ValueError(f"shape mismatch: slab {tuple(slab_i8.shape)}, queries {tuple(queries.shape)}")
    if queries.device != slab_i8.device:
        raise ValueError(f"queries on {queries.device}, slab on {slab_i8.device}")
    if not slab_i8.is_contiguous() or slab_i8.data_ptr() % 16:
        raise ValueError("slab must be contiguous and 16-byte aligned")
    if slab_i8.shape[0] % GROUP:
        raise ValueError(f"slab rows {slab_i8.shape[0]} not a multiple of {GROUP}")


def group_max_int8(slab_i8: torch.Tensor, q_i8: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K4 (replaces ``_group_max_int8_kernel``): (B, N/128) f32 masked group
    maxima of the exact int8 scores. CUDA tensors run K1's kernel in its
    int8 form (csrc/group_max.cu, ``fs_group_max_int8``); CPU tensors the
    plain twin. Bitwise equal to the twin (exact int32 sums)."""
    if slab_i8.device.type == "cpu":
        return group_max_int8_plain(slab_i8, q_i8, mask)
    _check_int8_operands(slab_i8, q_i8, torch.int8)
    n, d = slab_i8.shape
    if d % 128 or d > 1024:
        raise ValueError(f"group_max_int8 needs dim % 128 == 0 and dim <= 1024, got {d}")
    if mask.shape != (n,) or mask.dtype != torch.float32 or mask.device != slab_i8.device:
        raise ValueError("mask must be (N,) f32 on the slab's device")
    b = q_i8.shape[0]
    out = torch.empty((b, n // GROUP), dtype=torch.float32, device=slab_i8.device)
    if b == 0:
        return out
    q = _aligned(q_i8)  # the kernel reads query rows with TMA
    mask = mask.contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab_i8.device):
        rc = lib.fs_group_max_int8(
            q.data_ptr(), slab_i8.data_ptr(), mask.data_ptr(), out.data_ptr(), b, d, n,
            torch.cuda.current_stream(slab_i8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"group_max_int8 kernel launch failed: CUDA error {rc}")
    group_max_int8.launches += 1
    return out


group_max_int8.launches = 0


def gather_rescore_i8_plain(
    slab_i8: torch.Tensor, q_scaled: torch.Tensor, top_groups: torch.Tensor
) -> torch.Tensor:
    """Plain twin of K2's int8 form: (B, kk*128) dots of each f32 query
    (per-dim scale folded in) with its selected groups' int8 rows cast to
    f32."""
    b, kk = top_groups.shape
    d = slab_i8.shape[1]
    cand = slab_i8.view(-1, GROUP, d)[top_groups.to(torch.int64)].to(torch.float32)
    return torch.einsum("bd,bkrd->bkr", q_scaled.to(torch.float32), cand).reshape(b, kk * GROUP)


def gather_rescore_i8(
    slab_i8: torch.Tensor, q_scaled: torch.Tensor, top_groups: torch.Tensor
) -> torch.Tensor:
    """K2's int8 form (replaces ``_gather_rescore_kernel`` with
    ``compute_f32=True``): (B, kk) group ids -> (B, kk*128) f32 scores.
    CUDA tensors run csrc/gather_rescore.cu (any B and kk, 16 <= dim <=
    12288); CPU tensors the plain twin. From ``GATHER_I8_GROUP_MIN_B`` queries
    up, K2's counting sort first puts the pairs in group order, so that
    each group the batch chose is read once."""
    if slab_i8.device.type == "cpu":
        return gather_rescore_i8_plain(slab_i8, q_scaled, top_groups)
    _check_int8_operands(slab_i8, q_scaled, torch.float32)
    n, d = slab_i8.shape
    if d % 16 or not 16 <= d <= MAX_I8_RESCORE_DIM:
        raise ValueError(f"gather_rescore_i8 needs dim % 16 == 0 and 16 <= dim <= {MAX_I8_RESCORE_DIM}, got {d}")
    b, kk = top_groups.shape
    if b != q_scaled.shape[0] or top_groups.device != slab_i8.device:
        raise ValueError("top_groups must be (B, kk) on the slab's device")
    out = torch.empty((b, kk * GROUP), dtype=torch.float32, device=slab_i8.device)
    if b == 0 or kk == 0:
        return out
    q = _aligned(q_scaled)  # the kernel reads query rows with 16-byte loads
    groups = top_groups.to(torch.int32).contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab_i8.device):
        stream = torch.cuda.current_stream(slab_i8.device).cuda_stream
        if b < GATHER_I8_GROUP_MIN_B:
            rc = lib.fs_gather_rescore_i8(q.data_ptr(), slab_i8.data_ptr(), groups.data_ptr(), out.data_ptr(),
                                          b, kk, d, n, stream)
        else:
            plan, ids, pairs = _gather_plan_scratch(n // GROUP, b * kk, slab_i8.device)
            rc = lib.fs_gather_plan(groups.data_ptr(), plan.data_ptr(), b * kk, n // GROUP, stream)
            if rc == 0:
                rc = lib.fs_gather_rescore_i8_sorted(q.data_ptr(), slab_i8.data_ptr(), ids, pairs, out.data_ptr(),
                                                     b, kk, d, n, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rescore_i8 kernel launch failed: CUDA error {rc}")
    gather_rescore_i8.launches += 1
    return out


gather_rescore_i8.launches = 0


# --------------------------------------------------------------------------
# K5: per-tile top-k
# --------------------------------------------------------------------------

#: slab rows per tile of the per-tile top-k scan (fixed by K5)
TILE_N = 2048
#: the largest kk K5's threshold-list entry holds (larger kk: its wide entry)
TILE_TOPK_LIST_K = 64


def tile_topk_plain(
    slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, kk: int, tile_n: int = TILE_N
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K5: per tile of ``tile_n`` rows, ``kk`` argmax passes
    over q·slabᵀ + mask (the query rounded to the slab dtype, f32 sums).
    Pass j takes the first column equal to the maximum (``==``, so -0.0
    ties +0.0), records its score and slab row, and knocks it out with
    -inf. Returns (T, kk, B) f32 scores and int32 rows."""
    n = slab.shape[0]
    b = queries.shape[0]
    t = n // tile_n
    q = queries.to(slab.dtype).to(torch.float32)
    s = (q @ slab.to(torch.float32).T + mask[None, :].to(torch.float32)).view(b, t, tile_n)
    base = torch.arange(t, dtype=torch.int64, device=slab.device)[None, :] * tile_n
    out_s = torch.empty((kk, b, t), dtype=torch.float32, device=slab.device)
    out_i = torch.empty((kk, b, t), dtype=torch.int64, device=slab.device)
    for j in range(kk):
        best = s.amax(dim=2, keepdim=True)
        col = torch.argmax((s == best).to(torch.uint8), dim=2, keepdim=True)  # first max
        out_s[j] = torch.gather(s, 2, col)[..., 0]
        out_i[j] = col[..., 0] + base
        s.scatter_(2, col, NEG_INF)
    return out_s.permute(2, 0, 1).contiguous(), out_i.permute(2, 0, 1).to(torch.int32).contiguous()


def tile_topk(
    slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, kk: int, tile_n: int = TILE_N
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (replaces ``_tile_topk_kernel``): (T, kk, B) per-tile top-kk
    scores and slab rows. CUDA tensors run csrc/tile_topk.cu (tiles of
    2048 rows): its threshold-list entry, on K1's scoring body (an f32
    slab: an FFMA scan with K1's f32 bits, overlapped with the selection,
    on a query tile sized to the batch), for ``kk <= TILE_TOPK_LIST_K`` and
    dim % 64 == 0, else its wide entry (argmax passes; counted in
    ``tile_topk.wide_launches`` as well); CPU tensors the plain twin."""
    if slab.device.type == "cpu":
        return tile_topk_plain(slab, queries, mask, kk, tile_n)
    _check_kernel_operands(slab, queries)
    n, d = slab.shape
    if tile_n != TILE_N or n % TILE_N:
        raise ValueError(f"tile_topk runs {TILE_N}-row tiles over a multiple of them, got {tile_n}, {n}")
    wide = kk > TILE_TOPK_LIST_K or d % 64 != 0
    d_max = 1024 if wide and slab.dtype == torch.float32 else 2048  # the wide entry's f32 query rows
    if d % 16 or d > d_max or not 1 <= kk <= TILE_N:
        raise ValueError(f"tile_topk needs dim % 16 == 0, dim <= {d_max} and 1 <= kk <= {TILE_N}; got {d}, {kk}")
    if mask.shape != (n,) or mask.dtype != torch.float32 or mask.device != slab.device:
        raise ValueError("mask must be (N,) f32 on the slab's device")
    b = queries.shape[0]
    out_s = torch.empty((n // TILE_N, kk, b), dtype=torch.float32, device=slab.device)
    out_i = torch.empty((n // TILE_N, kk, b), dtype=torch.int32, device=slab.device)
    if b == 0:
        return out_s, out_i
    q = _aligned(queries.to(slab.dtype))
    mask = mask.contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab.device):
        rc = (lib.fs_tile_topk_wide if wide else lib.fs_tile_topk)(
            q.data_ptr(), slab.data_ptr(), mask.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, d, n, kk, _KINDS[slab.dtype],
            torch.cuda.current_stream(slab.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_topk kernel launch failed: CUDA error {rc}")
    tile_topk.launches += 1
    tile_topk.wide_launches += wide
    return out_s, out_i


tile_topk.launches = 0
tile_topk.wide_launches = 0


def scan_topk_pallas(
    slab: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
    *,
    tile_n: int = TILE_N,
) -> TopKResult:
    """Scan + per-tile top-k (K5), then one exact merge of the (B,
    T*kk) tile candidates in ``lax.top_k`` order (tile-major pools keep
    the row-ascending tiebreak). Needs N % tile_n == 0."""
    n = slab.shape[0]
    b = queries.shape[0]
    if n % tile_n:
        raise ValueError(f"slab rows {n} not a multiple of tile_n {tile_n}")
    kk = min(k, tile_n)
    if mask is None:
        mask = torch.zeros(n, dtype=torch.float32, device=slab.device)
    cand_s, cand_i = tile_topk(slab, queries, mask, kk, tile_n)
    cand_s = cand_s.permute(2, 0, 1).reshape(b, -1)
    cand_i = cand_i.permute(2, 0, 1).reshape(b, -1)
    top_s, pos = topk_desc_rowasc(cand_s, min(k, cand_s.shape[1]))
    top_i = torch.gather(cand_i, 1, pos)
    return _finalize(*_pad_topk(top_s, top_i, k))


# --------------------------------------------------------------------------
# K6: per-tile group candidates
# --------------------------------------------------------------------------

#: the widest tile K6 takes (64 groups of 128 rows)
MAX_CANDIDATE_TILE = 8192


def argmax_passes(x: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` argmax passes over the last axis of ``x`` (..., G), the
    reference kernels' selection: pass j takes the maximum ``m`` (+0.0
    above -0.0, as ``jnp.max``), the first column whose value ``== m`` (so
    -0.0 ties +0.0), records (``m``, column) and knocks the column out with
    -inf; an exhausted row repeats column 0 at -inf. ``x`` is not modified.
    Returns (..., t) f32 values and int64 columns."""
    g = x.shape[-1]
    col = torch.arange(g, dtype=torch.int64, device=x.device)
    vals, cols = [], []
    for _ in range(t):
        m = torch.gather(x, -1, float_order_key(x).argmax(dim=-1, keepdim=True))
        bi = torch.where(x == m, col, g).amin(dim=-1, keepdim=True)
        vals.append(m[..., 0])
        cols.append(bi[..., 0])
        x = torch.where(col == bi, NEG_INF, x)
    return torch.stack(vals, dim=-1), torch.stack(cols, dim=-1)


def tile_select_plain(gm: torch.Tensor, t: int, tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K6's selection: ``t`` :func:`argmax_passes` over each
    tile's ``tile_n / 128`` groups of the (B, n_groups) maxima ``gm``.
    Returns (T, t, B) f32 values and int32 global group ids."""
    b, n_groups = gm.shape
    g_tile = tile_n // GROUP
    n_tiles = n_groups // g_tile
    vals, cols = argmax_passes(gm.view(b, n_tiles, g_tile), t)  # (B, T, t)
    gids = cols + torch.arange(n_tiles, dtype=torch.int64, device=gm.device)[None, :, None] * g_tile
    return vals.permute(1, 2, 0).contiguous(), gids.permute(1, 2, 0).to(torch.int32).contiguous()


def _check_tile_select(n_groups: int, t: int, tile_n: int) -> None:
    if tile_n % GROUP or not GROUP <= tile_n <= MAX_CANDIDATE_TILE or (n_groups * GROUP) % tile_n:
        raise ValueError(
            f"K6 needs tile_n a multiple of {GROUP} up to {MAX_CANDIDATE_TILE} "
            f"that divides N; got tile_n {tile_n}, N {n_groups * GROUP}"
        )
    if not 1 <= t <= tile_n // GROUP:
        raise ValueError(f"K6 needs 1 <= t <= {tile_n // GROUP}, got {t}")


def tile_select(gm: torch.Tensor, t: int, tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's selection on given (B, n_groups) f32 maxima: (T, t, B) values
    and int32 global group ids of :func:`tile_select_plain`'s passes. CUDA
    tensors run ``fs_tile_select`` (csrc/group_candidates.cu), bitwise the
    twin's; CPU tensors the twin. :func:`group_candidates` runs it on K1's
    maxima and counts its launches."""
    if gm.device.type == "cpu":
        return tile_select_plain(gm, t, tile_n)
    if gm.dim() != 2 or gm.dtype != torch.float32:
        raise ValueError(f"tile_select takes (B, n_groups) f32 maxima, got {gm.dtype} {tuple(gm.shape)}")
    b, n_groups = gm.shape
    _check_tile_select(n_groups, t, tile_n)
    gm = gm.contiguous()
    out_v = torch.empty((n_groups * GROUP // tile_n, t, b), dtype=torch.float32, device=gm.device)
    out_g = torch.empty((n_groups * GROUP // tile_n, t, b), dtype=torch.int32, device=gm.device)
    if b == 0:
        return out_v, out_g
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(gm.device):
        rc = lib.fs_tile_select(
            gm.data_ptr(), out_v.data_ptr(), out_g.data_ptr(), b, n_groups, tile_n // GROUP, t,
            torch.cuda.current_stream(gm.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_select kernel launch failed: CUDA error {rc}")
    return out_v, out_g


def group_candidates_plain(
    slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, t: int, tile_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K6: per tile of ``tile_n`` rows, K1's group maxima
    (:func:`group_max_plain`), then ``t`` :func:`argmax_passes` over the
    tile's ``tile_n / 128`` groups. Returns (T, t, B) f32 values and int32
    global group ids."""
    return tile_select_plain(group_max_plain(slab, queries, mask), t, tile_n)


def group_candidates(
    slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, t: int, tile_n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 (replaces ``_group_candidates_kernel``): (T, t, B) per-tile top-t
    group maxima and their global group ids. CUDA tensors run K1's kernel
    (csrc/group_max.cu, not counted as a K1 launch) into a (B, N/128)
    scratch, then :func:`tile_select`'s kernel (csrc/group_candidates.cu;
    ``tile_n`` a multiple of 128 up to 8192 that divides N); CPU tensors
    the plain twin."""
    if slab.device.type == "cpu":
        return group_candidates_plain(slab, queries, mask, t, tile_n)
    _check_group_max_operands("group_candidates", slab, queries, mask)
    _check_tile_select(slab.shape[0] // GROUP, t, tile_n)
    b = queries.shape[0]
    gm = torch.empty((b, slab.shape[0] // GROUP), dtype=torch.float32, device=slab.device)
    if b == 0:
        return tile_select(gm, t, tile_n)
    _launch_group_max(slab, queries, mask, gm)
    out = tile_select(gm, t, tile_n)
    group_candidates.launches += 1
    return out


group_candidates.launches = 0


# --------------------------------------------------------------------------
# hierarchical scan
# --------------------------------------------------------------------------


def rescore_xla(slab: torch.Tensor, queries: torch.Tensor, top_groups: torch.Tensor) -> torch.Tensor:
    """The reference's XLA rescore (its ``rescore="xla"`` branch, no
    Pallas kernel): the selected groups' rows gathered and cast to f32,
    scored against the f32 query (not rounded to the slab dtype).
    (B, kk) group ids -> (B, kk*128) f32."""
    b, kk = top_groups.shape
    d = slab.shape[1]
    cand = slab.view(-1, GROUP, d)[top_groups.to(torch.int64)].reshape(b, kk * GROUP, d).to(torch.float32)
    return torch.einsum("bd,bcd->bc", queries.to(torch.float32), cand)


def _rescore_groups(
    slab: torch.Tensor,
    queries: torch.Tensor,
    mask: torch.Tensor,
    top_groups: torch.Tensor,  # (B, kk_groups) selected group ids
    *,
    k: int,
    rescore="pallas",
) -> TopKResult:
    """Exact-rescore tail of the hierarchical scans: score the selected
    groups' rows, add their mask, final top-k. ``rescore`` is ``"pallas"``
    (K2, the query rounded to the slab dtype: the product's lanes),
    ``"xla"`` (:func:`rescore_xla`, the f32 query) or a function with K2's
    signature."""
    n = slab.shape[0]
    b = queries.shape[0]
    kk_groups = top_groups.shape[1]
    top_groups = torch.sort(top_groups, dim=1).values  # row-ascending tiebreak
    offsets = torch.arange(GROUP, dtype=top_groups.dtype, device=slab.device)
    cand_rows = (top_groups[:, :, None] * GROUP + offsets).reshape(b, kk_groups * GROUP)
    if rescore == "pallas":
        rescore = gather_rescore
    elif rescore == "xla":
        rescore = rescore_xla
    exact = rescore(slab, queries, top_groups)
    mask_cand = mask.reshape(n // GROUP, GROUP)[top_groups.to(torch.int64)]
    exact = exact + mask_cand.reshape(b, kk_groups * GROUP)
    kk = min(k, exact.shape[1])
    top_scores, pos = topk_desc_rowasc(exact, kk)
    top_idx = torch.gather(cand_rows, 1, pos)
    return _finalize(*_pad_topk(top_scores, top_idx, k))


def scan_topk_hierarchical(
    slab: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
) -> TopKResult:
    """Exact top-k via group-max pruning (same algorithm as the reference).

    Group-max coverage: cut the rows into groups of 128; if x is a global
    top-k element, x's group is among the top-k groups ranked by group max
    (otherwise >= k groups each hold an element > x). So K1's (B, N/128)
    group maxima -> top-k groups -> K2's exact rescore of those k*128 rows
    -> final top-k recovers the exact top-k. Needs N % 128 == 0 (the index
    pads to 8192)."""
    n = slab.shape[0]
    if n % GROUP:
        raise ValueError(f"slab rows {n} not a multiple of {GROUP}")
    kk_groups = min(k, n // GROUP)
    if mask is None:
        mask = torch.zeros(n, dtype=torch.float32, device=slab.device)
    gmax = group_max(slab, queries, mask)  # (B, N/128)
    _, top_groups = topk_desc_rowasc(gmax, kk_groups)
    return _rescore_groups(slab, queries, mask, top_groups.to(torch.int32), k=k)


def scan_topk_hierarchical_int8(
    slab_i8: torch.Tensor,  # (N, D) int8
    slab_scale: torch.Tensor,  # (D,) f32 per-dim dequant scale
    queries: torch.Tensor,  # (B, D) f32
    k: int,
    mask: torch.Tensor | None = None,
    *,
    group_overfetch: int = 1,
) -> TopKResult:
    """The capacity lane: the only slab on the device is int8. K4 ranks the
    groups with the prepared int8 query, then the top ``k *
    group_overfetch`` groups' int8 rows are rescored (K2's int8 form)
    against the f32 query with the per-dim scale folded in, and an exact
    top-k runs over them. Int8 ranks are approximate, so covering the
    exact top-k is probable, not certain (recall_certificate.py measures
    it). The rescore always takes the kernel's form, ``(q * scale) · c``;
    the reference falls back to ``q · (c * scale)`` off its TPU gates
    (B % 8 != 0, or a VMEM scratch above 12 MiB)."""
    n = slab_i8.shape[0]
    if n % GROUP:
        raise ValueError(f"slab rows {n} not a multiple of {GROUP}")
    kk_groups = min(max(k * group_overfetch, k), n // GROUP)
    if mask is None:
        mask = torch.zeros(n, dtype=torch.float32, device=slab_i8.device)
    gmax = group_max_int8(slab_i8, prepare_query_int8(queries, slab_scale), mask)
    _, top_groups = topk_desc_rowasc(gmax, kk_groups)
    q_scaled = queries.to(torch.float32) * slab_scale.to(torch.float32)
    return _rescore_groups(
        slab_i8, q_scaled, mask, top_groups.to(torch.int32), k=k, rescore=gather_rescore_i8
    )


def scan_topk_int8_two_pass(
    slab_i8: torch.Tensor,
    slab_scale: torch.Tensor,
    slab_exact: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
    *,
    candidate_multiplier: int = 4,
) -> TopKResult:
    """Two-pass quantized scan, plain PyTorch (the lane the int8 mode takes
    off the accelerator). Pass 1 ranks every row by the exact int8 dot with
    the prepared query and keeps a pool of ``k * candidate_multiplier``;
    pass 2 rescores the pool's rows of ``slab_exact`` against the f32 query
    and keeps the exact top-k of the pool."""
    n = slab_i8.shape[0]
    pool = min(max(k * candidate_multiplier, k), n)
    rough = _apply_additive_mask(int8_dot(prepare_query_int8(queries, slab_scale), slab_i8), mask)
    _, cand_idx = topk_desc_rowasc(rough, pool)  # (B, pool)
    cand_rows = slab_exact[cand_idx].to(torch.float32)  # (B, pool, D)
    return _rescore_pool(cand_idx, torch.einsum("bd,bpd->bp", queries.to(torch.float32), cand_rows), mask, k)


def _rescore_pool(
    cand_idx: torch.Tensor, exact: torch.Tensor, mask: torch.Tensor | None, k: int
) -> TopKResult:
    """Pass 2's tail of the two-pass scans: the pool's mask, then its exact
    top-k."""
    if mask is not None:
        exact = exact + mask[cand_idx].to(torch.float32)
    top_s, pos = topk_desc_rowasc(exact, min(k, exact.shape[1]))
    return _finalize(*_pad_topk(top_s, torch.gather(cand_idx, 1, pos), k))


def scan_topk_int4_two_pass(
    slab_packed: torch.Tensor,  # (N, D//2) uint8, low nibble = even dim
    slab_scale: torch.Tensor,  # (D,) f32
    slab_exact: torch.Tensor,  # (N, D) exact-dtype slab
    queries: torch.Tensor,  # (B, D) f32
    k: int,
    mask: torch.Tensor | None = None,
    *,
    candidate_multiplier: int = 6,
) -> TopKResult:
    """Packed 4-bit two-pass scan (the reference's
    ``scan_topk_int4_two_pass``, which no Pallas kernel serves). Pass 1
    unpacks the nibbles to int8 and ranks every row by the exact int32 dot
    with the int8 lane's prepared query (on CUDA ``torch._int_mm`` through
    :func:`~frankensearch_tpu_torch.ops.vector_math.int8_matmul`, on the
    CPU an int32 product), keeping a pool of ``k * candidate_multiplier``.
    Pass 2 rescores the pool's rows of ``slab_exact`` against the query
    rounded to ``slab_exact``'s dtype (the reference's ``astype``, unlike
    the int8 and MRL scans' f32 query), f32 sums."""
    from frankensearch_tpu_torch.ops.quantize import unpack_int4_device
    from frankensearch_tpu_torch.ops.vector_math import int8_matmul

    n = slab_packed.shape[0]
    pool = min(max(k * candidate_multiplier, k), n)
    q_i8 = prepare_query_int8(queries, slab_scale)
    # rows x queries, so that _int_mm's (k, n) operand is the small query block
    rough = int8_matmul(unpack_int4_device(slab_packed), q_i8.T.contiguous()).T.to(torch.float32)
    _, cand_idx = topk_desc_rowasc(_apply_additive_mask(rough, mask), pool)
    cand_rows = slab_exact[cand_idx].to(torch.float32)  # (B, pool, D)
    q = queries.to(slab_exact.dtype).to(torch.float32)
    return _rescore_pool(cand_idx, torch.einsum("bd,bpd->bp", q, cand_rows), mask, k)


def scan_topk_mrl(
    slab: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
    *,
    search_dims: int = 64,
    rescore_top_k: int = 30,
) -> TopKResult:
    """Matryoshka two-pass scan (the reference's ``scan_topk_mrl``, which no
    Pallas kernel serves; plain PyTorch on both devices). Pass 1 scans the
    first ``search_dims`` dims with the truncated query renormalised and
    rounded to the slab dtype (f32 sums); pass 2 rescores a pool of
    ``max(k, rescore_top_k)`` rows at full dim against the f32 query (the
    rows cast to f32: not K2, which rounds the query to the slab dtype)."""
    n, d = slab.shape
    sd = min(search_dims, d)
    pool = min(max(k, rescore_top_k), n)
    q_trunc = queries[:, :sd].to(torch.float32)
    q_trunc = q_trunc / torch.clamp(torch.linalg.vector_norm(q_trunc, dim=1, keepdim=True), min=1e-12)
    from frankensearch_tpu_torch.ops.vector_math import mm_bf16_f32

    q_trunc = q_trunc.to(slab.dtype)
    rough = q_trunc @ slab[:, :sd].T if slab.dtype == torch.float32 else mm_bf16_f32(q_trunc, slab[:, :sd].T)
    _, cand_idx = topk_desc_rowasc(_apply_additive_mask(rough, mask), pool)
    cand_rows = slab[cand_idx].to(torch.float32)  # (B, pool, D)
    exact = torch.einsum("bd,bpd->bp", queries.to(torch.float32), cand_rows)
    return _rescore_pool(cand_idx, exact, mask, k)
