"""Exact batched scan + top-k over a device-resident vector slab (PyTorch).

Port of frankensearch_tpu/ops/topk_scan.py: the plain scan
(:func:`scan_topk_xla`) and the hierarchical group-max scan
(:func:`scan_topk_hierarchical`), whose two TPU kernels become the
hand-written Hopper kernels K1 (:func:`group_max`, csrc/group_max.cu) and
K2 (:func:`gather_rescore`, csrc/gather_rescore.cu).

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


def _check_kernel_operands(slab: torch.Tensor, queries: torch.Tensor) -> None:
    if slab.dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"the CUDA scan kernels take bf16/f16 slabs, got {slab.dtype} "
            "(f32 slabs on CUDA: ROADMAP, the int8/MRL/IVF lanes item)"
        )
    if slab.dim() != 2 or queries.dim() != 2 or queries.shape[1] != slab.shape[1]:
        raise ValueError(f"shape mismatch: slab {tuple(slab.shape)}, queries {tuple(queries.shape)}")
    if queries.device != slab.device:
        raise ValueError(f"queries on {queries.device}, slab on {slab.device}")
    if not slab.is_contiguous() or slab.data_ptr() % 16:
        raise ValueError("slab must be contiguous and 16-byte aligned")
    if slab.shape[0] % GROUP:
        raise ValueError(f"slab rows {slab.shape[0]} not a multiple of {GROUP}")


def group_max_plain(slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1: (B, N/128) maxima of q·slabᵀ + mask, the query
    rounded to the slab dtype, f32 accumulate."""
    b = queries.shape[0]
    q = queries.to(slab.dtype).to(torch.float32)
    scores = q @ slab.to(torch.float32).T + mask[None, :].to(torch.float32)
    return scores.view(b, slab.shape[0] // GROUP, GROUP).amax(dim=2)


def group_max(slab: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K1 (replaces ``_group_max_kernel``): (B, N/128) f32 masked group
    maxima. CUDA tensors run csrc/group_max.cu; CPU tensors the plain twin."""
    if slab.device.type == "cpu":
        return group_max_plain(slab, queries, mask)
    _check_kernel_operands(slab, queries)
    n, d = slab.shape
    if d % 64:
        raise ValueError(f"group_max needs dim % 64 == 0, got {d}")
    if mask.shape != (n,) or mask.dtype != torch.float32 or mask.device != slab.device:
        raise ValueError("mask must be (N,) f32 on the slab's device")
    b = queries.shape[0]
    out = torch.empty((b, n // GROUP), dtype=torch.float32, device=slab.device)
    if b == 0:
        return out
    q = queries.to(slab.dtype).contiguous()
    if q.data_ptr() % 16:  # the kernel stages query rows with 16-byte loads
        q = q.clone()
    mask = mask.contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab.device):
        rc = lib.fs_group_max(
            q.data_ptr(), slab.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, d, n, int(slab.dtype == torch.bfloat16),
            torch.cuda.current_stream(slab.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"group_max kernel launch failed: CUDA error {rc}")
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


def gather_rescore(
    slab: torch.Tensor, queries: torch.Tensor, top_groups: torch.Tensor
) -> torch.Tensor:
    """K2 (replaces ``_gather_rescore_kernel``): (B, kk) group ids ->
    (B, kk*128) f32 scores. CUDA tensors run csrc/gather_rescore.cu (any B
    and kk); CPU tensors the plain twin."""
    if slab.device.type == "cpu":
        return gather_rescore_plain(slab, queries, top_groups)
    _check_kernel_operands(slab, queries)
    n, d = slab.shape
    if d % 8 or d * 4 > 48 * 1024:
        raise ValueError(f"gather_rescore needs dim % 8 == 0 and dim <= 12288, got {d}")
    b, kk = top_groups.shape
    if b != queries.shape[0] or top_groups.device != slab.device:
        raise ValueError("top_groups must be (B, kk) on the slab's device")
    out = torch.empty((b, kk * GROUP), dtype=torch.float32, device=slab.device)
    if b == 0 or kk == 0:
        return out
    q = queries.to(slab.dtype).contiguous()
    groups = top_groups.to(torch.int32).contiguous()
    from frankensearch_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(slab.device):
        rc = lib.fs_gather_rescore(
            q.data_ptr(), slab.data_ptr(), groups.data_ptr(), out.data_ptr(),
            b, kk, d, n, int(slab.dtype == torch.bfloat16),
            torch.cuda.current_stream(slab.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_rescore kernel launch failed: CUDA error {rc}")
    gather_rescore.launches += 1
    return out


gather_rescore.launches = 0


# --------------------------------------------------------------------------
# hierarchical scan
# --------------------------------------------------------------------------


def _rescore_groups(
    slab: torch.Tensor,
    queries: torch.Tensor,
    mask: torch.Tensor,
    top_groups: torch.Tensor,  # (B, kk_groups) selected group ids
    *,
    k: int,
) -> TopKResult:
    """Exact-rescore tail of the hierarchical scan: score the selected
    groups' rows (K2), add their mask, final top-k. The reference's XLA
    rescore (f32 query) is not ported: the main path always took the
    kernel, whose query is rounded to the slab dtype."""
    n = slab.shape[0]
    b = queries.shape[0]
    kk_groups = top_groups.shape[1]
    top_groups = torch.sort(top_groups, dim=1).values  # row-ascending tiebreak
    offsets = torch.arange(GROUP, dtype=top_groups.dtype, device=slab.device)
    cand_rows = (top_groups[:, :, None] * GROUP + offsets).reshape(b, kk_groups * GROUP)
    exact = gather_rescore(slab, queries, top_groups)
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
