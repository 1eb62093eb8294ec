"""The least time the card could take for a piece of work, from its shapes.

``bound`` is a frozen copy of chip_smoke.py's (the program's kernel
checks), with the peaks of one NVIDIA H100 SXM from NVIDIA's data sheet
(dense rates, no sparsity, at the 700 W limit): bytes over the HBM
bandwidth or operations over the peak rate of their type, whichever is
larger. ``exact_scan`` counts a scan's bytes and operations from its
shapes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for work that must
    move ``bytes_moved`` bytes and do ``ops`` operations of type ``kind``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact_scan(batch: int, live_rows: int, padded_rows: int, dim: int, k: int, *,
               slab_bytes: int = 2, query_bytes: int = 4) -> tuple[float, float]:
    """(bytes, operations) an exact top-``k`` scan of ``batch`` queries over
    a slab needs: every live row read once (``slab_bytes`` an element), the
    f32 additive mask of every padded row, the queries, and the (score,
    row) pairs it returns; a multiply and an add per element of every live
    row for every query."""
    moved = live_rows * dim * slab_bytes + padded_rows * 4 + batch * dim * query_bytes + batch * k * 8
    return float(moved), 2.0 * batch * live_rows * dim
