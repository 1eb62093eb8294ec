"""The least time of K3 (``flat_class_fused``, ops/csrc/flat_score.cu), one
class of the flat BM25 lane, from its shapes.

K3 is bound by bytes on the H100 (the kernel's own header): it must read
each posting slot's term id and tf-side value (4 + 4 bytes a slot of the
class's (n_c, L, d_pad) blocks), each slot's row (4) and the queries' ids
and weights (8 a term), read the hot partial's slice where one is given
(4 a slot a query), and write the masked scores (4 a slot a query) and
each 128-slot group's (max, row) (8 a group a query). Its operations, at
least: one probe of each posting slot and, per slot and query, the hot add,
the mask and the group max, at the f32 peak of harness/roofline.py.
"""

from __future__ import annotations

from benchmark.harness import roofline


def k3(n_c: int, l_c: int, d_pad: int, b: int, t: int, hot: bool) -> tuple[float, float]:
    """(bytes, operations) of one K3 launch."""
    slots = n_c * d_pad
    moved = slots * l_c * 8 + slots * 4 + b * t * 8 + b * slots * (4 + (4 if hot else 0)) + b * (slots // 128) * 8
    return float(moved), float(slots * l_c + 3 * b * slots)


def least_ms(shapes) -> float:
    """The least ms of K3 launches of the given shapes
    (``systems/hybrid.py``'s notes)."""
    return sum(roofline.bound(*k3(*s), "f32")[0] for s in shapes)
