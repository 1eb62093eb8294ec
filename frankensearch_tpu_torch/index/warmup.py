"""Index warmup: kill cold-start variance before serving.

Parity target: reference crates/frankensearch-index/src/warmup.rs — mmap
prefault strategies (None / Full / adaptive HeatMap). The device analogs:
the upload happens at index open (DeviceVectorIndex), so warmup here
means (a) waiting for the upload to finish (a device synchronize), and
(b) one scan at each batch shape that will serve traffic, so the first
query never pays a first launch: on CUDA the first scan also loads the
kernel library (``ops/_build.library_path``, built on first use).
``compile_ms`` keeps the JAX package's field name and times (b).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

import numpy as np


class WarmupStrategy(enum.Enum):
    NONE = "none"
    UPLOAD_ONLY = "upload_only"  # block until the slab is resident on the device
    FULL = "full"  # upload + one scan at every serving batch shape


@dataclass
class WarmupReport:
    strategy: WarmupStrategy
    upload_ms: float = 0.0
    compile_ms: float = 0.0
    shapes_compiled: list[tuple[int, int]] = field(default_factory=list)


def warm_index(
    index,  # DeviceVectorIndex or TwoTierIndex
    *,
    strategy: WarmupStrategy = WarmupStrategy.FULL,
    batch_sizes: tuple[int, ...] = (1, 8, 64),
    ks: tuple[int, ...] = (10,),
) -> WarmupReport:
    report = WarmupReport(strategy=strategy)
    if strategy is WarmupStrategy.NONE:
        return report

    tiers = []
    if hasattr(index, "fast"):
        tiers.append(index.fast)
        if getattr(index, "quality", None) is not None:
            tiers.append(index.quality)
    else:
        tiers.append(index)

    def sync(tensor) -> None:
        if tensor.device.type == "cuda":
            import torch

            torch.cuda.synchronize(tensor.device)

    t0 = time.monotonic()
    for tier in tiers:
        sync(tier.slab)
        sync(tier.base_mask)
    report.upload_ms = (time.monotonic() - t0) * 1000.0
    if strategy is WarmupStrategy.UPLOAD_ONLY:
        return report

    t1 = time.monotonic()
    for tier in tiers:
        if tier.n_rows == 0:
            continue
        for b in batch_sizes:
            for k in ks:
                q = np.zeros((b, tier.dim), dtype=np.float32)
                q[:, 0] = 1.0
                res = tier.search_batch(q, k)
                sync(res.scores)
                report.shapes_compiled.append((b, k))
    report.compile_ms = (time.monotonic() - t1) * 1000.0
    return report
