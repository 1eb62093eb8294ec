#!/usr/bin/env python3
"""Where the time goes: profile the PyTorch port's main path on one NVIDIA GPU.

Usage: ``python3 profile_chip.py [OUT_DIR]`` from the root of a checkout (one
CUDA card). OUT_DIR, where the reports go, defaults to ``build/profile``.

Builds the two cells of ``chip_smoke.py`` (semantic-1M, hybrid-60k) and, for
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
JSON summary as the last line. The profiler table and the cProfile listing
of each (cell, B) go to ``OUT_DIR/profile_<cell>_b<B>.txt``.
"""

from __future__ import annotations

import cProfile
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


def profile_once(fn, path: str) -> tuple[float, float, float]:
    """(device ms, host ms under torch.profiler, host ms under cProfile) of
    one call each; writes both reports to ``path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        torch_prof_ms = (time.perf_counter() - t0) * 1000.0
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
    return device_ms, torch_prof_ms, cprofile_ms


def main() -> int:
    sys.modules["jax"] = None  # the port must not reach jax, even indirectly
    import torch

    if not torch.cuda.is_available():
        print("profile_chip: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from frankensearch_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    with tempfile.TemporaryDirectory(prefix="fs_profile_") as tmp:
        for cell, build in (("semantic-1M", cs.semantic_cell), ("hybrid-60k", cs.hybrid_cell)):
            built = build(dev, tmp)
            searcher, queries = built[0], built[-1]
            for b in (256, 1):
                batch = queries[:b]

                def call(batch=batch):
                    return searcher.search_batch(batch, k=cs.K)

                for _ in range(3):
                    call()
                host = [cs.timed(call)[1] for _ in range(REPS)]
                device_ms, torch_prof_ms, cprofile_ms = profile_once(
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
                }
                rows.append(row)
                cs.log(f"{cell} B={b}: host {row['host_ms_median']:.3f} ms median of {REPS} "
                       f"({row['host_ms_min']:.3f}-{row['host_ms_max']:.3f}); device {device_ms:.3f} ms; "
                       f"idle {row['idle_share']:.3f}; under torch.profiler {torch_prof_ms:.3f} ms, "
                       f"under cProfile {cprofile_ms:.3f} ms")
            del built, searcher
            torch.cuda.empty_cache()
    cs.log(cs.gpu_line())
    print(json.dumps({"profile": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
