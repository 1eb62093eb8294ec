"""Run one cell of BENCHMARK.json on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's system from the seed, warms up the shapes its traffic
uses, drives its traffic for ``--seconds`` (``--trace 1``: then a traced
window of at most 5 s under ``torch.profiler``), checks the answers
against the plain reference, and prints one JSON object as the last line
of standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``). Each number the check compared, with
its limit, ends standard error. Exits non-zero, printing no result, without
a CUDA card, with fewer cards than the cell asks for, or where JAX or the
JAX package was loaded.
"""

import os
import time

_T_ENTRY = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (from /proc, at 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_ENTRY = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache of a run stays in the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ.setdefault("USE_FLAX", "0")


def setup_clock() -> float:
    return _AGE_AT_ENTRY + time.perf_counter() - _T_ENTRY


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cell as cells, modules, spec

    bench = spec.load()
    chips = spec.cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    from frankensearch_tpu_torch.device import resolve_device

    device = resolve_device("cuda:0")
    result, log, lines = cells.run(args.workload, args.seed, args.seconds, bool(args.trace), device,
                                   setup_clock=setup_clock, bench=bench)
    for line in log:
        print(line, file=sys.stderr)
    loaded = modules.forbidden_loaded()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
