"""Readings for a hybrid cell's lexical limits: runs of one cell on several
seeds in one process, as the program serves it or with the bf16 BM25
control in its place, printing each run's check numbers as one JSON line.

    python3 benchmark/calibrate_lexical.py --workload <name> --seeds 1,2,3 --seconds 3 --control none|bm25-bf16

``none`` is the program as the configuration states it (the lower
readings); ``bm25-bf16`` serves from a lexical arm whose idf and tf-side
factors are rounded to bf16 (the upper readings; ``systems/hybrid.py``,
``bf16_factors``). The benchmark's own runs never run a control.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: every answer of the short window kept for the check, and a short warm-up
#: (nothing here is timed)
MIX = {"keep_every": 1, "warmup_calls": 2}
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("none", "bm25-bf16"), default="none")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells, spec

    if not torch.cuda.is_available():
        print("calibrate_lexical.py reads the card: no CUDA device here", file=sys.stderr)
        return 2
    from frankensearch_tpu_torch.device import resolve_device

    device = resolve_device("cuda:0")
    bench = spec.load()
    cfg = spec.config(bench, spec.cell(bench, args.workload)["config"])
    if args.control != "none":
        cfg = {**cfg, "control": args.control}
    t_start = time.perf_counter()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, log, lines = cells.run(args.workload, seed, args.seconds, False, device,
                                       setup_clock=lambda: time.perf_counter() - t_start, bench=bench,
                                       config=cfg, mix_override=MIX)
        for line in log + lines:
            print(f"[{seed}] {line}", file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"], "run_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
