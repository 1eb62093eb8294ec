"""Tiny cells for the benchmark's CPU tests: the configurations of
BENCHMARK.json cut to a few thousand docs and words, every width kept."""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

SEED = 2**31 + 977  # past 32 signed bits, as large seeds are


def tiny_config(bench: dict, name: str, docs: int = 6000) -> dict:
    cfg = copy.deepcopy(spec.config(bench, name))
    cfg["docs"] = docs
    cfg["embedder"]["rows"] = 4000
    cfg["queries"]["vocab"] = min(cfg["queries"]["vocab"], 4000)
    return cfg


@pytest.fixture(scope="session")
def bench():
    return spec.load()


@pytest.fixture
def run_tiny(bench):
    """Run a cell at a tiny size on the CPU: (result, log, check lines)."""
    import torch

    from benchmark.harness import cell

    def go(workload: str, *, seed: int = SEED, seconds: float = 0.4, traced: bool = False,
           config=None, system_hook=None):
        cfg = config if config is not None else tiny_config(bench, spec.cell(bench, workload)["config"])
        t0 = time.perf_counter()
        return cell.run(workload, seed, seconds, traced, torch.device("cpu"),
                        setup_clock=lambda: time.perf_counter() - t0, bench=bench, config=cfg,
                        system_hook=system_hook)

    return go


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
