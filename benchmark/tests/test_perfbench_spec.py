"""BENCHMARK.json keeps to its required shapes, every name it gives
finds its file, and nothing the benchmark runs may load JAX."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark.harness import modules, spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
HERE = Path(__file__).resolve().parents[1]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.fullmatch(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.fullmatch(n) for n in names)
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (HERE.parent / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"]) and NAME.fullmatch(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_keep_to_their_sources_and_bounds(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        assert spec.metrics_of(bench, "per_layer", w), w
        assert len(spec.metrics_of(bench, "end_to_end", w)) >= 2, w
        assert spec.metrics_of(bench, "per_layer", w), w


def test_every_name_finds_its_file(bench):
    for w in bench["workloads"]:
        mix = spec.mix(w["traffic"])
        assert {"load", "clients", "call", "batch", "k", "pool", "warmup_calls", "keep_every", "sample"} <= set(mix)
        assert callable(spec.plugin("loads", mix["load"]).run_window)
        assert callable(spec.plugin("calls", mix["call"]).bind)
        cfg = spec.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        system = spec.plugin("systems", cfg["system"])
        assert all(callable(getattr(system, f)) for f in ("build", "traced", "judge"))
        assert set(cfg["checks"]) >= {"vec_score_err", "vec_rank_gap"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]


def test_a_name_with_no_file_is_refused():
    with pytest.raises(KeyError):
        spec.plugin("calls", "no_such_call")
    assert spec.plugin("metrics", "qps") is spec.plugin("metrics", "qps")


@pytest.mark.parametrize("names, found", [
    (["frankensearch_tpu_torch", "frankensearch_tpu_torch.ops.topk_scan", "numpy"], []),
    (["jaxtyping", "flaxen", "frankensearch_tpu_extra"], []),
    (["frankensearch_tpu", "numpy"], ["frankensearch_tpu"]),
    (["frankensearch_tpu.index.fsvi"], ["frankensearch_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_compare_top_level_names_whole(names, found):
    assert modules.forbidden_loaded(names) == found


def test_no_benchmark_file_imports_jax():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.partition(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                tops = [node.module.partition(".")[0]]
            else:
                continue
            assert not set(tops) & modules.FORBIDDEN, f"{path}: imports {tops}"
