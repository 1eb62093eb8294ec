"""``BENCHMARK.json`` and the files it names.

Every part of a cell is a file found by its name, so a later cell, metric
or kind of traffic comes with files of its own and edits none of these:

- a configuration is the file its ``BENCHMARK.json`` entry names; its
  ``system`` key names ``systems/<system>.py``, which builds the system
  under test and judges its answers;
- a traffic mix is ``mixes/<traffic>.json``; its ``load`` key names
  ``loads/<load>.py``, which drives the window, and its ``call`` key
  names ``calls/<call>.py``, which sends one request;
- a metric, end to end or per layer, is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
_LOADED: dict = {}


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    with open(HERE / "mixes" / f"{name}.json") as f:
        return json.load(f)


def metrics_of(spec: dict, section: str, cell_name: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` list, and those whose list
    names it."""
    return [m for m in spec[section] if "workloads" not in m or cell_name in m["workloads"]]


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (``systems``, ``loads``, ``calls``,
    ``metrics``), loaded from its file once."""
    key = (kind, name)
    if key not in _LOADED:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} file {path.name!r} in benchmark/{kind}")
        mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(mod_spec)
        sys.modules[mod_spec.name] = module  # dataclasses look their module up there
        mod_spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return plugin("metrics", name).read
