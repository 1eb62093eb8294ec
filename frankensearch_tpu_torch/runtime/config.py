"""Layered product configuration with per-key source attribution.

Parity target: reference crates/frankensearch-fsfs/src/config.rs —
5-level precedence (CLI flags > project file > user file > env >
defaults), per-key source attribution, typed ConfigWarnings, and schema
validation. Files are JSON (``.frankensearch.json`` in the project,
``~/.config/frankensearch-tpu/config.json`` for the user).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any

from frankensearch_tpu_torch.core.config import TwoTierConfig, _parse_env_value

PROJECT_FILE = ".frankensearch.json"
USER_FILE = os.path.join("frankensearch-tpu", "config.json")

SOURCE_ORDER = ("default", "env", "user_file", "project_file", "cli")


@dataclass(frozen=True)
class ConfigWarning:
    key: str
    source: str
    message: str


@dataclass
class LayeredConfig:
    config: TwoTierConfig
    #: key -> winning source name
    sources: dict[str, str] = field(default_factory=dict)
    warnings: list[ConfigWarning] = field(default_factory=list)
    #: extra product keys (root, corpus globs, ...) not in TwoTierConfig
    product: dict[str, Any] = field(default_factory=dict)

    def attribution(self) -> dict[str, str]:
        return dict(self.sources)


def _load_json_layer(path: str, source: str, warnings: list[ConfigWarning]) -> dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            warnings.append(ConfigWarning("*", source, f"{path}: not a JSON object"))
            return {}
        return data
    except (json.JSONDecodeError, OSError) as e:
        warnings.append(ConfigWarning("*", source, f"{path}: {e}"))
        return {}


def load_layered_config(
    cli_overrides: dict[str, Any] | None = None,
    *,
    project_dir: str = ".",
    user_config_dir: str | None = None,
) -> LayeredConfig:
    """Resolve configuration across all five layers."""
    warnings: list[ConfigWarning] = []
    known = {f.name: f for f in fields(TwoTierConfig)}
    defaults = TwoTierConfig()

    layers: list[tuple[str, dict[str, Any]]] = [("default", defaults.to_dict())]

    env_layer: dict[str, Any] = {}
    for name in known:
        raw = os.environ.get("FRANKENSEARCH_" + name.upper())
        if raw is not None:
            try:
                env_layer[name] = _parse_env_value(name, raw, getattr(defaults, name))
            except Exception as e:
                warnings.append(ConfigWarning(name, "env", str(e)))
    layers.append(("env", env_layer))

    user_dir = user_config_dir or os.path.join(
        os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    )
    layers.append(("user_file", _load_json_layer(os.path.join(user_dir, USER_FILE), "user_file", warnings)))
    layers.append(
        ("project_file", _load_json_layer(os.path.join(project_dir, PROJECT_FILE), "project_file", warnings))
    )
    layers.append(("cli", dict(cli_overrides or {})))

    merged: dict[str, Any] = {}
    sources: dict[str, str] = {}
    product: dict[str, Any] = {}
    for source, layer in layers:
        for key, value in layer.items():
            if value is None and source != "default":
                continue
            if key in known:
                merged[key] = value
                sources[key] = source
            else:
                if source == "default":
                    continue
                product[key] = value
                sources[key] = source
                if source in ("user_file", "project_file"):
                    warnings.append(
                        ConfigWarning(key, source, f"unknown config key {key!r} (kept as product key)")
                    )

    # coerce enum-ish strings back through the env parser
    coerced = {}
    for key, value in merged.items():
        default_val = getattr(defaults, key)
        if isinstance(value, str) and not isinstance(default_val, str):
            try:
                value = _parse_env_value(key, value, default_val)
            except Exception as e:
                warnings.append(ConfigWarning(key, sources.get(key, "?"), str(e)))
                value = default_val
        coerced[key] = value

    try:
        cfg = TwoTierConfig(**coerced).validate()
    except Exception as e:
        warnings.append(ConfigWarning("*", "merge", f"validation failed: {e}; using defaults"))
        cfg = TwoTierConfig()
    return LayeredConfig(config=cfg, sources=sources, warnings=warnings, product=product)
