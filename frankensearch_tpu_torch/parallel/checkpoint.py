"""Training checkpoint and resume with a fail-closed manifest (PyTorch).

Port of frankensearch_tpu/parallel/checkpoint.py. A checkpoint is the
training state's two flat dicts of tensors (the parameters and the AdamW
state of parallel/train.py) written whole with ``torch.save`` beside a small
JSON manifest that binds the step, the BertConfig, the mesh layout and a
fingerprint of each dict (its names, shapes and dtypes), so a resume fails
closed on config, mesh or structure drift instead of reinterpreting
tensors. The manifest is written last, atomically and fsynced: a crash
before it leaves the previous checkpoint in force.

The manifest's ``step``, ``config`` and ``mesh`` fields are the
reference's; its fingerprints are over the port's state names (the
reference's are over jax key paths), so a manifest written by one package
is refused by the other, never misread. The tensor files are read back
with ``torch.load(weights_only=True)`` (the reference's are orbax
directories).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import Mapping

import torch

from frankensearch_tpu_torch.core.atomic_io import atomic_write_bytes, atomic_write_text
from frankensearch_tpu_torch.core.errors import InvalidConfig
from frankensearch_tpu_torch.rerank.bert import BertConfig

MANIFEST = "train_manifest.json"


def _tree_fingerprint(tree: Mapping[str, torch.Tensor]) -> str:
    """Order-stable structural fingerprint: names + shapes + dtypes."""
    h = hashlib.sha256()
    for name in sorted(tree):
        leaf = tree[name]
        h.update(name.encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(str(leaf.dtype).encode())
    return h.hexdigest()[:32]


def _mesh_layout(mesh) -> dict:
    return {"axes": list(mesh.axis_names), "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}


def _save_tensors(path: str, tree: Mapping[str, torch.Tensor]) -> None:
    buf = io.BytesIO()
    torch.save({n: t.detach().cpu() for n, t in tree.items()}, buf)
    atomic_write_bytes(path, buf.getvalue(), fsync=True)


def save_train_state(
    directory: str,
    params: Mapping[str, torch.Tensor],
    opt_state: Mapping[str, torch.Tensor],
    *,
    step: int,
    cfg: BertConfig,
    mesh=None,
) -> str:
    """Write a training checkpoint; returns its path prefix."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    ckpt_path = os.path.join(directory, f"step_{step:08d}")
    _save_tensors(ckpt_path + ".params.pt", params)
    _save_tensors(ckpt_path + ".opt.pt", opt_state)
    manifest = {
        "step": step,
        "config": dataclasses.asdict(cfg),
        "mesh": _mesh_layout(mesh) if mesh is not None else None,
        "params_fingerprint": _tree_fingerprint(params),
        "opt_fingerprint": _tree_fingerprint(opt_state),
    }
    atomic_write_text(os.path.join(directory, MANIFEST), json.dumps(manifest, indent=1), fsync=True)
    return ckpt_path


def _restore_into(path: str, like: Mapping[str, torch.Tensor]) -> None:
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if set(saved) != set(like):
        raise InvalidConfig(f"checkpoint {os.path.basename(path)} holds other tensors than the target")
    with torch.no_grad():
        for name, target in like.items():
            target.copy_(saved[name])


def restore_train_state(
    directory: str,
    params_like: Mapping[str, torch.Tensor],
    opt_state_like: Mapping[str, torch.Tensor],
    *,
    cfg: BertConfig,
    mesh=None,
):
    """Restore (params, opt_state, step): the saved values are copied into
    the ``*_like`` targets (freshly built state), so they land on the
    targets' devices and shards, and the targets are returned.

    Fails closed: config mismatch, mesh-layout mismatch, or fingerprint
    drift is a typed error, never a silent reinterpretation.
    """
    directory = os.path.abspath(directory)
    mpath = os.path.join(directory, MANIFEST)
    if not os.path.exists(mpath):
        raise InvalidConfig(f"no training manifest under {directory}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest["config"] != dataclasses.asdict(cfg):
        raise InvalidConfig(
            "checkpoint config mismatch: "
            f"saved {manifest['config']} vs requested {dataclasses.asdict(cfg)}"
        )
    if mesh is not None and manifest["mesh"] is not None:
        if manifest["mesh"] != _mesh_layout(mesh):
            raise InvalidConfig(f"mesh layout mismatch: saved {manifest['mesh']} vs {_mesh_layout(mesh)}")
    if manifest["params_fingerprint"] != _tree_fingerprint(params_like):
        raise InvalidConfig("params tree drift vs checkpoint fingerprint")
    if manifest["opt_fingerprint"] != _tree_fingerprint(opt_state_like):
        raise InvalidConfig("optimizer state drift vs checkpoint fingerprint")
    step = manifest["step"]
    ckpt_path = os.path.join(directory, f"step_{step:08d}")
    _restore_into(ckpt_path + ".params.pt", params_like)
    _restore_into(ckpt_path + ".opt.pt", opt_state_like)
    return params_like, opt_state_like, step


def latest_step(directory: str) -> int | None:
    mpath = os.path.join(directory, MANIFEST)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)["step"]
