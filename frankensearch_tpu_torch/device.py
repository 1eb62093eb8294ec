"""Device selection for the PyTorch port.

A caller names the device explicitly and gets exactly that device: asking
for CUDA on a machine without a usable card raises instead of quietly
running on the CPU. Resolving a device also pins float32 matrix products
to full float32 (TF32 off), because the reference computes in f32 at
HIGHEST precision wherever it asks for f32.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> :class:`torch.device`
    (``"cuda"`` resolves to the current card's index)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (expected cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
