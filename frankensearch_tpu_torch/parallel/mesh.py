"""Mesh construction (PyTorch port of frankensearch_tpu/parallel/mesh.py).

A :class:`Mesh` is a small value type: an array of ``torch.device``s (one
per shard, the same device may repeat) with the reference's axis names and
shape. The sharded ops take the devices along one axis
(:meth:`Mesh.shard_devices`); the first is the lead device, where the
per-shard heaps are merged and the results live.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Devices laid out on named axes (``jax.sharding.Mesh``'s shape)."""

    def __init__(self, devices, axis_names: tuple[str, ...]) -> None:
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(axis_names):
            raise ValueError(f"devices of shape {src.shape} for axes {axis_names}")
        self.devices = np.empty(src.shape, dtype=object)
        for at, dev in np.ndenumerate(src):
            self.devices[at] = torch.device(dev)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def shard_devices(self, axis: str = "d") -> tuple[torch.device, ...]:
        """The devices along ``axis`` (index 0 on every other axis): one per
        shard of a tensor sharded over ``axis`` and replicated elsewhere."""
        ax = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[ax] = slice(None)
        return tuple(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _visible(n: int | None, device) -> list[torch.device]:
    """The first ``n`` visible devices of ``device``'s type: cards starting
    at ``device``'s index (at most every card; ``None`` = every card), or
    ``n`` shards of the CPU (``None`` = one)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA mesh was requested but no card is visible")
    first = dev.index if dev.index is not None else torch.cuda.current_device()
    n = count if n is None else min(n, count)
    return [torch.device("cuda", (first + i) % count) for i in range(n)]


def make_mesh(
    n_devices: int | None = None,
    axes: tuple[str, ...] = ("d",),
    shape: tuple[int, ...] | None = None,
    *,
    device="cuda",
) -> Mesh:
    """A mesh over the first ``n_devices`` devices, as the reference takes
    ``jax.devices()[:n]``: on CUDA the visible cards (so ``n`` larger than
    the card count gives one shard per card), on the CPU ``n`` shards of
    the CPU. Default: a 1-D mesh over the document axis ("d"); for more
    axes pass them with an explicit ``shape``."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    devices = _visible(n_devices, device)
    if shape is None:
        shape = (len(devices),) if len(axes) == 1 else _default_shape(len(devices), len(axes))
    return Mesh(np.array(devices, dtype=object).reshape(shape), axes)


def _default_shape(n: int, ndim: int) -> tuple[int, ...]:
    if ndim == 1:
        return (n,)
    if ndim == 2:
        # a tp axis of 2 when it divides; else everything on axis 0
        tp = 2 if n % 2 == 0 and n >= 2 else 1
        return (n // tp, tp)
    raise ValueError(f"unsupported mesh ndim {ndim}")


def make_hybrid_mesh(
    slice_axes: tuple[str, ...] = ("d",),
    dcn_axis: str = "slice",
    *,
    n_devices: int | None = None,
    device="cuda",
) -> Mesh:
    """The reference's multi-slice mesh in its single-slice shape
    ``(1,) + inner``: CUDA has no slice index, so every device is in slice
    0 and the inner axes span them."""
    inner = make_mesh(n_devices, axes=slice_axes, device=device)
    return Mesh(inner.devices.reshape((1,) + inner.devices.shape), (dcn_axis,) + slice_axes)
