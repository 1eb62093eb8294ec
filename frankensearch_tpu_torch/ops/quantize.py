"""Scalar quantization for the vector slab (port of frankensearch_tpu/ops/quantize.py).

Parity target: reference crates/frankensearch-index/src/quantization.rs —
``ScalarQuantizer`` with per-dimension calibration, plus the packed 4-bit
variant. The calibration is host numpy, copied because the reference module
imports jax; the on-device nibble unpack is a torch function.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Int8Quantization:
    """Per-dimension symmetric int8 quantization of a row slab."""

    values: np.ndarray  # (N, D) int8
    scale: np.ndarray  # (D,) f32: dequant x ~= values * scale

    @property
    def dim(self) -> int:
        return self.values.shape[1]


def calibrate_int8(slab: np.ndarray) -> Int8Quantization:
    """Per-dimension symmetric absmax calibration (zero-point 0)."""
    slab = np.asarray(slab, dtype=np.float32)
    absmax = np.maximum(np.abs(slab).max(axis=0), 1e-8)
    scale = (absmax / 127.0).astype(np.float32)
    values = np.clip(np.round(slab / scale), -127, 127).astype(np.int8)
    return Int8Quantization(values=values, scale=scale)


def dequantize_int8(q: Int8Quantization) -> np.ndarray:
    return q.values.astype(np.float32) * q.scale


@dataclass(frozen=True)
class Int4Quantization:
    """Packed 4-bit (two values per byte, low nibble = even dim)."""

    packed: np.ndarray  # (N, D//2) uint8
    scale: np.ndarray  # (D,) f32
    dim: int


def calibrate_int4(slab: np.ndarray) -> Int4Quantization:
    slab = np.asarray(slab, dtype=np.float32)
    n, d = slab.shape
    if d % 2 != 0:
        raise ValueError("int4 packing requires even dimension")
    absmax = np.maximum(np.abs(slab).max(axis=0), 1e-8)
    scale = (absmax / 7.0).astype(np.float32)
    q = np.clip(np.round(slab / scale), -7, 7).astype(np.int8)  # [-7, 7]
    biased = (q + 8).astype(np.uint8)  # [1, 15], 4 bits
    packed = (biased[:, 0::2] | (biased[:, 1::2] << 4)).astype(np.uint8)
    return Int4Quantization(packed=packed, scale=scale, dim=d)


def unpack_int4(q: Int4Quantization) -> np.ndarray:
    low = (q.packed & 0x0F).astype(np.int16) - 8
    high = ((q.packed >> 4) & 0x0F).astype(np.int16) - 8
    out = np.empty((q.packed.shape[0], q.dim), dtype=np.int16)
    out[:, 0::2] = low
    out[:, 1::2] = high
    return out.astype(np.float32) * q.scale


def unpack_int4_device(packed: torch.Tensor) -> torch.Tensor:
    """Device-side nibble unpack: (N, D//2) uint8 -> (N, D) int8 in [-8, 7]
    (even dims = low nibble)."""
    low = (packed & 0x0F).to(torch.int8) - 8
    high = ((packed >> 4) & 0x0F).to(torch.int8) - 8
    return torch.stack([low, high], dim=-1).reshape(packed.shape[0], -1)


def quantization_error_bound(scale: np.ndarray) -> float:
    """Worst-case per-dot absolute error of int8 quantization
    (parity: quantization.rs error-bound doc): 0.5 * sum(scale) for a
    unit-norm query."""
    return float(0.5 * np.sum(np.asarray(scale)))
