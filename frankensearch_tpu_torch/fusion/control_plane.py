"""Calibration preset parsing for ``TwoTierConfig.calibration``.

The part of frankensearch_tpu/fusion/control_plane.py that the port
reaches: ``parse_calibrator``, which ``TwoTierConfig.validate`` calls on a
non-empty ``calibration`` spec. The adaptive control plane itself (its
persisted state, feedback and conformal widening) is not copied.
"""

from __future__ import annotations

from typing import Callable

from frankensearch_tpu_torch.core.errors import InvalidConfig


def parse_calibrator(spec: str) -> Callable[[float], float]:
    """Calibration preset spec -> callable. ``temperature:<t>`` or
    ``platt:<a>,<b>``. Raises InvalidConfig on malformed specs (validated
    at config time so a bad spec fails at open, not mid-query)."""
    from frankensearch_tpu_torch.fusion.calibration import (
        PlattCalibrator,
        TemperatureCalibrator,
    )

    kind, _, args = spec.partition(":")
    kind = kind.strip().lower()
    try:
        if kind == "temperature":
            t = float(args)
            if t <= 0:
                raise ValueError("temperature must be positive")
            return TemperatureCalibrator(temperature=t)
        if kind == "platt":
            a_s, _, b_s = args.partition(",")
            return PlattCalibrator(a=float(a_s), b=float(b_s or 0.0))
    except ValueError as e:
        raise InvalidConfig(f"bad calibration spec {spec!r}: {e}") from e
    raise InvalidConfig(
        f"unknown calibration kind {kind!r} (want temperature:<t> | platt:<a>,<b>)"
    )
