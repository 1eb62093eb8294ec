"""Adaptive control plane: config -> constructed, persistent controls.

Closes VERDICT r2 missing #4 / task 5: `fusion/adaptive.py` (learned
rrf-k/blend), `fusion/conformal.py` (required-k coverage) and
`fusion/calibration.py` (score calibration presets) were tested library
code with no construction path from the product. This module is that
path — `TwoTierConfig.adaptive_fusion / conformal_alpha / calibration`
build the components here, `open_hybrid` attaches them to the searcher,
and the CLI `feedback` command records outcomes through
:meth:`ControlPlane.record`, persisting state to
``<root>/control_plane.json`` so learning survives process restarts.

Parity target: the reference's builder-style options
crates/frankensearch-fusion/src/searcher.rs:312-868
(`with_adaptive_fusion`, `with_conformal`, `with_calibration`,
`with_feedback`).

Concurrency contract: ``save()`` is atomic (tmp + fsync + rename), so
the state file is never torn — but concurrent recorder PROCESSES are
last-writer-wins: each loads state at open and persists its own view
per event, so parallel `feedback` CLI calls can drop each other's
events (bounded regression of the learning state, never corruption;
single-process recording, incl. serve, is lossless because every event
saves). Matches the reference, whose feedback state is in-process only.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable

from frankensearch_tpu_torch.core.errors import InvalidConfig

STATE_FILE = "control_plane.json"


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


@dataclass
class ControlPlane:
    """The constructed adaptive controls + their persistence root."""

    adaptive: "object | None" = None  # fusion.adaptive.AdaptiveFusion
    conformal: "object | None" = None  # fusion.conformal.ConformalK
    feedback: "object | None" = None  # fusion.feedback.FeedbackBooster
    calibrator: Callable[[float], float] | None = None
    state_path: str | None = None

    def record(
        self,
        query: str,
        doc_id: str | None = None,
        *,
        success: bool = True,
        rank: int | None = None,
        requested_k: int | None = None,
        dwell_s: float | None = None,
    ) -> None:
        """One feedback event: the user clicked ``doc_id`` at ``rank``
        (success) or abandoned the result list (not success). Updates all
        attached controls and persists."""
        from frankensearch_tpu_torch.core.query_class import QueryClass

        qclass = QueryClass.classify(query)
        if self.adaptive is not None:
            self.adaptive.update(qclass, success)
        if self.feedback is not None and doc_id and success:
            self.feedback.record_click(doc_id)
            if dwell_s:
                self.feedback.record_dwell(doc_id, dwell_s)
        if self.conformal is not None:
            if rank is not None and success:
                self.conformal.add_rank(rank)
            if requested_k is not None:
                covered = success and rank is not None and rank <= requested_k
                self.conformal.observe(covered)
        self.save()

    # -- persistence -----------------------------------------------------

    def save(self) -> None:
        if not self.state_path:
            return
        state: dict = {"version": 1}
        if self.adaptive is not None:
            state["adaptive"] = self.adaptive.to_state()
        if self.conformal is not None:
            state["conformal"] = self.conformal.to_state()
        if self.feedback is not None:
            state["feedback"] = self.feedback.to_state()
        d = os.path.dirname(self.state_path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".control_plane.", suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def build_control_plane(config, root: str | None = None) -> ControlPlane | None:
    """Construct the control plane demanded by ``config``, loading any
    persisted state under ``root``. Returns None when every control is
    off (the searcher then carries zero overhead)."""
    wants_adaptive = bool(getattr(config, "adaptive_fusion", False))
    alpha = getattr(config, "conformal_alpha", None)
    cal_spec = getattr(config, "calibration", "") or ""
    if not (wants_adaptive or alpha is not None or cal_spec):
        return None

    state: dict = {}
    state_path = None
    if root:
        state_path = os.path.join(root, STATE_FILE)
        if os.path.exists(state_path):
            try:
                with open(state_path, encoding="utf-8") as f:
                    state = json.load(f)
            except (OSError, json.JSONDecodeError):
                state = {}  # corrupt state restarts learning, never blocks open

    adaptive = conformal = feedback = None
    if wants_adaptive:
        from frankensearch_tpu_torch.fusion.adaptive import AdaptiveFusion
        from frankensearch_tpu_torch.fusion.feedback import FeedbackBooster

        # typed/shape corruption inside a well-formed JSON must ALSO
        # restart learning, never block open (found by state-file fuzz:
        # {"adaptive": "garbage"} crashed open_hybrid before r3)
        adaptive = None
        if "adaptive" in state:
            try:
                adaptive = AdaptiveFusion.from_state(state["adaptive"])
            except Exception:
                adaptive = None
        if adaptive is None:
            adaptive = AdaptiveFusion(seed=getattr(config, "adaptive_seed", 0))
        feedback = None
        if "feedback" in state:
            try:
                feedback = FeedbackBooster.from_state(state["feedback"])
            except Exception:
                feedback = None
        if feedback is None:
            feedback = FeedbackBooster()
    if alpha is not None:
        from frankensearch_tpu_torch.fusion.conformal import ConformalK

        conformal = None
        if "conformal" in state:
            try:
                if abs(float(state["conformal"].get("alpha", alpha)) - alpha) < 1e-9:
                    conformal = ConformalK.from_state(state["conformal"])
            except Exception:
                conformal = None
        if conformal is None:
            conformal = ConformalK(alpha=alpha)
    calibrator = parse_calibrator(cal_spec) if cal_spec else None
    return ControlPlane(
        adaptive=adaptive,
        conformal=conformal,
        feedback=feedback,
        calibrator=calibrator,
        state_path=state_path,
    )
