"""Off-policy evaluation of ranking changes: IPS and Doubly Robust.

Parity target: reference crates/frankensearch-fusion/src/ope.rs (:1-8) —
estimate how a candidate ranking policy would have performed from logged
interactions of the serving policy, without an online experiment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class LoggedInteraction:
    """One logged impression: the doc shown, the propensity (probability
    the logging policy showed it at that slot), and the observed reward
    (click/dwell-derived, in [0, 1])."""

    query_id: str
    doc_id: str
    propensity: float
    reward: float


@dataclass(frozen=True)
class OpeEstimate:
    value: float
    std_error: float
    n: int
    clipped_fraction: float = 0.0


def ips_estimate(
    logs: Sequence[LoggedInteraction],
    target_propensity: "callable",
    *,
    clip: float = 10.0,
) -> OpeEstimate:
    """Inverse propensity scoring with weight clipping.

    target_propensity(query_id, doc_id) -> probability the NEW policy
    would show this doc at the logged slot.
    """
    if not logs:
        return OpeEstimate(0.0, 0.0, 0)
    vals = []
    clipped = 0
    for log in logs:
        p_log = max(log.propensity, 1e-6)
        w = target_propensity(log.query_id, log.doc_id) / p_log
        if w > clip:
            w = clip
            clipped += 1
        vals.append(w * log.reward)
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / max(n - 1, 1)
    return OpeEstimate(mean, (var / n) ** 0.5, n, clipped / n)


def doubly_robust_estimate(
    logs: Sequence[LoggedInteraction],
    target_propensity: "callable",
    reward_model: "callable",
    *,
    clip: float = 10.0,
) -> OpeEstimate:
    """DR = model estimate + IPS correction of the model's residual.
    reward_model(query_id, doc_id) -> predicted reward in [0, 1]."""
    if not logs:
        return OpeEstimate(0.0, 0.0, 0)
    vals = []
    clipped = 0
    for log in logs:
        p_log = max(log.propensity, 1e-6)
        w = target_propensity(log.query_id, log.doc_id) / p_log
        if w > clip:
            w = clip
            clipped += 1
        r_hat = reward_model(log.query_id, log.doc_id)
        vals.append(r_hat + w * (log.reward - r_hat))
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / max(n - 1, 1)
    return OpeEstimate(mean, (var / n) ** 0.5, n, clipped / n)
