"""Bayesian online adaptation of RRF-K and the blend factor.

Parity target: reference crates/frankensearch-fusion/src/adaptive.rs
(:1-8) — learn per-query-class fusion parameters from implicit feedback
(click = the refined/fused ranking worked; skip = it didn't) with
Thompson-sampling over a small discrete arm set.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from frankensearch_tpu_torch.core.query_class import QueryClass

_RRF_K_ARMS = (20, 40, 60, 90)
_BLEND_ARMS = (0.5, 0.6, 0.7, 0.8)


@dataclass
class _Beta:
    alpha: float = 1.0
    beta: float = 1.0

    def sample(self, rng: random.Random) -> float:
        return rng.betavariate(self.alpha, self.beta)

    def update(self, success: bool) -> None:
        if success:
            self.alpha += 1.0
        else:
            self.beta += 1.0


@dataclass
class AdaptiveFusion:
    seed: int = 0
    _rng: random.Random = field(init=False)
    _k_arms: dict[str, list[_Beta]] = field(default_factory=dict)
    _blend_arms: dict[str, list[_Beta]] = field(default_factory=dict)
    _last_k: dict[str, int] = field(default_factory=dict)
    _last_blend: dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def _arms(self, store: dict, qclass: QueryClass, n: int) -> list[_Beta]:
        return store.setdefault(qclass.value, [_Beta() for _ in range(n)])

    def choose_rrf_k(self, qclass: QueryClass) -> int:
        arms = self._arms(self._k_arms, qclass, len(_RRF_K_ARMS))
        idx = max(range(len(arms)), key=lambda i: arms[i].sample(self._rng))
        self._last_k[qclass.value] = idx
        return _RRF_K_ARMS[idx]

    def choose_blend(self, qclass: QueryClass) -> float:
        arms = self._arms(self._blend_arms, qclass, len(_BLEND_ARMS))
        idx = max(range(len(arms)), key=lambda i: arms[i].sample(self._rng))
        self._last_blend[qclass.value] = idx
        return _BLEND_ARMS[idx]

    def update(self, qclass: QueryClass, success: bool) -> None:
        ki = self._last_k.get(qclass.value)
        if ki is not None:
            self._arms(self._k_arms, qclass, len(_RRF_K_ARMS))[ki].update(success)
        bi = self._last_blend.get(qclass.value)
        if bi is not None:
            self._arms(self._blend_arms, qclass, len(_BLEND_ARMS))[bi].update(success)

    def expected_best_k(self, qclass: QueryClass) -> int:
        arms = self._arms(self._k_arms, qclass, len(_RRF_K_ARMS))
        idx = max(range(len(arms)), key=lambda i: arms[i].alpha / (arms[i].alpha + arms[i].beta))
        return _RRF_K_ARMS[idx]

    # -- persistence (CLI feedback must survive process restarts) --------

    def to_state(self) -> dict:
        def dump(store: dict[str, list[_Beta]]) -> dict:
            return {
                cls: [[a.alpha, a.beta] for a in arms]
                for cls, arms in store.items()
            }

        return {
            "seed": self.seed,
            "k_arms": dump(self._k_arms),
            "blend_arms": dump(self._blend_arms),
            # last-chosen arm per class: feedback for a query served by a
            # PREVIOUS process (CLI search -> CLI feedback) must credit
            # the arm that actually produced that ranking
            "last_k": dict(self._last_k),
            "last_blend": dict(self._last_blend),
        }

    @classmethod
    def from_state(cls, state: dict) -> "AdaptiveFusion":
        self = cls(seed=int(state.get("seed", 0)))

        def load(raw: dict) -> dict[str, list[_Beta]]:
            return {
                c: [_Beta(alpha=float(a), beta=float(b)) for a, b in arms]
                for c, arms in raw.items()
            }

        self._k_arms = load(state.get("k_arms", {}))
        self._blend_arms = load(state.get("blend_arms", {}))
        self._last_k = {c: int(i) for c, i in state.get("last_k", {}).items()}
        self._last_blend = {
            c: int(i) for c, i in state.get("last_blend", {}).items()
        }
        return self
