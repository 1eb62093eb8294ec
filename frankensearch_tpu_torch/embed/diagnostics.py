"""Model-cache diagnostics: observable quality-tier state, no raw paths.

Parity target: reference docs/fsfs-model-cache-diagnostics.md
(`bd-pkl0.11`) — report whether the model cache is warm, cold, missing,
or unknown WITHOUT downloading anything or exposing host-specific
paths. Contract rules honored structurally: ``raw_paths_present`` is
always false (directories are reported by basename + digest),
``network_required`` is always false (pure local probe), model identity
carries a ``sha256:*`` digest, and every degraded state attaches advice
with a stable ``model_cache.*`` reason code naming the operator knobs
(the `download` command, ``FRANKENSEARCH_ROOT``/``--root`` models/
staging, ``--fast-only``).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field


@dataclass
class ModelCacheReport:
    #: warm = at least one model dir verifies against its manifest;
    #: cold = model dirs exist but none verify (or lack manifests);
    #: missing = no model dirs at all (hash degradation serves);
    #: unknown = the probe itself failed
    state: str = "missing"
    models: list[dict] = field(default_factory=list)
    advice: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "v": 1,
            "state": self.state,
            "raw_paths_present": False,  # contract invariant
            "network_required": False,  # contract invariant
            "models": list(self.models),
            "advice": list(self.advice),
        }


def _dir_digest(model_dir: str) -> str:
    """Identity digest over (name, size) pairs — cheap, deterministic,
    and path-free."""
    h = hashlib.sha256()
    try:
        for name in sorted(os.listdir(model_dir)):
            full = os.path.join(model_dir, name)
            if os.path.isfile(full):
                h.update(f"{name}:{os.path.getsize(full)};".encode())
    except OSError:
        pass
    return "sha256:" + h.hexdigest()[:16]


def model_cache_report(root: str) -> ModelCacheReport:
    rep = ModelCacheReport()
    models_root = os.path.join(root, "models")
    try:
        if not os.path.isdir(models_root):
            rep.state = "missing"
            rep.advice.append({
                "code": "model_cache.missing",
                "advice": "no model cache: the fast tier degrades to the "
                          "non-semantic hash embedder. Acquire a model with "
                          "`frankensearch-tpu download` (staged verify-then-"
                          "promote) into <root>/models/<name>/, or run with "
                          "--fast-only if hash retrieval is acceptable.",
            })
            return rep
        any_verified = False
        any_present = False
        from frankensearch_tpu_torch.embed.model_manifest import verify_model_dir

        for name in sorted(os.listdir(models_root)):
            d = os.path.join(models_root, name)
            if not os.path.isdir(d):
                continue
            any_present = True
            ver = verify_model_dir(d)
            entry = {
                "name": name,  # basename only: raw_paths_present=false
                "identity": _dir_digest(d),
                "verified": bool(ver.ok),
            }
            if not ver.ok:
                entry["missing"] = list(getattr(ver, "missing", ()))[:5]
                entry["corrupted"] = list(getattr(ver, "corrupted", ()))[:5]
                rep.advice.append({
                    "code": "model_cache.unverified",
                    "advice": f"model '{name}' fails manifest verification: "
                              "re-acquire with `frankensearch-tpu download` "
                              "(the staged copy is verified before promote), "
                              "or remove the directory to degrade cleanly.",
                })
            any_verified = any_verified or ver.ok
            rep.models.append(entry)
        rep.state = "warm" if any_verified else ("cold" if any_present else "missing")
        if rep.state == "missing":
            rep.advice.append({
                "code": "model_cache.missing",
                "advice": "models/ exists but holds no model directories; "
                          "`frankensearch-tpu download` stages + verifies one.",
            })
        elif rep.state == "cold":
            rep.advice.append({
                "code": "model_cache.cold",
                "advice": "model directories present but none verify: the "
                          "quality tier will not be admitted. Re-acquire, or "
                          "serve with --fast-only until resolved.",
            })
    except Exception as e:  # the probe itself must never raise
        rep.state = "unknown"
        rep.advice.append({
            "code": "model_cache.probe_failed",
            "advice": f"cache probe failed ({type(e).__name__}); check "
                      "directory permissions under <root>/models/",
        })
    return rep
