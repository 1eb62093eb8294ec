"""Conformal recall certificates for approximate scan modes.

Parity target: reference crates/frankensearch-index/src/recall_certificate.rs
— distribution-free lower bounds on ANN recall, certifying the minimal
search parameter (the reference calibrates HNSW ``ef``; here the analogs
are the int8 two-pass candidate multiplier and the MRL rescore pool).

Method (split conformal on per-query recall): measure recall@k of the
approximate mode vs the exact scan on calibration queries; the certified
lower bound at confidence 1-delta is the floor((n+1)*delta)-th smallest
calibration recall (a conservative one-sided conformal quantile).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np


@dataclass(frozen=True)
class RecallCertificate:
    parameter_name: str
    parameter_value: float
    k: int
    n_calibration: int
    confidence: float
    certified_recall: float  # lower bound holding w.p. >= confidence
    mean_recall: float

    def to_dict(self) -> dict:
        return {
            "parameter": {self.parameter_name: self.parameter_value},
            "k": self.k,
            "n_calibration": self.n_calibration,
            "confidence": self.confidence,
            "certified_recall": self.certified_recall,
            "mean_recall": self.mean_recall,
        }

    def to_record(self) -> dict:
        """Lossless flat form for manifest persistence."""
        return {
            "parameter_name": self.parameter_name,
            "parameter_value": self.parameter_value,
            "k": self.k,
            "n_calibration": self.n_calibration,
            "confidence": self.confidence,
            "certified_recall": self.certified_recall,
            "mean_recall": self.mean_recall,
        }

    @staticmethod
    def from_record(d: dict) -> "RecallCertificate":
        return RecallCertificate(
            parameter_name=str(d["parameter_name"]),
            parameter_value=float(d["parameter_value"]),
            k=int(d["k"]),
            n_calibration=int(d["n_calibration"]),
            confidence=float(d["confidence"]),
            certified_recall=float(d["certified_recall"]),
            mean_recall=float(d["mean_recall"]),
        )


def per_query_recall(approx_idx: np.ndarray, exact_idx: np.ndarray) -> np.ndarray:
    """(B, k) index arrays -> (B,) recall@k, ignoring -1 padding."""
    out = np.zeros(approx_idx.shape[0], dtype=np.float64)
    for b in range(approx_idx.shape[0]):
        truth = {int(i) for i in exact_idx[b] if i >= 0}
        if not truth:
            out[b] = 1.0
            continue
        got = {int(i) for i in approx_idx[b] if i >= 0}
        out[b] = len(got & truth) / len(truth)
    return out


def certify_recall(
    recalls: Sequence[float],
    *,
    parameter_name: str,
    parameter_value: float,
    k: int,
    confidence: float = 0.95,
) -> RecallCertificate:
    r = np.sort(np.asarray(recalls, dtype=np.float64))
    n = r.size
    if n == 0:
        raise ValueError("need calibration queries")
    delta = 1.0 - confidence
    # one-sided conformal: index floor((n+1)*delta) - 1, clamped
    idx = max(min(math.floor((n + 1) * delta) - 1, n - 1), 0)
    # conservative: with too few samples the bound is 0 coverage-honest
    lower = float(r[idx]) if (n + 1) * delta >= 1.0 else 0.0
    return RecallCertificate(
        parameter_name=parameter_name,
        parameter_value=parameter_value,
        k=k,
        n_calibration=n,
        confidence=confidence,
        certified_recall=lower,
        mean_recall=float(r.mean()),
    )


def calibrate_minimal_parameter(
    run_approx: Callable[[float], np.ndarray],
    exact_idx: np.ndarray,
    parameter_values: Sequence[float],
    *,
    parameter_name: str,
    k: int,
    target_recall: float = 0.95,
    confidence: float = 0.95,
) -> RecallCertificate | None:
    """Smallest parameter whose CERTIFIED recall >= target (the reference's
    certified minimal-ef calibration). run_approx(v) -> (B, k) indices."""
    for v in sorted(parameter_values):
        approx = run_approx(v)
        recalls = per_query_recall(approx, exact_idx)
        cert = certify_recall(
            recalls, parameter_name=parameter_name, parameter_value=v,
            k=k, confidence=confidence,
        )
        if cert.certified_recall >= target_recall:
            return cert
    return None


# -- manifest persistence (VERDICT r4 #6) ------------------------------------
#
# The reference persists conformance/recall certificates in the generation
# manifest (crates/frankensearch-core/src/generation.rs:1-6;
# index/src/recall_certificate.rs), so a capacity index certifies once per
# GENERATION, not once per process. Certificates are identity-bound: the
# stored binding is the fast tier's scan_state_signature (base slab crc32 +
# WAL mutation census + row/live counts + embedder id); any slab or WAL
# change voids the cert and the fail-closed gate demands re-certification.

_CERT_EXTRA_KEY = "recall_certificates"


def persist_certificate(root: str, mode: str, cert: RecallCertificate,
                        binding: dict) -> bool:
    """Merge one mode's certificate into the generation manifest's extra
    section (creating a minimal manifest for manifest-less roots). Returns
    False when the root has no durable identity to bind to."""
    import os
    import time

    from frankensearch_tpu_torch.core.generation import (
        MANIFEST_FILE,
        build_manifest,
        read_manifest,
        write_manifest,
    )
    from frankensearch_tpu_torch.index.durability import artifact_mutation_lock

    if not binding or binding.get("slab_crc32") is None:
        return False
    with artifact_mutation_lock(os.path.join(root, MANIFEST_FILE)):
        if os.path.exists(os.path.join(root, MANIFEST_FILE)):
            manifest = read_manifest(root)
        else:
            manifest = build_manifest(
                root,
                generation_id=f"gen-{int(time.time() * 1000):013d}",
                commit_seq=int(time.time() * 1000),
            )
        certs = dict(manifest.extra.get(_CERT_EXTRA_KEY, {}))
        certs[mode] = {"cert": cert.to_record(), "binding": dict(binding)}
        manifest.extra[_CERT_EXTRA_KEY] = certs
        write_manifest(root, manifest)
    return True


def load_persisted_certificates(root: str, binding: dict | None) -> dict:
    """Certificates from the generation manifest whose stored binding
    matches the CURRENT fast-tier signature — a cert is void if the slab,
    WAL census, row/live counts, or embedder changed (fail-closed: the
    gate then demands a fresh certify_scan_mode)."""
    import os

    from frankensearch_tpu_torch.core.generation import MANIFEST_FILE, read_manifest

    if not binding or binding.get("slab_crc32") is None:
        return {}
    if not os.path.exists(os.path.join(root, MANIFEST_FILE)):
        return {}
    try:
        manifest = read_manifest(root)
    except Exception:
        # an unreadable manifest voids the certs, never the open
        return {}
    out: dict = {}
    for mode, entry in manifest.extra.get(_CERT_EXTRA_KEY, {}).items():
        try:
            if dict(entry.get("binding", {})) == dict(binding):
                out[mode] = RecallCertificate.from_record(entry["cert"])
        except (KeyError, TypeError, ValueError):
            continue
    return out
