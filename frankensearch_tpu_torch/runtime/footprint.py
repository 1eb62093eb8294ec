"""Index footprint advisor: dry-run byte census + recommendations.

Parity target: reference docs/fsfs-index-footprint-advisor-contract.md
(`bd-pkl0.8`) — measure vector-index, lexical-index, metadata,
model-cache, and artifact footprints; emit deterministic
compaction/rebuild/retention/feature recommendations with projected
byte savings, explicit risk labels, and exact replay commands. The
advisor NEVER deletes or rewrites anything: every report carries
``automatic_deletion_allowed: false`` by construction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

ADVISOR_VERSION = 1

#: deterministic threshold policy (contract: small / fragmented /
#: oversized index states map to fixed recommendations)
WAL_COMPACT_FRACTION = 0.25  # WAL >= 25% of the fast artifact -> compact
TOMBSTONE_COMPACT_FRACTION = 0.20  # >= 20% dead rows -> compact
F32_OVERSIZED_BYTES = 64 << 20  # f32 slab beyond 64 MiB -> dtype advice
STALE_GENERATION_KEEP = 2  # blue-green contract: current + previous


@dataclass(frozen=True)
class Recommendation:
    domain: str  # vector_index | lexical_index | metadata | model_cache | artifacts
    action: str  # compact | rebuild | retention | feature
    reason: str
    projected_savings_bytes: int
    risk: str  # low | medium | high
    replay_cmd: str

    def to_dict(self) -> dict:
        return {
            "domain": self.domain,
            "action": self.action,
            "reason": self.reason,
            "projected_savings_bytes": self.projected_savings_bytes,
            "risk": self.risk,
            "replay_cmd": self.replay_cmd,
        }


@dataclass
class FootprintReport:
    root: str
    domains: dict[str, int] = field(default_factory=dict)
    recommendations: list[Recommendation] = field(default_factory=list)
    detail: dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "v": ADVISOR_VERSION,
            "automatic_deletion_allowed": False,  # contract invariant
            "root": self.root,
            "domains": dict(self.domains),
            "total_bytes": sum(self.domains.values()),
            "recommendations": [r.to_dict() for r in self.recommendations],
            "detail": dict(self.detail),
        }


def _size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _walk_bytes(root: str) -> Iterator[tuple[str, int]]:
    for dirpath, _, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            yield full, _size(full)


_METADATA_NAMES = {
    "metadata.db", "jobs.db", "control_plane.json", "watch_snapshot.json",
    "watch_members.json", "resume_token.json", ".last_results.json",
}


def measure(root: str) -> FootprintReport:
    """Byte census over the five contract domains. Pure read-only."""
    rep = FootprintReport(root=root)
    domains = {
        "vector_index": 0, "lexical_index": 0, "metadata": 0,
        "model_cache": 0, "artifacts": 0,
    }
    wal_bytes = 0
    quarantine_bytes = 0
    tmp_bytes = 0
    gen_bytes: dict[str, int] = {}
    fast_bytes = 0
    for full, size in _walk_bytes(root):
        rel = os.path.relpath(full, root)
        parts = rel.split(os.sep)
        name = parts[-1]
        if parts[0] == "lexical":
            domains["lexical_index"] += size
            if len(parts) >= 2 and parts[1].startswith("gen-"):
                gen_bytes[parts[1]] = gen_bytes.get(parts[1], 0) + size
        elif parts[0] == "models":
            domains["model_cache"] += size
        elif parts[0] == ".quarantine":
            domains["artifacts"] += size
            quarantine_bytes += size
        elif name.endswith(".tmp"):
            domains["artifacts"] += size
            tmp_bytes += size
        elif name in _METADATA_NAMES:
            domains["metadata"] += size
        elif name.startswith("vector.") or name.endswith((".wal", ".fsum", ".fspar")):
            domains["vector_index"] += size
            if name.endswith(".wal"):
                wal_bytes += size
            if name == "vector.fast.idx":
                fast_bytes = size
        else:
            domains["artifacts"] += size
    rep.domains = domains
    rep.detail = {
        "wal_bytes": wal_bytes,
        "fast_artifact_bytes": fast_bytes,
        "quarantine_bytes": quarantine_bytes,
        "tmp_bytes": tmp_bytes,
        "lexical_generations": sorted(gen_bytes),
    }

    # ---- deterministic recommendation policy --------------------------
    recs: list[Recommendation] = []
    compact_cmd = f"frankensearch-tpu-torch compact --root {root}"
    if fast_bytes and wal_bytes >= WAL_COMPACT_FRACTION * fast_bytes:
        recs.append(Recommendation(
            domain="vector_index", action="compact",
            reason=(f"WAL sidecar is {wal_bytes / max(fast_bytes, 1):.0%} of the "
                    "fast artifact: fold appends/tombstones into the base"),
            projected_savings_bytes=wal_bytes,
            risk="low", replay_cmd=compact_cmd,
        ))
    tombstoned, live = _tombstone_counts(root)
    if live + tombstoned > 0 and tombstoned >= TOMBSTONE_COMPACT_FRACTION * (live + tombstoned):
        frac = tombstoned / (live + tombstoned)
        recs.append(Recommendation(
            domain="vector_index", action="compact",
            reason=f"{frac:.0%} of rows are tombstoned (fragmented index)",
            projected_savings_bytes=int(fast_bytes * frac),
            risk="low", replay_cmd=compact_cmd,
        ))
    dtype = _slab_dtype(root)
    if dtype == "f32" and fast_bytes >= F32_OVERSIZED_BYTES:
        recs.append(Recommendation(
            domain="vector_index", action="feature",
            reason="f32 slab at this size: bf16 halves it with ~8-bit-"
                   "mantissa score tolerance; int8 quarters it (two-pass "
                   "rescore lane)",
            projected_savings_bytes=fast_bytes // 2,
            risk="medium",
            replay_cmd=f"frankensearch-tpu-torch index <corpus> --root {root} "
                       "--slab-dtype bf16",
        ))
    gens = sorted(gen_bytes)
    if len(gens) > STALE_GENERATION_KEEP:
        stale = gens[:-STALE_GENERATION_KEEP]
        recs.append(Recommendation(
            domain="lexical_index", action="retention",
            reason=f"{len(stale)} superseded lexical generation(s) beyond "
                   "the blue-green keep window (current + previous)",
            projected_savings_bytes=sum(gen_bytes[g] for g in stale),
            risk="low",
            replay_cmd=compact_cmd + "  # seal/compact runs generation GC",
        ))
    if quarantine_bytes:
        recs.append(Recommendation(
            domain="artifacts", action="retention",
            reason="quarantined artifacts held for post-incident review",
            projected_savings_bytes=quarantine_bytes,
            risk="medium",
            replay_cmd=f"frankensearch-tpu-torch doctor --root {root} --verify  "
                       "# review before removing .quarantine manually",
        ))
    if tmp_bytes:
        recs.append(Recommendation(
            domain="artifacts", action="retention",
            reason="orphaned .tmp staging files from interrupted writes",
            projected_savings_bytes=tmp_bytes,
            risk="low",
            replay_cmd=f"frankensearch-tpu-torch doctor --root {root} --verify  "
                       "# confirms artifacts intact before cleanup",
        ))
    rep.recommendations = recs
    return rep


def _tombstone_counts(root: str) -> tuple[int, int]:
    """(tombstoned, live) rows in the fast artifact; (0, 0) when absent
    or unreadable — the advisor never raises."""
    try:
        from frankensearch_tpu_torch.index.fsvi import FtviFile
        from frankensearch_tpu_torch.index.two_tier import TwoTierPaths

        f = FtviFile(TwoTierPaths(root).fast, verify_slab=False)
        from frankensearch_tpu_torch.index.fsvi import FLAG_TOMBSTONE

        flags = getattr(f, "flags", None)
        if flags is None:
            return 0, f.record_count
        dead = int(((flags & FLAG_TOMBSTONE) != 0).sum())
        return dead, f.record_count - dead
    except Exception:
        return 0, 0


def _slab_dtype(root: str) -> str:
    try:
        from frankensearch_tpu_torch.index.fsvi import FtviFile
        from frankensearch_tpu_torch.index.two_tier import TwoTierPaths

        return FtviFile(TwoTierPaths(root).fast, verify_slab=False).header.dtype
    except Exception:
        return ""
