"""Quarantine->rebuild: regenerate a vector tier from WAL + storage.

The last rung of the durability ladder (reference analog:
crates/frankensearch-core/src/repair.rs RepairOrchestrator driving
repair actions, and crates/frankensearch-durability decode-repair).
When an artifact is corrupt beyond parity-stripe repair
(index/durability.py), this rebuilds a servable fast tier from what the
system still holds:

- the WAL sidecar carries FULL vectors for every appended doc — those
  are recovered verbatim;
- storage (metadata.db) knows the full doc census, so every doc whose
  vector existed only in the lost slab is reported and (when a job
  queue exists) enqueued as a ``reingest`` job — the truthful next
  action (core/recovery_plan.py philosophy): storage keeps previews,
  not full text, so silent re-embedding would be a lie.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from frankensearch_tpu_torch.index.fsvi import EmbeddingIdentity, write_ftvi
from frankensearch_tpu_torch.index.wal import WriteAheadLog


@dataclass
class RebuildReport:
    rebuilt: bool
    docs_recovered: int = 0
    #: docs known to storage whose vectors were lost with the slab
    docs_lost: list[str] = field(default_factory=list)
    reingest_jobs_enqueued: int = 0
    detail: str = ""


def _salvage_identity(path: str, dim: int) -> EmbeddingIdentity:
    """Best effort: the FTVI header has its own CRC, so it usually
    survives slab corruption/truncation — parse ONLY the header bytes
    (FtviFile would validate the slab and refuse). Falls back to an
    unknown identity at the WAL's dim, which keeps admission fail-closed
    downstream."""
    import struct
    import zlib

    from frankensearch_tpu_torch.index.fsvi import MAGIC, FtviHeader

    quarantined = os.path.join(os.path.dirname(path), ".quarantine", os.path.basename(path))
    for candidate in (path, quarantined):
        try:
            with open(candidate, "rb") as f:
                if f.read(8) != MAGIC:
                    continue
                json_len, json_crc = struct.unpack("<II", f.read(8))
                header_json = f.read(json_len)
                if zlib.crc32(header_json) != json_crc:
                    continue
                return FtviHeader.from_json(header_json).identity
        except Exception:
            continue
    return EmbeddingIdentity(
        embedder_id="unknown-recovered", embedder_revision="", dim=dim,
        is_semantic=False,
    )


def rebuild_fast_tier_from_wal(root: str, artifact: str | None = None) -> RebuildReport:
    """Rebuild ``vector.fast.idx`` (or ``artifact``) from its WAL sidecar.

    The corrupt artifact must already be quarantined or will be
    overwritten; callers go through
    ``ProtectedArtifactStore.open_verified(rebuild=...)`` which
    quarantines first.
    """
    from frankensearch_tpu_torch.index.durability import protect_artifact
    from frankensearch_tpu_torch.index.two_tier import TwoTierPaths

    path = artifact or TwoTierPaths(root).fast
    wal_path = path + ".wal"
    wal = WriteAheadLog(wal_path)
    if not wal.exists():
        return RebuildReport(rebuilt=False, detail="no WAL sidecar to rebuild from")
    state = wal.replay()
    if not state.live:
        return RebuildReport(rebuilt=False, detail="WAL holds no live vectors")

    doc_ids = sorted(state.live)
    vectors = np.stack([state.live[d] for d in doc_ids]).astype(np.float32)
    identity = _salvage_identity(path, dim=vectors.shape[1])
    write_ftvi(path, vectors, doc_ids, identity, dtype="f32")
    protect_artifact(path)
    from frankensearch_tpu_torch.core.generation import refresh_manifest

    refresh_manifest(root)  # census changed under the rebuild
    from frankensearch_tpu_torch.utils.tracing import get_logger

    get_logger("rebuild").warning(
        "fast tier rebuilt from WAL: %d live vector(s) into %s",
        len(doc_ids), path,
        extra={"fs_extra": {"artifact": path, "live": len(doc_ids)}},
    )
    # the artifact now owns these vectors; fold EXACTLY the replayed
    # prefix away (a writer may still be appending during recovery —
    # their post-snapshot batches must survive in the tail)
    wal.truncate(consumed=state.bytes_consumed)

    report = RebuildReport(rebuilt=True, docs_recovered=len(doc_ids),
                           detail="rebuilt from WAL")
    meta_db = os.path.join(root, "metadata.db")
    if os.path.exists(meta_db):
        from frankensearch_tpu_torch.storage.store import Storage

        storage = Storage(meta_db)
        try:
            recovered = set(doc_ids)
            report.docs_lost = [
                row.doc_id for row in storage.iter_documents()
                if row.doc_id not in recovered
            ]
        finally:
            storage.close()
        jobs_db = os.path.join(root, "jobs.db")
        if report.docs_lost and os.path.exists(jobs_db):
            from frankensearch_tpu_torch.storage.job_queue import PersistentJobQueue

            q = PersistentJobQueue(jobs_db)
            for doc_id in report.docs_lost:
                q.enqueue("reingest", {"doc_id": doc_id, "reason": "vector lost in slab corruption"})
                report.reingest_jobs_enqueued += 1
    return report
