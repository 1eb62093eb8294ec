"""WAL sidecar: append vectors/tombstones without rebuilding the artifact.

Parity target: reference crates/frankensearch-index/src/wal.rs —
``.fsvi.wal`` sidecar with FWAL header + CRC32-protected batches (FWB1),
appended without rebuild, partial tail discarded on open, compacted into
the main artifact; search merges WAL-resident entries with supersession
rules (two_tier.rs WAL merge; search.rs:276-300).

FTWL format (fresh layout, same contract):

    file   := b"FTWL\\x01" + batches...
    batch  := b"FWB1" + u32 LE payload_len + u32 LE crc32(payload) + payload
    payload (json+binary): u32 json_len + json header
                           {"op": "append"|"tombstone", "count": n,
                            "dim": d, "dtype": "f32", "doc_ids": [...]}
                           + raw f32 slab (append only)

Supersession rule (reference parity): a later WAL append for a doc id
supersedes both earlier WAL entries and the base artifact row; a
tombstone op supersedes everything before it.
"""

from __future__ import annotations

import os
import struct
import zlib
import json
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from frankensearch_tpu_torch.core.errors import WalCorrupted

WAL_MAGIC = b"FTWL\x01"
BATCH_MAGIC = b"FWB1"


@dataclass
class WalBatch:
    op: str  # "append" | "tombstone"
    doc_ids: list[str]
    vectors: np.ndarray | None = None  # (n, d) f32 for append


@dataclass
class WalState:
    """Materialized WAL contents after replay with supersession applied."""

    #: doc_id -> vector (latest append wins)
    live: dict[str, np.ndarray] = field(default_factory=dict)
    #: doc ids tombstoned by the WAL (applies to base artifact too)
    tombstones: set[str] = field(default_factory=set)
    batches_read: int = 0
    bytes_discarded: int = 0
    #: byte offset after the last APPLIED batch — the fold boundary a
    #: compactor must pass to truncate(consumed=...) so batches appended
    #: after its snapshot survive (see truncate docstring)
    bytes_consumed: int = 0


class WriteAheadLog:
    """Append-only WAL over a file path; safe against torn tails.

    ``sync`` policy (group commit, parity: quill watch contract — the
    reference sustains >=5k updates/s by amortizing durability over a
    poll cycle, BASELINE.md:34-37):

    - ``"always"`` (default): fsync inside every ``append``/``tombstone``
      — each batch is durable against power loss before the call returns.
    - ``"deferred"``: batches are written + flushed to the OS page cache
      (safe against *process* crash — the frame is already in the kernel)
      but fsync is left to an explicit ``sync()``. Callers group-commit:
      one ``sync()`` per poll cycle / durability window. A power loss
      inside the window can drop up to one window of tail batches; the
      CRC framing guarantees replay stops cleanly at the torn tail.
    """

    def __init__(self, path: str | os.PathLike, *, sync: str = "always") -> None:
        if sync not in ("always", "deferred"):
            raise ValueError(f"unknown WAL sync policy {sync!r}")
        self.path = str(path)
        self.sync_policy = sync

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def sync(self) -> None:
        """Group-commit point: fsync everything appended so far."""
        if not os.path.exists(self.path):
            return
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def append(self, doc_ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.shape[0] != len(doc_ids):
            raise ValueError("doc_ids / vectors length mismatch")
        header = json.dumps(
            {
                "op": "append",
                "count": len(doc_ids),
                "dim": int(vectors.shape[1]) if len(doc_ids) else 0,
                "dtype": "f32",
                "doc_ids": list(doc_ids),
            },
            separators=(",", ":"),
        ).encode("utf-8")
        payload = struct.pack("<I", len(header)) + header + vectors.tobytes()
        self._write_batch(payload)

    def tombstone(self, doc_ids: Sequence[str]) -> None:
        header = json.dumps(
            {"op": "tombstone", "count": len(doc_ids), "doc_ids": list(doc_ids)},
            separators=(",", ":"),
        ).encode("utf-8")
        payload = struct.pack("<I", len(header)) + header
        self._write_batch(payload)

    def _write_batch(self, payload: bytes) -> None:
        with open(self.path, "ab") as f:
            # cross-process exclusion for the multi-write batch frame:
            # two unlocked appenders interleave magic/header/payload and
            # poison the log from that offset (generation_root.rs flock
            # guard discipline; the lock dies with its holder)
            import fcntl

            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                if f.tell() == 0 and os.path.getsize(self.path) == 0:
                    f.write(WAL_MAGIC)
                f.write(BATCH_MAGIC)
                f.write(struct.pack("<II", len(payload), zlib.crc32(payload)))
                f.write(payload)
                f.flush()
                if self.sync_policy == "always":
                    os.fsync(f.fileno())
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    def replay(self, strict: bool = False) -> WalState:
        """Read all intact batches; a torn/corrupt tail is discarded
        (strict=False, the recovery default) or raises (strict=True,
        the reference's strict inspection mode)."""
        state = WalState()
        if not os.path.exists(self.path):
            return state
        with open(self.path, "rb") as f:
            data = f.read()
        if data[: len(WAL_MAGIC)] != WAL_MAGIC:
            if strict:
                raise WalCorrupted(f"bad WAL magic in {self.path}")
            state.bytes_discarded = len(data)
            return state
        pos = len(WAL_MAGIC)
        while pos < len(data):
            tail_error = None
            if pos + 12 > len(data):
                tail_error = "truncated batch frame"
            elif data[pos : pos + 4] != BATCH_MAGIC:
                tail_error = "bad batch magic"
            else:
                (plen, crc) = struct.unpack("<II", data[pos + 4 : pos + 12])
                start = pos + 12
                if start + plen > len(data):
                    tail_error = "truncated batch payload"
                else:
                    payload = data[start : start + plen]
                    if zlib.crc32(payload) != crc:
                        tail_error = "batch CRC mismatch"
            if tail_error is not None:
                if strict:
                    raise WalCorrupted(f"{tail_error} at offset {pos} in {self.path}")
                state.bytes_discarded = len(data) - pos
                break
            batch = _decode_payload(payload)
            _apply(state, batch)
            state.batches_read += 1
            pos = start + plen
            state.bytes_consumed = pos
        return state

    def truncate(self, consumed: int | None = None) -> None:
        """Drop folded WAL bytes after compaction.

        ``consumed=None`` removes the file — ONLY safe when the caller
        exclusively owns the WAL (no concurrent appenders possible).

        ``consumed=<offset>`` (the replay's ``bytes_consumed`` the folder
        actually materialized) cuts exactly that prefix UNDER THE SAME
        flock appenders take, preserving batches appended after the fold
        snapshot. Found by racing a compactor against a live writer:
        whole-file truncate silently destroyed 345/3,623 durably-fsynced
        appends (the batches landing between the compactor's open and
        its truncate). CRC framing keeps a mis-offset cut safe: bytes
        that aren't a clean batch boundary replay as a torn tail.
        """
        if not os.path.exists(self.path):
            return
        if consumed is None:
            os.remove(self.path)
            return
        import fcntl

        with open(self.path, "r+b") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                cut = max(consumed, len(WAL_MAGIC))
                if size <= cut:
                    # nothing appended since the fold: empty the file
                    # (appenders re-seed the magic on next write)
                    f.seek(0)
                    f.truncate(0)
                else:
                    f.seek(cut)
                    tail = f.read(size - cut)
                    f.seek(0)
                    f.truncate(0)
                    f.write(WAL_MAGIC)
                    f.write(tail)
                f.flush()
                os.fsync(f.fileno())
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def _decode_payload(payload: bytes) -> WalBatch:
    (jlen,) = struct.unpack("<I", payload[:4])
    header = json.loads(payload[4 : 4 + jlen].decode("utf-8"))
    op = header["op"]
    doc_ids = list(header["doc_ids"])
    vectors = None
    if op == "append":
        n, d = header["count"], header["dim"]
        raw = payload[4 + jlen :]
        vectors = np.frombuffer(raw, dtype=np.float32).reshape(n, d).copy()
    return WalBatch(op=op, doc_ids=doc_ids, vectors=vectors)


def _apply(state: WalState, batch: WalBatch) -> None:
    if batch.op == "append":
        assert batch.vectors is not None
        for i, doc_id in enumerate(batch.doc_ids):
            state.live[doc_id] = batch.vectors[i]
            state.tombstones.discard(doc_id)
    elif batch.op == "tombstone":
        for doc_id in batch.doc_ids:
            state.tombstones.add(doc_id)
            state.live.pop(doc_id, None)
    else:  # pragma: no cover
        raise WalCorrupted(f"unknown WAL op {batch.op!r}")
