"""FTVI: the on-disk flat vector artifact (FSVI-equivalent, TPU edition).

Parity target: reference FSVI v1/v2 (crates/frankensearch-index/src/lib.rs:6-44
layout diagram): header with magic/version/embedder identity/dim/quantization/
record count + CRC, record table with doc ids and TOMBSTONE flags, 64-byte
aligned vector slab (f16 default). v2 adds embedding identity binding and
fail-closed admission (lib.rs:263).

FTVI is NOT a byte-level copy of FSVI — it is a fresh layout designed for
bulk HBM upload:

    [0:8)    magic b"FTVI\\x01\\x00\\x00\\x00" (version 1)
    [8:12)   u32 LE header_json_len
    [12:16)  u32 LE crc32(header_json)
    [16:..)  header JSON (identity, dim, dtype, record_count, offsets)
    ...      doc-id blob (utf-8, concatenated)
    ...      u64 LE doc-id offsets array (record_count + 1 entries)
    ...      u8 flags array (bit 0 = TOMBSTONE)
    ...      pad to 64-byte alignment
    ...      vector slab, row-major (record_count x dim), dtype per header
    ...      optional int8 scale block (dim x f32) when dtype == int8

Reads memory-map the slab (numpy memmap) so opening a multi-GB artifact is
O(header); the device upload happens once in DeviceVectorIndex.

Identity binding (fail-closed): ``embedder_id``, ``embedder_revision`` and
``dim`` are part of the header; `verify_identity` refuses mismatched query
embedders, mirroring the reference's v2 admission errors.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from frankensearch_tpu_torch.core.errors import (
    DimensionMismatch,
    IdentityMismatch,
    IndexCorrupted,
    IndexNotFound,
)

MAGIC = b"FTVI\x01\x00\x00\x00"
ALIGN = 64
FLAG_TOMBSTONE = 0x01

_DTYPES = {
    "f32": np.float32,
    "f16": np.float16,
    "bf16": np.uint16,  # stored as raw bf16 bits; reinterpreted on device
    "int8": np.int8,
}


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(_DTYPES[name])
    except KeyError:
        raise IndexCorrupted(f"unknown slab dtype {name!r}") from None


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 bit pattern (u16)."""
    bits = x.astype(np.float32).view(np.uint32)
    rounding = ((bits >> 16) & 1) + 0x7FFF
    return ((bits + rounding) >> 16).astype(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


@dataclass(frozen=True)
class EmbeddingIdentity:
    """Embedder identity bound into the artifact (FSVI v2 parity)."""

    embedder_id: str
    embedder_revision: str = ""
    dim: int = 0
    is_semantic: bool = True

    def to_dict(self) -> dict:
        return {
            "embedder_id": self.embedder_id,
            "embedder_revision": self.embedder_revision,
            "dim": self.dim,
            "is_semantic": self.is_semantic,
        }

    @staticmethod
    def from_dict(d: dict) -> "EmbeddingIdentity":
        return EmbeddingIdentity(
            embedder_id=d["embedder_id"],
            embedder_revision=d.get("embedder_revision", ""),
            dim=int(d.get("dim", 0)),
            is_semantic=bool(d.get("is_semantic", True)),
        )


@dataclass
class FtviHeader:
    identity: EmbeddingIdentity
    dim: int
    dtype: str  # "f32" | "f16" | "bf16" | "int8"
    record_count: int
    doc_blob_offset: int = 0
    doc_blob_len: int = 0
    offsets_offset: int = 0
    flags_offset: int = 0
    slab_offset: int = 0
    scale_offset: int = 0  # 0 when dtype != int8
    slab_crc32: int = 0
    extra: dict = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "identity": self.identity.to_dict(),
                "dim": self.dim,
                "dtype": self.dtype,
                "record_count": self.record_count,
                "doc_blob_offset": self.doc_blob_offset,
                "doc_blob_len": self.doc_blob_len,
                "offsets_offset": self.offsets_offset,
                "flags_offset": self.flags_offset,
                "slab_offset": self.slab_offset,
                "scale_offset": self.scale_offset,
                "slab_crc32": self.slab_crc32,
                "extra": self.extra,
            },
            separators=(",", ":"),
        ).encode("utf-8")

    @staticmethod
    def from_json(raw: bytes) -> "FtviHeader":
        d = json.loads(raw.decode("utf-8"))
        return FtviHeader(
            identity=EmbeddingIdentity.from_dict(d["identity"]),
            dim=d["dim"],
            dtype=d["dtype"],
            record_count=d["record_count"],
            doc_blob_offset=d["doc_blob_offset"],
            doc_blob_len=d["doc_blob_len"],
            offsets_offset=d["offsets_offset"],
            flags_offset=d["flags_offset"],
            slab_offset=d["slab_offset"],
            scale_offset=d.get("scale_offset", 0),
            slab_crc32=d.get("slab_crc32", 0),
            extra=d.get("extra", {}),
        )


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write_ftvi(
    path: str | os.PathLike,
    vectors: np.ndarray,
    doc_ids: Sequence[str],
    identity: EmbeddingIdentity,
    dtype: str = "bf16",
    flags: np.ndarray | None = None,
    scale: np.ndarray | None = None,
    extra: dict | None = None,
) -> FtviHeader:
    """Write an FTVI artifact atomically (tmp + rename).

    ``vectors`` is f32 (or already-quantized int8 when dtype == "int8").
    """
    n = len(doc_ids)
    if vectors.shape[0] != n:
        raise ValueError(f"{vectors.shape[0]} vectors for {n} doc ids")
    dim = int(vectors.shape[1]) if n else identity.dim
    if flags is None:
        flags = np.zeros(n, dtype=np.uint8)
    flags = np.asarray(flags, dtype=np.uint8)

    if dtype == "bf16":
        slab = f32_to_bf16_bits(np.ascontiguousarray(vectors, dtype=np.float32))
    elif dtype == "f16":
        slab = np.ascontiguousarray(vectors, dtype=np.float16)
    elif dtype == "f32":
        slab = np.ascontiguousarray(vectors, dtype=np.float32)
    elif dtype == "int8":
        if vectors.dtype != np.int8:
            raise ValueError("int8 FTVI requires pre-quantized int8 vectors")
        if scale is None:
            raise ValueError("int8 FTVI requires a per-dimension scale block")
        slab = np.ascontiguousarray(vectors)
    else:
        raise ValueError(f"unknown dtype {dtype!r}")

    blob = b"".join(s.encode("utf-8") for s in doc_ids)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    pos = 0
    for i, s in enumerate(doc_ids):
        offsets[i] = pos
        pos += len(s.encode("utf-8"))
    offsets[n] = pos

    header = FtviHeader(
        identity=identity,
        dim=dim,
        dtype=dtype,
        record_count=n,
        extra=extra or {},
    )
    # two-pass: compute layout with a fixed-size header slot
    header_json = header.to_json()
    # reserve generous room: offsets grow as numbers get larger; pad slot
    header_slot = _align(16 + len(header_json) + 256)

    doc_blob_offset = header_slot
    offsets_offset = _align(doc_blob_offset + len(blob))
    flags_offset = _align(offsets_offset + offsets.nbytes)
    slab_offset = _align(flags_offset + flags.nbytes)
    scale_offset = 0
    end = slab_offset + slab.nbytes
    if dtype == "int8":
        scale_offset = _align(end)
        end = scale_offset + dim * 4

    header.doc_blob_offset = doc_blob_offset
    header.doc_blob_len = len(blob)
    header.offsets_offset = offsets_offset
    header.flags_offset = flags_offset
    header.slab_offset = slab_offset
    header.scale_offset = scale_offset
    header.slab_crc32 = zlib.crc32(slab.tobytes())
    header_json = header.to_json()
    if 16 + len(header_json) > header_slot:
        raise IndexCorrupted("header overflow")  # pragma: no cover

    tmp = str(path) + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<II", len(header_json), zlib.crc32(header_json)))
            f.write(header_json)
            f.write(b"\x00" * (doc_blob_offset - 16 - len(header_json)))
            f.write(blob)
            f.write(b"\x00" * (offsets_offset - doc_blob_offset - len(blob)))
            f.write(offsets.tobytes())
            f.write(b"\x00" * (flags_offset - offsets_offset - offsets.nbytes))
            f.write(flags.tobytes())
            f.write(b"\x00" * (slab_offset - flags_offset - flags.nbytes))
            f.write(slab.tobytes())
            if dtype == "int8":
                f.write(b"\x00" * (scale_offset - slab_offset - slab.nbytes))
                f.write(np.asarray(scale, dtype=np.float32).tobytes())
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        # ENOSPC mid-stage: the big slab tmp is exactly what wedges
        # full-disk retries — never leak it (the published artifact is
        # untouched either way; the rename below never ran)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # a rewrite invalidates any durability sidecars describing the OLD
    # bytes — refresh them, or stale parity would "repair" the new
    # artifact back to its previous content (resurrecting e.g. docs a
    # compaction just tombstone-folded). Sidecars are computed from the
    # STAGED tmp file BEFORE the artifact swap, so the artifact+sidecar
    # replaces land back to back (a racing reader's inconsistency window
    # is microseconds, not the digest-computation seconds).
    from frankensearch_tpu_torch.index.durability import PARITY_SUFFIX, SIDECAR_SUFFIX

    path = str(path)
    if os.path.exists(path + SIDECAR_SUFFIX) or os.path.exists(path + PARITY_SUFFIX):
        from frankensearch_tpu_torch.index.durability import (
            artifact_mutation_lock,
            protect_artifact,
        )

        # sidecars-then-artifact under the mutation flock: a concurrent
        # reader that fails verify mid-publish re-verifies under this
        # lock instead of "repairing" the healthy pair (durability.py)
        with artifact_mutation_lock(path):
            protect_artifact(path, source=tmp)
            os.replace(tmp, path)
    else:
        os.replace(tmp, path)
    return header


class FtviFile:
    """An opened FTVI artifact: header + doc table in memory, slab memmap'd."""

    def __init__(self, path: str | os.PathLike, verify_slab: bool = False) -> None:
        self.path = str(path)
        if not os.path.exists(self.path):
            raise IndexNotFound(f"no FTVI artifact at {self.path}")
        with open(self.path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise IndexCorrupted(f"bad magic in {self.path}")
            (json_len, json_crc) = struct.unpack("<II", f.read(8))
            header_json = f.read(json_len)
            if zlib.crc32(header_json) != json_crc:
                raise IndexCorrupted(f"header CRC mismatch in {self.path}")
            self.header = FtviHeader.from_json(header_json)
            h = self.header
            f.seek(h.doc_blob_offset)
            blob = f.read(h.doc_blob_len)
            f.seek(h.offsets_offset)
            offsets = np.frombuffer(f.read((h.record_count + 1) * 8), dtype=np.uint64)
            f.seek(h.flags_offset)
            self.flags = np.frombuffer(f.read(h.record_count), dtype=np.uint8).copy()
        try:
            # the doc-id blob has no per-section CRC; a flipped byte must
            # still surface typed, not as a raw UnicodeDecodeError
            self.doc_ids: list[str] = [
                blob[int(offsets[i]) : int(offsets[i + 1])].decode("utf-8")
                for i in range(h.record_count)
            ]
        except (UnicodeDecodeError, IndexError, OverflowError) as e:
            raise IndexCorrupted(f"doc-id table unreadable in {self.path}: {e}") from None
        np_dtype = _np_dtype(h.dtype)
        # validate byte extents BEFORE memmap: a truncated file would
        # otherwise surface as an untyped 'mmap length is greater than
        # file size' ValueError (caught by the fuzz suite)
        slab_bytes = h.record_count * h.dim * np.dtype(np_dtype).itemsize
        file_size = os.path.getsize(self.path)
        need = h.slab_offset + slab_bytes
        if h.dtype == "int8" and h.scale_offset:
            need = max(need, h.scale_offset + h.dim * 4)
        if file_size < need:
            raise IndexCorrupted(
                f"{self.path} truncated: {file_size} bytes < {need} expected"
            )
        self.slab = np.memmap(
            self.path,
            dtype=np_dtype,
            mode="r",
            offset=h.slab_offset,
            shape=(h.record_count, h.dim),
        )
        self.scale: np.ndarray | None = None
        if h.dtype == "int8" and h.scale_offset:
            self.scale = np.memmap(
                self.path, dtype=np.float32, mode="r", offset=h.scale_offset, shape=(h.dim,)
            )
        if verify_slab:
            if zlib.crc32(np.ascontiguousarray(self.slab).tobytes()) != h.slab_crc32:
                raise IndexCorrupted(f"slab CRC mismatch in {self.path}")

    @property
    def record_count(self) -> int:
        return self.header.record_count

    @property
    def dim(self) -> int:
        return self.header.dim

    def vectors_f32(self) -> np.ndarray:
        """Decode the slab to f32 (host-side; device upload prefers raw)."""
        h = self.header
        if h.dtype == "f32":
            return np.asarray(self.slab, dtype=np.float32)
        if h.dtype == "f16":
            return np.asarray(self.slab, dtype=np.float32)
        if h.dtype == "bf16":
            return bf16_bits_to_f32(np.asarray(self.slab))
        if h.dtype == "int8":
            assert self.scale is not None
            return self.slab.astype(np.float32) * np.asarray(self.scale)
        raise IndexCorrupted(f"unknown dtype {h.dtype}")

    def tombstoned(self) -> np.ndarray:
        return (self.flags & FLAG_TOMBSTONE) != 0

    def verify_identity(self, identity: EmbeddingIdentity) -> None:
        """Fail-closed admission (FSVI v2 parity: identity-bound queries)."""
        mine = self.header.identity
        if identity.embedder_id != mine.embedder_id:
            raise IdentityMismatch(
                f"query embedder {identity.embedder_id!r} != index embedder {mine.embedder_id!r}"
            )
        if (
            identity.embedder_revision
            and mine.embedder_revision
            and identity.embedder_revision != mine.embedder_revision
        ):
            raise IdentityMismatch(
                f"embedder revision {identity.embedder_revision!r} != {mine.embedder_revision!r}"
            )
        if identity.dim and self.header.dim and identity.dim != self.header.dim:
            raise DimensionMismatch(self.header.dim, identity.dim)


def iter_doc_ids(path: str | os.PathLike) -> Iterable[str]:
    yield from FtviFile(path).doc_ids
