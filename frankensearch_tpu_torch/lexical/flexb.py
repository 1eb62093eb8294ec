"""FLXB v1 — packed binary lexical segment format.

Parity target: the reference's Quill on-disk layer (quiver postings
blocks + FSLX segment container, quill/src/quiver.rs:1-8 and
segment.rs:1-6: self-delimiting sections, 64-byte alignment, checksums,
opaque payloads).

The TPU-native answer is simpler than FOR-compressed posting blocks:
the serving-time consumer is the device BM25 scorer, whose working set
IS flat arrays (post_term/post_doc/post_tf + per-field idf tables), so
the packed format stores exactly those arrays raw little-endian. Loading
is ``np.frombuffer`` byte-copies — zero parse, no per-posting Python —
followed by one HBM upload. The container keeps FSLX's section
discipline: named section table, 64-byte-aligned payloads, CRC32 over
the payload region, version gate.

Layout::

    header   32 B:  magic "FLXB" | version u32 | section_count u32 |
                    crc32 u32 | payload_len u64 | reserved 8 B
    table    32 B/section: name 16 B (zero-padded ascii) |
                    offset u64 | length u64      (payload-relative)
    payload  sections, each 64-byte aligned

Sections: ``manifest`` (JSON: counts + per-field bases), ``ids_blob`` /
``ids_off`` (doc-id string table), ``pterm``/``pdoc``/``ptf`` (postings,
padded exactly as the device wants them), per field ``tb_<f>``/
``to_<f>``/``idf_<f>`` (term dictionary + idf table), ``docmeta``
(JSON hydration data).

The port's copy of frankensearch_tpu/lexical/flexb.py: the same bytes;
``load_packed`` uploads onto the device its caller names.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

MAGIC = b"FLXB"
VERSION = 1
_ALIGN = 64
_HEADER = struct.Struct("<4sII I Q 8x")  # magic, version, nsec, crc, payload_len
_SECTION = struct.Struct("<16sQQ")


from frankensearch_tpu_torch.core.errors import IndexCorrupted


class FlexbCorrupted(IndexCorrupted):
    """FLXB framing/CRC violation — part of the typed SearchError
    taxonomy so the durability ladder and product surfaces can catch it
    uniformly (was a bare Exception until the r2 fuzz suite)."""


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _string_table(strings: list[str]) -> tuple[bytes, np.ndarray]:
    blobs = [s.encode("utf-8") for s in strings]
    off = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=off[1:])
    return b"".join(blobs), off


def _read_string_table(blob: bytes, off: np.ndarray) -> list[str]:
    return [blob[off[i] : off[i + 1]].decode("utf-8") for i in range(len(off) - 1)]


def write_sections(path: str, sections: dict[str, bytes]) -> None:
    """Write the FLXB container atomically (tmp + rename)."""
    names = list(sections)
    payload = bytearray()
    table = []
    for name in names:
        if len(name.encode("ascii")) > 16:
            raise ValueError(f"section name too long: {name!r}")
        data = sections[name]
        start = len(payload)
        payload.extend(data)
        payload.extend(b"\x00" * (_pad(len(payload)) - len(payload)))
        table.append((name, start, len(data)))
    payload = bytes(payload)
    header = _HEADER.pack(MAGIC, VERSION, len(names), zlib.crc32(payload), len(payload))
    body = b"".join(
        _SECTION.pack(n.encode("ascii").ljust(16, b"\x00"), o, ln) for n, o, ln in table
    )
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(body)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # a failed stage (ENOSPC, kill) must not leak the partial tmp:
        # on a full disk the leak itself wedges every retry
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_sections(path: str) -> dict[str, bytes]:
    """Read and CRC-verify the container; returns name -> raw bytes."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER.size:
        raise FlexbCorrupted("truncated header")
    magic, version, nsec, crc, payload_len = _HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise FlexbCorrupted(f"bad magic {magic!r}")
    if version != VERSION:
        raise FlexbCorrupted(f"unsupported FLXB version {version}")
    table_end = _HEADER.size + nsec * _SECTION.size
    payload = raw[table_end : table_end + payload_len]
    if len(payload) != payload_len:
        raise FlexbCorrupted("truncated payload")
    if zlib.crc32(payload) != crc:
        raise FlexbCorrupted("payload CRC mismatch")
    out: dict[str, bytes] = {}
    if len(raw) < table_end:
        raise FlexbCorrupted("truncated section table")
    for i in range(nsec):
        name_b, off, ln = _SECTION.unpack_from(raw, _HEADER.size + i * _SECTION.size)
        try:
            # the section table sits outside the payload CRC (it locates
            # the payload), so a flipped byte here must still surface as
            # a TYPED corruption, not a UnicodeDecodeError
            name = name_b.rstrip(b"\x00").decode("ascii")
        except UnicodeDecodeError:
            raise FlexbCorrupted(f"undecodable section name {name_b!r}") from None
        if off + ln > payload_len:
            raise FlexbCorrupted(f"section {name} out of bounds")
        out[name] = payload[off : off + ln]
    return out


# -- device-index (de)serialization ------------------------------------------


def save_packed(index, path: str) -> None:
    """Serialize a BulkDeviceBm25Index-shaped object to FLXB.

    Accepts any index exposing doc_ids, n_docs, posting_count,
    vocab_size, _post_term/_post_doc/_post_tf (device or host arrays),
    _arms ({field: _FieldArm}), and hydrate_candidates().
    """
    ids_blob, ids_off = _string_table(index.doc_ids)
    meta = index.hydrate_candidates(index.doc_ids)
    # FLXB is the packed 1M+ segment: previews only, by design — carrying
    # full content would roughly double the artifact (and the loaded
    # host dict). The boolean post-filter's preview-bound lenient rule
    # covers FLXB-loaded arms.
    meta = {
        d: {k: v for k, v in m.items() if k != "content"}
        for d, m in meta.items()
    }
    manifest = {
        "n_docs": index.n_docs,
        "posting_count": index.posting_count,
        "vocab_size": index.vocab_size,
        "fields": {},
    }
    sections: dict[str, bytes] = {}
    for fname, arm in index._arms.items():
        terms = sorted(arm.term_ids, key=arm.term_ids.get)
        tb, to = _string_table(terms)
        sections[f"tb_{fname}"] = tb
        sections[f"to_{fname}"] = to.tobytes()
        sections[f"idf_{fname}"] = np.ascontiguousarray(arm.idf_host, np.float32).tobytes()
        manifest["fields"][fname] = {"base": int(arm.base), "n_terms": len(terms)}
    sections["manifest"] = json.dumps(manifest, separators=(",", ":")).encode()
    sections["ids_blob"] = ids_blob
    sections["ids_off"] = ids_off.tobytes()
    pterm, pdoc, ptf = getattr(index, "_post_host", None) or (
        index._post_term, index._post_doc, index._post_tf
    )
    sections["pterm"] = np.ascontiguousarray(np.asarray(pterm), np.int32).tobytes()
    sections["pdoc"] = np.ascontiguousarray(np.asarray(pdoc), np.int32).tobytes()
    sections["ptf"] = np.ascontiguousarray(np.asarray(ptf), np.float32).tobytes()
    raw = getattr(index, "_raw_host", None)
    if raw is not None and (
        len(raw[0]) == 0 or int(np.max(raw[0])) <= 0xFFFF
    ):
        # raw (tf, field*256+fieldnorm_id) per posting + per-field norm
        # caches/boost products: lets loads rebuild the PACKED 5 B/posting
        # term-major layout (lexical/daat.py). Optional sections — old
        # segments load fine without them (f32 layout).
        tf_raw, fidx, cache_flat, bk = raw
        sections["rtf"] = np.ascontiguousarray(tf_raw, np.uint16).tobytes()
        sections["rfx"] = np.ascontiguousarray(fidx, np.uint16).tobytes()
        sections["rcache"] = np.ascontiguousarray(cache_flat, np.float32).tobytes()
        sections["rbk"] = np.ascontiguousarray(bk, np.float32).tobytes()
    sections["docmeta"] = json.dumps(meta, separators=(",", ":")).encode()
    write_sections(path, sections)


def load_packed(path: str, *, device):
    """Load a FLXB segment into a ready BulkDeviceBm25Index on ``device``
    (no corpus, no tokenizer run — byte-copies + one upload)."""
    from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index, _FieldArm
    from frankensearch_tpu_torch.lexical.memory_index import _BOOSTS

    sec = read_sections(path)
    try:
        manifest = json.loads(sec["manifest"])
    except (KeyError, ValueError) as e:
        raise FlexbCorrupted(f"manifest unreadable: {e}") from None
    index = BulkDeviceBm25Index.__new__(BulkDeviceBm25Index)
    index._source = None
    ids_off = np.frombuffer(sec["ids_off"], dtype=np.int64)
    doc_ids = _read_string_table(sec["ids_blob"], ids_off)
    p = manifest["posting_count"]

    raw = None
    if "rtf" in sec:
        # raw sections are OPTIONAL accelerators (the packed term-major
        # layout): any shape/size inconsistency degrades to raw=None and
        # the f32 layout serves — never a crash (payload CRC already
        # guards bit damage; this guards crafted/truncated sections)
        try:
            rtf = np.frombuffer(sec["rtf"], dtype=np.uint16)
            rfx = np.frombuffer(sec["rfx"], dtype=np.uint16)
            if len(rtf) >= p and len(rfx) >= p:
                raw = (
                    rtf[:p].astype(np.int64),
                    rfx[:p],
                    np.frombuffer(sec["rcache"], dtype=np.float32),
                    np.frombuffer(sec["rbk"], dtype=np.float32),
                )
        except (ValueError, KeyError):
            raw = None
    arms = {}
    for fname, finfo in manifest["fields"].items():
        to = np.frombuffer(sec[f"to_{fname}"], dtype=np.int64)
        terms = _read_string_table(sec[f"tb_{fname}"], to)
        base = finfo["base"]
        arms[fname] = _FieldArm(
            term_ids={t: base + i for i, t in enumerate(terms)},
            idf_host=np.frombuffer(sec[f"idf_{fname}"], dtype=np.float32),
            boost=_BOOSTS.get(fname, np.float32(1.0)),
            base=base,
        )
    index._meta = json.loads(sec["docmeta"])
    # legacy segments carry padded arrays; trim to the true posting count,
    # then the shared finalizer picks dense vs doc-blocked layout
    index._init_state(
        doc_ids, arms, manifest["vocab_size"],
        np.frombuffer(sec["pterm"], dtype=np.int32)[:p].astype(np.int64),
        np.frombuffer(sec["pdoc"], dtype=np.int32)[:p].astype(np.int64),
        np.frombuffer(sec["ptf"], dtype=np.float32)[:p],
        raw=raw, device=device,
    )
    return index
