"""Lexical index persistence: FLEX v1 JSON artifact.

The reference's Quill engine persists FSLX segments + a Keeper MANIFEST
with blue-green CURRENT publication (quill/src/keeper.rs). This module
provides the same *contract* at framework scale — atomic publication of
an immutable lexical snapshot next to the vector artifacts — with a
simple JSON container (the postings layout is small next to the vector
slab; a packed binary/segment format is a later optimization).

Layout:  <root>/lexical/<generation>/index.flex.json
         <root>/lexical/CURRENT   (text file: generation name; atomic swap)

The port's copy of frankensearch_tpu/lexical/persist.py: the same bytes.
A packed load takes the device its arm goes to (``load_packed_lexical(root,
device=...)``); the device indexes built only to be written as FLXB
(``republish_lexical``, ``publish_incremental``) are built on the host.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import torch

from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex, _DocEntry, _FieldStats
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

FLEX_VERSION = 1

#: where the FLXB writers build the index they serialize: its host arrays
#: are what they write, and it is never searched
_SERIALIZE_DEVICE = torch.device("cpu")


def save_lexical(index: MemoryLexicalIndex, root: str) -> str:
    """Write an immutable snapshot + atomically publish CURRENT.
    Returns the generation name.

    Publication is guarded by the cross-process flock WriterLock
    (keeper.rs WRITER_LOCK role): two writers racing a blue-green
    publish would otherwise interleave CURRENT swaps."""
    from frankensearch_tpu_torch.index.file_identity import WriterLock

    os.makedirs(os.path.join(root, "lexical"), exist_ok=True)
    with WriterLock(os.path.join(root, "lexical", ".writer.lock")):
        return _save_lexical_locked(index, root)


def _new_generation_name(root: str) -> str:
    """Millisecond stamps COLLIDE for back-to-back publishes (a tiny
    snapshot saves in <1 ms), and a colliding name silently writes into
    the live generation's directory — bump until unused (publishers hold
    the WriterLock, so the existence check is race-free)."""
    base = int(time.time() * 1000)
    while True:
        name = f"gen-{base:013d}"
        if not os.path.exists(os.path.join(root, "lexical", name)):
            return name
        base += 1


def _flex_payload(index: MemoryLexicalIndex) -> dict:
    postings, field_stats, docs = index.snapshot_postings()
    return {
        "version": FLEX_VERSION,
        "field_stats": {
            f: {"total_tokens": s.total_tokens, "doc_count": s.doc_count}
            for f, s in field_stats.items()
        },
        "docs": {
            d: {
                "title": e.title,
                "metadata": dict(e.metadata) if e.metadata else None,
                "preview": e.content_preview,
                # full content: phrase adjacency must stay EXACT across a
                # reload (probed: a reopened oracle verified phrases
                # against content_full="" — every phrase not in a TITLE
                # silently failed post-compact). The oracle snapshot is
                # the small/medium-corpus lane; bulk 1M+ lanes (FLXB)
                # deliberately keep previews only.
                "content": e.content_full,
                "fieldnorm_id": e.fieldnorm_id,
                "token_counts": e.token_counts,
            }
            for d, e in docs.items()
        },
        "postings": {
            f: {term: plist for term, plist in terms.items()}
            for f, terms in postings.items()
        },
    }


def _save_lexical_locked(index: MemoryLexicalIndex, root: str) -> str:
    generation = _new_generation_name(root)
    gen_dir = os.path.join(root, "lexical", generation)
    os.makedirs(gen_dir, exist_ok=True)
    payload = _flex_payload(index)
    path = os.path.join(gen_dir, "index.flex.json")
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            # one C-encoder pass: json.dump would stream the same bytes
            # through the pure-Python encoder, minutes at a million docs
            f.write(json.dumps(payload, separators=(",", ":")))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # blue-green CURRENT pointer (keeper.rs publish_current parity)
        current = os.path.join(root, "lexical", "CURRENT")
        atomic_write_text(current, generation)
    except BaseException:
        # failed BEFORE publication: this generation dir is ours alone
        # (we hold the WriterLock and CURRENT never pointed at it) — a
        # leaked partial generation wedges full-disk retries forever
        # (prune_generations keeps the newest gens, i.e. exactly these)
        import shutil

        shutil.rmtree(gen_dir, ignore_errors=True)
        raise
    return generation


def load_lexical(root: str) -> MemoryLexicalIndex | None:
    """Resolve CURRENT and load that generation; None when absent.
    Corruption raises TYPED ``IndexCorrupted`` (never a raw decode
    error), so callers can take the degradation ladder.

    The loaded oracle equals the reference's field for field. The
    snapshot's counts are JSON ints already, so its per-doc dicts and
    posting lists become the index's own (no per-entry copy), and the
    cyclic collector is paused over the millions of containers the parse
    makes: it would otherwise rescan the growing heap many times over."""
    import gc

    paused = gc.isenabled()
    gc.disable()
    try:
        return _load_lexical(root)
    finally:
        if paused:
            gc.enable()


def _load_lexical(root: str) -> MemoryLexicalIndex | None:
    from frankensearch_tpu_torch.core.errors import IndexCorrupted

    current = os.path.join(root, "lexical", "CURRENT")
    if not os.path.exists(current):
        return None
    with open(current) as f:
        generation = f.read().strip()
    path = os.path.join(root, "lexical", generation, "index.flex.json")
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except FileNotFoundError:
        return None
    except (ValueError, UnicodeDecodeError) as e:
        raise IndexCorrupted(f"FLEX snapshot unreadable at {path}: {e}") from None
    if payload.get("version") != FLEX_VERSION:
        raise IndexCorrupted(f"unsupported FLEX version {payload.get('version')}")
    index = MemoryLexicalIndex()
    for fname, s in payload["field_stats"].items():
        index._field_stats[fname] = _FieldStats(
            total_tokens=s["total_tokens"], doc_count=s["doc_count"]
        )
    index._docs = {
        # pre-r3 snapshots lack "content": content_full stays empty and
        # phrase checks fall back to the preview bound
        doc_id: _DocEntry(
            doc_id, d["title"], d["metadata"], d["preview"], d.get("content", ""),
            d["fieldnorm_id"], d.get("token_counts", {}),
        )
        for doc_id, d in payload["docs"].items()
    }
    for fname, terms in payload["postings"].items():
        index._postings[fname] = defaultdict(dict, terms)
    index._generation = 1
    # incremental generations (publish_incremental) carry the window
    # snapshots alongside the base: fold them so the oracle holds the
    # full corpus with exact fresh global stats
    fold_delta_snapshots(index, os.path.join(root, "lexical", generation))
    return index


def save_packed_lexical(device_index, root: str, generation: str | None = None) -> str:
    """Write a FLXB packed segment (lexical/flexb.py) for the device BM25
    arm. With ``generation=None`` a new generation is created and
    published via CURRENT (blue-green, keeper.rs parity); otherwise the
    segment is written alongside an existing generation's artifacts."""
    from frankensearch_tpu_torch.lexical.flexb import save_packed

    publish = generation is None
    if generation is None:
        generation = _new_generation_name(root)
    gen_dir = os.path.join(root, "lexical", generation)
    created_dir = not os.path.isdir(gen_dir)
    os.makedirs(gen_dir, exist_ok=True)
    packed_path = os.path.join(gen_dir, "index.flexb")
    try:
        save_packed(device_index, packed_path)
    except BaseException:
        if publish and created_dir:
            # unpublished generation dir of our own making: a failed
            # stage (ENOSPC) must not leak it — see _save_lexical_locked
            import shutil

            shutil.rmtree(gen_dir, ignore_errors=True)
        raise
    # protect-on-commit (tantivy_wrapper.rs per-segment .fec parity):
    # sidecars make single-burst damage REPAIRABLE at open — without
    # them the in-file CRC can only detect, not heal
    try:
        from frankensearch_tpu_torch.index.durability import protect_artifact

        protect_artifact(packed_path)
    except OSError:
        pass  # unprotected segment still loads; repair ladder degrades
    if publish:
        current = os.path.join(root, "lexical", "CURRENT")
        atomic_write_text(current, generation)
    return generation


def load_packed_lexical(root: str, *, device):
    """Load the CURRENT generation's FLXB segment(s) as a ready device
    arm; None when absent. Incremental generations (segments.json —
    publish_incremental) load as a lexical/segments.SegmentedBm25
    stack; single-segment generations load the plain packed arm."""
    from frankensearch_tpu_torch.lexical.flexb import load_packed

    current = os.path.join(root, "lexical", "CURRENT")
    if not os.path.exists(current):
        return None
    with open(current) as f:
        generation = f.read().strip()
    gen_dir = os.path.join(root, "lexical", generation)
    seg_names = _load_segments_manifest(gen_dir)
    if seg_names and len(seg_names) > 1:
        from frankensearch_tpu_torch.core.errors import IndexCorrupted
        from frankensearch_tpu_torch.index.durability import ensure_artifact
        from frankensearch_tpu_torch.lexical.flexb import read_sections
        from frankensearch_tpu_torch.lexical.segments import SegmentedBm25

        def _flexb_ok(p: str) -> bool:
            read_sections(p)  # raises on payload-CRC damage
            return True

        segs = []
        for name in seg_names:
            spath = os.path.join(gen_dir, name)
            if not os.path.exists(spath):
                return None  # degrade: the JSON oracle arm keeps serving
            if not ensure_artifact(spath, intrinsic_check=_flexb_ok):
                return None
            try:
                segs.append(load_packed(spath, device=device))
            except IndexCorrupted:
                return None
        return SegmentedBm25(segs)
    path = os.path.join(gen_dir, "index.flexb")
    if not os.path.exists(path):
        return None
    # verify-then-repair-on-open (tantivy_wrapper.rs per-segment .fec
    # parity); an unrepairable packed arm degrades to None — the JSON
    # oracle arm keeps serving (graceful-degradation ladder)
    from frankensearch_tpu_torch.core.errors import IndexCorrupted
    from frankensearch_tpu_torch.index.durability import ensure_artifact

    def _flexb_intrinsic(p: str) -> bool:
        # FLXB payload-CRC validation: a publish killed between the
        # sidecar refresh and the atomic rename leaves stale sidecars
        # over a complete valid segment (see durability.ensure_artifact)
        from frankensearch_tpu_torch.lexical.flexb import read_sections

        read_sections(p)
        return True

    if not ensure_artifact(path, intrinsic_check=_flexb_intrinsic):
        return None
    try:
        return load_packed(path, device=device)
    except IndexCorrupted:
        # damage the sidecars could not heal (or a pre-sidecar segment):
        # degrade to the JSON oracle arm rather than killing the open
        return None


def republish_lexical(index: MemoryLexicalIndex, root: str) -> str:
    """Publish a new generation carrying BOTH artifacts: the FLEX JSON
    oracle snapshot and the FLXB packed device arm (derived from the
    oracle's committed postings, so append/compact flows keep the fast
    read path). Packed failures degrade to JSON-only silently — the
    reader falls back the same way."""
    generation = save_lexical(index, root)
    try:
        from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index

        save_packed_lexical(
            DeviceBm25Index(index, device=_SERIALIZE_DEVICE), root, generation=generation
        )
    except Exception:
        pass
    prune_generations(root)
    return generation


def prune_generations(root: str, keep: int = 2) -> list[str]:
    """Blue-green retention (keeper.rs GC): drop all but the ``keep``
    newest generations — never the one CURRENT points to. The previous
    generation survives as a grace window for in-flight readers; without
    this a sealing daemon leaks a full snapshot per seal, unbounded.
    Returns the removed generation names."""
    import shutil

    lex_root = os.path.join(root, "lexical")
    try:
        with open(os.path.join(lex_root, "CURRENT")) as f:
            current = f.read().strip()
    except OSError:
        return []
    gens = sorted(g for g in os.listdir(lex_root) if g.startswith("gen-"))
    if len(gens) <= keep:
        return []
    removed = []
    for g in gens[:-keep]:
        if g == current:
            continue
        try:
            shutil.rmtree(os.path.join(lex_root, g))
            removed.append(g)
        except OSError:
            continue
    return removed


def list_generations(root: str) -> list[str]:
    lex_root = os.path.join(root, "lexical")
    if not os.path.isdir(lex_root):
        return []
    return sorted(g for g in os.listdir(lex_root) if g.startswith("gen-"))


# -- incremental (segment-stacking) publication -------------------------------


def publish_incremental(delta_mem: MemoryLexicalIndex, root: str) -> str | None:
    """Publish a new generation that STACKS a delta segment over the
    previous generation's artifacts instead of rebuilding them — the
    keeper.rs concat-merge / quiver.rs byte-copy-merge parity move
    (VERDICT r4 next #3): update→searchable cost is the DELTA's build.

    The new generation hard-links (copy fallback) every artifact of the
    CURRENT one, adds ``seg-NNN.flexb`` (the delta's packed device
    segment) + ``delta-NNN.flex.json`` (its oracle snapshot, folded into
    the base oracle at load), and lists the device segments in
    ``segments.json`` (lexical/segments.SegmentedBm25 loads the stack).

    Returns the generation name, or None when the append fast path does
    not apply — no packed base in CURRENT, or the stack is at
    MAX_SEGMENTS (compaction due): the caller falls back to the full
    ``republish_lexical``.
    """
    import shutil

    from frankensearch_tpu_torch.index.file_identity import WriterLock
    from frankensearch_tpu_torch.lexical.device_bm25 import DeviceBm25Index
    from frankensearch_tpu_torch.lexical.flexb import save_packed
    from frankensearch_tpu_torch.lexical.segments import MAX_SEGMENTS

    os.makedirs(os.path.join(root, "lexical"), exist_ok=True)
    with WriterLock(os.path.join(root, "lexical", ".writer.lock")):
        current = os.path.join(root, "lexical", "CURRENT")
        if not os.path.exists(current):
            return None
        with open(current) as f:
            prev = f.read().strip()
        prev_dir = os.path.join(root, "lexical", prev)
        if not os.path.exists(os.path.join(prev_dir, "index.flexb")):
            return None
        prev_segs = sorted(
            f for f in os.listdir(prev_dir)
            if f.startswith("seg-") and f.endswith(".flexb")
        )
        if 1 + len(prev_segs) + 1 > MAX_SEGMENTS:
            return None  # compaction due
        seg_no = len(prev_segs) + 1

        generation = _new_generation_name(root)
        gen_dir = os.path.join(root, "lexical", generation)
        os.makedirs(gen_dir, exist_ok=True)
        try:
            # carry forward every prior artifact by hard link (same-fs
            # O(1); the sidecars ride along so verify-on-open still heals)
            for fname in os.listdir(prev_dir):
                src = os.path.join(prev_dir, fname)
                dst = os.path.join(gen_dir, fname)
                if fname == "segments.json" or not os.path.isfile(src):
                    continue
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copy2(src, dst)

            seg_name = f"seg-{seg_no:03d}.flexb"
            seg_path = os.path.join(gen_dir, seg_name)
            save_packed(DeviceBm25Index(delta_mem, device=_SERIALIZE_DEVICE), seg_path)
            try:
                from frankensearch_tpu_torch.index.durability import protect_artifact

                protect_artifact(seg_path)
            except OSError:
                pass
            delta_json = os.path.join(gen_dir, f"delta-{seg_no:03d}.flex.json")
            tmp = delta_json + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(_flex_payload(delta_mem), separators=(",", ":")))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, delta_json)
            manifest = {
                "v": 1,
                "segments": ["index.flexb"]
                + [f"seg-{i:03d}.flexb" for i in range(1, seg_no + 1)],
            }
            atomic_write_text(
                os.path.join(gen_dir, "segments.json"),
                json.dumps(manifest, separators=(",", ":")),
            )
            atomic_write_text(current, generation)
        except BaseException:
            shutil.rmtree(gen_dir, ignore_errors=True)
            raise
    prune_generations(root)
    return generation


def _load_segments_manifest(gen_dir: str) -> list[str] | None:
    path = os.path.join(gen_dir, "segments.json")
    if not os.path.exists(path):
        return None
    from frankensearch_tpu_torch.core.errors import IndexCorrupted

    try:
        with open(path, encoding="utf-8") as f:
            manifest = json.load(f)
        return list(manifest["segments"])
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise IndexCorrupted(f"segments manifest unreadable: {e}") from None


def fold_delta_snapshots(index: MemoryLexicalIndex, gen_dir: str) -> int:
    """Fold every delta-*.flex.json of an incremental generation into a
    loaded base oracle (re-adds the delta documents: the oracle keeps
    exact fresh global stats by construction). Returns docs folded."""
    from frankensearch_tpu_torch.core.errors import IndexCorrupted
    from frankensearch_tpu_torch.core.types import IndexableDocument

    folded = 0
    for fname in sorted(os.listdir(gen_dir)):
        if not (fname.startswith("delta-") and fname.endswith(".flex.json")):
            continue
        try:
            with open(os.path.join(gen_dir, fname), encoding="utf-8") as f:
                payload = json.load(f)
        except (ValueError, UnicodeDecodeError) as e:
            raise IndexCorrupted(f"delta snapshot unreadable: {e}") from None
        for doc_id, d in payload["docs"].items():
            index.add_document(IndexableDocument(
                doc_id=doc_id,
                content=d.get("content", "") or d.get("preview", ""),
                title=d.get("title"),
                metadata=d.get("metadata"),
            ))
            folded += 1
    if folded:
        index.commit()
    return folded
