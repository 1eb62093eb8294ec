"""Artifact durability: checksum sidecars, verify/REPAIR-on-open, quarantine.

Parity target: crates/frankensearch-durability (reference) —
``FileProtector``/``FsviProtector`` write FEC sidecars and repair
corruption via RaptorQ (src/fsvi_protector.rs:1-7, src/codec.rs:7).
SURVEY §7 waives the RaptorQ *codec* specifically, not repair: this
module honors the full contract with a simpler code — a RAID-5-style
XOR parity-stripe sidecar (``.fspar``) that repairs any single corrupt
stripe per group (default 64 KiB stripes, groups of 16 => 6.25% space
overhead), plus the cheap verify-on-open digest sidecar (``.fsum``,
the reference's xxh3 fast-path role), protect-on-commit, atomic sidecar
swap, and quarantine + rebuild-callback when parity can't recover.

The port's copy of frankensearch_tpu/index/durability.py. It leaves out
the FLXB lexical artifact's intrinsic check: the port reads no FLXB
artifact yet, so ``intrinsic_check_for`` knows FTVI (``.idx``) files only.
"""

from __future__ import annotations

import contextlib
import fcntl
import logging
import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from typing import Callable

from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

import numpy as np

from frankensearch_tpu_torch.core.errors import IndexCorrupted

logger = logging.getLogger("frankensearch.durability")

SIDECAR_SUFFIX = ".fsum"
SIDECAR_VERSION = 1
PARITY_SUFFIX = ".fspar"
PARITY_VERSION = 1
LOCK_SUFFIX = ".lock"


@contextlib.contextmanager
def artifact_mutation_lock(path: str):
    """Cross-process exclusion for mutations of an (artifact, sidecars)
    pair — publishers (write_ftvi's protect-then-replace) and the parity
    repairer both hold it. Without it two races exist (probed
    2026-08-18):

    - mid-publish false corruption: write_ftvi replaces the sidecars
      (computed from the staged tmp) BEFORE the artifact, so a reader in
      that window sees NEW digests over OLD bytes, fails verify, and
      would quarantine/\"repair\" a healthy index;
    - repair-clobbers-publish: an unlocked repairer that loaded the OLD
      artifact+parity can os.replace its reconstructed OLD bytes over a
      concurrently published NEW artifact — silently reverting a
      compaction (whose WAL fold already discarded the only other copy).

    flock (kernel-owned, vanishes with the holder — WriterLock rationale,
    file_identity.py:158) on ``<artifact>.lock``; blocking acquire, the
    publish/repair critical sections are short. ``.lock`` files are
    coordination artifacts, excluded from the generation census the same
    way ``.tmp`` staging files are (core/generation.py)."""
    fd = os.open(path + LOCK_SUFFIX, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


def _digest_file(path: str, algo: str = "crc32", chunk: int = 1 << 20) -> str:
    """File digest for the verify-on-open fast path.

    Default crc32: ~3 GB/s vs blake2b's ~0.6 GB/s — this sidecar exists
    to catch ACCIDENTAL corruption on every open (the reference's xxh3
    fast-path role), where a 2^-32 miss rate is ample; the parity
    sidecar keeps blake2b-64 per stripe for repair-grade verification.
    ``algo`` honors what an existing sidecar recorded (back-compat with
    r1 blake2b-128 sidecars)."""
    if algo == "crc32":
        import zlib

        crc = 0
        with open(path, "rb") as f:
            while True:
                b = f.read(chunk)
                if not b:
                    break
                crc = zlib.crc32(b, crc)
        return f"{crc:08x}"
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


@dataclass(frozen=True)
class ProtectionReceipt:
    path: str
    sidecar: str
    digest: str
    bytes: int


class FileProtector:
    """Protect-on-commit + verify-on-open for a single artifact file."""

    @staticmethod
    def protect(path: str, *, source: str | None = None) -> ProtectionReceipt:
        """``source`` lets a publisher compute the digest from a staged
        tmp file while naming the sidecar for the final path — the
        artifact + sidecar swaps then happen back to back (microsecond
        inconsistency window instead of the digest-computation seconds a
        racing reader could otherwise observe)."""
        src = source or path
        digest = _digest_file(src)
        sidecar = path + SIDECAR_SUFFIX
        payload = {
            "v": SIDECAR_VERSION,
            "algo": "crc32",
            "digest": digest,
            "bytes": os.path.getsize(src),
        }
        # atomic sidecar swap; staged tmp cleaned on ENOSPC/kill
        atomic_write_text(sidecar, json.dumps(payload), fsync=True)
        return ProtectionReceipt(path=path, sidecar=sidecar, digest=digest,
                                 bytes=payload["bytes"])

    @staticmethod
    def verify(path: str, *, fast: bool = True) -> bool:
        """fast=True checks size first (the <1ms fast path); full digest
        only when sizes match."""
        sidecar = path + SIDECAR_SUFFIX
        if not os.path.exists(sidecar):
            return False
        with open(sidecar, encoding="utf-8") as f:
            payload = json.load(f)
        if payload.get("v") != SIDECAR_VERSION:
            return False
        if not os.path.exists(path):
            return False
        if os.path.getsize(path) != payload["bytes"]:
            return False
        algo = "crc32" if payload.get("algo") == "crc32" else "blake2b"
        return _digest_file(path, algo=algo) == payload["digest"]

    @staticmethod
    def is_protected(path: str) -> bool:
        return os.path.exists(path + SIDECAR_SUFFIX)


def _stripe_digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=8).hexdigest()


@dataclass(frozen=True)
class RepairReport:
    """Outcome of a parity verify-and-repair pass."""

    ok: bool                      #: file is intact after the pass
    scanned_stripes: int = 0
    bad_stripes: tuple[int, ...] = ()
    repaired_stripes: tuple[int, ...] = ()
    unrepairable_groups: tuple[int, ...] = ()
    detail: str = ""


class ParityProtector:
    """XOR parity-stripe sidecar: detect via per-stripe digests, repair
    any single corrupt stripe per group by XOR reconstruction.

    Fills the reference's RaptorQ FEC role
    (crates/frankensearch-durability/src/codec.rs:7) with a code whose
    failure mode is explicit: >=2 corrupt stripes in one group are
    unrepairable and fall through to quarantine + rebuild.
    """

    @staticmethod
    def protect(path: str, *, stripe: int = 1 << 16, group: int = 16,
                source: str | None = None) -> str:
        src = source or path
        size = os.path.getsize(src)
        digests: list[str] = []
        parity_blocks: list[bytes] = []
        with open(src, "rb") as f:
            acc: np.ndarray | None = None
            in_group = 0
            while True:
                data = f.read(stripe)
                if not data:
                    break
                digests.append(_stripe_digest(data))
                padded = data if len(data) == stripe else data + b"\0" * (stripe - len(data))
                arr = np.frombuffer(padded, dtype=np.uint8)
                acc = arr.copy() if acc is None else acc ^ arr
                in_group += 1
                if in_group == group:
                    parity_blocks.append(acc.tobytes())
                    acc, in_group = None, 0
            if acc is not None:
                parity_blocks.append(acc.tobytes())
        header = {
            "v": PARITY_VERSION,
            "algo": "xor-parity+blake2b-64",
            "stripe": stripe,
            "group": group,
            "bytes": size,
            "n_stripes": len(digests),
            "stripe_digests": digests,
        }
        sidecar = path + PARITY_SUFFIX
        tmp = sidecar + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode("utf-8"))
                f.write(b"\n")
                for block in parity_blocks:
                    f.write(block)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, sidecar)  # atomic sidecar swap
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return sidecar

    @staticmethod
    def is_protected(path: str) -> bool:
        return os.path.exists(path + PARITY_SUFFIX)

    @staticmethod
    def _load_sidecar(path: str) -> tuple[dict, bytes] | None:
        sidecar = path + PARITY_SUFFIX
        if not os.path.exists(sidecar):
            return None
        with open(sidecar, "rb") as f:
            line = f.readline()
            try:
                header = json.loads(line)
            except ValueError:
                return None
            if header.get("v") != PARITY_VERSION:
                return None
            parity = f.read()
        return header, parity

    @classmethod
    def verify_and_repair(cls, path: str) -> RepairReport:
        """Scan per-stripe digests; XOR-reconstruct single bad stripes per
        group; rewrite the file atomically when anything was repaired."""
        loaded = cls._load_sidecar(path)
        if loaded is None:
            return RepairReport(ok=False, detail="no parity sidecar")
        header, parity = loaded
        stripe, group = header["stripe"], header["group"]
        digests = header["stripe_digests"]
        n_stripes = header["n_stripes"]
        if not os.path.exists(path):
            return RepairReport(ok=False, detail="artifact missing")
        if os.path.getsize(path) != header["bytes"]:
            return RepairReport(
                ok=False,
                detail=f"size changed ({os.path.getsize(path)} != {header['bytes']}): "
                "stripes shifted, parity cannot apply",
            )

        with open(path, "rb") as f:
            raw = f.read()
        stripes: list[bytes] = [raw[i * stripe:(i + 1) * stripe] for i in range(n_stripes)]
        bad = [i for i in range(n_stripes) if _stripe_digest(stripes[i]) != digests[i]]
        if not bad:
            return RepairReport(ok=True, scanned_stripes=n_stripes)

        repaired: list[int] = []
        unrepairable: list[int] = []
        n_groups = (n_stripes + group - 1) // group
        for g in range(n_groups):
            members = [i for i in range(g * group, min((g + 1) * group, n_stripes))]
            bad_here = [i for i in members if i in bad]
            if not bad_here:
                continue
            if len(bad_here) > 1:
                unrepairable.append(g)
                continue
            target = bad_here[0]
            acc = np.frombuffer(parity[g * stripe:(g + 1) * stripe], dtype=np.uint8).copy()
            for i in members:
                if i == target:
                    continue
                data = stripes[i]
                if len(data) != stripe:
                    data = data + b"\0" * (stripe - len(data))
                acc ^= np.frombuffer(data, dtype=np.uint8)
            # the reconstructed stripe: trim the final stripe's zero pad
            want_len = len(stripes[target])
            fixed = acc.tobytes()[:want_len]
            if _stripe_digest(fixed) != digests[target]:
                unrepairable.append(g)
                continue
            stripes[target] = fixed
            repaired.append(target)

        if repaired:
            tmp = path + ".repair.tmp"
            try:
                with open(tmp, "wb") as f:
                    for s in stripes:
                        f.write(s)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise
        ok = not unrepairable
        # operator-visible: silent corruption repair is the one event a
        # deployment must notice (tracing_config.rs role)
        from frankensearch_tpu_torch.utils.tracing import get_logger

        get_logger("durability").warning(
            "parity repair on %s: %d bad stripe(s), %d repaired%s",
            path, len(bad), len(repaired),
            "" if ok else f", {len(unrepairable)} group(s) UNREPAIRABLE",
            extra={"fs_extra": {
                "artifact": path, "bad": list(bad),
                "repaired": list(repaired), "unrepairable_groups": list(unrepairable),
            }},
        )
        return RepairReport(
            ok=ok,
            scanned_stripes=n_stripes,
            bad_stripes=tuple(bad),
            repaired_stripes=tuple(repaired),
            unrepairable_groups=tuple(unrepairable),
            detail="repaired" if ok and repaired else
            ("" if ok else f"{len(unrepairable)} group(s) with >1 corrupt stripe"),
        )


def protect_artifact(path: str, *, source: str | None = None) -> ProtectionReceipt:
    """Protect-on-commit: write BOTH sidecars (digest + parity).
    ``source`` stages the computation against a tmp file (see
    FileProtector.protect)."""
    receipt = FileProtector.protect(path, source=source)
    ParityProtector.protect(path, source=source)
    return receipt


def intrinsic_check_for(path: str):
    """The format-level in-file integrity validator for a known artifact
    kind, or None. Used to distinguish stale-sidecar publish remnants
    from real damage (see ensure_artifact)."""
    name = os.path.basename(path)
    if name.endswith(".idx"):
        def _ftvi(p: str) -> bool:
            from frankensearch_tpu_torch.index.fsvi import FtviFile

            FtviFile(p, verify_slab=True)
            return True

        return _ftvi
    return None


def heal_stale_sidecars(path: str) -> bool:
    """If the artifact is intrinsically valid but its digest sidecar
    disagrees (a publish killed between sidecar refresh and the atomic
    rename), regenerate the sidecars and return True. Caller must hold
    the artifact mutation lock."""
    check = intrinsic_check_for(path)
    if check is None or FileProtector.verify(path):
        return False
    try:
        if not check(path):
            return False
    except Exception:
        return False
    logger.warning(
        "%s: digest sidecar mismatch but artifact passes its in-file "
        "integrity check — stale sidecars from an interrupted publish; "
        "regenerating", path,
    )
    protect_artifact(path)
    return True


def ensure_artifact(path: str, intrinsic_check=None) -> bool:
    """Verify-then-repair-on-open for one artifact.

    Returns True when the file is intact (possibly after parity repair),
    False when unprotected-and-unverifiable corruption remains. Files
    with no ``.fsum`` sidecar pass trivially (nothing pinned them).

    ``intrinsic_check(path) -> bool``: the artifact format's own in-file
    integrity validation (FTVI header+slab CRC, FLXB payload CRC). A
    publisher writes sidecars BEFORE the atomic artifact rename
    (write_ftvi rationale), so a crash in that window leaves NEW
    sidecars over the OLD — fully valid — artifact bytes, permanently:
    without this check a single SIGKILL mid-compact made the root
    unopenable (kill-fuzz probe, 2026-08-18). Since the rename is
    atomic the artifact is never half-written, so "digest mismatch but
    intrinsically valid" means stale sidecars, not damage — regenerate
    them and serve. (The not-yet-truncated WAL replays the crashed
    mutation's changes; supersession keeps that idempotent.)
    """
    if not FileProtector.is_protected(path):
        return True
    if FileProtector.verify(path):
        return True
    # A failed verify may be a mid-publish window, not corruption: take
    # the mutation flock (waits out any in-flight publisher/repairer)
    # and RE-verify before touching anything (see artifact_mutation_lock)
    with artifact_mutation_lock(path):
        if FileProtector.verify(path):
            return True
        if intrinsic_check is not None:
            try:
                intact = bool(intrinsic_check(path))
            except Exception:
                intact = False
            if intact:
                logger.warning(
                    "%s: digest sidecar mismatch but artifact passes its "
                    "in-file integrity check — stale sidecars from an "
                    "interrupted publish; regenerating", path,
                )
                protect_artifact(path)
                return True
        report = ParityProtector.verify_and_repair(path)
        return bool(report.repaired_stripes) and FileProtector.verify(path)


@dataclass
class QuarantineResult:
    quarantined_to: str


class ProtectedArtifactStore:
    """Directory-level protect/verify/quarantine (FsviProtector role)."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.quarantine_dir = os.path.join(root, ".quarantine")

    def protect_all(self, names: list[str] | None = None) -> list[ProtectionReceipt]:
        receipts = []
        for name in names or self._artifact_names():
            path = os.path.join(self.root, name)
            if os.path.isfile(path):
                receipts.append(protect_artifact(path))
        return receipts

    def _artifact_names(self) -> list[str]:
        return [
            n for n in sorted(os.listdir(self.root))
            if os.path.isfile(os.path.join(self.root, n))
            and not n.endswith(SIDECAR_SUFFIX)
            and not n.endswith(PARITY_SUFFIX)
            and not n.endswith(".tmp")
        ]

    def verify_all(self) -> dict[str, bool]:
        out = {}
        for name in self._artifact_names():
            path = os.path.join(self.root, name)
            if FileProtector.is_protected(path):
                out[name] = FileProtector.verify(path)
        return out

    def quarantine(self, name: str) -> QuarantineResult:
        """Move a corrupt artifact aside instead of serving it."""
        os.makedirs(self.quarantine_dir, exist_ok=True)
        src = os.path.join(self.root, name)
        dst = os.path.join(self.quarantine_dir, name)
        shutil.move(src, dst)
        for suffix in (SIDECAR_SUFFIX, PARITY_SUFFIX):
            sidecar = src + suffix
            if os.path.exists(sidecar):
                shutil.move(sidecar, dst + suffix)
        return QuarantineResult(quarantined_to=dst)

    def open_verified(
        self,
        name: str,
        *,
        rebuild: Callable[[], None] | None = None,
    ) -> str:
        """Verify-then-REPAIR-then-open (tantivy_wrapper.rs:1-15
        verify-and-repair-on-open contract).

        Ladder: digest ok -> open. Mismatch -> parity-stripe repair; on
        success re-verify and open. Unrepairable -> quarantine, then the
        ``rebuild`` callback (e.g. re-embed from WAL + storage) gets one
        shot to regenerate the artifact; only if that also fails (or no
        callback) does this raise ``IndexCorrupted``.
        """
        path = os.path.join(self.root, name)
        if not FileProtector.is_protected(path) or FileProtector.verify(path):
            return path
        report = ParityProtector.verify_and_repair(path)
        if report.repaired_stripes and FileProtector.verify(path):
            return path
        self.quarantine(name)
        if rebuild is not None:
            rebuild()
            if os.path.exists(path) and (
                not FileProtector.is_protected(path) or FileProtector.verify(path)
            ):
                return path
        raise IndexCorrupted(
            f"{name} failed durability verification; parity repair "
            f"{'recovered ' + str(len(report.repaired_stripes)) + ' stripes but digest still mismatched' if report.repaired_stripes else 'could not recover (' + (report.detail or 'no parity sidecar') + ')'}; quarantined"
        )

    def repair_all(self) -> dict[str, RepairReport]:
        """Run parity verify-and-repair over every protected artifact
        (healing stale-sidecar publish remnants first — doctor --repair
        must not report a bit-perfect artifact as unrepairable)."""
        out: dict[str, RepairReport] = {}
        for name in self._artifact_names():
            path = os.path.join(self.root, name)
            if ParityProtector.is_protected(path):
                with artifact_mutation_lock(path):
                    if heal_stale_sidecars(path):
                        out[name] = RepairReport(
                            ok=True, detail="sidecars regenerated (stale publish remnant)"
                        )
                        continue
                    out[name] = ParityProtector.verify_and_repair(path)
        return out
