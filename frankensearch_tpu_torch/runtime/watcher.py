"""Filesystem watcher: poll -> debounce -> classify -> batch.

Parity target: reference crates/frankensearch-fsfs/src/watcher.rs —
notify-based FS events with 500 ms debounce, discovery-policy
classification, pressure-adaptive batching, and snapshot diff for crash
catch-up (:1-8). This implementation polls mtimes (no inotify dependency)
and persists a JSON snapshot so a restart emits exactly the changes that
happened while it was down.
"""

from __future__ import annotations

import json
import os
import stat
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

DEFAULT_DEBOUNCE_S = 0.5

_TEXT_EXTS = {
    ".txt", ".md", ".rst", ".py", ".rs", ".c", ".cc", ".cpp", ".h", ".hpp",
    ".js", ".ts", ".tsx", ".go", ".java", ".rb", ".toml", ".yaml", ".yml", ".json",
    # NDJSON corpus batches: the CLI's own `index` format must be
    # watchable too (cmd_watch explodes these into per-record docs)
    ".jsonl", ".ndjson",
}
_SKIP_DIRS = {
    ".git", ".hg", "__pycache__", "node_modules", ".venv", "target",
    # high-cost artifact contract (runtime/high_cost.py;
    # high_cost_artifact.rs): vendor + transient build trees skip
    "vendor", "third_party", ".cargo", "build", "dist", ".cache",
}
MAX_FILE_BYTES = 2_000_000  # giant-file skip (fsfs file_classification.rs)


@dataclass(frozen=True)
class RenameMovePolicy:
    """Rename/move detection contract (incremental_change.rs:169
    RenameMovePolicy defaults): identity keys inode + content hash,
    same-device renames preserve identity, cross-device moves need a
    hash confirm. The digest is a sha256 over the first 4096 bytes
    (incremental_change.rs:151 HashPolicy sample_prefix_bytes)."""

    identity_keys: tuple[str, ...] = ("inode", "content_hash")
    same_device_rename_preserves_identity: bool = True
    cross_device_move: str = "hash_confirm"
    sample_prefix_bytes: int = 4096


@dataclass(frozen=True)
class FileChange:
    path: str
    kind: str  # "created" | "modified" | "deleted" | "renamed"
    size: int = 0
    mtime: float = 0.0
    #: identity evidence for rename pairing (incremental_change.rs)
    ino: int = -1
    dev: int = -1
    digest: str = ""
    #: set only on kind == "renamed": the old path
    rename_from: str = ""


@dataclass(frozen=True)
class SkipReason:
    path: str
    reason: str  # "binary_ext"|"too_large"|"unreadable"|"symlink"|"special"


@dataclass
class ScanResult:
    changes: list[FileChange] = field(default_factory=list)
    skipped: list[SkipReason] = field(default_factory=list)


RENAME_POLICY = RenameMovePolicy()


def _prefix_digest(path: str, n_bytes: int) -> str:
    """sha256 over the first ``n_bytes`` (HashPolicy sample prefix);
    hang-proof against FIFOs, "" when unreadable."""
    import hashlib

    try:
        fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
    except OSError:
        return ""
    try:
        if not stat.S_ISREG(os.fstat(fd).st_mode):
            return ""
        return hashlib.sha256(os.read(fd, n_bytes)).hexdigest()[:16]
    except OSError:
        return ""
    finally:
        os.close(fd)


def _classify(path: str) -> str | None:
    """None = indexable, else a skip reason (discovery policy)."""
    try:
        st = os.lstat(path)
    except OSError:
        return "unreadable"
    if stat.S_ISLNK(st.st_mode):
        return "symlink"
    if not stat.S_ISREG(st.st_mode):
        # FIFOs/sockets/devices: a FIFO named data.txt passes the
        # extension check and a plain open() for read BLOCKS until a
        # writer appears — one mkfifo in a watched dir wedged the whole
        # watch loop forever (probed 2026-08-18)
        return "special"
    ext = os.path.splitext(path)[1].lower()
    if ext not in _TEXT_EXTS:
        return "binary_ext"
    if st.st_size > MAX_FILE_BYTES:
        return "too_large"
    return None


def open_regular_text(path: str, *, encoding: str = "utf-8", errors: str = "ignore"):
    """Open ``path`` for text reading ONLY if it is a regular file,
    without ever blocking. O_NONBLOCK makes the open itself hang-proof
    against FIFOs; fstat on the fd (not the path) closes the
    classify->open TOCTOU — a file swapped for a FIFO after
    classification still cannot wedge the reader. Reads on regular
    files ignore O_NONBLOCK, so the returned handle behaves normally.
    Raises OSError for any non-regular file."""
    import errno

    fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
    try:
        if not stat.S_ISREG(os.fstat(fd).st_mode):
            raise OSError(errno.ESPIPE, "not a regular file", path)
    except BaseException:
        os.close(fd)
        raise
    return os.fdopen(fd, encoding=encoding, errors=errors)


class SnapshotWatcher:
    """Polling watcher with a persistent snapshot for crash catch-up."""

    def __init__(
        self,
        roots: Iterable[str],
        snapshot_path: str,
        *,
        debounce_s: float = DEFAULT_DEBOUNCE_S,
        clock: Callable[[], float] = time.monotonic,
        mount_table=None,
    ) -> None:
        self.roots = [os.path.abspath(r) for r in roots]
        self.snapshot_path = snapshot_path
        self.debounce_s = debounce_s
        self.clock = clock
        self._snapshot: dict[str, tuple[float, int]] = {}
        self._pending: dict[str, FileChange] = {}
        self._pending_since: float = 0.0
        # per-mount policy (mount_info.rs): roots on disabled mounts are
        # dropped with a warning; the slowest root's poll interval is the
        # recommended cadence for the caller's loop
        self.mount_warnings: list[str] = []
        self.recommended_poll_s: float | None = None
        if mount_table is not None:
            kept = []
            for root in self.roots:
                hit = mount_table.lookup(root)
                if hit is None:
                    kept.append(root)
                    continue
                entry, policy = hit
                if not policy.enabled or not policy.available:
                    self.mount_warnings.append(
                        f"skipping {root}: {entry.fstype} mount "
                        f"{entry.mount_point} is "
                        f"{'disabled' if not policy.enabled else 'unavailable'}"
                    )
                    continue
                if entry.category.is_network:
                    self.mount_warnings.append(
                        f"{root} is on a network mount ({entry.fstype}): "
                        f"polling every {policy.poll_interval_s:.0f}s"
                    )
                if policy.change_detection.value == "poll":
                    self.recommended_poll_s = max(
                        self.recommended_poll_s or 0.0, policy.poll_interval_s
                    )
                kept.append(root)
            self.roots = kept
        self._load_snapshot()

    # -- snapshot persistence (crash catch-up) ------------------------------

    def _load_snapshot(self) -> None:
        if os.path.exists(self.snapshot_path):
            try:
                with open(self.snapshot_path, encoding="utf-8") as f:
                    raw = json.load(f)
                # legacy 2-field [mtime, size] entries upgrade in place:
                # identity fields refresh on the next stat of each file
                self._snapshot = {
                    k: (
                        v[0], v[1],
                        int(v[2]) if len(v) > 2 else -1,
                        int(v[3]) if len(v) > 3 else -1,
                        str(v[4]) if len(v) > 4 else "",
                    )
                    for k, v in raw.items()
                }
            except (json.JSONDecodeError, OSError, TypeError, IndexError):
                self._snapshot = {}

    def persist_snapshot(self) -> None:
        atomic_write_text(
            self.snapshot_path,
            json.dumps({k: list(v) for k, v in self._snapshot.items()}),
        )

    # -- scanning ---------------------------------------------------------------

    def scan(self) -> ScanResult:
        """One poll cycle: diff the filesystem against the snapshot."""
        result = ScanResult()
        seen: set[str] = set()
        for root in self.roots:
            for dirpath, dirnames, files in os.walk(root):
                dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
                for name in files:
                    full = os.path.join(dirpath, name)
                    reason = _classify(full)
                    if reason is not None:
                        if full in self._snapshot:
                            # previously indexed, now unreadable/oversized
                            result.changes.append(FileChange(path=full, kind="deleted"))
                            del self._snapshot[full]
                        else:
                            result.skipped.append(SkipReason(path=full, reason=reason))
                        continue
                    seen.add(full)
                    try:
                        st = os.stat(full)
                    except OSError:
                        continue
                    prev = self._snapshot.get(full)
                    if prev is None or prev[:2] != (st.st_mtime, st.st_size):
                        digest = _prefix_digest(full, RENAME_POLICY.sample_prefix_bytes)
                        change = FileChange(
                            full,
                            "created" if prev is None else "modified",
                            st.st_size, st.st_mtime,
                            ino=st.st_ino, dev=st.st_dev, digest=digest,
                        )
                        result.changes.append(change)
                        self._snapshot[full] = (
                            st.st_mtime, st.st_size, st.st_ino, st.st_dev, digest
                        )
                    elif prev[2] == -1:
                        # legacy snapshot entry: learn identity silently
                        self._snapshot[full] = (
                            prev[0], prev[1], st.st_ino, st.st_dev,
                            _prefix_digest(full, RENAME_POLICY.sample_prefix_bytes),
                        )
        for path in list(self._snapshot):
            if path not in seen and any(path.startswith(r + os.sep) for r in self.roots):
                old = self._snapshot.pop(path)
                # deleted events carry the old identity so a later-seen
                # create can pair into a rename (incremental_change.rs)
                result.changes.append(FileChange(
                    path=path, kind="deleted", size=old[1],
                    ino=old[2], dev=old[3], digest=old[4],
                ))
        return result

    @staticmethod
    def _pair_renames(batch: list[FileChange]) -> list[FileChange]:
        """Collapse delete+create pairs with matching identity into one
        rename event. Same-device: inode match preserves identity
        (RenameMovePolicy.same_device_rename_preserves_identity);
        cross-device: size + prefix-hash confirm (cross_device_move =
        hash_confirm). Content must be unchanged (equal digests) — a
        move-and-edit stays a delete+create so downstream re-embeds."""
        deletes = [c for c in batch if c.kind == "deleted"]
        if not deletes:
            return batch
        out: list[FileChange] = []
        unclaimed = {id(c): c for c in deletes}

        def match(create: FileChange) -> FileChange | None:
            cands = [
                d for d in unclaimed.values()
                if d.digest and d.digest == create.digest and d.size == create.size
            ]
            if not cands:
                return None
            # prefer the inode-identical candidate (same-device rename);
            # otherwise any hash-confirmed one, deterministically
            same = [
                d for d in cands
                if d.ino != -1 and d.ino == create.ino and d.dev == create.dev
            ]
            return min(same or cands, key=lambda c: c.path)

        for c in batch:
            if c.kind != "created":
                continue
            d = match(c)
            if d is not None:
                del unclaimed[id(d)]
                out.append(FileChange(
                    path=c.path, kind="renamed", size=c.size, mtime=c.mtime,
                    ino=c.ino, dev=c.dev, digest=c.digest,
                    rename_from=d.path,
                ))
            else:
                out.append(c)
        out.extend(c for c in batch if c.kind == "modified")
        out.extend(c for c in batch if c.kind == "deleted" and id(c) in unclaimed)
        return out

    # -- debounced batching ------------------------------------------------------

    def poll(self) -> list[FileChange] | None:
        """Scan and debounce: changes are held for debounce_s of quiet
        before being released as one batch (watcher.rs 500 ms debounce)."""
        now = self.clock()
        result = self.scan()
        for c in result.changes:
            self._pending[c.path] = c  # latest change per path wins
            self._pending_since = now
        if not self._pending:
            return None
        if now - self._pending_since >= self.debounce_s or not result.changes:
            batch = self._pair_renames(list(self._pending.values()))
            self._pending.clear()
            self.persist_snapshot()
            return batch
        return None
