"""Stable file identity + confined path admission.

Parity targets (reference crates/frankensearch-index):
- src/file_identity.rs — stable identity as (device, inode), surviving
  renames and detecting replaced-under-us files;
- src/generation_root.rs — descriptor-relative admission of generation
  roots: every artifact path must resolve INSIDE the root with no
  symlink escape (capability-style confinement; openat semantics
  approximated with realpath containment checks).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from frankensearch_tpu_torch.core.errors import SearchError


class PathEscape(SearchError):
    code = "path_escape"


@dataclass(frozen=True)
class FileIdentity:
    device: int
    inode: int
    size: int
    mtime_ns: int

    @staticmethod
    def of(path: str) -> "FileIdentity":
        st = os.stat(path)
        return FileIdentity(
            device=st.st_dev, inode=st.st_ino, size=st.st_size, mtime_ns=st.st_mtime_ns
        )

    def same_file(self, other: "FileIdentity") -> bool:
        """Same underlying file object (rename-stable)."""
        return self.device == other.device and self.inode == other.inode

    def unchanged(self, other: "FileIdentity") -> bool:
        return self.same_file(other) and self.size == other.size and self.mtime_ns == other.mtime_ns


class LockHeld(SearchError):
    code = "writer_lock_held"


class ConfinedRoot:
    """Admits only paths that resolve inside the root. All artifact opens
    in a generation go through this.

    Two enforcement layers (generation_root.rs openat semantics):

    - ``resolve``: realpath containment (string-level, portable);
    - ``open_fd`` / ``open_bytes``: DESCRIPTOR-RELATIVE component walk —
      the root is held as a directory fd and every path component is
      opened with ``dir_fd`` + ``O_NOFOLLOW``, so a symlink planted at
      ANY depth (even one racing a check) can never redirect the open
      outside the capability. Mount crossings inside the root are
      refused too (st_dev must not change mid-walk), matching the
      reference's per-filesystem policy boundary.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.realpath(root)
        if not os.path.isdir(self.root):
            raise SearchError(f"confined root is not a directory: {root}")
        self._root_fd = os.open(self.root, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        self._root_dev = os.fstat(self._root_fd).st_dev

    def close(self) -> None:
        if getattr(self, "_root_fd", -1) >= 0:
            os.close(self._root_fd)
            self._root_fd = -1

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except OSError:
            pass

    def resolve(self, relative: str) -> str:
        if os.path.isabs(relative):
            raise PathEscape(f"absolute path not admitted: {relative}")
        candidate = os.path.realpath(os.path.join(self.root, relative))
        if candidate != self.root and not candidate.startswith(self.root + os.sep):
            raise PathEscape(f"path escapes generation root: {relative}")
        return candidate

    def open_fd(self, relative: str, flags: int = os.O_RDONLY) -> int:
        """Capability-style open: component-wise, descriptor-relative,
        O_NOFOLLOW at every step. Returns an open fd; caller closes."""
        if os.path.isabs(relative):
            raise PathEscape(f"absolute path not admitted: {relative}")
        parts = [p for p in relative.split(os.sep) if p not in ("", ".")]
        if any(p == ".." for p in parts):
            raise PathEscape(f"'..' traversal not admitted: {relative}")
        if not parts:
            raise PathEscape("empty path")
        fd = self._root_fd
        opened: list[int] = []
        try:
            for i, part in enumerate(parts):
                last = i == len(parts) - 1
                step_flags = (flags if last else os.O_RDONLY) | os.O_NOFOLLOW
                if not last:
                    step_flags |= getattr(os, "O_DIRECTORY", 0)
                try:
                    nxt = os.open(part, step_flags, dir_fd=fd)
                except OSError as e:
                    import errno as _errno

                    # O_NOFOLLOW on a symlink: ELOOP for a final
                    # component, ENOTDIR when O_DIRECTORY is also set
                    # (symlink in directory position) — both are escapes
                    if e.errno in (_errno.ELOOP, _errno.ENOTDIR):
                        try:
                            is_link = os.path.islink(
                                os.path.join(self.root, *parts[: i + 1])
                            )
                        except OSError:
                            is_link = False
                        if is_link or e.errno == _errno.ELOOP:
                            raise PathEscape(
                                f"symlink in confined path refused: "
                                f"{relative!r} at {part!r}"
                            ) from None
                    raise
                opened.append(nxt)
                if os.fstat(nxt).st_dev != self._root_dev:
                    raise PathEscape(
                        f"mount crossing inside generation root refused: {relative!r}"
                    )
                fd = nxt
            final = opened.pop()
            return final
        finally:
            for h in opened:
                os.close(h)

    def open_bytes(self, relative: str) -> bytes:
        fd = self.open_fd(relative)
        try:
            with os.fdopen(fd, "rb", closefd=False) as f:
                return f.read()
        finally:
            os.close(fd)

    def exists(self, relative: str) -> bool:
        try:
            return os.path.exists(self.resolve(relative))
        except PathEscape:
            return False


class WriterLock:
    """Kernel-enforced cross-process writer exclusion via ``flock``
    (generation_root.rs flock guards / quill keeper WRITER_LOCK role).

    Unlike the timeout-based PublicationLease, an flock vanishes the
    instant its holder dies — no stale window. The lock file carries
    pid/host metadata for the diagnostics path only.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._fd: int | None = None

    def acquire(self) -> "WriterLock":
        import fcntl
        import socket

        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            holder = ""
            try:
                with os.fdopen(os.dup(fd), "r") as f:
                    holder = f.read().strip()
            except OSError:
                pass
            os.close(fd)
            raise LockHeld(
                f"writer lock {self.path} held"
                + (f" by {holder}" if holder else "")
            ) from None
        os.ftruncate(fd, 0)
        os.write(fd, f"pid={os.getpid()} host={socket.gethostname()}".encode())
        os.fsync(fd)
        self._fd = fd
        return self

    def release(self) -> None:
        if self._fd is not None:
            import fcntl

            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "WriterLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass(frozen=True)
class FilesystemPolicy:
    """Per-filesystem durability policy (generation_root.rs ext4/Btrfs/
    APFS policies, fsfs mount_info.rs network-mount heuristics)."""

    fs_type: str
    local: bool
    durable_rename: bool  #: atomic os.replace + fsync honored
    flock_reliable: bool
    advice: str = ""


_NETWORK_FS = {"nfs", "nfs4", "cifs", "smbfs", "sshfs", "fuse.sshfs", "9p", "afs"}
_LOCAL_DURABLE = {"ext4", "ext3", "ext2", "btrfs", "xfs", "zfs", "apfs", "f2fs",
                  "tmpfs", "overlay", "overlayfs", "ramfs"}


def filesystem_policy(path: str) -> FilesystemPolicy:
    """Classify the filesystem under ``path`` (best effort: /proc/mounts
    longest-prefix match on Linux; unknown types default to local with a
    caveat rather than refusing)."""
    real = os.path.realpath(path)
    fs_type = "unknown"
    try:
        best = ""
        with open("/proc/mounts", encoding="utf-8") as f:
            for line in f:
                fields = line.split()
                if len(fields) < 3:
                    continue
                mnt, typ = fields[1], fields[2]
                if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best):
                    best, fs_type = mnt, typ
    except OSError:
        pass
    if fs_type in _NETWORK_FS or fs_type.startswith("fuse"):
        return FilesystemPolicy(
            fs_type=fs_type, local=False, durable_rename=False, flock_reliable=False,
            advice="network/FUSE filesystem: atomic-rename and flock semantics "
                   "are not guaranteed; generations should live on local storage",
        )
    return FilesystemPolicy(
        fs_type=fs_type,
        local=True,
        durable_rename=True,
        flock_reliable=True,
        advice="" if fs_type in _LOCAL_DURABLE else f"unrecognized fs {fs_type!r}: treated as local",
    )
