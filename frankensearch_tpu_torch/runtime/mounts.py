"""Mount-aware indexing policies.

Parity target: reference crates/frankensearch-fsfs/src/mount_info.rs —
classify the filesystem under each corpus root (/proc/mounts) and apply
per-mount behavioral policy: filesystem category taxonomy (:19), default
policies per category with change-detection strategy / stat timeout /
io-concurrency / poll interval (:138-252), user overrides (:252),
longest-prefix MountTable lookup + availability marking (:294-420),
availability probing (:441), transient-vs-permanent I/O error
classification (:508), and octal-unescaping /proc/mounts parsing (:526).

The coarse INDEX/WARN/SKIP surface (``classify_fs``/``mount_info_for``)
is kept for the CLI doctor path; the full model below drives discovery.
"""

from __future__ import annotations

import enum
import os
import re
import time
from dataclasses import dataclass, replace

_NETWORK_FS = {"nfs", "nfs4", "cifs", "smbfs", "sshfs", "fuse.sshfs", "9p", "glusterfs", "ceph"}
_PSEUDO_FS = {"proc", "sysfs", "devtmpfs", "devpts", "cgroup", "cgroup2", "tmpfs-run",
              "debugfs", "tracefs", "securityfs", "bpf", "mqueue", "hugetlbfs"}


class MountPolicy(enum.Enum):
    INDEX = "index"
    WARN = "warn"  # indexable but with a performance warning
    SKIP = "skip"


@dataclass(frozen=True)
class MountInfo:
    mount_point: str
    fs_type: str
    policy: MountPolicy
    reason: str = ""


def _read_mounts(path: str = "/proc/mounts") -> list[tuple[str, str]]:
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    out.append((parts[1], parts[2]))  # (mount_point, fs_type)
    except OSError:
        pass
    return out


def classify_fs(fs_type: str) -> tuple[MountPolicy, str]:
    base = fs_type.split(".")[0]
    if fs_type in _PSEUDO_FS or base in _PSEUDO_FS:
        return MountPolicy.SKIP, f"pseudo filesystem {fs_type}"
    if fs_type in _NETWORK_FS or base in _NETWORK_FS:
        return MountPolicy.WARN, f"network filesystem {fs_type}: polling is expensive"
    if base == "fuse" or fs_type.startswith("fuse."):
        return MountPolicy.WARN, f"FUSE filesystem {fs_type}"
    return MountPolicy.INDEX, ""


def mount_info_for(path: str, mounts: list[tuple[str, str]] | None = None) -> MountInfo:
    """Policy for the mount containing ``path`` (longest-prefix match)."""
    path = os.path.realpath(path)
    mounts = mounts if mounts is not None else _read_mounts()
    best: tuple[str, str] = ("/", "unknown")
    for mp, fs in mounts:
        if (path == mp or path.startswith(mp.rstrip("/") + "/")) and len(mp) >= len(best[0]):
            best = (mp, fs)
    policy, reason = classify_fs(best[1])
    return MountInfo(mount_point=best[0], fs_type=best[1], policy=policy, reason=reason)


# -- full per-mount policy model (mount_info.rs parity) ------------------------


class FsCategory(enum.Enum):
    LOCAL = "local"
    NFS = "nfs"
    SSHFS = "sshfs"
    FUSE = "fuse"
    CIFS = "cifs"
    MEMORY = "memory"
    VIRTUAL = "virtual"
    UNKNOWN = "unknown"

    @property
    def is_network(self) -> bool:
        return self in (FsCategory.NFS, FsCategory.SSHFS, FsCategory.FUSE, FsCategory.CIFS)

    @property
    def is_virtual(self) -> bool:
        return self is FsCategory.VIRTUAL

    @property
    def supports_reliable_watch(self) -> bool:
        """inotify-class change events can only be trusted on local/memory
        filesystems (mount_info.rs supports_reliable_watch)."""
        return self in (FsCategory.LOCAL, FsCategory.MEMORY)


_LOCAL_FS = {
    "ext2", "ext3", "ext4", "xfs", "btrfs", "zfs", "f2fs", "reiserfs", "jfs",
    "nilfs2", "bcachefs", "apfs", "hfs", "hfsplus", "ntfs", "ntfs3", "vfat",
    "fat32", "exfat",
}
_NFS_FS = {"nfs", "nfs4", "nfsd"}
_CIFS_FS = {"cifs", "smb", "smb2", "smbfs"}
_MEMORY_FS = {"tmpfs", "ramfs"}
_VIRTUAL_FS = {
    "proc", "sysfs", "devtmpfs", "devpts", "securityfs", "cgroup", "cgroup2",
    "pstore", "debugfs", "tracefs", "hugetlbfs", "mqueue", "configfs",
    "efivarfs", "binfmt_misc", "fusectl", "autofs", "bpf", "nsfs", "overlay",
}


def classify_fstype(fstype: str) -> FsCategory:
    if fstype in _LOCAL_FS:
        return FsCategory.LOCAL
    if fstype in _NFS_FS:
        return FsCategory.NFS
    if fstype in _CIFS_FS:
        return FsCategory.CIFS
    if fstype in _MEMORY_FS:
        return FsCategory.MEMORY
    if fstype in _VIRTUAL_FS:
        return FsCategory.VIRTUAL
    if fstype == "fuse.sshfs":
        return FsCategory.SSHFS
    if fstype in ("fuse", "fuseblk") or fstype.startswith("fuse."):
        return FsCategory.FUSE
    return FsCategory.UNKNOWN


class ChangeDetection(enum.Enum):
    WATCH = "watch"  # real-time inotify-class events
    POLL = "poll"  # periodic rescan
    STATIC = "static"  # index once, never monitor


@dataclass(frozen=True)
class MountEntry:
    device: str
    mount_point: str
    fstype: str
    category: FsCategory
    options: str = ""


@dataclass
class FullMountPolicy:
    """Per-mount behavior knobs the discovery walker obeys
    (mount_info.rs MountPolicy; defaults per category :157-252)."""

    change_detection: ChangeDetection
    stat_timeout_s: float
    max_concurrent_io: int
    poll_interval_s: float
    enabled: bool = True
    available: bool = True

    @classmethod
    def for_category(cls, category: FsCategory) -> "FullMountPolicy":
        if category in (FsCategory.LOCAL, FsCategory.MEMORY):
            return cls(ChangeDetection.WATCH, 5.0, 64, 300.0)
        if category is FsCategory.NFS:
            return cls(ChangeDetection.POLL, 2.0, 8, 60.0)
        if category is FsCategory.SSHFS:
            return cls(ChangeDetection.POLL, 5.0, 4, 120.0)
        if category is FsCategory.CIFS:
            return cls(ChangeDetection.POLL, 2.0, 8, 60.0)
        if category is FsCategory.VIRTUAL:
            return cls(ChangeDetection.STATIC, 0.5, 1, 3600.0, enabled=False)
        # FUSE and UNKNOWN get the conservative FUSE defaults
        return cls(ChangeDetection.POLL, 3.0, 4, 120.0)


@dataclass(frozen=True)
class MountOverride:
    """User-supplied per-mount override (config file `[mounts."/path"]`)."""

    category: FsCategory | None = None
    change_detection: ChangeDetection | None = None
    stat_timeout_s: float | None = None
    max_concurrent_io: int | None = None
    poll_interval_s: float | None = None
    enabled: bool | None = None

    def apply(self, base: FullMountPolicy) -> FullMountPolicy:
        out = replace(base)
        for attr in (
            "change_detection", "stat_timeout_s", "max_concurrent_io",
            "poll_interval_s", "enabled",
        ):
            v = getattr(self, attr)
            if v is not None:
                setattr(out, attr, v)
        return out


_OCTAL_ESC = re.compile(r"\\([0-7]{3})")


def _unescape_octal(s: str) -> str:
    """/proc/mounts escapes space/tab/newline/backslash as \\0NN."""
    return _OCTAL_ESC.sub(lambda m: chr(int(m.group(1), 8)), s)


def parse_proc_mounts(content: str) -> list[MountEntry]:
    entries = []
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 4:
            continue
        fstype = parts[2]
        entries.append(
            MountEntry(
                device=_unescape_octal(parts[0]),
                mount_point=_unescape_octal(parts[1]),
                fstype=fstype,
                category=classify_fstype(fstype),
                options=parts[3],
            )
        )
    return entries


def read_system_mounts(path: str = "/proc/mounts") -> list[MountEntry]:
    try:
        with open(path, encoding="utf-8") as f:
            return parse_proc_mounts(f.read())
    except OSError:
        return []


class MountTable:
    """Mount entries + effective policies with longest-prefix lookup and
    availability marking (mount_info.rs MountTable)."""

    def __init__(
        self,
        entries: list[MountEntry],
        overrides: dict[str, MountOverride] | None = None,
    ) -> None:
        overrides = overrides or {}
        self._entries: list[MountEntry] = []
        self._policies: dict[str, FullMountPolicy] = {}
        for entry in entries:
            ovr = overrides.get(entry.mount_point)
            if ovr is not None and ovr.category is not None:
                entry = replace(entry, category=ovr.category)
            policy = FullMountPolicy.for_category(entry.category)
            if ovr is not None:
                policy = ovr.apply(policy)
            self._entries.append(entry)
            self._policies[entry.mount_point] = policy

    @classmethod
    def system(cls, overrides: dict[str, MountOverride] | None = None) -> "MountTable":
        return cls(read_system_mounts(), overrides)

    def entries(self) -> list[MountEntry]:
        return list(self._entries)

    def policy_for(self, mount_point: str) -> FullMountPolicy | None:
        return self._policies.get(mount_point)

    def lookup(self, path: str) -> tuple[MountEntry, FullMountPolicy] | None:
        """Longest-prefix mount containing ``path``."""
        best: tuple[MountEntry, FullMountPolicy] | None = None
        best_len = -1
        for entry in self._entries:
            mp = entry.mount_point
            if path == mp or path.startswith(mp.rstrip("/") + "/") or mp == "/":
                if len(mp) > best_len:
                    policy = self._policies.get(mp)
                    if policy is not None:
                        best = (entry, policy)
                        best_len = len(mp)
        return best

    def network_mounts(self) -> list[MountEntry]:
        return [e for e in self._entries if e.category.is_network]

    def enabled_mounts(self) -> list[tuple[MountEntry, FullMountPolicy]]:
        return [
            (e, self._policies[e.mount_point])
            for e in self._entries
            if self._policies[e.mount_point].enabled
            and self._policies[e.mount_point].available
        ]

    def mark_unavailable(self, mount_point: str) -> bool:
        p = self._policies.get(mount_point)
        if p is None:
            return False
        p.available = False
        return True

    def mark_available(self, mount_point: str) -> bool:
        p = self._policies.get(mount_point)
        if p is None:
            return False
        p.available = True
        return True


@dataclass(frozen=True)
class ProbeResult:
    mount_point: str
    available: bool
    latency_s: float
    error: str | None = None


class IoErrorClass(enum.Enum):
    TRANSIENT = "transient"  # network hiccup / busy — may recover
    PERMANENT = "permanent"  # gone / denied — stop retrying


def classify_io_error(err: OSError) -> IoErrorClass:
    """Permanent only when the mount itself is gone or forbidden; default
    transient (safer: never treat a blip as data deletion)."""
    import errno

    if isinstance(err, (FileNotFoundError, PermissionError)):
        return IoErrorClass.PERMANENT
    if err.errno in (errno.ENOENT, errno.EACCES, errno.EPERM):
        return IoErrorClass.PERMANENT
    return IoErrorClass.TRANSIENT


def probe_mount(mount_point: str, timeout_s: float) -> ProbeResult:
    """One stat against the mount root; slow stats count as unavailable
    (the table's mark_unavailable hook drives skip-and-retry)."""
    t0 = time.monotonic()
    try:
        os.stat(mount_point)
    except OSError as e:
        return ProbeResult(
            mount_point=mount_point,
            available=False,
            latency_s=time.monotonic() - t0,
            error=f"{classify_io_error(e).value}: {e}",
        )
    latency = time.monotonic() - t0
    if latency >= timeout_s:
        return ProbeResult(
            mount_point=mount_point,
            available=False,
            latency_s=latency,
            error=f"stat latency {latency*1e3:.0f}ms exceeds timeout {timeout_s*1e3:.0f}ms",
        )
    return ProbeResult(mount_point=mount_point, available=True, latency_s=latency)
