"""Leak-free atomic file publication.

Reference parity: frankensearch publishes every small metadata artifact
(CURRENT pointers, heartbeats, receipts) via write-tmp + rename with the
tmp cleaned up on failure (crates/frankensearch-quill/src/keeper.rs
publish_current; crates/frankensearch-fsfs/src/lifecycle.rs). A staged
tmp leaked on ENOSPC is worse than a failed write: on a full disk the
debris itself wedges every retry, and the generation census must
special-case it forever.

The big artifact writers (fsvi/flexb/persist/durability) carry their own
staged-write cleanup because they also manage sidecars; this helper is
for the dozens of small JSON/pointer writers.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

__all__ = ["atomic_write_text", "atomic_write_bytes"]

# mkstemp creates 0600 files; published artifacts (heartbeats, leases,
# manifests) must keep the umask-default permissions a plain open() gives,
# or cross-user/cross-process readers lose access (ADVICE r3). Capture the
# umask once — os.umask is the only query API and it is process-global.
_UMASK = os.umask(0)
os.umask(_UMASK)


def _publish(path: str, data: bytes, fsync: bool) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".stage.", suffix=".tmp")
    try:
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_text(path: str, text: str, *, fsync: bool = False) -> None:
    """Stage + rename ``text`` into ``path``; never leaks the tmp."""
    _publish(path, text.encode("utf-8"), fsync)


def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = False) -> None:
    """Stage + rename ``data`` into ``path``; never leaks the tmp."""
    _publish(path, data, fsync)
