"""Process lifecycle: PID files, health checks, cross-process leases.

Parity target: reference crates/frankensearch-fsfs/src/lifecycle.rs —
daemon PID files, health checks, and ``PublicationLease``: a
cross-process mutex guarding index publication (O_EXCL lease file with
pid + heartbeat; stale leases from dead processes are reclaimable).
"""

from __future__ import annotations

import errno
import json
import os
import time
from dataclasses import dataclass

from frankensearch_tpu_torch.core.errors import SearchError
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text


class LeaseHeld(SearchError):
    code = "lease_held"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


@dataclass
class PidFile:
    path: str

    def write(self) -> None:
        with open(self.path, "w", encoding="utf-8") as f:
            f.write(str(os.getpid()))

    def read(self) -> int | None:
        try:
            with open(self.path, encoding="utf-8") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def is_running(self) -> bool:
        pid = self.read()
        return pid is not None and _pid_alive(pid)

    def remove(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


class PublicationLease:
    """Cross-process mutex via O_EXCL lease file + stale reclaim."""

    def __init__(self, path: str, *, stale_after_s: float = 60.0) -> None:
        self.path = path
        self.stale_after_s = stale_after_s
        self._held = False

    def acquire(self) -> "PublicationLease":
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    json.dump({"pid": os.getpid(), "at": time.time()}, f)
                self._held = True
                return self
            except OSError as e:
                if e.errno != errno.EEXIST:
                    raise
                if not self._try_reclaim():
                    holder = self._read()
                    raise LeaseHeld(
                        f"publication lease held by pid {holder.get('pid')}"
                        if holder else "publication lease held"
                    )
                # reclaimed: loop and try to take it

    def _read(self) -> dict | None:
        try:
            with open(self.path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _try_reclaim(self) -> bool:
        """Remove the lease if its holder is dead or it's past stale_after."""
        holder = self._read()
        if holder is None:
            try:
                os.remove(self.path)
                return True
            except FileNotFoundError:
                return True
            except OSError:
                return False
        dead = not _pid_alive(int(holder.get("pid", -1)))
        stale = time.time() - float(holder.get("at", 0)) > self.stale_after_s
        if dead or stale:
            try:
                os.remove(self.path)
                return True
            except FileNotFoundError:
                return True
            except OSError:
                return False
        return False

    def heartbeat(self) -> None:
        if self._held:
            atomic_write_text(
                self.path, json.dumps({"pid": os.getpid(), "at": time.time()})
            )

    def release(self) -> None:
        if self._held:
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
            self._held = False

    def __enter__(self) -> "PublicationLease":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass
class HealthCheck:
    """Composable health check for daemon/serve modes."""

    name: str
    check: "callable"  # -> (ok: bool, detail: str)

    def run(self) -> dict:
        try:
            ok, detail = self.check()
        except Exception as e:
            ok, detail = False, f"{type(e).__name__}: {e}"
        return {"check": self.name, "ok": bool(ok), "detail": detail}


def run_health_checks(checks: list[HealthCheck]) -> dict:
    results = [c.run() for c in checks]
    return {"healthy": all(r["ok"] for r in results), "checks": results}
