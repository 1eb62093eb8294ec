"""Install lifecycle: self-update + uninstall transactions.

Parity: reference crates/frankensearch-fsfs/src/runtime.rs:4257-4460
(``run_update_command`` / ``collect_update_payload``: semver gate,
check-only mode, refuse-unverified-bytes checksum ladder, rollback) and
runtime.rs:4640-4900 (``run_uninstall_command``: target collection,
``--yes``/``--dry-run`` gate, purge-only targets, per-entry status).

The TPU build runs from a Python package, not a static binary, so "the
binary" becomes a staged release bundle under ``<root>/updates`` guarded
by an install manifest with a backup pointer: ``apply`` verifies the
asset's SHA-256 against the bundle's checksum file (refusing unverified
bytes, like the reference's SHA256SUMS ladder), promotes it to
``updates/current``, and keeps the previous staged version for
``--rollback``. The running interpreter's site-packages are never
mutated. Uninstall collects the index root, model cache, and config
surfaces as typed targets; the package itself is reported as
pip-managed and left alone.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from frankensearch_tpu_torch.core.atomic_io import atomic_write_text, atomic_write_bytes

__all__ = [
    "SemVer",
    "UpdateError",
    "LocalReleaseDir",
    "NetworkReleaseSource",
    "collect_update_payload",
    "rollback_update",
    "UninstallTarget",
    "collect_uninstall_targets",
    "run_uninstall",
]

MANIFEST_NAME = "install-manifest.json"
_SEMVER = re.compile(r"^v?(\d+)\.(\d+)\.(\d+)$")


class UpdateError(ValueError):
    """Typed update failure (maps to an error envelope at the CLI)."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code


@dataclass(frozen=True, order=True)
class SemVer:
    major: int
    minor: int
    patch: int

    @staticmethod
    def parse(raw: str) -> "SemVer":
        m = _SEMVER.match(raw.strip())
        if m is None:
            raise UpdateError("bad_version", f"cannot parse {raw!r} as semver")
        return SemVer(int(m.group(1)), int(m.group(2)), int(m.group(3)))

    def __str__(self) -> str:  # pragma: no cover - trivial
        return f"{self.major}.{self.minor}.{self.patch}"


# --------------------------------------------------------------------------
# release sources
# --------------------------------------------------------------------------


@dataclass
class LocalReleaseDir:
    """A staged release bundle on disk.

    Layout: ``release.json`` ``{"version": "...", "asset": "<filename>",
    "url": "..."?}`` next to the asset and a checksum source —
    ``SHA256SUMS`` (``<hex>  <filename>`` lines) or ``<asset>.sha256``.
    """

    path: str
    kind: str = "local"

    def release(self) -> dict:
        meta_path = os.path.join(self.path, "release.json")
        if not os.path.isfile(meta_path):
            raise UpdateError("no_release", f"no release.json under {self.path}")
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        if not isinstance(meta, dict) or "version" not in meta:
            raise UpdateError("bad_release", "release.json lacks a 'version'")
        return meta

    def asset_bytes(self, name: str) -> bytes:
        p = os.path.join(self.path, name)
        if not os.path.isfile(p):
            raise UpdateError("missing_asset", f"release asset {name!r} absent")
        with open(p, "rb") as f:
            return f.read()

    def expected_sha256(self, name: str) -> str | None:
        """SHA256SUMS first, then the per-asset sidecar (runtime.rs:4393)."""
        sums = os.path.join(self.path, "SHA256SUMS")
        if os.path.isfile(sums):
            with open(sums, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[-1].lstrip("*") == name:
                        return parts[0].lower()
        sidecar = os.path.join(self.path, name + ".sha256")
        if os.path.isfile(sidecar):
            with open(sidecar, encoding="utf-8") as f:
                tok = f.read().split()
                if tok:
                    return tok[0].lower()
        return None


@dataclass
class NetworkReleaseSource:
    """Release metadata over HTTP (zero-egress boxes get a typed error).

    Mirrors the reference's GitHub-release query (runtime.rs:4299
    ``fetch_latest_release``); the base URL must serve ``release.json``,
    the asset, and a checksum source under one prefix.
    """

    base_url: str
    timeout_s: float = 10.0
    kind: str = "network"

    def _fetch(self, name: str) -> bytes:
        url = self.base_url.rstrip("/") + "/" + name
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
                return r.read()
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise UpdateError(
                "network_unreachable",
                f"cannot fetch {name} from {self.base_url}: {e}",
            ) from e

    def release(self) -> dict:
        try:
            meta = json.loads(self._fetch("release.json").decode("utf-8"))
        except json.JSONDecodeError as e:
            raise UpdateError("bad_release", f"release.json not JSON: {e}") from e
        if not isinstance(meta, dict) or "version" not in meta:
            raise UpdateError("bad_release", "release.json lacks a 'version'")
        return meta

    def asset_bytes(self, name: str) -> bytes:
        return self._fetch(name)

    def expected_sha256(self, name: str) -> str | None:
        for src, pick in (("SHA256SUMS", True), (name + ".sha256", False)):
            try:
                text = self._fetch(src).decode("utf-8", "replace")
            except UpdateError:
                continue
            if pick:
                for line in text.splitlines():
                    parts = line.split()
                    if len(parts) >= 2 and parts[-1].lstrip("*") == name:
                        return parts[0].lower()
            else:
                tok = text.split()
                if tok:
                    return tok[0].lower()
        return None


# --------------------------------------------------------------------------
# update transaction
# --------------------------------------------------------------------------


def _read_manifest(updates_dir: str) -> dict:
    p = os.path.join(updates_dir, MANIFEST_NAME)
    if not os.path.isfile(p):
        return {}
    try:
        with open(p, encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (json.JSONDecodeError, OSError):
        return {}


def _write_manifest(updates_dir: str, manifest: dict) -> None:
    atomic_write_text(
        os.path.join(updates_dir, MANIFEST_NAME),
        json.dumps(manifest, indent=2, sort_keys=True),
        fsync=True,
    )


def collect_update_payload(
    current_version: str,
    source,
    *,
    updates_dir: str,
    check_only: bool = False,
    channel: str = "stable",
) -> dict:
    """Run the update transaction; returns the FsfsUpdatePayload shape.

    ``{current_version, latest_version, update_available, check_only,
    applied, channel, release_url, notes}`` — runtime.rs:4286.
    """
    notes: list[str] = []
    current = SemVer.parse(current_version)

    meta = source.release()
    latest = SemVer.parse(str(meta["version"]))
    release_url = meta.get("url")
    payload = {
        "current_version": str(current),
        "latest_version": str(latest),
        "update_available": latest > current,
        "check_only": check_only,
        "applied": False,
        "channel": channel,
        "release_url": release_url,
        "notes": notes,
    }

    if not latest > current:
        notes.append(f"frankensearch-tpu-torch {current} is already up to date")
        return payload

    asset = meta.get("asset")
    if not asset or os.path.basename(str(asset)) != asset:
        raise UpdateError("bad_release", f"release.json asset invalid: {asset!r}")

    if check_only:
        notes.append(
            f"update available: v{current} -> v{latest} "
            "(run `frankensearch-tpu-torch update` to apply)"
        )
        return payload

    expected = source.expected_sha256(asset)
    if not expected:
        # refuse to install unverified bytes (runtime.rs:4389 ladder)
        raise UpdateError(
            "unverified_bytes",
            f"no SHA256SUMS or {asset}.sha256 for {asset}; refusing to install",
        )
    blob = source.asset_bytes(asset)
    got = hashlib.sha256(blob).hexdigest()
    if got != expected:
        raise UpdateError(
            "checksum_mismatch", f"{asset}: expected {expected}, got {got}"
        )

    os.makedirs(updates_dir, exist_ok=True)
    staged = os.path.join(updates_dir, str(latest))
    os.makedirs(staged, exist_ok=True)
    atomic_write_bytes(os.path.join(staged, asset), blob, fsync=True)

    prev = _read_manifest(updates_dir)
    manifest = {
        "installed": str(latest),
        "asset": asset,
        "sha256": expected,
        "at": time.time(),
        "previous": prev.get("installed") or str(current),
        "source": getattr(source, "kind", "local"),
    }
    _write_manifest(updates_dir, manifest)
    payload["applied"] = True
    notes.append(f"staged v{latest} under {staged} (verified sha256:{expected[:12]}…)")
    notes.append("python package is pip-managed; staged bundle is the active generation")
    return payload


def rollback_update(updates_dir: str) -> dict:
    """Restore the previous staged version (runtime.rs --rollback)."""
    manifest = _read_manifest(updates_dir)
    prev = manifest.get("previous")
    cur = manifest.get("installed")
    if not manifest or not prev:
        raise UpdateError("nothing_to_rollback", "no previous staged version recorded")
    _write_manifest(
        updates_dir,
        {**manifest, "installed": prev, "previous": None, "at": time.time()},
    )
    return {
        "rolled_back_from": cur,
        "active_version": prev,
        "notes": [f"rolled back staged generation {cur} -> {prev}"],
    }


# --------------------------------------------------------------------------
# uninstall transaction
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class UninstallTarget:
    target: str
    kind: str  # "file" | "directory" | "package"
    path: str
    purge_only: bool = False


def collect_uninstall_targets(
    root: str,
    *,
    user_config_dir: str | None = None,
    project_dir: str = ".",
) -> list[UninstallTarget]:
    """Collect the removal candidates (runtime.rs:4712).

    ``model_dir`` is listed before ``index_dir`` so per-entry statuses
    stay meaningful even though it nests under the root.
    """
    user_dir = user_config_dir or os.path.join(
        os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    )
    return [
        UninstallTarget("package", "package", "frankensearch_tpu_torch", purge_only=False),
        UninstallTarget(
            "model_dir", "directory", os.path.join(root, "models"), purge_only=True
        ),
        UninstallTarget("index_dir", "directory", root, purge_only=False),
        UninstallTarget(
            "user_config_dir",
            "directory",
            os.path.join(user_dir, "frankensearch-tpu"),
            purge_only=True,
        ),
        UninstallTarget(
            "project_config",
            "file",
            os.path.join(project_dir, ".frankensearch.json"),
            purge_only=True,
        ),
    ]


@dataclass
class _Entry:
    target: str
    path: str
    status: str  # "removed" | "skipped" | "error"
    reason: str = ""

    def to_dict(self) -> dict:
        return {
            "target": self.target,
            "path": self.path,
            "status": self.status,
            "reason": self.reason,
        }


def _apply_target(t: UninstallTarget, dry_run: bool, purge: bool) -> _Entry:
    if t.kind == "package":
        return _Entry(
            t.target, t.path, "skipped", "python package (pip-managed; not removed)"
        )
    if t.purge_only and not purge:
        return _Entry(t.target, t.path, "skipped", "purge_only (pass --purge)")
    exists = os.path.isdir(t.path) if t.kind == "directory" else os.path.isfile(t.path)
    if not exists:
        return _Entry(t.target, t.path, "skipped", "not present")
    if dry_run:
        return _Entry(t.target, t.path, "skipped", "dry-run")
    try:
        if t.kind == "directory":
            shutil.rmtree(t.path)
        else:
            os.unlink(t.path)
    except OSError as e:
        return _Entry(t.target, t.path, "error", str(e))
    return _Entry(t.target, t.path, "removed")


def run_uninstall(
    root: str,
    *,
    dry_run: bool,
    confirmed: bool,
    purge: bool,
    user_config_dir: str | None = None,
    project_dir: str = ".",
) -> dict:
    """Full uninstall payload (runtime.rs:4663 collect_uninstall_payload)."""
    if not dry_run and not confirmed:
        raise UpdateError(
            "confirmation_required", "uninstall requires --yes or --dry-run"
        )
    notes: list[str] = []
    if dry_run:
        notes.append("dry-run mode: no files were deleted")
    if not purge:
        notes.append("purge-disabled: model/cache/config targets were skipped")

    entries = [
        _apply_target(t, dry_run, purge)
        for t in collect_uninstall_targets(
            root, user_config_dir=user_config_dir, project_dir=project_dir
        )
    ]
    removed = sum(1 for e in entries if e.status == "removed")
    failed = sum(1 for e in entries if e.status == "error")
    return {
        "purge": purge,
        "dry_run": dry_run,
        "confirmed": confirmed,
        "removed": removed,
        "skipped": len(entries) - removed - failed,
        "failed": failed,
        "entries": [e.to_dict() for e in entries],
        "notes": notes,
    }
