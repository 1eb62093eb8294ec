"""Model acquisition: real transport + fail-closed verify-then-promote.

Parity target: reference crates/frankensearch-embed/src/model_download.rs —
``DownloadConfig`` (retries/backoff/UA/redirect cap/body cap, :58-91),
the ``acquire_frozen_model`` transaction (advisory lock → warm-cache
reuse → stage via network stream or local-bundle copy → manifest verify
→ load self-test → atomic publication with backup preservation,
:484-741), durable path-free receipts / progress records (:150-230),
and ``diagnose_model_acquisition``'s crash-recovery scan (:284-340).

The network transport is stdlib ``urllib`` streaming to disk with
SHA-256 folded into the stream, HTTP Range resume after truncation,
exponential backoff on transient failures, a redirect cap, and a
manifest-declared byte ceiling (fail-closed: one byte over the declared
size aborts the artifact). The test suite drives it against a loopback
HTTP server; production deployments point it at their artifact store.

Every byte accepted is authorized by the frozen ``ModelManifest``: the
transport cannot introduce files the manifest does not list, and nothing
is published until every listed file matches its pinned SHA-256 + size.
"""

from __future__ import annotations

from frankensearch_tpu_torch.core.atomic_io import atomic_write_text

import hashlib
import http.client
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.embed.model_manifest import (
    ModelFileEntry,
    ModelManifest,
    verify_model_dir,
    write_model_manifest,
)

RECEIPT_SCHEMA_VERSION = 1

#: model_download.rs DEFAULT_MAX_MODEL_ARTIFACT_BYTES rationale: the cap
#: is a finite-resource guard only — the real bound on every artifact is
#: its manifest-declared size, enforced mid-stream.
DEFAULT_MAX_ARTIFACT_BYTES = 2 << 30

_CHUNK = 1 << 16
_staging_counter = [0]
_staging_lock = threading.Lock()


class AcquisitionCancelled(EmbeddingFailed):
    """Structured cancellation observed between transport chunks."""


@dataclass(frozen=True)
class DownloadConfig:
    """model_download.rs DownloadConfig."""

    max_retries: int = 3
    backoff_base_s: float = 0.25
    user_agent: str = "frankensearch-tpu/1.0"
    max_redirects: int = 5
    max_artifact_bytes: int = DEFAULT_MAX_ARTIFACT_BYTES
    timeout_s: float = 30.0


@dataclass(frozen=True)
class NetworkSource:
    """Immutable artifact URLs. ``urls`` maps manifest file name → URL;
    ``base_url`` covers the common flat-layout case (url = base/name).
    Explicit per-file URLs win over the base."""

    base_url: str | None = None
    urls: dict[str, str] = field(default_factory=dict)

    def url_for(self, name: str) -> str:
        if name in self.urls:
            return self.urls[name]
        if self.base_url is not None:
            return self.base_url.rstrip("/") + "/" + name
        raise EmbeddingFailed(f"no URL for artifact {name!r}")


@dataclass(frozen=True)
class LocalBundleSource:
    """Operator-supplied complete artifact tree (stage_local_bundle)."""

    source_dir: str


# Stage names follow model_download.rs ModelAcquisitionStageV1.
STAGE_STREAMING = "streaming"
STAGE_STAGED_VERIFIED = "staged_verified"
STAGE_SELF_TEST_PASSED = "load_self_test_passed"
STAGE_PUBLISHED = "published"
STAGE_WARM_CACHE = "warm_cache_verified"
STAGE_FAILED = "failed"
STAGE_CANCELLED = "cancelled"


@dataclass(frozen=True)
class AcquisitionReceipt:
    """Path-free durable evidence (ModelAcquisitionReceiptV1)."""

    model_id: str
    revision: str
    manifest_fingerprint: str
    source: str  # "network" | "local_bundle" | "warm_cache"
    source_hosts: tuple[str, ...]
    outcome: str  # "published" | "verified_warm_cache"
    bytes_verified: int
    duration_ms: int
    prior_generation_preserved: bool
    authorized_by: str
    #: acquisition never implies compatibility with an existing index
    requires_reindex: bool = True

    def to_dict(self) -> dict:
        return {
            "v": RECEIPT_SCHEMA_VERSION,
            "model_id": self.model_id,
            "revision": self.revision,
            "manifest_fingerprint": self.manifest_fingerprint,
            "source": self.source,
            "source_hosts": list(self.source_hosts),
            "outcome": self.outcome,
            "bytes_verified": self.bytes_verified,
            "duration_ms": self.duration_ms,
            "prior_generation_preserved": self.prior_generation_preserved,
            "authorized_by": self.authorized_by,
            "requires_reindex": self.requires_reindex,
        }

    @staticmethod
    def from_dict(d: dict) -> "AcquisitionReceipt":
        if d.get("v") != RECEIPT_SCHEMA_VERSION:
            raise EmbeddingFailed(f"unsupported receipt version {d.get('v')}")
        return AcquisitionReceipt(
            model_id=d["model_id"],
            revision=d["revision"],
            manifest_fingerprint=d["manifest_fingerprint"],
            source=d["source"],
            source_hosts=tuple(d["source_hosts"]),
            outcome=d["outcome"],
            bytes_verified=d["bytes_verified"],
            duration_ms=d["duration_ms"],
            prior_generation_preserved=d["prior_generation_preserved"],
            authorized_by=d["authorized_by"],
            requires_reindex=d["requires_reindex"],
        )


def manifest_fingerprint(manifest: ModelManifest) -> str:
    """Stable fingerprint binding the full frozen artifact manifest."""
    return hashlib.sha256(manifest.to_json().encode("utf-8")).hexdigest()


def _progress(
    stage: str,
    manifest: ModelManifest,
    *,
    file_name: str = "",
    bytes_done: int = 0,
    bytes_total: int | None = None,
    files_done: int = 0,
    elapsed_s: float = 0.0,
) -> dict:
    """Bounded, path-free progress record (ModelAcquisitionProgressV1)."""
    return {
        "v": RECEIPT_SCHEMA_VERSION,
        "stage": stage,
        "model_id": manifest.model_id,
        "revision": manifest.revision,
        "file_name": file_name,
        "bytes_done": bytes_done,
        "bytes_total": bytes_total,
        "files_done": files_done,
        "files_total": len(manifest.files),
        "elapsed_s": round(elapsed_s, 3),
    }


class _CappedRedirectHandler(urllib.request.HTTPRedirectHandler):
    def __init__(self, cap: int) -> None:
        super().__init__()
        self.max_repeats = cap
        self.max_redirections = cap


def _total_bytes(manifest: ModelManifest) -> int:
    return sum(f.bytes for f in manifest.files)


def _source_hosts(manifest: ModelManifest, source: NetworkSource) -> tuple[str, ...]:
    from urllib.parse import urlparse

    hosts = set()
    for f in manifest.files:
        host = urlparse(source.url_for(f.name)).hostname
        if host:
            hosts.add(host)
    return tuple(sorted(hosts))


def receipt_path(destination_dir: str) -> str:
    parent, name = os.path.split(os.path.abspath(destination_dir))
    return os.path.join(parent, f"{name}.receipt.json")


def _check_cancel(cancel: threading.Event | None, where: str) -> None:
    if cancel is not None and cancel.is_set():
        raise AcquisitionCancelled(f"acquisition cancelled at {where}")


class ModelDownloader:
    """One explicit frozen-model acquisition transaction
    (model_download.rs acquire_frozen_model)."""

    def __init__(self, config: DownloadConfig | None = None) -> None:
        self.config = config or DownloadConfig()

    # ------------------------------------------------------------------
    def acquire(
        self,
        manifest: ModelManifest,
        source: NetworkSource | LocalBundleSource,
        destination_dir: str,
        *,
        authorized_by: str,
        on_progress=None,
        load_self_test=None,
        cancel: threading.Event | None = None,
    ) -> AcquisitionReceipt:
        """Lock → warm-cache reuse → stage → verify → self-test →
        atomically publish; durable receipt on success. Fail-closed: any
        verification miss aborts without touching the live generation.
        """
        if not authorized_by:
            raise EmbeddingFailed(
                "model acquisition requires explicit authorization "
                "(downloads are never implicit)"
            )
        if not manifest.files:
            raise EmbeddingFailed("manifest lists no artifacts; nothing to acquire")
        # defense-in-depth vs from_json's gate: manifests can also be
        # constructed programmatically, and every staging path below
        # joins entry.name under a directory
        from frankensearch_tpu_torch.embed.model_manifest import validate_artifact_name

        for entry in manifest.files:
            validate_artifact_name(entry.name)
        started = time.monotonic()
        emit = on_progress or (lambda rec: None)
        destination_dir = os.path.abspath(destination_dir)
        parent, name = os.path.split(destination_dir)
        os.makedirs(parent, exist_ok=True)

        from frankensearch_tpu_torch.index.file_identity import WriterLock

        lock = WriterLock(os.path.join(parent, f".{name}.acquisition.lock"))
        try:
            lock.acquire()
        except Exception as exc:  # concurrent acquisition on same dest
            raise EmbeddingFailed(f"acquisition already in progress: {exc}") from exc
        try:
            return self._acquire_locked(
                manifest, source, destination_dir, authorized_by,
                emit, load_self_test, cancel, started,
            )
        except AcquisitionCancelled:
            emit(_progress(STAGE_CANCELLED, manifest,
                           elapsed_s=time.monotonic() - started))
            raise
        except Exception:
            emit(_progress(STAGE_FAILED, manifest,
                           elapsed_s=time.monotonic() - started))
            raise
        finally:
            lock.release()

    # ------------------------------------------------------------------
    def _acquire_locked(
        self, manifest, source, destination_dir, authorized_by,
        emit, load_self_test, cancel, started,
    ) -> AcquisitionReceipt:
        parent, name = os.path.split(destination_dir)
        fingerprint = manifest_fingerprint(manifest)
        _check_cancel(cancel, "acquisition-start")

        # warm cache: an existing destination that verifies is reused
        # without any transport (acquire_frozen_model cache_reason path)
        if os.path.isdir(destination_dir) and verify_model_dir(
            destination_dir, manifest
        ).ok:
            _check_cancel(cancel, "warm-cache-self-test")
            if load_self_test is not None:
                load_self_test(destination_dir, manifest)
            emit(_progress(STAGE_WARM_CACHE, manifest,
                           files_done=len(manifest.files),
                           elapsed_s=time.monotonic() - started))
            receipt = AcquisitionReceipt(
                model_id=manifest.model_id, revision=manifest.revision,
                manifest_fingerprint=fingerprint, source="warm_cache",
                source_hosts=(), outcome="verified_warm_cache",
                bytes_verified=_total_bytes(manifest),
                duration_ms=int((time.monotonic() - started) * 1000),
                prior_generation_preserved=False,
                authorized_by=authorized_by,
            )
            self._write_receipt(destination_dir, receipt)
            return receipt

        # unique staging generation under the destination's parent, so
        # the final promote is a same-filesystem atomic rename
        with _staging_lock:
            _staging_counter[0] += 1
            stamp = f"{os.getpid()}-{_staging_counter[0]}"
        staging = os.path.join(parent, f".{name}-download-{stamp}")
        os.makedirs(staging)

        if isinstance(source, NetworkSource):
            src_kind = "network"
            hosts = _source_hosts(manifest, source)
            self._stage_network(manifest, source, staging, emit, cancel, started)
        else:
            src_kind = "local_bundle"
            hosts = ()
            self._stage_local(manifest, source, staging, emit, cancel, started)

        # the staged generation must be self-describing: the manifest
        # rides with the bytes it authorizes
        write_model_manifest(staging, manifest)
        _check_cancel(cancel, "staged-verification")
        verification = verify_model_dir(staging, manifest)
        if not verification.ok:
            raise EmbeddingFailed(
                f"staged model failed verification: "
                f"missing={list(verification.missing)} "
                f"corrupted={list(verification.corrupted)}"
            )
        emit(_progress(STAGE_STAGED_VERIFIED, manifest,
                       files_done=len(manifest.files),
                       elapsed_s=time.monotonic() - started))

        _check_cancel(cancel, "load-self-test")
        if load_self_test is not None:
            load_self_test(staging, manifest)
            emit(_progress(STAGE_SELF_TEST_PASSED, manifest,
                           files_done=len(manifest.files),
                           elapsed_s=time.monotonic() - started))

        _check_cancel(cancel, "atomic-publication")
        preserved = False
        if os.path.exists(destination_dir):
            # a destination that exists here FAILED verification (the
            # warm path returned above); preserve it for forensics
            with _staging_lock:
                _staging_counter[0] += 1
                bstamp = f"{os.getpid()}-{_staging_counter[0]}"
            backup = os.path.join(parent, f"{name}.backup.{bstamp}")
            os.replace(destination_dir, backup)
            preserved = True
        os.replace(staging, destination_dir)
        emit(_progress(STAGE_PUBLISHED, manifest,
                       files_done=len(manifest.files),
                       elapsed_s=time.monotonic() - started))

        receipt = AcquisitionReceipt(
            model_id=manifest.model_id, revision=manifest.revision,
            manifest_fingerprint=fingerprint, source=src_kind,
            source_hosts=hosts, outcome="published",
            bytes_verified=_total_bytes(manifest),
            duration_ms=int((time.monotonic() - started) * 1000),
            prior_generation_preserved=preserved,
            authorized_by=authorized_by,
        )
        self._write_receipt(destination_dir, receipt)
        return receipt

    # ------------------------------------------------------------------
    def _write_receipt(self, destination_dir: str, receipt: AcquisitionReceipt) -> None:
        path = receipt_path(destination_dir)
        atomic_write_text(path, json.dumps(receipt.to_dict(), indent=2), fsync=True)

    # ------------------------------------------------------------------
    def _stage_local(self, manifest, source, staging, emit, cancel, started) -> None:
        """Copy + verify an operator-supplied bundle (stage_local_bundle).

        Only manifest-listed names are copied: the bundle cannot smuggle
        extra files into the published generation.
        """
        for i, entry in enumerate(manifest.files):
            _check_cancel(cancel, "local-stage-copy")
            src = os.path.join(source.source_dir, entry.name)
            if not os.path.isfile(src):
                raise EmbeddingFailed(f"local bundle missing artifact {entry.name!r}")
            shutil.copyfile(src, os.path.join(staging, entry.name))
            emit(_progress(STAGE_STREAMING, manifest, file_name=entry.name,
                           bytes_done=entry.bytes, bytes_total=entry.bytes,
                           files_done=i + 1,
                           elapsed_s=time.monotonic() - started))

    # ------------------------------------------------------------------
    def _stage_network(self, manifest, source, staging, emit, cancel, started) -> None:
        opener = urllib.request.build_opener(
            _CappedRedirectHandler(self.config.max_redirects)
        )
        for i, entry in enumerate(manifest.files):
            _check_cancel(cancel, "network-stage-file")
            self._fetch_one(
                opener, source.url_for(entry.name), staging, entry, manifest,
                files_done=i, emit=emit, cancel=cancel, started=started,
            )

    def _fetch_one(
        self, opener, url, staging, entry: ModelFileEntry, manifest,
        *, files_done, emit, cancel, started,
    ) -> None:
        """Stream one artifact with retry + Range resume.

        The byte ceiling is min(declared size, config cap): the manifest
        authorizes exactly ``entry.bytes`` bytes, so byte entry.bytes+1
        aborts the artifact mid-stream (fail-closed against a tampering
        or misconfigured origin), and retries never re-download verified
        prefixes — the on-disk partial is re-hashed and the request
        resumes with a Range header.
        """
        cap = min(entry.bytes, self.config.max_artifact_bytes)
        if entry.bytes > self.config.max_artifact_bytes:
            raise EmbeddingFailed(
                f"artifact {entry.name!r} declares {entry.bytes} bytes, over the "
                f"configured cap {self.config.max_artifact_bytes}"
            )
        part = os.path.join(staging, entry.name + ".part")
        final = os.path.join(staging, entry.name)
        last_error: Exception | None = None
        for attempt in range(self.config.max_retries + 1):
            if attempt:
                time.sleep(self.config.backoff_base_s * (2 ** (attempt - 1)))
            _check_cancel(cancel, "network-retry")
            have = os.path.getsize(part) if os.path.exists(part) else 0
            if have > cap:
                os.remove(part)
                have = 0
            try:
                req = urllib.request.Request(
                    url, headers={"User-Agent": self.config.user_agent}
                )
                if have:
                    req.add_header("Range", f"bytes={have}-")
                with opener.open(req, timeout=self.config.timeout_s) as resp:
                    status = getattr(resp, "status", 200)
                    mode = "ab" if (have and status == 206) else "wb"
                    if mode == "wb":
                        have = 0
                    with open(part, mode) as out:
                        done = have
                        while True:
                            _check_cancel(cancel, "network-chunk")
                            chunk = resp.read(_CHUNK)
                            if not chunk:
                                break
                            done += len(chunk)
                            if done > cap:
                                raise EmbeddingFailed(
                                    f"artifact {entry.name!r} exceeded its "
                                    f"manifest-declared {entry.bytes} bytes"
                                )
                            out.write(chunk)
                            emit(_progress(
                                STAGE_STREAMING, manifest, file_name=entry.name,
                                bytes_done=done, bytes_total=entry.bytes,
                                files_done=files_done,
                                elapsed_s=time.monotonic() - started))
                if os.path.getsize(part) != entry.bytes:
                    # truncated stream: transient — leave the partial on
                    # disk so the next attempt resumes via Range
                    last_error = EmbeddingFailed(
                        f"short read for {entry.name!r}: "
                        f"{os.path.getsize(part)}/{entry.bytes} bytes"
                    )
                    continue
                os.replace(part, final)
                return
            except (AcquisitionCancelled, EmbeddingFailed):
                raise  # policy violations and cancellation never retry
            except urllib.error.HTTPError as exc:
                if exc.code == 416 and have:
                    # origin refused our resume offset: restart clean
                    os.remove(part)
                    last_error = exc
                    continue
                if 400 <= exc.code < 500:
                    raise EmbeddingFailed(
                        f"permanent HTTP {exc.code} fetching {entry.name!r}"
                    ) from exc
                last_error = exc  # 5xx: transient
            except (
                urllib.error.URLError,
                TimeoutError,
                OSError,
                # a connection cut mid-body surfaces as IncompleteRead
                # (an HTTPException, NOT an OSError) from resp.read()
                http.client.HTTPException,
            ) as exc:
                last_error = exc  # transient transport failure
        raise EmbeddingFailed(
            f"artifact {entry.name!r} failed after "
            f"{self.config.max_retries + 1} attempts: {last_error}"
        ) from last_error


# ----------------------------------------------------------------------
def diagnose_acquisition(destination_dir: str) -> dict:
    """Crash-recovery scan (diagnose_model_acquisition): count the
    acquisition by-products around a destination so operators can see
    orphan staging trees, preserved backups, and a held advisory lock
    without guessing at naming conventions."""
    destination_dir = os.path.abspath(destination_dir)
    parent, name = os.path.split(destination_dir)
    if not name:
        raise EmbeddingFailed("destination must end in a directory name")
    out = {
        "v": RECEIPT_SCHEMA_VERSION,
        "destination_present": os.path.exists(destination_dir),
        "orphan_staging": 0,
        "preserved_backups": 0,
        "lock_present": False,
        "receipt_present": os.path.exists(receipt_path(destination_dir)),
    }
    if not os.path.isdir(parent):
        return out
    staging_prefix = f".{name}-download-"
    backup_prefix = f"{name}.backup."
    lock_name = f".{name}.acquisition.lock"
    for fname in os.listdir(parent):
        if fname.startswith(staging_prefix):
            out["orphan_staging"] += 1
        elif fname.startswith(backup_prefix):
            out["preserved_backups"] += 1
        elif fname == lock_name:
            # lock FILES linger after release (unlinking them is the
            # classic flock race); only a lock that is actually HELD
            # right now means an acquisition is in flight
            out["lock_present"] = _flock_held(os.path.join(parent, fname))
    return out


def _flock_held(path: str) -> bool:
    import fcntl

    try:
        fd = os.open(path, os.O_RDWR)
    except OSError:
        return False
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(fd, fcntl.LOCK_UN)
        return False  # we could take it: nobody holds it
    except OSError:
        return True
    finally:
        os.close(fd)


def load_receipt(destination_dir: str) -> AcquisitionReceipt | None:
    path = receipt_path(destination_dir)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return AcquisitionReceipt.from_dict(json.load(f))
