"""The port's install lifecycle and model acquisition (``runtime/install.py``,
``embed/model_download.py``, the ``update``, ``uninstall`` and ``download``
commands) against the JAX package's on the CPU.

Oracles: tests/test_install_lifecycle.py and tests/test_model_download.py,
replayed on the port (downloads from the same loopback HTTP origin, with its
fault injection: nothing leaves the box), and each command's envelope
against the reference command's on the same inputs: equal except the
package and program names (``frankensearch_tpu_torch`` /
``frankensearch-tpu-torch`` in the uninstall target and the update notes),
the paths under each run's own directory, and the receipt's duration.
"""

import argparse
import hashlib
import json
import os
import shutil
import threading

import numpy as np
import pytest

from frankensearch_tpu_torch.core.errors import EmbeddingFailed
from frankensearch_tpu_torch.embed.model_download import (
    AcquisitionCancelled,
    AcquisitionReceipt,
    DownloadConfig,
    LocalBundleSource,
    ModelDownloader,
    NetworkSource,
    diagnose_acquisition,
    load_receipt,
    manifest_fingerprint,
)
from frankensearch_tpu_torch.embed.model_manifest import (
    ModelFileEntry,
    ModelManifest,
    build_model_manifest,
    verify_model_dir,
)
from frankensearch_tpu_torch.index.file_identity import WriterLock
from frankensearch_tpu_torch.runtime.install import (
    LocalReleaseDir,
    NetworkReleaseSource,
    SemVer,
    UpdateError,
    collect_uninstall_targets,
    collect_update_payload,
    rollback_update,
    run_uninstall,
)
from tests.test_install_lifecycle import make_bundle
from tests.test_model_download import _Origin, origin  # noqa: F401  (fixture)
from tests.test_torch_cli import no_pallas, reference_logger_untouched, run  # noqa: F401

FAST_CFG = DownloadConfig(max_retries=3, backoff_base_s=0.01, timeout_s=5.0)
ARTIFACTS = {
    "weights.npz": np.random.default_rng(5).integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    "vocab.txt": b"alpha\nbeta\ngamma\n",
}
#: the package and program names, the only words the envelopes differ by
NAMES = (("frankensearch_tpu_torch", "frankensearch_tpu"), ("frankensearch-tpu-torch", "frankensearch-tpu"))


def envs(tmp_path, make_argv, prepare=None) -> tuple[dict, dict]:
    """(port envelope, reference envelope) of one command, each run in a
    directory of its own (``prepare(d)`` first); the directory in the
    texts and the program names made equal."""
    out = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        if prepare is not None:
            prepare(d)
        rc, text = run(pkg, "--format", "json", *make_argv(d))
        text = text.replace(str(d), "<DIR>")
        if pkg == "port":
            for ours, theirs in NAMES:
                text = text.replace(ours, theirs)
        env = json.loads(text)
        assert rc == (0 if env["ok"] else 1)
        out[pkg] = env
    return out["port"], out["ref"]


# -- tests/test_install_lifecycle.py on the port ------------------------------------------------


def test_semver_ordering_and_v_prefix():
    assert SemVer.parse("v1.2.3") == SemVer.parse("1.2.3")
    assert SemVer.parse("1.10.0") > SemVer.parse("1.9.9")
    with pytest.raises(UpdateError):
        SemVer.parse("1.2")


def test_check_only_reports_without_staging(tmp_path):
    make_bundle(str(tmp_path / "bundle"))
    out = collect_update_payload("0.1.0", LocalReleaseDir(str(tmp_path / "bundle")),
                                 updates_dir=str(tmp_path / "updates"), check_only=True)
    assert out["update_available"] and out["check_only"] and not out["applied"]
    assert not os.path.exists(tmp_path / "updates")
    assert out["notes"] == ["update available: v0.1.0 -> v9.9.9 (run `frankensearch-tpu-torch update` to apply)"]


def test_apply_verifies_and_stages_with_manifest(tmp_path):
    digest = make_bundle(str(tmp_path / "bundle"))
    updates = str(tmp_path / "updates")
    out = collect_update_payload("0.1.0", LocalReleaseDir(str(tmp_path / "bundle")), updates_dir=updates)
    assert out["applied"] and os.path.isfile(os.path.join(updates, "9.9.9", "fs-tpu.tar.gz"))
    with open(os.path.join(updates, "install-manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["installed"], manifest["sha256"], manifest["previous"]) == ("9.9.9", digest, "0.1.0")


def test_up_to_date_applies_nothing(tmp_path):
    make_bundle(str(tmp_path / "bundle"), version="0.0.1")
    out = collect_update_payload("0.1.0", LocalReleaseDir(str(tmp_path / "bundle")),
                                 updates_dir=str(tmp_path / "updates"))
    assert not out["update_available"] and not out["applied"]
    assert out["notes"] == ["frankensearch-tpu-torch 0.1.0 is already up to date"]


@pytest.mark.parametrize("mutate,code", [
    (lambda b: make_bundle(b, checksum=False), "unverified_bytes"),
    (lambda b: (make_bundle(b), open(os.path.join(b, "fs-tpu.tar.gz"), "wb").write(b"tampered")), "checksum_mismatch"),
    (lambda b: (make_bundle(b), json.dump({"version": "9.9.9", "asset": "../evil"},
                                          open(os.path.join(b, "release.json"), "w"))), "bad_release"),
    (lambda b: os.makedirs(b), "no_release"),
], ids=["unverified", "tampered", "traversal", "no-release"])
def test_refused_updates(tmp_path, mutate, code):
    bundle = str(tmp_path / "bundle")
    mutate(bundle)
    with pytest.raises(UpdateError) as ei:
        collect_update_payload("0.1.0", LocalReleaseDir(bundle), updates_dir=str(tmp_path / "updates"))
    assert ei.value.code == code
    assert not os.path.exists(tmp_path / "updates" / "install-manifest.json")


def test_sidecar_checksum_accepted(tmp_path):
    make_bundle(str(tmp_path / "bundle"), sums_file=False)
    out = collect_update_payload("0.1.0", LocalReleaseDir(str(tmp_path / "bundle")),
                                 updates_dir=str(tmp_path / "updates"))
    assert out["applied"]


def test_rollback_restores_previous(tmp_path):
    make_bundle(str(tmp_path / "bundle"))
    updates = str(tmp_path / "updates")
    collect_update_payload("0.1.0", LocalReleaseDir(str(tmp_path / "bundle")), updates_dir=updates)
    assert rollback_update(updates)["active_version"] == "0.1.0"
    with pytest.raises(UpdateError):
        rollback_update(updates)


def test_network_release_source_typed_error_on_dead_endpoint(tmp_path):
    with pytest.raises(UpdateError) as ei:
        collect_update_payload("0.1.0", NetworkReleaseSource("http://127.0.0.1:1/rel", timeout_s=0.5),
                               updates_dir=str(tmp_path / "updates"))
    assert ei.value.code == "network_unreachable"


def test_network_release_source_over_loopback(origin, tmp_path):  # noqa: F811
    blob = b"release-bytes"
    _Origin.files.update({"/rel/release.json": json.dumps({"version": "2.0.0", "asset": "a.tgz"}).encode(),
                          "/rel/a.tgz": blob,
                          "/rel/SHA256SUMS": f"{hashlib.sha256(blob).hexdigest()}  a.tgz\n".encode()})
    out = collect_update_payload("0.1.0", NetworkReleaseSource(origin + "/rel"), updates_dir=str(tmp_path / "u"))
    assert out["applied"] and open(tmp_path / "u" / "2.0.0" / "a.tgz", "rb").read() == blob
    with open(tmp_path / "u" / "install-manifest.json") as f:
        assert json.load(f)["source"] == "network"


def uninstall_root(tmp_path) -> str:
    root = tmp_path / ".fsindex"
    (root / "models" / "m1").mkdir(parents=True)
    (root / "models" / "m1" / "w.bin").write_bytes(b"x")
    (root / "fast.ftvi").write_bytes(b"y")
    return str(root)


def test_uninstall_requires_confirmation(tmp_path):
    with pytest.raises(UpdateError) as ei:
        run_uninstall(uninstall_root(tmp_path), dry_run=False, confirmed=False, purge=False)
    assert ei.value.code == "confirmation_required"


def test_uninstall_dry_run_deletes_nothing(tmp_path):
    root = uninstall_root(tmp_path)
    out = run_uninstall(root, dry_run=True, confirmed=False, purge=True, user_config_dir=str(tmp_path / "cfg"),
                        project_dir=str(tmp_path))
    assert out["removed"] == 0 and out["failed"] == 0 and os.path.isdir(root)
    assert any("dry-run" in n for n in out["notes"])


def test_uninstall_purge_gate_and_package_never_removed(tmp_path):
    root = uninstall_root(tmp_path)
    cfg = tmp_path / "cfg" / "frankensearch-tpu"
    cfg.mkdir(parents=True)
    out = run_uninstall(root, dry_run=False, confirmed=True, purge=False, user_config_dir=str(tmp_path / "cfg"),
                        project_dir=str(tmp_path))
    by = {e["target"]: e for e in out["entries"]}
    assert by["index_dir"]["status"] == "removed" and by["user_config_dir"]["status"] == "skipped"
    assert "purge_only" in by["user_config_dir"]["reason"]
    assert by["package"] == {"target": "package", "path": "frankensearch_tpu_torch", "status": "skipped",
                             "reason": "python package (pip-managed; not removed)"}
    assert not os.path.isdir(root) and cfg.is_dir()


def test_uninstall_purge_removes_config_surfaces(tmp_path):
    root = uninstall_root(tmp_path)
    cfg = tmp_path / "cfg" / "frankensearch-tpu"
    cfg.mkdir(parents=True)
    proj = tmp_path / ".frankensearch.json"
    proj.write_text("{}")
    out = run_uninstall(root, dry_run=False, confirmed=True, purge=True, user_config_dir=str(tmp_path / "cfg"),
                        project_dir=str(tmp_path))
    assert out["failed"] == 0 and out["removed"] == 4 and not cfg.exists() and not proj.exists()


def test_uninstall_target_collection_shapes(tmp_path):
    names = [t.target for t in collect_uninstall_targets(str(tmp_path / "r"), user_config_dir=str(tmp_path / "c"),
                                                         project_dir=str(tmp_path))]
    assert names == ["package", "model_dir", "index_dir", "user_config_dir", "project_config"]


def test_cmd_update_check_and_uninstall_dry_run(tmp_path):
    from frankensearch_tpu_torch.cli.main import cmd_uninstall, cmd_update

    make_bundle(str(tmp_path / "bundle"))
    out = cmd_update(argparse.Namespace(root=str(tmp_path / ".fsindex"), check=True, from_dir=str(tmp_path / "bundle"),
                                        url="", rollback=False))
    assert out["ok"] and out["data"]["update_available"]
    out = cmd_uninstall(argparse.Namespace(root=str(tmp_path / ".fsindex"), yes=False, dry_run=True, purge=False))
    assert out["ok"] and out["data"]["dry_run"]
    out = cmd_uninstall(argparse.Namespace(root=str(tmp_path), yes=False, dry_run=False, purge=False))
    assert not out["ok"] and out["error"]["code"] == "confirmation_required"


def test_completions_include_every_command():
    from frankensearch_tpu_torch.cli.main import build_parser

    rc, script = run("port", "completions")
    sub = [a for a in build_parser()._subparsers._group_actions if hasattr(a, "choices")][0]
    assert rc == 0 and len(sub.choices) == 26
    for name in sub.choices:
        assert name in script, name


# -- update and uninstall envelopes against the reference's ---------------------------------------


def bundle_in(d, **kw) -> None:
    make_bundle(str(d / "bundle"), **kw)


def uninstall_ix(d) -> None:
    (d / "ix" / "models").mkdir(parents=True)
    (d / "ix" / "fast.ftvi").write_bytes(b"y")


@pytest.mark.parametrize("argv,prepare", [
    (lambda d: ["update", "--root", str(d / "ix"), "--check", "--from-dir", str(d / "bundle")], bundle_in),
    (lambda d: ["update", "--root", str(d / "ix"), "--from-dir", str(d / "bundle")], bundle_in),
    (lambda d: ["update", "--root", str(d / "ix"), "--from-dir", str(d / "bundle")],
     lambda d: bundle_in(d, version="0.0.9")),
    (lambda d: ["update", "--root", str(d / "ix"), "--from-dir", str(d / "bundle")],
     lambda d: bundle_in(d, checksum=False)),
    (lambda d: ["update", "--root", str(d / "ix")], None),
    (lambda d: ["update", "--root", str(d / "ix"), "--rollback"], None),
    (lambda d: ["update", "--root", str(d / "ix"), "--url", "http://127.0.0.1:1/rel"], None),
    (lambda d: ["uninstall", "--root", str(d / "ix"), "--dry-run"], lambda d: uninstall_ix(d)),
    (lambda d: ["uninstall", "--root", str(d / "ix")], None),
], ids=["check", "apply", "up-to-date", "unverified", "no-source", "nothing-to-roll-back", "unreachable",
        "uninstall-dry-run", "uninstall-unconfirmed"])
def test_update_uninstall_envelopes_equal_reference(tmp_path, argv, prepare):
    got, want = envs(tmp_path, argv, prepare)
    assert got == want


def test_update_apply_then_rollback_envelopes_equal_reference(tmp_path):
    """apply, then ``--rollback``, then ``--rollback`` again (nothing left)."""
    got = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        bundle_in(d)
        root = str(d / "ix")
        seq = [run(pkg, "--format", "json", "update", "--root", root, "--from-dir", str(d / "bundle")),
               run(pkg, "--format", "json", "update", "--root", root, "--rollback"),
               run(pkg, "--format", "json", "update", "--root", root, "--rollback")]
        got[pkg] = [(rc, json.loads(text.replace(str(d), "<DIR>").replace("frankensearch-tpu-torch",
                                                                             "frankensearch-tpu"))) for rc, text in seq]
        with open(os.path.join(root, "updates", "install-manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["installed"] == "0.1.0" and manifest["previous"] is None
    assert got["port"] == got["ref"]
    assert [rc for rc, _ in got["port"]] == [0, 0, 1]
    assert got["port"][2][1]["error"]["code"] == "nothing_to_rollback"


# -- tests/test_model_download.py on the port ------------------------------------------------------


def manifest_for(files: dict, tmp_path, model_id="m2v-test") -> ModelManifest:
    src = tmp_path / f"authoring-{model_id}"
    src.mkdir(exist_ok=True)
    for name, body in files.items():
        (src / name).write_bytes(body)
        _Origin.files["/" + name] = body
    return build_model_manifest(str(src), model_id, "rev-1", 64, "model2vec")


def acquire(man, base, dest, cfg=FAST_CFG, **kw):
    kw.setdefault("authorized_by", "tester")
    return ModelDownloader(cfg).acquire(man, NetworkSource(base_url=base), str(dest), **kw)


def requests_for(path: str) -> list:
    return [r for r in _Origin.log if r["path"] == path]


def test_happy_path_publishes_and_receipts(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    dest = tmp_path / "models" / "m"
    stages = []
    receipt = acquire(man, origin, dest, on_progress=lambda p: stages.append(p["stage"]))
    assert (receipt.outcome, receipt.source, receipt.source_hosts) == ("published", "network", ("127.0.0.1",))
    assert receipt.bytes_verified == sum(len(b) for b in ARTIFACTS.values())
    assert receipt.manifest_fingerprint == manifest_fingerprint(man) and not receipt.prior_generation_preserved
    assert verify_model_dir(str(dest)).ok and (dest / "weights.npz").read_bytes() == ARTIFACTS["weights.npz"]
    assert load_receipt(str(dest)) == receipt
    assert [s for s in stages if s != "streaming"] == ["staged_verified", "published"]
    diag = diagnose_acquisition(str(dest))
    assert diag["orphan_staging"] == 0 and diag["receipt_present"]


def test_truncation_resumes_with_range(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    _Origin.faults["/weights.npz"] = [{"truncate": 30_000}]
    assert acquire(man, origin, tmp_path / "m").outcome == "published"
    assert (tmp_path / "m" / "weights.npz").read_bytes() == ARTIFACTS["weights.npz"]
    reqs = requests_for("/weights.npz")
    assert len(reqs) == 2 and reqs[1]["range"] == "bytes=30000-"


def test_origin_refusing_resume_restarts_clean(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    _Origin.faults["/weights.npz"] = [{"truncate": 10_000}, {"no206": True}]
    assert acquire(man, origin, tmp_path / "m").outcome == "published"
    assert (tmp_path / "m" / "weights.npz").read_bytes() == ARTIFACTS["weights.npz"]


def test_transient_5xx_retried(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    _Origin.faults["/vocab.txt"] = [{"status": 503}, {"status": 502}]
    assert acquire(man, origin, tmp_path / "m").outcome == "published"
    assert len(requests_for("/vocab.txt")) == 3


def test_permanent_404_fails_without_retry(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    del _Origin.files["/vocab.txt"]
    with pytest.raises(EmbeddingFailed, match="HTTP 404"):
        acquire(man, origin, tmp_path / "m")
    assert not (tmp_path / "m").exists() and len(requests_for("/vocab.txt")) == 1
    assert diagnose_acquisition(str(tmp_path / "m"))["orphan_staging"] == 1


def test_tampered_bytes_fail_closed(origin, tmp_path):  # noqa: F811
    man = manifest_for(dict(ARTIFACTS), tmp_path)
    bad = bytearray(ARTIFACTS["vocab.txt"])
    bad[0] ^= 0xFF
    _Origin.files["/vocab.txt"] = bytes(bad)
    with pytest.raises(EmbeddingFailed, match="corrupted"):
        acquire(man, origin, tmp_path / "m")
    assert not (tmp_path / "m").exists()


def test_oversize_stream_aborts_mid_flight(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    _Origin.faults["/vocab.txt"] = [{"extra": b"X" * 64}]
    with pytest.raises(EmbeddingFailed, match="exceeded its manifest-declared"):
        acquire(man, origin, tmp_path / "m")


def test_declared_size_over_cap_rejected_before_transport(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    with pytest.raises(EmbeddingFailed, match="over the configured cap"):
        acquire(man, origin, tmp_path / "m", cfg=DownloadConfig(max_retries=0, max_artifact_bytes=1000))
    assert not requests_for("/weights.npz")


def test_warm_cache_reuses_without_transport(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    acquire(man, origin, tmp_path / "m")
    _Origin.log.clear()
    probed = []
    receipt = acquire(man, origin, tmp_path / "m", load_self_test=lambda p, m: probed.append(p))
    assert (receipt.outcome, receipt.source) == ("verified_warm_cache", "warm_cache")
    assert not _Origin.log and probed == [str(tmp_path / "m")]


def test_rejected_destination_preserved_as_backup(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    acquire(man, origin, tmp_path / "m")
    (tmp_path / "m" / "weights.npz").write_bytes(b"corrupted slab")
    receipt = acquire(man, origin, tmp_path / "m")
    assert receipt.outcome == "published" and receipt.prior_generation_preserved
    assert verify_model_dir(str(tmp_path / "m")).ok
    assert diagnose_acquisition(str(tmp_path / "m"))["preserved_backups"] == 1


def test_redirect_chain_followed_then_capped(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    _Origin.files["/hop2/vocab.txt"] = ARTIFACTS["vocab.txt"]
    _Origin.faults["/vocab.txt"] = [{"redirect": f"{origin}/hop2/vocab.txt"}]
    assert acquire(man, origin, tmp_path / "m").outcome == "published"
    man2 = manifest_for(ARTIFACTS, tmp_path, model_id="m2")
    _Origin.faults["/vocab.txt"] = [{"redirect": f"{origin}/vocab.txt"} for _ in range(40)]
    with pytest.raises(EmbeddingFailed):
        acquire(man2, origin, tmp_path / "m2", cfg=DownloadConfig(max_retries=0, backoff_base_s=0.01, max_redirects=3))


def test_failed_self_test_blocks_publication(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)

    def boom(path, manifest):
        raise EmbeddingFailed("model loads but embeds garbage")

    with pytest.raises(EmbeddingFailed, match="embeds garbage"):
        acquire(man, origin, tmp_path / "m", load_self_test=boom)
    assert not (tmp_path / "m").exists()


def test_cancellation_between_chunks(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    cancel = threading.Event()
    stages = []

    def cancelling(p):
        stages.append(p["stage"])
        if p["stage"] == "streaming" and p["bytes_done"] > 0:
            cancel.set()

    with pytest.raises(AcquisitionCancelled):
        acquire(man, origin, tmp_path / "m", cancel=cancel, on_progress=cancelling)
    assert stages[-1] == "cancelled" and not (tmp_path / "m").exists()


def test_authorization_and_artifacts_are_mandatory(tmp_path):
    man = ModelManifest(model_id="m", revision="r", dim=4, kind="model2vec")
    for who, match in (("", "authorization"), ("op", "no artifacts")):
        with pytest.raises(EmbeddingFailed, match=match):
            ModelDownloader(FAST_CFG).acquire(man, LocalBundleSource(str(tmp_path)), str(tmp_path / "d"),
                                              authorized_by=who)


@pytest.mark.parametrize("bad", ["../escape.txt", "/abs.txt", "a/b.txt", "a\\b.txt", "..", ".", "",
                                 "model_manifest.json", "x\x00y"])
def test_traversal_artifact_names_fail_closed(tmp_path, bad):
    raw = json.dumps({"v": 1, "model_id": "m", "revision": "r", "dim": 4, "kind": "model2vec",
                      "files": [{"name": bad, "sha256": "0" * 64, "bytes": 1}]})
    with pytest.raises(EmbeddingFailed, match="illegal artifact name"):
        ModelManifest.from_json(raw)
    man = ModelManifest(model_id="m", revision="r", dim=4, kind="model2vec",
                        files=[ModelFileEntry(name=bad, sha256="0" * 64, bytes=1)])
    with pytest.raises(EmbeddingFailed, match="illegal artifact name"):
        ModelDownloader(FAST_CFG).acquire(man, LocalBundleSource(str(tmp_path)), str(tmp_path / "models" / "d"),
                                          authorized_by="op")
    assert not (tmp_path / "models" / "d").exists()


def test_concurrent_acquisition_excluded_by_lock(origin, tmp_path):  # noqa: F811
    man = manifest_for(ARTIFACTS, tmp_path)
    held = WriterLock(str(tmp_path / ".m.acquisition.lock")).acquire()
    try:
        with pytest.raises(EmbeddingFailed, match="already in progress"):
            acquire(man, origin, tmp_path / "m")
        assert diagnose_acquisition(str(tmp_path / "m"))["lock_present"]
    finally:
        held.release()
    assert acquire(man, origin, tmp_path / "m").outcome == "published"


def test_local_bundle_cannot_smuggle_unlisted_files(tmp_path):
    src = tmp_path / "bundle"
    src.mkdir()
    (src / "weights.npz").write_bytes(b"W" * 100)
    man = build_model_manifest(str(src), "m", "r", 8, "model2vec")
    (src / "trojan.py").write_text("import os")
    receipt = ModelDownloader(FAST_CFG).acquire(man, LocalBundleSource(str(src)), str(tmp_path / "m"),
                                                authorized_by="op")
    assert (receipt.source, receipt.source_hosts) == ("local_bundle", ())
    assert not (tmp_path / "m" / "trojan.py").exists() and verify_model_dir(str(tmp_path / "m")).ok
    os.remove(src / "weights.npz")
    with pytest.raises(EmbeddingFailed, match="missing artifact"):
        ModelDownloader(FAST_CFG).acquire(man, LocalBundleSource(str(src)), str(tmp_path / "m2"), authorized_by="op")


def test_receipt_rejects_foreign_version():
    with pytest.raises(EmbeddingFailed, match="unsupported receipt"):
        AcquisitionReceipt.from_dict({"v": 99})


def test_acquired_model2vec_embeds_on_the_port(origin, tmp_path):  # noqa: F811
    """A real Model2Vec artifact set over loopback HTTP, a load self-test
    through the port's embedder, then its vectors against the reference's
    embedder over the same published directory."""
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from frankensearch_tpu.embed.model2vec import Model2VecEmbedder as RefModel2Vec
    from frankensearch_tpu_torch.embed.model2vec import Model2VecEmbedder

    rng = np.random.default_rng(7)
    vocab = {"alpha": 0, "beta": 1, "gamma": 2, "delta": 3, "[UNK]": 4}
    author = tmp_path / "author"
    author.mkdir()
    save_file({"embeddings": rng.standard_normal((len(vocab), 16)).astype(np.float32)},
              str(author / "model.safetensors"))
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(author / "tokenizer.json"))
    (author / "config.json").write_text(json.dumps({"model_revision": "rev-9"}))
    man = build_model_manifest(str(author), "m2v-mini", "rev-9", 16, "model2vec")
    for name in ("model.safetensors", "tokenizer.json", "config.json"):
        _Origin.files["/" + name] = (author / name).read_bytes()

    def self_test(path, manifest):
        assert Model2VecEmbedder.from_dir(path, device="cpu").embed_batch(["alpha beta"]).shape == (1, manifest.dim)

    dest = tmp_path / "models" / "m2v-mini"
    assert acquire(man, origin, dest, load_self_test=self_test).outcome == "published"
    got = np.asarray(Model2VecEmbedder.from_dir(str(dest), device="cpu").embed_batch(["gamma delta alpha"]))
    want = np.asarray(RefModel2Vec.from_dir(str(dest)).embed_batch(["gamma delta alpha"]))
    assert got.shape == (1, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- download envelopes against the reference's ----------------------------------------------------


def bundle_dir(d) -> None:
    src = d / "bundle"
    src.mkdir()
    for name, body in ARTIFACTS.items():
        (src / name).write_bytes(body)
    man = build_model_manifest(str(src), "m", "rev-1", 64, "model2vec")
    (src / "model_manifest.json").write_text(man.to_json())


def strip_download(env: dict) -> dict:
    receipt = (env.get("data") or {}).get("receipt")
    if receipt is not None:
        receipt.pop("duration_ms")
    return env


@pytest.mark.parametrize("argv,prepare", [
    (lambda d: ["download", "m", "--root", str(d / "ix"), "--from-dir", str(d / "bundle"), "--authorize", "op"],
     bundle_dir),
    (lambda d: ["download", "m", "--root", str(d / "ix"), "--from-dir", str(d / "bundle")], bundle_dir),
    (lambda d: ["download", "m", "--root", str(d / "ix"), "--authorize", "op"], None),
    (lambda d: ["download", "m", "--root", str(d / "ix"), "--authorize", "op", "--manifest",
                str(d / "bundle" / "model_manifest.json")], bundle_dir),
    (lambda d: ["download", "m", "--root", str(d / "ix"), "--diagnose"], None),
], ids=["from-dir", "unauthorized", "no-manifest", "no-source", "diagnose"])
def test_download_envelopes_equal_reference(tmp_path, argv, prepare):
    got, want = envs(tmp_path, argv, prepare)
    assert strip_download(got) == strip_download(want)


def test_download_warm_cache_and_failure_envelopes_equal_reference(tmp_path):
    """A second ``download`` of the same bundle reuses the verified
    destination; a bundle missing an artifact fails typed."""
    def twice(d):
        bundle_dir(d)
        rc, _ = run("port" if d.name == "port" else "ref", "--format", "json", "download", "m", "--root",
                    str(d / "ix"), "--from-dir", str(d / "bundle"), "--authorize", "op")
        assert rc == 0

    (tmp_path / "warm").mkdir()
    got, want = envs(tmp_path / "warm", lambda d: ["download", "m", "--root", str(d / "ix"), "--from-dir",
                                                   str(d / "bundle"), "--authorize", "op"], twice)
    assert strip_download(got) == strip_download(want) and got["data"]["receipt"]["outcome"] == "verified_warm_cache"

    def broken(d):
        bundle_dir(d)
        os.remove(d / "bundle" / "vocab.txt")

    (tmp_path / "broken").mkdir()
    got, want = envs(tmp_path / "broken", lambda d: ["download", "m", "--root", str(d / "ix"), "--from-dir",
                                                     str(d / "bundle"), "--authorize", "op"], broken)
    assert got == want and got["error"]["code"] == "acquisition_failed"


def test_download_over_loopback_envelope_equals_reference(origin, tmp_path):  # noqa: F811
    for name, body in ARTIFACTS.items():
        _Origin.files["/" + name] = body

    def manifest_only(d):
        bundle_dir(d)
        shutil.move(str(d / "bundle" / "model_manifest.json"), str(d / "manifest.json"))
        shutil.rmtree(d / "bundle")

    got, want = envs(tmp_path, lambda d: ["download", "m", "--root", str(d / "ix"), "--url", origin, "--manifest",
                                          str(d / "manifest.json"), "--authorize", "op", "--max-retries", "1"],
                     manifest_only)
    assert strip_download(got) == strip_download(want)
    assert got["data"]["receipt"]["source"] == "network" and got["data"]["stages"] == ["staged_verified", "published"]
