"""The port's ``watch`` (and ``runtime/mounts.py``) against the JAX
package's on the CPU.

Oracles: tests/test_cli_e2e.py::test_watch_* (ingest and delete across
arms, the storage census, the NDJSON record lifecycle), a corrupt members
sidecar, tests/test_rename_detection.py (a rename re-keys without
re-embedding), tests/test_mounts_tracing.py's ``MountTable`` cases and
tests/test_wal_group_commit.py's ``--durability-window`` case. Both CLIs
run in process (tests/test_torch_cli.py's helpers): one corpus directory,
mutated between cycles, watched into a root of each package built from it;
after every cycle the two ``watch`` envelopes are equal and ``search``
over both roots gives the same rows (scores within 1e-6 relative). The
port's ``watch`` and ``tui`` also run over a root the reference built and
the reference's ``watch`` wrote to.
"""

import json
import os
import shutil

import pytest

import frankensearch_tpu.runtime.mounts as ref_mounts
import frankensearch_tpu_torch.runtime.mounts as port_mounts
from tests.test_torch_cli import (  # noqa: F401
    both, env_of, no_pallas, reference_logger_untouched, run, same_rows,
)

WATCH = ("--once", "--cycles", "2", "--debounce", "0")


def build(tmp_path, corpus) -> dict:
    """Each package's root over ``corpus``."""
    roots = {}
    for pkg in ("port", "ref"):
        roots[pkg] = str(tmp_path / f"ix_{pkg}")
        env_of(pkg, "index", str(corpus), "--root", roots[pkg])
    return roots


def watch_both(corpus, roots, *extra) -> dict:
    """One ``watch`` of ``corpus`` into each root (the port's first: the
    reference's second poll must see the same tree); the envelopes equal."""
    got, want = both("watch", str(corpus), "--root", "{root}", *WATCH, *extra, roots=roots)
    assert got == want
    return got["data"]


def search_equal(roots, query: str, k: int = 5) -> list:
    got, want = both("search", query, "--root", "{root}", "-k", str(k), roots=roots)
    same_rows(got["data"], want["data"])
    return got["data"]


def test_watch_ingests_and_deletes_across_arms_equals_reference(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.txt").write_text("alpha beta document one")
    (corpus / "b.txt").write_text("zeppelin unique document")
    roots = build(tmp_path, corpus)
    assert search_equal(roots, "zeppelin unique", 2)[0]["doc_id"] == "b.txt"
    os.remove(corpus / "b.txt")
    (corpus / "c.txt").write_text("quartz onyx new document")
    data = watch_both(corpus, roots)
    assert data["batches"] == [{"ingested": 1, "deleted": 1, "renamed": 0}]
    assert search_equal(roots, "quartz onyx", 2)[0]["doc_id"] == "c.txt"
    assert all(r["doc_id"] != "b.txt" for r in search_equal(roots, "zeppelin unique", 3))


def test_watch_ingested_docs_join_storage_census_equals_reference(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.txt").write_text("alpha beta document")
    roots = build(tmp_path, corpus)
    (corpus / "b.txt").write_text("delta epsilon zeta fresh")
    watch_both(corpus, roots)
    # negation and a scrambled phrase over the watch-ingested doc's text
    for q in ("delta epsilon -fresh", '"epsilon delta"'):
        got, want = both("search", q, "--root", "{root}", "-k", "3", roots=roots, stdin=None)
        same_rows(got["data"], want["data"])
        assert all(r["doc_id"] != "b.txt" for r in got["data"])
    got, want = both("status", "--root", "{root}", roots=roots)
    assert got["data"]["storage"] == want["data"]["storage"]
    assert got["data"]["storage"]["doc_count"] == 2


def test_watch_ndjson_record_lifecycle_equals_reference(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "batch.jsonl").write_text(
        '{"id":"r1","content":"kilo lima"}\n{"id":"r2","content":"mike november"}\n')
    roots = build(tmp_path, corpus)
    (corpus / "batch.jsonl").write_text(
        '{"id":"r1","content":"kilo lima updated quebec"}\n{"id":"r3","content":"romeo sierra"}\n')
    assert watch_both(corpus, roots)["batches"] == [{"ingested": 2, "deleted": 1, "renamed": 0}]
    got = search_equal(roots, "quebec", 3)
    assert got[0]["doc_id"] == "r1" and got[0].get("lexical_score") is not None
    assert all(r.get("lexical_score") is None for r in search_equal(roots, "november", 3))
    os.remove(corpus / "batch.jsonl")
    assert watch_both(corpus, roots)["batches"] == [{"ingested": 0, "deleted": 2, "renamed": 0}]
    assert all(r["doc_id"] != "r3" for r in search_equal(roots, "romeo", 3))


def test_watch_corrupt_members_sidecar_equals_reference(tmp_path):
    """A members sidecar of the wrong shape degrades to re-learning the
    memberships; it never crashes the watch."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "batch.jsonl").write_text('{"id":"r1","content":"kilo lima"}\n')
    roots = build(tmp_path, corpus)
    for root in roots.values():
        with open(os.path.join(root, "watch_members.json"), "w") as f:
            json.dump({"batch.jsonl": 123, "other.jsonl": "r9"}, f)
    (corpus / "batch.jsonl").write_text('{"id":"r2","content":"oscar papa"}\n')
    assert watch_both(corpus, roots)["batches"] == [{"ingested": 1, "deleted": 0, "renamed": 0}]
    for root in roots.values():
        with open(os.path.join(root, "watch_members.json")) as f:
            assert json.load(f) == {"batch.jsonl": ["r2"]}
    assert search_equal(roots, "oscar papa", 2)[0]["doc_id"] == "r2"


def test_watch_rename_rekeys_without_reembedding_equals_reference(tmp_path, monkeypatch):
    import frankensearch_tpu.embed.hash_embedder as ref_he
    import frankensearch_tpu_torch.embed.hash_embedder as port_he

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "keep.txt").write_text("anchor document zeta")
    (corpus / "old_name.txt").write_text("movable payload omega")
    roots = build(tmp_path, corpus)
    before = search_equal(roots, "movable payload omega", 2)
    os.rename(corpus / "old_name.txt", corpus / "new_name.txt")
    embedded = []
    for he in (ref_he, port_he):
        real = he.HashEmbedder.embed_batch
        monkeypatch.setattr(he.HashEmbedder, "embed_batch",
                            lambda self, texts, _real=real: embedded.append(list(texts)) or _real(self, texts))
    data = watch_both(corpus, roots)
    assert data["batches"] == [{"ingested": 0, "deleted": 0, "renamed": 1}]
    assert not any("movable payload" in t for batch in embedded for t in batch)
    got = search_equal(roots, "movable payload omega", 2)
    assert got[0]["doc_id"] == "new_name.txt"
    assert got[0]["fast_score"] == before[0]["fast_score"]  # the row moved, not re-embedded
    assert all(r["doc_id"] != "old_name.txt" for r in got)


def test_watch_durability_window_equals_reference(tmp_path):
    """Group commit: the appends ride the page cache and the exit is a
    commit point; the WAL both packages wrote replays to the same state."""
    from frankensearch_tpu.index.wal import WriteAheadLog as RefWal
    from frankensearch_tpu_torch.index.wal import WriteAheadLog as PortWal

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.txt").write_text("alpha beta document")
    roots = build(tmp_path, corpus)
    for i in range(3):
        (corpus / f"n{i}.txt").write_text(f"sierra tango {i} uniform")
    os.remove(corpus / "a.txt")
    watch_both(corpus, roots, "--durability-window", "0.5")
    states = {}
    for pkg, wal in (("port", PortWal), ("ref", RefWal)):
        st = wal(os.path.join(roots[pkg], "vector.fast.idx.wal")).replay(strict=True)
        states[pkg] = (sorted(st.live), sorted(st.tombstones), st.bytes_discarded)
    assert states["port"] == states["ref"]
    assert states["port"][0] == ["n0.txt", "n1.txt", "n2.txt"] and states["port"][1] == ["a.txt"]
    search_equal(roots, "sierra tango", 3)


def test_port_watch_and_tui_over_a_reference_root(tmp_path):
    """The port opens, watches into and serves a root the reference built
    and the reference's ``watch`` wrote to; every row equals the
    reference's over its own copy of the same steps."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.txt").write_text("alpha beta document")
    (corpus / "b.txt").write_text("bravo charlie delta")
    root = str(tmp_path / "ix")
    env_of("ref", "index", str(corpus), "--root", root)
    (corpus / "c.txt").write_text("echo foxtrot golf")
    assert env_of("ref", "watch", str(corpus), "--root", root, *WATCH)["ok"]
    twin = str(tmp_path / "ix_twin")
    shutil.copytree(root, twin)
    roots = {"port": root, "ref": twin}
    (corpus / "d.txt").write_text("hotel india juliet")
    os.remove(corpus / "b.txt")
    assert watch_both(corpus, roots)["batches"] == [{"ingested": 1, "deleted": 1, "renamed": 0}]
    for q in ("echo foxtrot", "hotel india", "bravo charlie"):
        search_equal(roots, q, 3)
    script = "hotel india\necho\n:q\n"
    frames = {pkg: run(pkg, "tui", "--root", roots[pkg], stdin=script)[1] for pkg in ("port", "ref")}
    assert frames["port"] == frames["ref"]
    assert "d.txt" in frames["port"]


# -- runtime/mounts.py, both packages ----------------------------------------------------------


@pytest.fixture(params=["port", "ref"])
def mounts(request):
    return port_mounts if request.param == "port" else ref_mounts


def test_mounts_classify_and_longest_prefix(mounts):
    assert mounts.classify_fs("ext4")[0] is mounts.MountPolicy.INDEX
    assert mounts.classify_fs("nfs4")[0] is mounts.MountPolicy.WARN
    assert mounts.classify_fs("fuse.sshfs")[0] is mounts.MountPolicy.WARN
    assert mounts.classify_fs("proc")[0] is mounts.MountPolicy.SKIP
    table = [("/", "ext4"), ("/mnt/nfs", "nfs4"), ("/proc", "proc")]
    assert mounts.mount_info_for("/mnt/nfs/data", table).policy is mounts.MountPolicy.WARN
    assert mounts.mount_info_for("/home/user", table).policy is mounts.MountPolicy.INDEX
    assert mounts.mount_info_for("/proc/self", table).policy is mounts.MountPolicy.SKIP


def test_mounts_taxonomy_and_policies(mounts):
    fc = mounts.FsCategory
    assert [mounts.classify_fstype(t) for t in ("ext4", "apfs", "nfs4", "cifs", "fuse.sshfs", "fuse.rclone",
                                                  "tmpfs", "overlay", "proc", "weirdfs")] == [
        fc.LOCAL, fc.LOCAL, fc.NFS, fc.CIFS, fc.SSHFS, fc.FUSE, fc.MEMORY, fc.VIRTUAL, fc.VIRTUAL, fc.UNKNOWN]
    assert fc.NFS.is_network and not fc.LOCAL.is_network
    assert fc.LOCAL.supports_reliable_watch and not fc.SSHFS.supports_reliable_watch
    local = mounts.FullMountPolicy.for_category(fc.LOCAL)
    assert local.change_detection is mounts.ChangeDetection.WATCH and local.max_concurrent_io == 64
    assert mounts.FullMountPolicy.for_category(fc.NFS).max_concurrent_io == 8
    assert not mounts.FullMountPolicy.for_category(fc.VIRTUAL).enabled
    assert mounts.FullMountPolicy.for_category(fc.UNKNOWN).max_concurrent_io == 4


def policy_tuple(p) -> tuple:
    """A mount policy as plain values (the two packages' enums differ)."""
    return tuple((k, getattr(v, "value", v)) for k, v in sorted(vars(p).items()))


def test_mounts_table_equals_reference():
    """Parse, lookup with overrides, availability marking: every result
    equal between the packages."""
    content = ("/dev/sda1 / ext4 rw,relatime 0 0\nhost:/export /mnt/nfs nfs4 rw 0 0\n"
               "host:/export/deep /mnt/nfs/deep nfs4 rw 0 0\ntmpfs /tmp/with\\040space tmpfs rw 0 0\n"
               "# comment\nshort line\n")
    out = {}
    for name, m in (("port", port_mounts), ("ref", ref_mounts)):
        entries = m.parse_proc_mounts(content)
        table = m.MountTable(entries, overrides={"/mnt/nfs/deep": m.MountOverride(
            change_detection=m.ChangeDetection.STATIC, max_concurrent_io=2)})
        looked = []
        for path in ("/mnt/nfs/deep/f.txt", "/mnt/nfs/x", "/home/u/x", "/tmp/with space/y"):
            e, p = table.lookup(path)
            looked.append((e.mount_point, e.category.value, policy_tuple(p)))
        marks = [table.mark_unavailable("/mnt/nfs"), len(table.enabled_mounts()),
                 table.mark_available("/mnt/nfs"), len(table.enabled_mounts()), table.mark_unavailable("/nope")]
        t2 = m.MountTable(entries, overrides={"/mnt/nfs": m.MountOverride(category=m.FsCategory.LOCAL)})
        out[name] = ([(x.device, x.mount_point, x.fstype, x.category.value) for x in entries], looked,
                     [x.mount_point for x in table.network_mounts()], marks, policy_tuple(t2.lookup("/mnt/nfs/x")[1]))
    assert out["port"] == out["ref"]
    assert out["port"][2] == ["/mnt/nfs", "/mnt/nfs/deep"] and out["port"][3] == [True, 3, True, 4, False]


def test_mounts_probe_and_error_class(mounts, tmp_path):
    ok = mounts.probe_mount(str(tmp_path), timeout_s=5.0)
    assert ok.available and ok.error is None
    missing = mounts.probe_mount(str(tmp_path / "gone"), timeout_s=5.0)
    assert not missing.available and "permanent" in missing.error
    slow = mounts.probe_mount(str(tmp_path), timeout_s=0.0)
    assert not slow.available and "exceeds timeout" in slow.error
    assert mounts.classify_io_error(FileNotFoundError()) is mounts.IoErrorClass.PERMANENT
    assert mounts.classify_io_error(TimeoutError()) is mounts.IoErrorClass.TRANSIENT


def test_watcher_respects_the_port_mount_policy(tmp_path):
    from frankensearch_tpu_torch.runtime.watcher import SnapshotWatcher

    m = port_mounts
    root = tmp_path / "corpus"
    root.mkdir()
    (root / "a.txt").write_text("hello")
    table = m.MountTable([m.MountEntry("dev", str(tmp_path), "nfs4", m.FsCategory.NFS)])
    w = SnapshotWatcher([str(root)], str(tmp_path / "snap.json"), mount_table=table)
    assert w.roots == [str(root)] and w.recommended_poll_s == 60.0
    assert any("network mount" in x for x in w.mount_warnings)
    off = m.MountTable([m.MountEntry("dev", str(tmp_path), "nfs4", m.FsCategory.NFS)],
                       overrides={str(tmp_path): m.MountOverride(enabled=False)})
    w2 = SnapshotWatcher([str(root)], str(tmp_path / "snap2.json"), mount_table=off)
    assert w2.roots == [] and w2.mount_warnings
    assert m.MountTable.system().lookup(str(tmp_path)) is not None
