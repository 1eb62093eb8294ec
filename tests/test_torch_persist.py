"""The segment/persist seam of the port (``index/file_identity``,
``lexical/flexb``, ``lexical/segments``, ``lexical/persist``) against the
JAX reference on the CPU.

Each scenario of the reference's oracles (tests/test_durability.py's file
identity, confinement and writer lock; tests/test_flexb.py;
tests/test_incremental_seal.py's stacking and persisted stacks;
tests/test_seal_fuzz.py's raw-section seams and crash safety;
tests/test_durability_repair.py's FLXB repair) runs on both packages
(``PKGS``), and the artifacts both write from the same documents are
compared byte for byte: FLXB segments, oracle JSON snapshots,
``segments.json`` and the delta snapshots. Generation names carry a
clock, so artifacts are compared by role. Loads, searches and the
segment stack's global-idf scores are held bitwise to the reference (the
dense lane; the split layout with the reference's flat lane in interpret
mode, K3's order).
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import frankensearch_tpu.core.errors as j_errors
import frankensearch_tpu.core.types as j_types
import frankensearch_tpu.index.durability as j_dur
import frankensearch_tpu.index.file_identity as j_fid
import frankensearch_tpu.lexical.device_bm25 as j_dbm
import frankensearch_tpu.lexical.flexb as j_flexb
import frankensearch_tpu.lexical.memory_index as j_mem
import frankensearch_tpu.lexical.persist as j_persist
import frankensearch_tpu.lexical.segments as j_seg
import frankensearch_tpu_torch.core.errors as t_errors
import frankensearch_tpu_torch.core.types as t_types
import frankensearch_tpu_torch.index.durability as t_dur
import frankensearch_tpu_torch.index.file_identity as t_fid
import frankensearch_tpu_torch.lexical.device_bm25 as t_dbm
import frankensearch_tpu_torch.lexical.flexb as t_flexb
import frankensearch_tpu_torch.lexical.memory_index as t_mem
import frankensearch_tpu_torch.lexical.persist as t_persist
import frankensearch_tpu_torch.lexical.segments as t_seg
from tests.test_torch_hot_arm import lowered, reference_flat_interpret

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(
    name="ref", fid=j_fid, flexb=j_flexb, persist=j_persist, seg=j_seg, dbm=j_dbm, dur=j_dur,
    errors=j_errors, Doc=j_types.IndexableDocument, Mem=j_mem.MemoryLexicalIndex, kw={},
)
PORT = SimpleNamespace(
    name="port", fid=t_fid, flexb=t_flexb, persist=t_persist, seg=t_seg, dbm=t_dbm, dur=t_dur,
    errors=t_errors, Doc=t_types.IndexableDocument, Mem=t_mem.MemoryLexicalIndex, kw={"device": CPU},
)
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
WORDS = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()
QUERIES = ["alpha", "beta gamma", "kappa iota theta", "alpha alpha zeta", "missing"]


def corpus(pkg, n=40, seed=7):
    """tests/test_flexb.py's corpus: 20 words over 50 terms, some titles
    and metadata."""
    rng = np.random.default_rng(seed)
    vocab = [f"term{i:02d}" for i in range(50)]
    return [
        pkg.Doc(
            doc_id=f"doc-{i:03d}",
            content=" ".join(rng.choice(vocab, size=20)),
            title=f"title {vocab[i % 50]}" if i % 3 == 0 else None,
            metadata={"n": i} if i % 5 == 0 else None,
        )
        for i in range(n)
    ]


def word_docs(pkg, n, seed, length=12, start=0):
    """tests/test_incremental_seal.py's docs: ``length`` words over ten."""
    rng = np.random.default_rng(seed)
    return [pkg.Doc(doc_id=f"doc-{start + i:05d}", content=" ".join(rng.choice(WORDS, size=length)))
            for i in range(n)]


def mem_of(pkg, docs):
    mem = pkg.Mem()
    for d in docs:
        mem.add_document(d)
    mem.commit()
    return mem


def device_index(pkg, docs):
    return pkg.dbm.DeviceBm25Index(mem_of(pkg, docs), **pkg.kw)


def bulk(pkg, docs):
    return pkg.dbm.BulkDeviceBm25Index(docs, **pkg.kw)


def hits(arm, queries=QUERIES, k=15):
    return [[(c.doc_id, c.score) for c in arm.search_candidates(q, k)] for q in queries]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def current_gen(root):
    with open(os.path.join(root, "lexical", "CURRENT")) as f:
        return f.read().strip()


def flip(path, offset, n=4):
    with open(path, "r+b") as f:
        f.seek(offset)
        data = f.read(n)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in data))


# -- index/file_identity ------------------------------------------------------


@PKGS
def test_file_identity_rename_stable_and_replace_detected(pkg, tmp_path):
    p = tmp_path / "f1"
    p.write_text("x")
    before = pkg.fid.FileIdentity.of(str(p))
    os.rename(p, tmp_path / "f2")
    after = pkg.fid.FileIdentity.of(str(tmp_path / "f2"))
    assert before.same_file(after) and before.unchanged(after)
    repl = tmp_path / "f.new"
    repl.write_text("x")
    os.replace(repl, tmp_path / "f2")
    assert not before.same_file(pkg.fid.FileIdentity.of(str(tmp_path / "f2")))


@PKGS
def test_confined_root_admits_inside_and_refuses_escapes(pkg, tmp_path):
    gen = tmp_path / "gen"
    (gen / "sub").mkdir(parents=True)
    (gen / "sub" / "a.bin").write_bytes(b"payload")
    (tmp_path / "secret").write_bytes(b"outside")
    os.symlink(str(tmp_path / "secret"), str(gen / "sub" / "leak"))
    os.symlink(str(tmp_path), str(gen / "updir"))
    root = pkg.fid.ConfinedRoot(str(gen))
    try:
        assert root.exists("sub/a.bin") and root.open_bytes("sub/a.bin") == b"payload"
        for bad in ("../outside", "/etc/passwd", "sub/leak"):
            with pytest.raises(pkg.fid.PathEscape):
                root.resolve(bad)
        for bad in ("sub/leak", "updir/secret"):
            with pytest.raises(pkg.fid.PathEscape):
                root.open_bytes(bad)
        with pytest.raises(pkg.fid.PathEscape):
            root.open_fd("sub/../sub/a.bin")
    finally:
        root.close()


@PKGS
def test_writer_lock_is_exclusive_and_guards_publication(pkg, tmp_path):
    path = str(tmp_path / "w.lock")
    with pkg.fid.WriterLock(path):
        with pytest.raises(pkg.fid.LockHeld, match="pid="):
            pkg.fid.WriterLock(path).acquire()
    pkg.fid.WriterLock(path).acquire().release()
    mem = mem_of(pkg, [pkg.Doc(doc_id="d", content="alpha")])
    os.makedirs(tmp_path / "lexical", exist_ok=True)
    with pkg.fid.WriterLock(str(tmp_path / "lexical" / ".writer.lock")):
        with pytest.raises(pkg.fid.LockHeld):
            pkg.persist.save_lexical(mem, str(tmp_path))
    assert pkg.persist.save_lexical(mem, str(tmp_path))


def test_port_writer_lock_dies_with_its_process(tmp_path):
    path = str(tmp_path / "w.lock")
    subprocess.run(
        [sys.executable, "-c",
         "from frankensearch_tpu_torch.index.file_identity import WriterLock;"
         f"WriterLock({path!r}).acquire()"],
        check=True, capture_output=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
    )
    t_fid.WriterLock(path).acquire().release()


def test_filesystem_policy_equals_reference(tmp_path):
    from dataclasses import astuple

    assert astuple(t_fid.filesystem_policy(str(tmp_path))) == astuple(j_fid.filesystem_policy(str(tmp_path)))
    assert t_fid._NETWORK_FS == j_fid._NETWORK_FS and t_fid._LOCAL_DURABLE == j_fid._LOCAL_DURABLE


# -- lexical/flexb: the container ------------------------------------------------


def test_container_bytes_equal_and_aligned(tmp_path):
    sections = {"alpha": b"abc", "beta": b"x" * 100, "gamma": b""}
    j_flexb.write_sections(str(tmp_path / "ref.flexb"), sections)
    t_flexb.write_sections(str(tmp_path / "port.flexb"), sections)
    raw = read(tmp_path / "port.flexb")
    assert raw == read(tmp_path / "ref.flexb")
    assert t_flexb.read_sections(str(tmp_path / "ref.flexb")) == sections
    for i in range(3):
        _, off, _ = t_flexb._SECTION.unpack_from(raw, t_flexb._HEADER.size + i * t_flexb._SECTION.size)
        assert off % 64 == 0


@pytest.mark.parametrize("fault,match", [("crc", "CRC"), ("magic", "magic"), ("version", "version"),
                                         ("truncated", None)])
def test_container_faults_raise_typed(tmp_path, fault, match):
    p = str(tmp_path / "x.flexb")
    t_flexb.write_sections(p, {"alpha": b"hello world payload" * 10})
    raw = bytearray(read(p))
    if fault == "crc":
        raw[-3] ^= 0xFF
    elif fault == "magic":
        raw[:4] = b"NOPE"
    elif fault == "version":
        raw[4] = 99
    else:
        raw = raw[: len(raw) - 50]
    with open(p, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(t_flexb.FlexbCorrupted, match=match):
        t_flexb.read_sections(p)
    with pytest.raises(j_flexb.FlexbCorrupted, match=match):
        j_flexb.read_sections(p)


# -- lexical/flexb: packed segments ------------------------------------------------


@pytest.mark.parametrize("kind", ["bulk", "memory", "memory_split"])
def test_packed_segment_bytes_equal_reference(tmp_path, kind):
    """The same documents give byte-identical FLXB segments (the split
    layout does not change what is written: the unsplit host postings
    and the raw sections)."""
    paths = {}
    for pkg in (REF, PORT):
        docs = corpus(pkg)
        if kind == "bulk":
            index = bulk(pkg, docs)
        elif kind == "memory":
            index = device_index(pkg, docs)
        else:
            with lowered():
                index = device_index(pkg, docs)
            assert index._hot is not None
        paths[pkg.name] = str(tmp_path / f"{pkg.name}.flexb")
        pkg.flexb.save_packed(index, paths[pkg.name])
    assert read(paths["port"]) == read(paths["ref"])
    assert "rtf" in t_flexb.read_sections(paths["port"])


@pytest.mark.parametrize("layout", ["dense", "split"])
def test_port_loads_reference_segment_bitwise(tmp_path, layout):
    """The port's ``load_packed`` of a reference-written segment serves
    the reference's loaded arm bitwise, in the dense lane and in the
    split layout (hot arm, flat lane on K3's twin, DAAT)."""
    path = str(tmp_path / "ref.flexb")
    j_flexb.save_packed(bulk(REF, corpus(REF, n=60)), path)
    if layout == "dense":
        ref, port = j_flexb.load_packed(path), t_flexb.load_packed(path, device=CPU)
        assert port._blocked is None
        assert hits(port) == hits(ref)
    else:
        with lowered(), reference_flat_interpret():
            ref, port = j_flexb.load_packed(path), t_flexb.load_packed(path, device=CPU)
            assert port._hot is not None and port._term_major().packed
            queries = QUERIES + ["term00 term07", "term31", "title term12 term40"]
            assert hits(port, queries) == hits(ref, queries)
    assert port.doc_ids == ref.doc_ids and port.n_docs == ref.n_docs
    assert (port.posting_count, port.vocab_size) == (ref.posting_count, ref.vocab_size)
    assert port.device == CPU
    for name, arm in ref._arms.items():
        assert port._arms[name].term_ids == arm.term_ids and port._arms[name].df_host is None
        np.testing.assert_array_equal(port._arms[name].idf_host, arm.idf_host)


def test_roundtrip_serves_the_built_index(tmp_path):
    docs = corpus(PORT)
    built = bulk(PORT, docs)
    path = str(tmp_path / "lex.flexb")
    t_flexb.save_packed(built, path)
    loaded = t_flexb.load_packed(path, device=CPU)
    assert hits(loaded, QUERIES + ["term00", "term07 term31"]) == hits(built, QUERIES + ["term00", "term07 term31"])
    meta = loaded.hydrate_candidates(["doc-000", "doc-005"])
    assert meta == {d: {k: v for k, v in m.items()} for d, m in built.hydrate_candidates(["doc-000", "doc-005"]).items()}
    assert meta["doc-005"]["metadata"] == {"n": 5} and meta["doc-000"]["title"].startswith("title ")


@PKGS
def test_packed_generation_publish_and_load(pkg, tmp_path):
    root = str(tmp_path / "root")
    gen = pkg.persist.save_packed_lexical(bulk(pkg, corpus(pkg, 12)), root)
    assert current_gen(root) == gen
    assert pkg.persist.load_packed_lexical(root, **pkg.kw).n_docs == 12
    gen2 = pkg.persist.save_packed_lexical(bulk(pkg, corpus(pkg, 13)), root)
    assert gen2 != gen and pkg.persist.load_packed_lexical(root, **pkg.kw).n_docs == 13
    assert pkg.persist.load_packed_lexical(str(tmp_path / "absent"), **pkg.kw) is None


def _small_segment(tmp_path):
    docs = [PORT.Doc(doc_id=f"d{i}", content=f"alpha beta doc {i}") for i in range(20)]
    path = str(tmp_path / "x.flexb")
    t_flexb.save_packed(bulk(PORT, docs), path)
    return path


def test_random_flips_raise_typed_errors(tmp_path):
    """tests/test_flexb.py's fuzz on the port: a flipped byte either loads
    or raises a typed SearchError, never anything else."""
    path = _small_segment(tmp_path)
    orig = read(path)
    rng = np.random.default_rng(0)
    detected = 0
    for _ in range(12):
        off = int(rng.integers(0, len(orig)))
        bad = bytearray(orig)
        bad[off] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(bad))
        try:
            t_flexb.load_packed(path, device=CPU)
        except t_errors.SearchError:
            detected += 1
    assert detected >= 6


def test_truncation_at_every_offset_raises_typed(tmp_path):
    path = _small_segment(tmp_path)
    orig = read(path)
    for off in range(len(orig)):
        with open(path, "wb") as f:
            f.write(orig[:off])
        with pytest.raises(t_errors.SearchError):
            t_flexb.load_packed(path, device=CPU)
    with open(path, "wb") as f:
        f.write(os.urandom(4096))
    with pytest.raises(t_errors.SearchError):
        t_flexb.load_packed(path, device=CPU)


def test_raw_shorter_than_postings_falls_back_to_f32(tmp_path):
    """tests/test_seal_fuzz.py: a CRC-valid segment whose raw tf section
    undercounts the postings loads the f32 term-major layout, and scores
    as the reference does."""
    with lowered(hot=False):
        for pkg in (REF, PORT):
            dev = device_index(pkg, word_docs(pkg, 60, seed=3, length=10))
            path = str(tmp_path / f"{pkg.name}.flxb")
            pkg.flexb.save_packed(dev, path)
            sec = pkg.flexb.read_sections(path)
            sec["rtf"] = sec["rtf"][: len(sec["rtf"]) // 2]
            pkg.flexb.write_sections(str(tmp_path / f"{pkg.name}-crafted.flxb"), sec)
        assert read(tmp_path / "port-crafted.flxb") == read(tmp_path / "ref-crafted.flxb")
        loaded = t_flexb.load_packed(str(tmp_path / "port-crafted.flxb"), device=CPU)
        tm = loaded._term_major()
        assert tm is not None and not tm.packed
        ref = j_flexb.load_packed(str(tmp_path / "ref-crafted.flxb"))
        assert hits(loaded, ["alpha beta", "kappa"], 10) == hits(ref, ["alpha beta", "kappa"], 10)
    blob = bytearray(read(tmp_path / "port.flxb"))
    blob[len(blob) * 2 // 3] ^= 0xFF
    with open(tmp_path / "port.flxb", "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(t_flexb.FlexbCorrupted):
        t_flexb.read_sections(str(tmp_path / "port.flxb"))


# -- lexical/segments -------------------------------------------------------------


def _stack(pkg, base_kind, tmp_path):
    """A two-segment stack: a base segment of ``base_kind`` (``memory``:
    df stored; ``bulk``: df stored; ``flexb``: loaded, df inverted from
    the idf) and a 20-doc delta whose docs keep the corpus's lengths."""
    base = word_docs(pkg, 100, seed=2, length=10)
    if base_kind == "memory":
        sealed = device_index(pkg, base)
    elif base_kind == "bulk":
        sealed = bulk(pkg, base)
    else:
        path = str(tmp_path / f"{pkg.name}-base.flexb")
        pkg.flexb.save_packed(bulk(pkg, base), path)
        sealed = pkg.flexb.load_packed(path, **pkg.kw)
    return sealed, pkg.seg.append_segment(sealed, word_docs(pkg, 20, seed=7, length=10, start=1000))


@pytest.mark.parametrize("base_kind", ["memory", "bulk", "flexb"])
def test_segment_stack_global_idf_equals_reference(tmp_path, base_kind):
    """The stack weights every segment with the whole stack's idf (df
    summed over segments: stored, or inverted from a loaded segment's
    idf), bitwise as the reference does."""
    (j_base, j_stack), (t_base, t_stack) = _stack(REF, base_kind, tmp_path), _stack(PORT, base_kind, tmp_path)
    assert isinstance(t_stack, t_seg.SegmentedBm25) and t_stack.segments[0] is t_base
    assert t_stack.segments[1].device == CPU and t_stack.n_docs == 120
    assert (t_base._arms["content"].df_host is None) == (base_kind == "flexb")
    terms = sorted(set(WORDS) | {"missing"})
    assert t_stack._global_weights(terms) == j_stack._global_weights(terms)
    queries = QUERIES + ["alpha beta gamma delta", "eta"]
    got = [[(c.doc_id, c.score) for c in r] for r in t_stack.search_candidates_batch(queries, 30)]
    want = [[(c.doc_id, c.score) for c in r] for r in j_stack.search_candidates_batch(queries, 30)]
    assert got == want
    assert t_stack.hydrate_candidates(["doc-01000", "doc-00001"]).keys() == \
        j_stack.hydrate_candidates(["doc-01000", "doc-00001"]).keys()


@PKGS
def test_stack_scores_match_a_full_rebuild(pkg):
    """Delta docs of the corpus's length keep avgdl, so the stack scores
    as one rebuilt segment and ranks as the oracle."""
    base, extra = word_docs(pkg, 100, seed=2, length=10), word_docs(pkg, 20, seed=7, length=10, start=1000)
    stack = pkg.seg.append_segment(device_index(pkg, base), extra)
    full = device_index(pkg, base + extra)
    oracle = mem_of(pkg, base + extra)
    for q in ["alpha", "beta gamma", "kappa iota theta"]:
        a, b = stack.search_candidates(q, 30), full.search_candidates(q, 30)
        assert [c.doc_id for c in a] == [c.doc_id for c in b] == [c.doc_id for c in oracle.search_candidates(q, 30)]
        np.testing.assert_allclose([c.score for c in a], [c.score for c in b], rtol=1e-5)


@PKGS
def test_flooding_term_down_weights_old_segment(pkg):
    base = [pkg.Doc(doc_id=f"doc-{i:05d}", content="alpha beta") for i in range(20)]
    base += [pkg.Doc(doc_id=f"doc-{100 + i:05d}", content="gamma beta") for i in range(20)]
    sealed = device_index(pkg, base)
    solo = {c.doc_id: c.score for c in sealed.search_candidates("alpha", 50)}
    flood = [pkg.Doc(doc_id=f"doc-{1000 + i:05d}", content="alpha alpha delta") for i in range(60)]
    stack = pkg.seg.append_segment(sealed, flood)
    after = {c.doc_id: c.score for c in stack.search_candidates("alpha", 200) if c.doc_id.startswith("doc-000")}
    assert after and all(s < solo[d] for d, s in after.items())


@PKGS
def test_append_segment_refuses_supersession_and_a_full_stack(pkg):
    base = word_docs(pkg, 30, seed=2)
    sealed = device_index(pkg, base)
    assert pkg.seg.append_segment(sealed, word_docs(pkg, 2, seed=1)) is None  # doc-00000 again
    stack = sealed
    for i in range(pkg.seg.MAX_SEGMENTS - 1):
        stack = pkg.seg.append_segment(stack, word_docs(pkg, 3, seed=i, start=1000 + 100 * i))
    assert len(stack.segments) == pkg.seg.MAX_SEGMENTS
    assert pkg.seg.append_segment(stack, word_docs(pkg, 3, seed=9, start=9000)) is None


# -- lexical/persist ----------------------------------------------------------------


def test_oracle_snapshot_bytes_equal_and_cross_loads(tmp_path):
    roots = {}
    for pkg in (REF, PORT):
        roots[pkg.name] = str(tmp_path / pkg.name)
        docs = corpus(pkg, 30) + [pkg.Doc(doc_id="uni", content="Ünïcode wörds ß", title="T")]
        pkg.persist.save_lexical(mem_of(pkg, docs), roots[pkg.name])
    snap = {n: read(os.path.join(r, "lexical", current_gen(r), "index.flex.json")) for n, r in roots.items()}
    assert snap["port"] == snap["ref"]
    port, ref = t_persist.load_lexical(roots["ref"]), j_persist.load_lexical(roots["port"])
    assert port.doc_count() == ref.doc_count() == 31
    queries = QUERIES + ["term00 term07", "ünïcode", "title term03"]
    assert hits(port, queries) == hits(ref, queries)


@PKGS
def test_blue_green_publication_and_rapid_publishes(pkg, tmp_path):
    root = str(tmp_path)
    gens = [pkg.persist.save_lexical(mem_of(pkg, corpus(pkg, 5 + i)), root) for i in range(4)]
    assert len(set(gens)) == 4 and current_gen(root) == gens[-1]
    assert pkg.persist.load_lexical(root).doc_count() == 8
    removed = pkg.persist.prune_generations(root)
    assert sorted(removed) == sorted(gens[:2]) and pkg.persist.list_generations(root) == sorted(gens[2:])


def _incremental_root(pkg, root):
    pkg.persist.republish_lexical(mem_of(pkg, word_docs(pkg, 60, seed=2)), root)
    return pkg.persist.publish_incremental(mem_of(pkg, word_docs(pkg, 8, seed=7, start=1000)), root)


def test_incremental_generation_bytes_equal_and_loads_as_a_stack(tmp_path):
    """republish + publish_incremental write the same FLXB segments, delta
    snapshot and segments.json in both packages; the port loads either
    root as a two-segment stack that serves the reference's bits."""
    roots = {p.name: str(tmp_path / p.name) for p in (REF, PORT)}
    gens = {p.name: _incremental_root(p, roots[p.name]) for p in (REF, PORT)}
    for name in ("index.flexb", "seg-001.flexb", "delta-001.flex.json", "segments.json", "index.flex.json"):
        got, want = (os.path.join(roots[n], "lexical", gens[n], name) for n in ("port", "ref"))
        assert read(got) == read(want), name
    gen_dir = os.path.join(roots["port"], "lexical", gens["port"])
    assert os.stat(os.path.join(gen_dir, "index.flexb")).st_nlink >= 2  # carried by hard link
    ref = j_persist.load_packed_lexical(roots["ref"])
    queries = QUERIES + ["alpha beta", "eta theta"]
    for root in roots.values():
        arm = t_persist.load_packed_lexical(root, device=CPU)
        assert isinstance(arm, t_seg.SegmentedBm25) and arm.n_docs == 68
        assert [s.device for s in arm.segments] == [CPU, CPU]
        assert [[(c.doc_id, c.score) for c in r] for r in arm.search_candidates_batch(queries, 20)] == \
            [[(c.doc_id, c.score) for c in r] for r in ref.search_candidates_batch(queries, 20)]
        oracle = t_persist.load_lexical(root)
        assert oracle.doc_count() == 68
        assert hits(oracle) == hits(j_persist.load_lexical(roots["ref"]))


def oracle_fields(index) -> dict:
    """Every field a loaded oracle holds, as plain values (the posting
    lists' counts with their types)."""
    return {
        "field_stats": {f: vars(st) for f, st in index._field_stats.items()},
        "docs": {d: vars(e) for d, e in index._docs.items()},
        "postings": {f: {t: [(d, tf, type(tf)) for d, tf in pl.items()] for t, pl in terms.items()}
                     for f, terms in index._postings.items()},
        "postings_types": {f: (type(terms), terms.default_factory) for f, terms in index._postings.items()},
        "generation": index._generation,
        "staged": list(index._staged),
    }


@pytest.mark.parametrize("incremental", [False, True], ids=["base", "folded"])
def test_load_lexical_equals_reference_field_for_field(tmp_path, incremental):
    """The port's load (the snapshot's dicts taken as they parse, the
    collector paused) gives the reference's oracle field for field, on a
    root with an incremental generation's window folded in; either
    package's root loads the same."""
    roots = {}
    for pkg in (REF, PORT):
        roots[pkg.name] = root = str(tmp_path / pkg.name)
        docs = corpus(pkg, 60) + [pkg.Doc(doc_id="uni", content="Ünïcode wörds ß ß", title="Tïtle ß",
                                          metadata={"k": [1, "x"]})]
        pkg.persist.republish_lexical(mem_of(pkg, docs), root)
        if incremental:
            fresh = word_docs(pkg, 9, seed=4, start=1000) + [pkg.Doc(doc_id="doc-003", content="term01 replaced")]
            assert pkg.persist.publish_incremental(mem_of(pkg, fresh), root)
    for root in roots.values():
        got, want = t_persist.load_lexical(root), j_persist.load_lexical(root)
        assert oracle_fields(got) == oracle_fields(want)
        assert got.doc_count() == 61 + 9 * incremental
        assert hits(got, QUERIES + ["term01 replaced", "ß"]) == hits(want, QUERIES + ["term01 replaced", "ß"])
    assert oracle_fields(t_persist.load_lexical(roots["port"])) == oracle_fields(j_persist.load_lexical(roots["ref"]))


@PKGS
@pytest.mark.parametrize("damage", ["truncated", "version"])
def test_damaged_snapshot_raises_typed(pkg, tmp_path, damage):
    import gc

    root = str(tmp_path)
    pkg.persist.save_lexical(mem_of(pkg, corpus(pkg, 10)), root)
    path = os.path.join(root, "lexical", current_gen(root), "index.flex.json")
    text = read(path).decode()
    with open(path, "w", encoding="utf-8") as f:
        f.write(text[: len(text) // 2] if damage == "truncated" else text.replace('"version":1', '"version":9'))
    with pytest.raises(pkg.errors.IndexCorrupted):
        pkg.persist.load_lexical(root)
    assert gc.isenabled()


@PKGS
def test_stack_compacts_after_max_segments(pkg, tmp_path):
    root = str(tmp_path)
    pkg.persist.republish_lexical(mem_of(pkg, word_docs(pkg, 40, seed=2)), root)
    start = 1000
    for i in range(pkg.seg.MAX_SEGMENTS - 1):
        assert pkg.persist.publish_incremental(mem_of(pkg, word_docs(pkg, 4, seed=i + 1, start=start)), root)
        start += 100
    assert pkg.persist.publish_incremental(mem_of(pkg, word_docs(pkg, 4, seed=0, start=start)), root) is None
    oracle = pkg.persist.load_lexical(root)
    pkg.persist.republish_lexical(oracle, root)
    arm = pkg.persist.load_packed_lexical(root, **pkg.kw)
    assert not isinstance(arm, pkg.seg.SegmentedBm25) and arm.n_docs == oracle.doc_count() == 52


def test_failed_incremental_stage_leaks_nothing(tmp_path, monkeypatch):
    root = str(tmp_path)
    t_persist.republish_lexical(mem_of(PORT, word_docs(PORT, 60, seed=3, length=10)), root)
    before = current_gen(root)
    gens_before = t_persist.list_generations(root)

    def boom(*a, **k):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(t_flexb, "save_packed", boom)
    with pytest.raises(OSError):
        t_persist.publish_incremental(mem_of(PORT, word_docs(PORT, 5, seed=1, start=1000)), root)
    assert current_gen(root) == before and t_persist.list_generations(root) == gens_before
    assert t_persist.load_packed_lexical(root, device=CPU) is not None
    assert t_persist.load_lexical(root).doc_count() == 60


def test_missing_segment_degrades_to_none(tmp_path):
    root = str(tmp_path)
    gen = _incremental_root(PORT, root)
    for suffix in ("", ".fspar", ".fsum"):
        os.remove(os.path.join(root, "lexical", gen, "seg-001.flexb" + suffix))
    assert t_persist.load_packed_lexical(root, device=CPU) is None
    assert t_persist.load_lexical(root).doc_count() == 68


# -- FLXB durability: the intrinsic check, repair, degradation -----------------------


def _packed_root(pkg, root):
    gen = pkg.persist.save_packed_lexical(bulk(pkg, corpus(pkg, 40)), root)
    return os.path.join(root, "lexical", gen, "index.flexb")


def test_intrinsic_check_knows_flexb(tmp_path):
    """``intrinsic_check_for`` validates an FLXB artifact (its payload
    CRC) as the reference's does; stale sidecars over a valid segment
    (a publish killed between the sidecar refresh and the rename) heal."""
    flexb = _packed_root(PORT, str(tmp_path))
    check = t_dur.intrinsic_check_for(flexb)
    assert check is not None and check(flexb)
    assert t_dur.intrinsic_check_for(str(tmp_path / "x.bin")) is None
    other = str(tmp_path / "other.bin")
    with open(other, "wb") as f:
        f.write(os.urandom(4096))
    t_dur.protect_artifact(flexb, source=other)
    assert not t_dur.FileProtector.verify(flexb)
    assert t_dur.heal_stale_sidecars(flexb) and t_dur.FileProtector.verify(flexb)
    t_dur.protect_artifact(flexb, source=other)
    assert t_dur.ensure_artifact(flexb, intrinsic_check=check) and t_dur.FileProtector.verify(flexb)
    flip(flexb, os.path.getsize(flexb) // 2, n=8)
    with pytest.raises(t_flexb.FlexbCorrupted):
        check(flexb)


def test_stale_flexb_sidecars_heal_on_load(tmp_path):
    flexb = _packed_root(PORT, str(tmp_path))
    other = str(tmp_path / "other.bin")
    with open(other, "wb") as f:
        f.write(os.urandom(4096))
    t_dur.protect_artifact(flexb, source=other)
    assert t_persist.load_packed_lexical(str(tmp_path), device=CPU) is not None
    assert t_dur.FileProtector.verify(flexb)


def test_flexb_corruption_repairs_and_unrepairable_degrades(tmp_path):
    root = str(tmp_path / "a")
    flexb = _packed_root(PORT, root)
    assert t_dur.ParityProtector.is_protected(flexb)
    good = read(flexb)
    flip(flexb, os.path.getsize(flexb) // 2, n=8)
    assert t_persist.load_packed_lexical(root, device=CPU) is not None
    assert read(flexb) == good
    for suffix in (".fsum", ".fspar"):
        os.remove(flexb + suffix)
    flip(flexb, os.path.getsize(flexb) // 2, n=8)
    assert t_persist.load_packed_lexical(root, device=CPU) is None
