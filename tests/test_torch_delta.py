"""The lease-bounded lexical delta (``lexical/delta.py``), its seals and the
fused phase-1 lane over it, against the JAX reference on the CPU.

Oracles: tests/test_delta.py (searchable before seal, read routing, seals,
the lease), tests/test_incremental_seal.py (in-memory and persisted segment
stacking, the full-republish fallbacks), tests/test_seal_fuzz.py (reads
racing seals). Each scenario runs on both packages (``PKGS``); a seal's
artifacts are byte-equal across them, and reads after a seal are bitwise
the reference's. The fused lane takes a ``DeltaLexicalIndex`` arm through
its read arm: with the writes sealed it serves bitwise as the bare packed
arm does (and as the reference does, spies on ``fused_phase1_*`` in both
packages); with unsealed writes the oracle serves on the unfused path.
"""

import contextlib
import os
import threading

import pytest

import frankensearch_tpu.lexical.delta as j_delta
import frankensearch_tpu.ops.hybrid_phase1 as jhp
import frankensearch_tpu_torch.lexical.delta as t_delta
import frankensearch_tpu_torch.ops.hybrid_phase1 as thp
from frankensearch_tpu.core.config import TwoTierConfig as RefConfig
from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHash
from frankensearch_tpu.fusion.searcher import TwoTierSearcher as RefSearcher
from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex
from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, TwoTierIndex, TwoTierSearcher
from tests import test_torch_hot_arm as th
from tests.test_torch_model2vec import _spy
from tests.test_torch_persist import CPU, PKGS, PORT, REF, current_gen, device_index, mem_of, read, word_docs

for _pkg, _mod in ((REF, j_delta), (PORT, t_delta)):
    _pkg.delta = _mod


def seed_oracle(pkg, n=6):
    """tests/test_delta.py's oracle: ``n`` docs "alpha beta sealed doc i"."""
    return mem_of(pkg, [pkg.Doc(doc_id=f"d{i}", content=f"alpha beta sealed doc {i}") for i in range(n)])


def doc(pkg, i, text):
    return pkg.Doc(doc_id=f"d{i}", content=text)


def cands(arm, queries, k=10):
    return [[(c.doc_id, c.score) for c in arm.search_candidates(q, k)] for q in queries]


# -- searchable before seal, read routing, the lease --------------------------


@PKGS
def test_delta_docs_visible_without_seal(pkg):
    arm = pkg.delta.DeltaLexicalIndex(seed_oracle(pkg))
    arm.add_document(doc(pkg, 100, "zeppelin fresh unsealed document"))
    arm.commit()
    hits = arm.search_candidates("zeppelin fresh", 5)
    assert hits and hits[0].doc_id == "d100" and arm.unsealed_docs == 1


@PKGS
def test_reads_route_to_the_sealed_arm_when_clean(pkg):
    oracle = seed_oracle(pkg)
    sealed = device_index(pkg, [pkg.Doc(doc_id=f"d{i}", content=f"alpha beta sealed doc {i}") for i in range(6)])
    arm = pkg.delta.DeltaLexicalIndex(oracle, sealed=sealed)
    assert arm._read_arm() is sealed
    arm.add_document(doc(pkg, 100, "new doc"))
    assert arm._read_arm() is oracle
    arm.seal()
    assert arm.unsealed_docs == 0 and arm.seal() is None


@PKGS
def test_lease_budget_auto_seals_refuses_and_ages_out(pkg):
    arm = pkg.delta.DeltaLexicalIndex(seed_oracle(pkg), lease=pkg.delta.DeltaLease(max_docs=3, max_age_s=1e9))
    for i in range(10):
        arm.add_document(doc(pkg, 100 + i, f"doc {i}"))
    assert len(arm.seal_history) >= 2 and arm.unsealed_docs < 4
    strict = pkg.delta.DeltaLexicalIndex(
        seed_oracle(pkg), lease=pkg.delta.DeltaLease(max_docs=2, max_age_s=1e9), auto_seal=False)
    strict.add_document(doc(pkg, 100, "a"))
    strict.add_document(doc(pkg, 101, "b"))
    with pytest.raises(pkg.delta.LeaseExceeded, match="doc budget"):
        strict.add_document(doc(pkg, 102, "c"))
    t = [0.0]
    aged = pkg.delta.DeltaLexicalIndex(
        seed_oracle(pkg), lease=pkg.delta.DeltaLease(max_docs=1000, max_age_s=5.0), clock=lambda: t[0])
    aged.add_document(doc(pkg, 100, "a"))
    t[0] = 10.0
    aged.add_document(doc(pkg, 101, "b"))
    assert [r.docs_sealed for r in aged.seal_history] == [1]
    aged.seal()
    assert aged.lease.docs_written == 0 and aged.lease.acquired_at is None


def test_rooted_delta_needs_a_device(tmp_path):
    with pytest.raises(PORT.errors.InvalidConfig, match="device"):
        t_delta.DeltaLexicalIndex(seed_oracle(PORT), root=str(tmp_path))


# -- seals: persisted, byte-equal, bitwise reads --------------------------------------


def _rooted(pkg, root, oracle, sealed=None):
    return pkg.delta.DeltaLexicalIndex(oracle, sealed=sealed, root=root, **pkg.kw)


@pytest.mark.parametrize("writes", ["append", "append_and_delete"])
def test_rooted_seal_equals_reference(tmp_path, writes):
    """A seal over a root publishes the same artifacts in both packages
    (an incremental stack for new docs; a full republish when a delete
    dirties the window) and then serves the reference's bits from the
    reloaded packed arm."""
    queries = ["alpha beta", "gamma", "sealed doc", "quartz onyx", "mineral 3"]
    arms, gens = {}, {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name)
        pkg.persist.republish_lexical(seed_oracle(pkg, 20), root)
        arm = _rooted(pkg, root, pkg.persist.load_lexical(root), pkg.persist.load_packed_lexical(root, **pkg.kw))
        for i in range(5):
            arm.add_document(doc(pkg, 200 + i, f"quartz onyx mineral {i} gamma"))
        if writes == "append_and_delete":
            arm.delete_document("d3")
        arm.commit()
        before = cands(arm, queries)
        receipt = arm.seal()
        assert receipt.generation == current_gen(root) and receipt.docs_sealed == 5 + (writes != "append")
        assert [d for d, _ in cands(arm, queries)[0]] == [d for d, _ in before[0]]
        arms[pkg.name], gens[pkg.name] = arm, receipt.generation
    names = ["index.flexb", "index.flex.json"]
    if writes == "append":
        names += ["seg-001.flexb", "delta-001.flex.json", "segments.json"]
        assert isinstance(arms["port"].sealed, PORT.seg.SegmentedBm25)
    else:
        assert not os.path.exists(os.path.join(tmp_path, "port", "lexical", gens["port"], "segments.json"))
    for name in names:
        got, want = (os.path.join(tmp_path, n, "lexical", gens[n], name) for n in ("port", "ref"))
        assert read(got) == read(want), name
    assert cands(arms["port"], queries) == cands(arms["ref"], queries)
    assert arms["port"].sealed.device == CPU


@PKGS
def test_seal_without_a_packed_base_republishes(pkg, tmp_path):
    arm = _rooted(pkg, str(tmp_path), seed_oracle(pkg))
    arm.add_document(doc(pkg, 100, "brand new delta doc"))
    receipt = arm.seal()
    assert receipt.docs_sealed == 1 and os.path.exists(tmp_path / "lexical" / "CURRENT")
    assert arm.sealed is not None and any(h.doc_id == "d100" for h in arm.search_candidates("delta doc", 5))


@PKGS
def test_persisted_incremental_seal_keeps_the_main_segment_packed(pkg, tmp_path):
    root = str(tmp_path)
    pkg.persist.republish_lexical(mem_of(pkg, word_docs(pkg, 60, seed=2)), root)
    arm = _rooted(pkg, root, pkg.persist.load_lexical(root), pkg.persist.load_packed_lexical(root, **pkg.kw))
    for d in word_docs(pkg, 6, seed=7, start=1000):
        arm.add_document(d)
    arm.commit()
    receipt = arm.seal()
    gen_dir = os.path.join(root, "lexical", receipt.generation)
    assert os.path.exists(os.path.join(gen_dir, "seg-001.flexb"))
    assert os.stat(os.path.join(gen_dir, "index.flexb")).st_nlink >= 2
    assert isinstance(arm.sealed, pkg.seg.SegmentedBm25)
    tm = arm.sealed.segments[0]._term_major()
    assert tm is not None and tm.packed


# -- in-memory stacking ---------------------------------------------------------------


@PKGS
def test_in_memory_seal_stacks_over_the_device_arm(pkg):
    base = word_docs(pkg, 120, seed=2)
    sealed = device_index(pkg, base)
    arm = pkg.delta.DeltaLexicalIndex(mem_of(pkg, base), sealed=sealed)
    for d in word_docs(pkg, 10, seed=7, start=1000):
        arm.add_document(d)
    arm.commit()
    arm.seal()
    assert isinstance(arm.sealed, pkg.seg.SegmentedBm25) and arm.sealed.segments[0] is sealed
    ids = {c.doc_id for c in arm.search_candidates("alpha beta", 200)}
    assert any(i.startswith("doc-010") for i in ids)


@pytest.mark.parametrize("write", ["supersede", "delete"])
@PKGS
def test_dirty_window_takes_the_full_path(pkg, write):
    base = word_docs(pkg, 30, seed=2)
    arm = pkg.delta.DeltaLexicalIndex(mem_of(pkg, base), sealed=device_index(pkg, base))
    if write == "supersede":
        arm.add_document(pkg.Doc(doc_id="doc-00000", content="alpha zeta"))
    else:
        arm.add_document(pkg.Doc(doc_id="doc-00999", content="alpha"))
        arm.delete_document("doc-00001")
    arm.commit()
    arm.seal()
    assert not isinstance(arm.sealed, pkg.seg.SegmentedBm25) and arm.sealed is arm.oracle


def test_in_memory_stack_caps_then_folds_like_the_reference():
    results = {}
    for pkg in (REF, PORT):
        base = word_docs(pkg, 40, seed=2)
        arm = pkg.delta.DeltaLexicalIndex(mem_of(pkg, base), sealed=device_index(pkg, base))
        kinds = []
        for round_no in range(pkg.seg.MAX_SEGMENTS + 1):
            for d in word_docs(pkg, 5, seed=round_no + 1, start=1000 + 100 * round_no):
                arm.add_document(d)
            arm.commit()
            arm.seal()
            kinds.append(isinstance(arm.sealed, pkg.seg.SegmentedBm25))
            if kinds[-1]:
                results.setdefault(pkg.name, []).append(
                    [[(c.doc_id, c.score) for c in r] for r in arm.sealed.search_candidates_batch(
                        ["alpha", "beta gamma", "kappa"], 25)])
        assert kinds == [True, True, True, False, False]
        assert len({c.doc_id for c in arm.search_candidates("alpha", 500)}) > 40
    assert results["port"] == results["ref"]


# -- concurrency ------------------------------------------------------------------------


def test_concurrent_writers_and_readers():
    arm = t_delta.DeltaLexicalIndex(seed_oracle(PORT), lease=t_delta.DeltaLease(max_docs=50, max_age_s=1e9))
    errors: list[Exception] = []

    def writer(base):
        try:
            for i in range(40):
                arm.add_document(doc(PORT, base + i, f"thread doc {base + i} xylophone"))
                arm.commit()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def reader():
        try:
            for _ in range(60):
                arm.search_candidates("xylophone", 5)
                arm.search_candidates("sealed doc", 5)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(1000,)), threading.Thread(target=writer, args=(2000,)),
               threading.Thread(target=reader), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    arm.seal()
    assert len(arm.search_candidates("xylophone", 100)) == 80


def test_reads_never_error_across_seals():
    base = word_docs(PORT, 80, seed=3, length=10)
    arm = t_delta.DeltaLexicalIndex(mem_of(PORT, base), sealed=device_index(PORT, base))
    stop = threading.Event()
    errors: list[Exception] = []

    def reader():
        while not stop.is_set():
            try:
                arm.search_candidates("alpha beta", 10)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for round_no in range(6):
            for i in range(4):
                arm.add_document(PORT.Doc(doc_id=f"new-{1000 + 10 * round_no + i:05d}", content="alpha beta gamma"))
            arm.commit()
            arm.seal()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors and any(c.doc_id.startswith("new-") for c in arm.search_candidates("alpha", 300))


def test_writers_racing_auto_seal_and_explicit_seal(tmp_path):
    """Two writers under a tiny auto-seal lease and an explicit sealer on
    a built root (tests/test_delta.py's race): no error, every append
    survives."""
    import frankensearch_tpu_torch as fst

    root = str(tmp_path / "ix")
    fe = fst.HashEmbedder(dim=32)
    base = [fst.IndexableDocument(doc_id=f"d{i}", content=f"base alpha {i}") for i in range(10)]
    fst.IndexBuilder(root, device="cpu").with_documents(base).with_embedder_stack(
        fst.EmbedderStack(fast=fe)).build()
    h = fst.open_hybrid(root, fast_embedder=fe, device="cpu")
    delta = h.delta
    delta.lease.max_docs = 8
    delta.lease.max_age_s = 0.05
    errors: list[str] = []
    added: list[str] = []

    def writer(tid):
        for i in range(60):
            try:
                delta.add_document(fst.IndexableDocument(doc_id=f"w{tid}-{i}", content=f"gamma {tid} {i}"))
                delta.commit()
                added.append(f"w{tid}-{i}")
            except Exception as e:
                errors.append(f"{type(e).__name__}: {e}")

    def sealer():
        for _ in range(20):
            try:
                delta.seal()
            except Exception as e:
                errors.append(f"seal {type(e).__name__}: {e}")

    threads = [threading.Thread(target=writer, args=(t,)) for t in (1, 2)] + [threading.Thread(target=sealer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    delta.seal()
    have = {c.doc_id for c in delta.search_candidates("gamma", 10000)}
    assert all(d in have for d in added)
    h.close()


# -- the fused phase-1 lane over a delta arm -------------------------------------------


LANES = ("fused_phase1_dense", "fused_phase1_blocked", "fused_phase1_daat", "fused_phase1_daat_mixed")


def _searchers(root, layout):
    """The reference and the port over one FTVI artifact, each with a
    ``DeltaLexicalIndex`` over its bulk arm, and the port's bare bulk arm."""
    docs = th.corpus()
    texts = [d.content for d in docs]
    ids = [d.doc_id for d in docs]
    vecs = HashEmbedder(dim=64).embed_batch(texts)
    ref_index = RefIndex.create(root, vecs, ids, RefHash(dim=64).identity(), use_pallas=True)
    with th.lowered() if layout == "split" else contextlib.nullcontext():
        ref_bulk = th.jbm.BulkDeviceBm25Index(docs)
        port_bulk = th.tbm.BulkDeviceBm25Index(th.port_docs(docs), device=CPU)
    mem, port_mem = th.memory_pair(docs)
    ref = RefSearcher(ref_index, RefHash(dim=64), lexical=j_delta.DeltaLexicalIndex(mem, sealed=ref_bulk),
                      config=RefConfig(fast_only=True))
    index = TwoTierIndex.open(root, device=CPU)
    port = TwoTierSearcher(index, HashEmbedder(dim=64), lexical=t_delta.DeltaLexicalIndex(port_mem, sealed=port_bulk),
                           config=TwoTierConfig(fast_only=True))
    bare = TwoTierSearcher(index, HashEmbedder(dim=64), lexical=port_bulk, config=TwoTierConfig(fast_only=True))
    return ref, port, bare


def _rows(outcomes):
    return [[(r.doc_id, r.score, r.lexical_score) for r in o.results] for o in outcomes]


@pytest.mark.parametrize("layout", ["dense", "split"])
def test_fused_lane_serves_a_delta_arm(tmp_path, monkeypatch, layout):
    ref, port, bare = _searchers(str(tmp_path), layout)
    assert (port.lexical.sealed._hot is not None) == (layout == "split")
    ref_calls, port_calls = _spy(monkeypatch, jhp, LANES), _spy(monkeypatch, thp, LANES)
    with th.reference_flat_interpret():
        want = ref.search_batch(th.QUERIES, k=10)
        got = port.search_batch(th.QUERIES, k=10)
        assert sum(port_calls.values()) == 1 and port_calls == ref_calls, (port_calls, ref_calls)
        alone = bare.search_batch(th.QUERIES, k=10)
    assert all(o.metrics.phase1_fused for o in got) and port.last_fusion_path == "device"
    assert _rows(got) == _rows(alone)
    assert [[(d, s) for d, s, _ in r] for r in _rows(got)] == [[(d, s) for d, s, _ in r] for r in _rows(want)]


def test_unsealed_writes_take_the_unfused_path(tmp_path, monkeypatch):
    """With unsealed writes the delta's read arm is the host oracle: both
    packages skip the fused lane, and the new doc is served."""
    ref, port, _ = _searchers(str(tmp_path), "dense")
    for searcher, Doc in ((ref, REF.Doc), (port, PORT.Doc)):
        searcher.lexical.add_document(Doc(doc_id="zz-new", content="zeppelin w0"))
        searcher.lexical.commit()
    ref_calls, port_calls = _spy(monkeypatch, jhp, LANES), _spy(monkeypatch, thp, LANES)
    want = ref.search_batch(["zeppelin", "w0 w1"], k=10)
    got = port.search_batch(["zeppelin", "w0 w1"], k=10)
    assert sum(port_calls.values()) == sum(ref_calls.values()) == 0
    assert not any(o.metrics.phase1_fused for o in got)
    assert [[r.doc_id for r in o.results] for o in got] == [[r.doc_id for r in o.results] for o in want]
    assert any(r.doc_id == "zz-new" and r.lexical_score for r in got[0].results)
