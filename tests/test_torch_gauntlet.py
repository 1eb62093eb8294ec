"""The port's gauntlet (``gauntlet/generator.py``, ``gauntlet/runner.py``)
against the JAX package's on the CPU, and the gauntlet run over the
port's own lexical and vector arms.

Oracle: tests/test_gauntlet.py. The generators give the reference's doc
ids, contents, titles, fingerprints and queries for the same specs. The
differential campaign of the port's ``MemoryLexicalIndex`` against its
``DeviceBm25Index`` on the CPU counts the same cases, agreements, swaps
and divergences as the reference's campaign over its own two arms, and
catches a broken candidate. The boolean, reload and maintenance laws hold
on the port's CPU arms (the oracle, the device arm and the FTS5 arm where
SQLite has it; a ``TwoTierIndex`` appended, deleted and compacted). The
bulk arm keeps the subset and negation laws alone; beside the oracle it
breaks arm parity exactly where the reference's bulk arm does (it
hydrates previews, so its tree filter drops a doc only on full positive
evidence). The port's compaction moves no surviving base row's slab bits,
where the reference's moves a few HashEmbedder rows by one bf16 ulp: the
maintenance law at 2,000 docs holds on the port and not on the
reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

import frankensearch_tpu.gauntlet.generator as ref_gen
import frankensearch_tpu.gauntlet.runner as ref_runner
import frankensearch_tpu_torch.gauntlet.generator as port_gen
import frankensearch_tpu_torch.gauntlet.runner as port_runner
from frankensearch_tpu.lexical.device_bm25 import DeviceBm25Index as RefDeviceBm25
from frankensearch_tpu.lexical.memory_index import MemoryLexicalIndex as RefMemory
from frankensearch_tpu_torch import HashEmbedder, TwoTierIndex
from frankensearch_tpu_torch.lexical.device_bm25 import BulkDeviceBm25Index, DeviceBm25Index
from frankensearch_tpu_torch.lexical.fts5_adapter import Fts5LexicalIndex, fts5_available
from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

CPU = torch.device("cpu")
SPECS = [
    {},
    {"n_docs": 40, "seed": 2},
    {"n_docs": 120, "seed": 7, "zipf_a": 1.1},
    {"n_docs": 30, "min_len": 1, "max_len": 3, "vocab_size": 5, "title_every": 0, "seed": 11},
]


def doc_rows(docs):
    return [(d.doc_id, d.content, d.title, d.metadata) for d in docs]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()) or "default")
def test_generators_equal_reference(spec):
    port_spec, ref_spec = port_gen.CorpusSpec(**spec), ref_gen.CorpusSpec(**spec)
    assert port_spec.fingerprint() == ref_spec.fingerprint()
    port_docs, ref_docs = port_gen.generate_corpus(port_spec), ref_gen.generate_corpus(ref_spec)
    assert doc_rows(port_docs) == doc_rows(ref_docs)
    assert type(port_docs[0]).__module__.startswith("frankensearch_tpu_torch.")
    for qspec in ({}, {"n_queries": 30, "seed": 3, "max_terms": 6}):
        assert port_gen.generate_queries(port_gen.QuerySpec(**qspec), port_docs) == \
            ref_gen.generate_queries(ref_gen.QuerySpec(**qspec), ref_docs)


def memory_of(cls, corpus, **kw):
    mem = cls(**kw)
    for d in corpus:
        mem.add_document(d)
    mem.commit()
    return mem


def report_rows(report):
    return (report.corpus_fingerprint, report.cases, report.exact_agreements, report.rank_swaps_within_tolerance,
            [(d.query, d.detail) for d in report.divergences])


@pytest.mark.parametrize("n_docs,seed", [(120, 7), (60, 3)])
def test_campaign_equals_reference(n_docs, seed):
    reports = []
    for gen, runner, mem_cls, device_arm in (
        (port_gen, port_runner, MemoryLexicalIndex, lambda m: DeviceBm25Index(m, device=CPU)),
        (ref_gen, ref_runner, RefMemory, RefDeviceBm25),
    ):
        spec = gen.CorpusSpec(n_docs=n_docs, seed=seed)
        corpus = gen.generate_corpus(spec)
        mem = memory_of(mem_cls, corpus)
        dev = device_arm(mem)
        reports.append(runner.run_differential_campaign(mem.search_candidates, dev.search_candidates,
                                                        corpus_spec=spec, corpus=corpus, k=10))
    port, ref = reports
    assert report_rows(port) == report_rows(ref)
    assert port.ok and port.cases == 50 and port.agreement_rate > 0.8


def test_campaign_catches_a_broken_candidate():
    spec = port_gen.CorpusSpec(n_docs=40, seed=2)
    corpus = port_gen.generate_corpus(spec)
    mem = memory_of(MemoryLexicalIndex, corpus)

    def broken(query, k):  # drops the top hit
        return mem.search_candidates(query, k + 1)[1:]

    report = port_runner.run_differential_campaign(mem.search_candidates, broken, corpus_spec=spec, corpus=corpus)
    assert not report.ok and report.cases == 50
    assert all(d.detail.startswith(("set diff", "non-tie rank swap")) for d in report.divergences)


@pytest.mark.parametrize("n_docs,k", [(60, 20), (400, 100)])
def test_boolean_laws_hold_on_the_ports_arms(n_docs, k):
    """At the reference's size, and at a size whose match sets the
    default budgets (4 k, k = 20) would cut: there k = n_docs / 4, so each
    law compares whole match sets (a cut set breaks the subset law on
    every arm, the oracle too)."""
    spec = port_gen.CorpusSpec(n_docs=n_docs)
    corpus = port_gen.generate_corpus(spec)
    mem = memory_of(MemoryLexicalIndex, corpus, preview_chars=10_000)
    arms = {"oracle": mem, "device": DeviceBm25Index(mem, device=CPU)}
    if fts5_available():
        arms["fts5"] = memory_of(Fts5LexicalIndex, corpus)
    violations = port_runner.check_boolean_laws(arms, corpus_spec=spec, k=k)
    assert violations == [], [(v.law, v.query, v.detail) for v in violations[:4]]
    bulk = BulkDeviceBm25Index(corpus, device=CPU, preview_chars=10_000)
    assert port_runner.check_boolean_laws({"bulk": bulk}, corpus_spec=spec, k=k) == []  # the arm's own laws


@pytest.mark.parametrize("preview_chars", [240, 10_000])
def test_bulk_arm_boolean_laws_equal_reference(preview_chars):
    """The bulk arm hydrates previews only, so its tree filter drops a doc
    only on full positive evidence (``LexicalRead.search_boolean``): its
    AND and phrase sets hold docs the oracle excludes. The port keeps the
    reference's rule, so the laws report the same violations in both."""
    from frankensearch_tpu.lexical.device_bm25 import BulkDeviceBm25Index as RefBulk

    found = []
    for gen, runner, mem_cls, bulk in ((port_gen, port_runner, MemoryLexicalIndex,
                                        lambda c: BulkDeviceBm25Index(c, device=CPU, preview_chars=preview_chars)),
                                       (ref_gen, ref_runner, RefMemory,
                                        lambda c: RefBulk(c, preview_chars=preview_chars))):
        corpus = gen.generate_corpus(gen.CorpusSpec(n_docs=60))
        arms = {"oracle": memory_of(mem_cls, corpus, preview_chars=10_000), "bulk": bulk(corpus)}
        found.append([(v.law, v.query, v.detail) for v in runner.check_boolean_laws(arms)])
    assert found[0] == found[1] and found[0]


def test_boolean_laws_catch_a_leaking_arm():
    corpus = port_gen.generate_corpus(port_gen.CorpusSpec(n_docs=60))
    mem = memory_of(MemoryLexicalIndex, corpus, preview_chars=10_000)

    class Leaky:  # NOT ignored: the bag's results
        def search_candidates(self, query, k):
            return mem.search_candidates(query, k)

        def search_boolean(self, query, k):
            from frankensearch_tpu_torch.lexical.query import parse_query

            return mem.search_boolean(parse_query(" ".join(query.positive_terms())), k)

    laws = {v.law for v in port_runner.check_boolean_laws({"oracle": mem, "leaky": Leaky()})}
    assert {"boolean-not-disjoint", "boolean-arm-parity"} <= laws


@pytest.mark.parametrize("spec", [None, {"n_docs": 90, "seed": 5}])
def test_reload_law_holds_on_the_port(spec):
    kw = {} if spec is None else {"corpus_spec": port_gen.CorpusSpec(**spec)}
    assert port_runner.check_reload_law(**kw) == []


def test_maintenance_law_holds_on_the_ports_index(tmp_path):
    fe = HashEmbedder(dim=64)

    def build(corpus):
        vecs = fe.embed_batch([d.content for d in corpus])
        return TwoTierIndex.create(str(tmp_path / "gx"), vecs, [d.doc_id for d in corpus], fe.identity(),
                                   device=CPU)

    def search(index, q, k):
        return list(index.search_fast_classified(fe.embed(q), k).hits)

    def maintain(index):  # append + delete the same doc, then compact: net no-op
        index.append_fast(["transient-doc"], fe.embed_batch(["transient maintenance doc"]))
        index.delete(["transient-doc"])
        return index.compact()

    assert port_runner.check_maintenance_laws(build, search, maintain, law="append-delete-compact-invariance") == []

    def lossy(index):  # drops a doc: the law must see it
        index.delete([index.fast.doc_ids[0]])
        return index.compact()

    assert port_runner.check_maintenance_laws(build, search, lossy, law="lossy") != []


def test_reports_are_the_ports_types():
    report = port_runner.CampaignReport(corpus_fingerprint="f")
    assert report.ok and report.agreement_rate == 1.0
    assert dataclasses.fields(report) and type(port_runner.LawViolation("l", "q", "d")).__module__ == port_runner.__name__
    assert np.isclose(port_runner.CampaignReport("f", cases=4, exact_agreements=3).agreement_rate, 0.75)


LAW_SPEC = {"n_docs": 2000, "seed": 20261033}  # HashEmbedder(256) rows some of which a renormalizing reopen moves


def hash_index_pair(tmp_path):
    """The same 2,000 HashEmbedder(256) rows in a port and a reference
    ``TwoTierIndex`` (bf16 artifacts), and the embedder."""
    from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex

    fe = HashEmbedder(dim=256)
    corpus = port_gen.generate_corpus(port_gen.CorpusSpec(**LAW_SPEC))
    vecs, ids = fe.embed_batch([d.content for d in corpus]), [d.doc_id for d in corpus]
    port = TwoTierIndex.create(str(tmp_path / "port"), vecs, ids, fe.identity(), device=CPU)
    ref = RefIndex.create(str(tmp_path / "ref"), vecs, ids, fe.identity(), use_pallas=False)
    return port, ref, fe


def test_compaction_moves_no_base_row(tmp_path):
    """Reopening a compacted bf16 artifact renormalizes its rows; the
    reference rewrites each row's bf16 rounding, which a few HashEmbedder
    rows do not survive (one bf16 ulp moves). The port keeps the stored
    bits of those rows, so every surviving row's slab bits are unchanged;
    every other row's bytes are the reference's."""
    from frankensearch_tpu_torch.index.fsvi import FtviFile

    port, ref, fe = hash_index_pair(tmp_path)
    slabs = {"port": port.fast.slab[: port.fast.n_rows].clone(),
             "ref": np.asarray(ref.fast.slab[: ref.fast.n_rows].astype(np.float32))}
    for index in (port, ref):
        index.append_fast(["transient-doc"], fe.embed_batch(["transient maintenance doc"]))
        index.delete(["transient-doc", port.fast.doc_ids[5]])
    got, want = port.compact(), ref.compact()
    keep = [r for r in range(2000) if r != 5]
    assert torch.equal(got.fast.slab[:1999], slabs["port"][keep])
    moved = ~(np.asarray(want.fast.slab[:1999].astype(np.float32)) == slabs["ref"][keep]).all(axis=1)
    files = [FtviFile(str(tmp_path / pkg / "vector.fast.idx"), verify_slab=False) for pkg in ("port", "ref")]
    differ = ~(np.asarray(files[0].slab) == np.asarray(files[1].slab)).all(axis=1)
    assert moved.any() and np.array_equal(differ, moved)


def test_maintenance_law_at_depth_holds_on_the_port(tmp_path):
    """The append-delete-compact law over HashEmbedder(256) rows at 2,000
    docs: the reference's compaction breaks it, the port's keeps it."""
    from frankensearch_tpu.embed.hash_embedder import HashEmbedder as RefHash
    from frankensearch_tpu.index.two_tier import TwoTierIndex as RefIndex

    found = {}
    for name, runner, gen, create, fe in (
        ("port", port_runner, port_gen, lambda r, v, i, e: TwoTierIndex.create(r, v, i, e, device=CPU),
         HashEmbedder(dim=256)),
        ("ref", ref_runner, ref_gen, lambda r, v, i, e: RefIndex.create(r, v, i, e, use_pallas=False),
         RefHash(dim=256)),
    ):
        def build(corpus, name=name, create=create, fe=fe):
            return create(str(tmp_path / name), fe.embed_batch([d.content for d in corpus]),
                          [d.doc_id for d in corpus], fe.identity())

        def search(index, q, k, fe=fe):
            return list(index.search_fast_classified(fe.embed(q), k).hits)

        def maintain(index, fe=fe):
            index.append_fast(["transient-doc"], fe.embed_batch(["transient maintenance doc"]))
            index.delete(["transient-doc"])
            return index.compact()

        found[name] = runner.check_maintenance_laws(build, search, maintain, law="append-delete-compact-invariance",
                                                    corpus_spec=gen.CorpusSpec(**LAW_SPEC))
    assert found["port"] == [] and found["ref"] != []
