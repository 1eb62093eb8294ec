"""The port's ``search --federate`` (``fusion/federated.py``) and ``shadow``
(``core/shadow.py``) against the JAX package's on the CPU.

Oracles: tests/test_cli_federated.py's federation cases (merge across
roots, an unservable shard degrading into coverage, no servable shard,
duplicate roots), tests/test_fusion_extras.py's ``FederatedSearcher`` cases,
and the ``shadow`` command with ``--candidate device`` and ``fts5``
against the reference's envelope (timings left out). Both CLIs run in
process (tests/test_torch_cli.py's helpers) over roots each package built
from the same documents.

Divergences pinned here: a shard whose search raises anything but a
``SearchError`` fails the federated ``search()`` (the reference folds it
into the coverage receipt); a shadow candidate's ``SearchError`` is a
``shadow_error`` as in the reference, any other exception propagates.
"""

import json
import time

import pytest

import frankensearch_tpu.core.types as ref_types
import frankensearch_tpu.fusion.federated as ref_fed
import frankensearch_tpu_torch.core.types as port_types
import frankensearch_tpu_torch.fusion.federated as port_fed
from frankensearch_tpu_torch.core.errors import SearchError, SubsystemError
from tests.test_torch_cli import (  # noqa: F401
    both, env_of, no_pallas, reference_logger_untouched, run, same_rows, strip_timing,
)

PKG = {"port": (port_types, port_fed), "ref": (ref_types, ref_fed)}


class FakeSearcher:
    def __init__(self, results):
        self._results = results

    def search(self, query, k=10, **kw):
        return self._results[:k]


class Raising:
    def __init__(self, exc):
        self.exc = exc

    def search(self, *a, **k):
        raise self.exc


def sr(types, doc_id, score):
    return types.ScoredResult(doc_id=doc_id, score=score)


def merged(out) -> list:
    return [(r.doc_id, r.score) for r in out.results]


@pytest.mark.parametrize("strategy", ["rrf", "score"])
def test_merge_equals_reference(strategy):
    got = {}
    for pkg, (types, fed) in PKG.items():
        f = fed.FederatedSearcher(
            shards=[("s1", FakeSearcher([sr(types, "a", 1.0), sr(types, "b", 0.5)])),
                    ("s2", FakeSearcher([sr(types, "b", 0.9), sr(types, "c", 0.4)]))],
            merge=fed.MergeStrategy(strategy))
        out = f.search("q", k=3)
        got[pkg] = (merged(out), out.coverage.complete, out.coverage.responded)
    assert got["port"] == got["ref"]
    assert got["port"][0][0][0] == ("b" if strategy == "rrf" else "a")


def test_duplicate_shard_name_rejected():
    f = port_fed.FederatedSearcher()
    f.add_shard("s1", FakeSearcher([]))
    with pytest.raises(ValueError, match="duplicate shard name"):
        f.add_shard("s1", FakeSearcher([]))


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_search_error_shard_is_partial_not_fatal(pkg):
    types, fed = PKG[pkg]
    f = fed.FederatedSearcher(shards=[("ok", FakeSearcher([sr(types, "a", 1.0)])),
                                      ("bad", Raising(SubsystemError("shard down")))])
    out = f.search("q", k=3)
    assert not out.coverage.complete and out.coverage.responded == 1
    assert [r.doc_id for r in out.results] == ["a"]
    assert out.coverage.failed[0].shard == "bad" and "shard down" in out.coverage.failed[0].error


def test_device_fault_in_a_shard_propagates():
    """Divergence: the reference reports any exception as the shard's
    coverage entry; the port raises a non-``SearchError`` from ``search()``
    once every shard has been joined."""
    f = port_fed.FederatedSearcher(shards=[("ok", FakeSearcher([sr(port_types, "a", 1.0)])),
                                           ("gpu", Raising(RuntimeError("CUDA error: device fault")))])
    with pytest.raises(RuntimeError, match="device fault"):
        f.search("q", k=3)
    ref = ref_fed.FederatedSearcher(shards=[("gpu", Raising(RuntimeError("device fault")))])
    assert ref.search("q", k=3).coverage.failed[0].shard == "gpu"


def test_hung_shard_does_not_hold_the_query():
    import threading

    class Hung:
        def search(self, *a, **k):
            time.sleep(3.0)
            return [sr(port_types, "b", 2.0)]

    f = port_fed.FederatedSearcher(shards=[("ok", FakeSearcher([sr(port_types, "a", 1.0)])), ("hung", Hung())],
                                   timeout_s=0.3)
    t0 = time.monotonic()
    out = f.search("q", k=3)
    assert time.monotonic() - t0 < 2.0
    assert out.coverage.timed_out == ("hung",) and [r.doc_id for r in out.results] == ["a"]
    again = f.search("q", k=3)
    assert again.coverage.timed_out == ("hung",)
    hung = [t for t in threading.enumerate() if t.name == "fed-hung"]
    assert len(hung) == 1 and hung[0].daemon


# -- search --federate through both CLIs ----------------------------------------------------------


def write_jsonl(path, docs) -> str:
    with open(path, "w") as f:
        f.writelines(json.dumps({"id": i, "content": c}) + "\n" for i, c in docs)
    return str(path)


@pytest.fixture(scope="module")
def fed_roots(tmp_path_factory):
    """Two roots per package: a and b."""
    base = tmp_path_factory.mktemp("fed")
    a = write_jsonl(base / "a.jsonl", [("a-rust", "rust ownership borrowing lifetimes compiler"),
                                       ("a-jax", "jax jit compilation tpu acceleration")])
    b = write_jsonl(base / "b.jsonl", [("b-rust", "rust async tokio executor runtime"),
                                       ("b-sql", "sqlite btree transactions journal")])
    out = {}
    for pkg in ("port", "ref"):
        out[pkg] = (str(base / f"{pkg}_a"), str(base / f"{pkg}_b"))
        env_of(pkg, "index", a, "--root", out[pkg][0])
        env_of(pkg, "index", b, "--root", out[pkg][1])
    return out


def federated(pkg, roots, query, *extra_roots):
    argv = ["search", query, "--root", roots[0], "-k", "10"]
    for r in extra_roots:
        argv += ["--federate", r]
    return env_of(pkg, *argv)


def test_federated_merge_across_roots_equals_reference(fed_roots):
    got = federated("port", fed_roots["port"], "rust", fed_roots["port"][1])
    want = federated("ref", fed_roots["ref"], "rust", fed_roots["ref"][1])
    same_rows(got["data"], want["data"])
    assert {"a-rust", "b-rust"} <= {r["doc_id"] for r in got["data"]}
    assert strip_timing(got["meta"])["coverage"] == {
        "total_shards": 2, "responded": 2, "complete": True, "failed": [], "timed_out": []}
    assert got["meta"]["phases"] == ["federated"] and strip_timing(got["meta"]) == strip_timing(want["meta"])


def test_unservable_shard_degrades_into_coverage(fed_roots, tmp_path):
    missing = str(tmp_path / "nope")
    got = federated("port", fed_roots["port"], "rust", missing)
    want = federated("ref", fed_roots["ref"], "rust", missing)
    same_rows(got["data"], want["data"])
    cov = got["meta"]["coverage"]
    assert cov == want["meta"]["coverage"]
    assert cov["total_shards"] == 2 and cov["responded"] == 1 and not cov["complete"]
    assert cov["failed"][0]["shard"] == missing and got["warnings"] == want["warnings"]


def test_no_servable_shard_errors(tmp_path):
    x, y = str(tmp_path / "x"), str(tmp_path / "y")
    got, want = both("search", "q", "--root", x, "--federate", y)
    assert got == want and got["error"]["code"] == "not_found"


def test_duplicate_roots_rejected(fed_roots):
    got = federated("port", fed_roots["port"], "rust", fed_roots["port"][0])
    want = federated("ref", fed_roots["ref"], "rust", fed_roots["ref"][0])
    assert got["error"] == want["error"] and got["error"]["code"] == "invalid_request"


def test_federated_shards_flag_is_refused(fed_roots):
    rc, out = run("port", "--format", "json", "search", "rust", "--root", fed_roots["port"][0],
                  "--federate", fed_roots["port"][1], "--shards", "2")
    assert rc == 1 and json.loads(out)["error"]["code"] == "not_ported"


# -- shadow -----------------------------------------------------------------------------------------


SHADOW_TIMING = {"primary_ms", "shadow_ms"}


@pytest.fixture(scope="module")
def shadow_inputs(tmp_path_factory):
    from tests.test_torch_cli import write_corpus

    base = tmp_path_factory.mktemp("shadow")
    corpus = write_corpus(base / "docs.jsonl", n=80, seed=21)
    queries = base / "q.txt"
    queries.write_text("\n".join(["rust", "vector search", "w001", "w002 w003", "log tpu", "w010 w011 w012",
                                  "nothing-matches", "w005"]) + "\n")
    return corpus, str(queries)


@pytest.mark.parametrize("candidate", ["device", "fts5"])
def test_shadow_equals_reference(shadow_inputs, candidate):
    corpus, queries = shadow_inputs
    got, want = both("shadow", corpus, "--candidate", candidate, "--queries-file", queries, "--score-tolerance",
                     "1e-3")
    for env in (got, want):
        for key in SHADOW_TIMING:
            env["data"].pop(key)
    assert got == want
    assert got["data"]["queries"] == 8 and got["data"]["shadow_errors"] == 0
    if candidate == "device":
        assert got["data"]["agreement_rate"] == 1.0


def test_shadow_needs_queries(shadow_inputs):
    got, want = both("shadow", shadow_inputs[0], "--candidate", "device")
    assert got == want and got["error"]["code"] == "invalid_request"


class Candidate:
    def __init__(self, exc):
        self.exc = exc

    def search_candidates(self, query, budget):
        raise self.exc


def test_shadow_search_error_counts_device_fault_raises():
    from frankensearch_tpu_torch.core.shadow import ShadowLexical
    from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

    primary = MemoryLexicalIndex()
    primary.add_document(port_types.IndexableDocument(doc_id="a", content="alpha beta"))
    primary.commit()
    sh = ShadowLexical(primary, Candidate(SearchError("candidate refused")))
    assert [c.doc_id for c in sh.search_candidates("alpha", 5)] == ["a"]
    assert sh.report.shadow_errors == 1 and sh.report.divergences[0].kind == "shadow_error"
    with pytest.raises(RuntimeError, match="device fault"):
        ShadowLexical(primary, Candidate(RuntimeError("device fault"))).search_candidates("alpha", 5)
