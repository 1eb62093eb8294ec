"""The port's ``repro`` and ``footprint`` (``runtime/repro.py``,
``runtime/footprint.py``) against the JAX package's on the CPU.

Oracle: tests/test_cli_e2e.py::TestReproPack and the footprint advisor's
contract (tests/test_schemas.py). ``repro`` runs over each package's root
built from one seeded corpus: the packs are equal except
``environment.json``'s device keys (the port names torch, its CUDA version
and the cards, as ``version`` does; the reference names jax and its
devices) and the timing fields; the phases' doc ids equal ``search()``'s
over a library handle of the same root. ``footprint`` of one root by both
packages is equal except the program name in the replay commands
(``frankensearch-tpu-torch``). Both are validated against their
``schemas/`` files.
"""

import json
import os
import shutil

import jsonschema
import pytest
import torch

import frankensearch_tpu.runtime.footprint as ref_footprint
import frankensearch_tpu_torch as fst
import frankensearch_tpu_torch.runtime.footprint as port_footprint
from frankensearch_tpu_torch.runtime.repro import ReproPack
from tests.test_torch_cli import (  # noqa: F401
    close, env_of, no_pallas, reference_logger_untouched, run, same_rows, write_corpus,
)

SCHEMAS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "schemas")
DEVICE_KEYS = {"jax", "torch", "cuda", "devices"}
#: per-event timing fields
TIMING = {"at", "latency_ms"}


def schema(name: str) -> dict:
    with open(os.path.join(SCHEMAS, name), encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus") / "docs.jsonl")


@pytest.fixture(scope="module")
def roots(tmp_path_factory, corpus):
    out = {}
    for pkg in ("port", "ref"):
        out[pkg] = str(tmp_path_factory.mktemp(f"rf_{pkg}"))
        env_of(pkg, "index", corpus, "--root", out[pkg])
    return out


def read_pack(path: str) -> dict:
    files = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), encoding="utf-8") as f:
            text = f.read()
        files[name] = [json.loads(x) for x in text.splitlines()] if name.endswith(".jsonl") else json.loads(text)
    return files


def pack_events(events: list) -> list:
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in TIMING}
        payload = {k: v for k, v in e["payload"].items() if k not in TIMING}
        if e["kind"] == "metrics":
            payload = {k: v for k, v in payload.items() if not k.endswith(("_ms", "_us"))}
        out.append({**e, "payload": payload})
    return out


@pytest.mark.parametrize("query,k", [("write ahead log", 10), ("rust ownership", 3), ("w001 w002 w003", 20),
                                     ("nothing-matches-this", 5)])
def test_repro_pack_equals_reference(roots, tmp_path, query, k):
    packs, envs = {}, {}
    for pkg in ("port", "ref"):
        out = str(tmp_path / f"pack_{pkg}")
        envs[pkg] = env_of(pkg, "repro", query, "--out", out, "--root", roots[pkg], "-k", str(k))
        assert envs[pkg]["data"]["pack"] == out
        envs[pkg]["data"]["pack"] = "<PACK>"
        packs[pkg] = read_pack(out)
    assert envs["port"] == envs["ref"]
    got, want = packs["port"], packs["ref"]
    assert sorted(got) == sorted(want) == ["INDEX.json", "config.json", "environment.json", "evidence.jsonl"]
    assert got["INDEX.json"] == want["INDEX.json"] and got["config.json"] == want["config.json"]
    env_got, env_want = got["environment.json"], want["environment.json"]
    assert {k: v for k, v in env_got.items() if k not in DEVICE_KEYS | {"created_at"}} == \
        {k: v for k, v in env_want.items() if k not in DEVICE_KEYS | {"created_at"}}
    assert env_got["torch"] == torch.__version__ and env_got["cuda"] == torch.version.cuda
    assert env_got["devices"] == [] and "jax" not in env_got and "jax" in env_want
    ev_got, ev_want = pack_events(got["evidence.jsonl"]), pack_events(want["evidence.jsonl"])
    assert [e["kind"] for e in ev_got] == [e["kind"] for e in ev_want]
    rows_got = [e for e in ev_got if e["kind"] == "results"][0]["payload"]["rows"]
    rows_want = [e for e in ev_want if e["kind"] == "results"][0]["payload"]["rows"]
    same_rows(rows_got, rows_want)
    for g, w in zip(ev_got, ev_want):
        if g["kind"] != "results":
            close(g, w, g["kind"])
    jsonschema.validate(got["INDEX.json"], schema("repro-bundle-v1.schema.json"))


def test_repro_phases_are_search_phases(roots, tmp_path):
    """The pack's phases and results are the library's ``search()`` over
    the same root (its own open), and the pack loads back."""
    out = str(tmp_path / "pack")
    env_of("port", "repro", "write ahead log", "--out", out, "--root", roots["port"])
    pack = ReproPack.load(out)
    kinds = [e["kind"] for e in pack.events]
    assert kinds[0] == "query" and "phase" in kinds and kinds[-1] == "results"
    assert pack.config and "rrf_k" in pack.config
    h = fst.open_hybrid(roots["port"], device="cpu")
    want = h.searcher.search("write ahead log", k=10)
    h.close()
    phases = [e["payload"] for e in pack.events if e["kind"] == "phase"]
    assert [p["kind"] for p in phases] == [p.kind.value for p in want.phases]
    assert [p["doc_ids"] for p in phases] == [[r.doc_id for r in p.results] for p in want.phases]
    rows = [e for e in pack.events if e["kind"] == "results"][0]["payload"]["rows"]
    assert [r["doc_id"] for r in rows] == [r.doc_id for r in want.results]


def test_repro_attaches_the_generation_manifest(roots, tmp_path):
    """Where the CURRENT lexical generation holds a MANIFEST.json, the
    pack carries it as ``manifest.generation.json`` in both packages; a
    root built by ``index`` has none there (its manifest is the root's)."""
    got = {}
    for pkg in ("port", "ref"):
        root = str(tmp_path / f"root_{pkg}")
        shutil.copytree(roots[pkg], root)
        with open(os.path.join(root, "lexical", "CURRENT")) as f:
            gen = f.read().strip()
        shutil.copy(os.path.join(root, "MANIFEST.json"), os.path.join(root, "lexical", gen, "MANIFEST.json"))
        out = str(tmp_path / f"pack_{pkg}")
        env = env_of(pkg, "repro", "rust", "--out", out, "--root", root)
        assert env["data"]["manifests"] == ["generation"]
        with open(os.path.join(out, "manifest.generation.json")) as f, open(os.path.join(root, "MANIFEST.json")) as m:
            assert f.read() == m.read()
        got[pkg] = read_pack(out)["INDEX.json"]
    assert got["port"] == got["ref"] and "manifest.generation.json" in got["port"]["files"]
    jsonschema.validate(got["port"], schema("repro-bundle-v1.schema.json"))


def test_repro_without_a_card_raises_by_default(roots, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py drives the default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run("port", "--format", "json", "repro", "rust", "--out", str(tmp_path / "p"), "--root", roots["port"],
            device=False)
    assert not os.path.exists(tmp_path / "p")


# -- footprint -----------------------------------------------------------------------------------------


def footprint_pair(root: str) -> tuple[dict, dict]:
    """(port, reference) footprint envelopes of one root; the port's
    program name replaced by the reference's."""
    rc, text = run("port", "--format", "json", "footprint", "--root", root)
    got = json.loads(text.replace("frankensearch-tpu-torch ", "frankensearch-tpu "))
    assert rc == (0 if got["ok"] else 1)
    return got, env_of("ref", "footprint", "--root", root)


def grown_root(pkg_roots, tmp_path, corpus) -> str:
    """The reference's root copied and grown into every recommendation:
    a WAL of appends, tombstones, superseded generations, quarantined and
    orphaned staging bytes."""
    root = str(tmp_path / "grown")
    shutil.copytree(pkg_roots["ref"], root)
    more = tmp_path / "more.jsonl"
    more.write_text("\n".join(json.dumps({"id": f"new-{i}", "content": f"fresh token{i} zeppelin"}) for i in range(40)))
    env_of("port", "append-batch", str(more), "--root", root)
    env_of("port", "delete", *[f"doc-{i:03d}" for i in range(30)], "--root", root)
    lex = os.path.join(root, "lexical")
    for i in range(3):
        os.makedirs(os.path.join(lex, f"gen-000000000000{i}"))
        with open(os.path.join(lex, f"gen-000000000000{i}", "index.flex.json"), "w") as f:
            f.write("{}" * (100 + i))
    os.makedirs(os.path.join(root, ".quarantine"))
    with open(os.path.join(root, ".quarantine", "vector.fast.idx.1"), "wb") as f:
        f.write(b"q" * 1000)
    with open(os.path.join(root, "vector.fast.idx.tmp"), "wb") as f:
        f.write(b"t" * 500)
    return root


@pytest.mark.parametrize("argv", [("search", "write ahead log"), ("repro", "rust", "--out", "{out}")])
def test_one_shot_commands_leave_no_sqlite_sidecars(roots, tmp_path, argv):
    """``search`` and ``repro`` close the handle they open: its metadata
    store's sqlite ``-wal`` / ``-shm`` files do not outlive the command in
    the root until a garbage collection (they did, and a collection
    between the two packages' ``footprint`` of one root changed its
    ``artifacts`` bytes)."""
    import gc

    root = str(tmp_path / "root")
    shutil.copytree(roots["port"], root)
    gc.disable()
    try:
        env_of("port", *[a.replace("{out}", str(tmp_path / "pack")) for a in argv], "--root", root)
        assert [f for f in sorted(os.listdir(root)) if f.endswith(("-wal", "-shm"))] == []
    finally:
        gc.enable()


def test_footprint_equals_reference(tmp_path, corpus):
    # roots of its own: no command of another test has run on them, so no
    # sqlite handle another test left open (the reference's ``repro``
    # leaves one until a garbage collection) can close between the two
    # packages' census of one root
    roots = {}
    for pkg in ("port", "ref"):
        roots[pkg] = str(tmp_path / f"own_{pkg}")
        env_of(pkg, "index", corpus, "--root", roots[pkg])
    for root in (roots["port"], roots["ref"], grown_root(roots, tmp_path, corpus)):
        got, want = footprint_pair(root)
        assert got == want
        jsonschema.validate(got["data"], schema("footprint-advisor-v1.schema.json"))
    recs = {(r["domain"], r["action"]) for r in got["data"]["recommendations"]}
    assert recs == {("vector_index", "compact"), ("lexical_index", "retention"), ("artifacts", "retention")}
    assert len(got["data"]["recommendations"]) == 4  # WAL, generations, quarantine, staging
    _, text = run("port", "--format", "json", "footprint", "--root", str(tmp_path / "grown"))
    assert all(r["replay_cmd"].startswith("frankensearch-tpu-torch ")
               for r in json.loads(text)["data"]["recommendations"])


def test_footprint_f32_advice_equals_reference(roots, tmp_path, corpus, monkeypatch):
    root = str(tmp_path / "f32")
    env_of("port", "index", corpus, "--root", root, "--slab-dtype", "f32")
    for mod in (port_footprint, ref_footprint):
        monkeypatch.setattr(mod, "F32_OVERSIZED_BYTES", 1)
    got, want = footprint_pair(root)
    assert got == want
    assert [r["action"] for r in got["data"]["recommendations"]] == ["feature"]
    assert got["data"]["recommendations"][0]["replay_cmd"].startswith("frankensearch-tpu index <corpus>")


def test_footprint_counts_equal_the_ftvi(roots, tmp_path):
    """A fast artifact with a quarter of its rows tombstoned: both
    advisors count the FTVI's flags and recommend the compaction."""
    import numpy as np

    from frankensearch_tpu_torch.index.fsvi import FLAG_TOMBSTONE, FtviFile, write_ftvi
    from frankensearch_tpu_torch.index.two_tier import TwoTierPaths

    root = str(tmp_path / "dead")
    shutil.copytree(roots["ref"], root)
    path = TwoTierPaths(root).fast
    f = FtviFile(path, verify_slab=False)
    flags = np.zeros(f.record_count, dtype=np.uint8)
    flags[::4] = FLAG_TOMBSTONE
    write_ftvi(path, f.vectors_f32(), f.doc_ids, f.header.identity, dtype=f.header.dtype, flags=flags)
    f = FtviFile(path, verify_slab=False)
    dead = int(((f.flags & FLAG_TOMBSTONE) != 0).sum())
    assert dead == (f.record_count + 3) // 4
    assert port_footprint._tombstone_counts(root) == ref_footprint._tombstone_counts(root) == (dead, f.record_count - dead)
    assert port_footprint._slab_dtype(root) == ref_footprint._slab_dtype(root) == f.header.dtype
    got, want = footprint_pair(root)
    assert got == want
    assert [r["reason"] for r in got["data"]["recommendations"]] == ["25% of rows are tombstoned (fragmented index)"]


def test_footprint_missing_root_equals_reference(tmp_path):
    got, want = footprint_pair(str(tmp_path / "nope"))
    assert got == want and got["error"]["code"] == "not_found"


def _broken_docs():
    node = {"v": 1, "node_id": "n", "pid": 7, "host": "h", "root": "/r", "generation_id": "g", "started_at": 1.0,
            "at": 2.0, "qps": 1.5, "p50_ms": 1.0, "p99_ms": 2.0, "hbm_used_frac": 0.5, "queue_pressure": 0.0,
            "doc_count": 3, "errors": 0}
    pack = {"v": 1, "files": ["INDEX.json", "environment.json", "evidence.jsonl"], "event_count": 4}
    report = port_footprint.FootprintReport(root="/r", domains={d: 1 for d in (
        "vector_index", "lexical_index", "metadata", "model_cache", "artifacts")}, recommendations=[
        port_footprint.Recommendation("vector_index", "compact", "why", 5, "low", "cmd")]).to_dict()
    edits = {
        "fleet-node-v1.schema.json": (node, [("v", 2), ("pid", 0), ("pid", True), ("pid", 1.5), ("hbm_used_frac", 1.5),
                                             ("node_id", ""), ("extra", 1), ("qps", -1.0), ("doc_count", "3"),
                                             ("at", None)]),
        "repro-bundle-v1.schema.json": (pack, [("files", ["INDEX.json", "evidence.jsonl"]), ("files", [1]),
                                               ("event_count", -1), ("v", True), ("files", None)]),
        "footprint-advisor-v1.schema.json": (report, [("automatic_deletion_allowed", True),
                                                      ("automatic_deletion_allowed", 0), ("root", ""),
                                                      ("domains", {"vector_index": 1}), ("total_bytes", -2),
                                                      ("recommendations", [{"domain": "x"}]), ("detail", [])]),
    }
    for name, (good, changes) in edits.items():
        yield name, good
        for key, value in changes:
            bad = json.loads(json.dumps(good))
            if value is None:
                del bad[key]
            else:
                bad[key] = value
            yield name, bad


@pytest.mark.parametrize("name,doc", list(_broken_docs()), ids=lambda v: v if isinstance(v, str) else "")
def test_chip_smoke_schema_check_agrees_with_jsonschema(name, doc):
    """``chip_smoke.schema_errors`` (the card's machine has no
    jsonschema) rejects exactly what jsonschema rejects."""
    import chip_smoke

    want = list(jsonschema.Draft7Validator(schema(name)).iter_errors(doc))
    assert bool(chip_smoke.schema_errors(doc, schema(name))) == bool(want), (doc, want)
