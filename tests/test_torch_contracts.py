"""The port's contract modules (``core/contract_sanity.py``,
``core/e2e_artifact.py``, ``core/distributed_observability.py``) against
the JAX package's on the CPU.

Oracles: tests/test_contracts_observability.py and
tests/test_core_schemas.py. The schema registry equals the reference's
entry for entry, and each of the ten constants the lockstep reads is the
port's own module's, equal to the reference's. The evidence-stream lint
and the artifact validator give the reference's violations on the same
records, the artifact writer writes the reference's bytes, and the
generation lifecycle emits the reference's events through the port's
collector (the clock fixed).
"""

import importlib

import pytest

import frankensearch_tpu.core.contract_sanity as ref_cs
import frankensearch_tpu.core.distributed_observability as ref_do
import frankensearch_tpu.core.e2e_artifact as ref_e2e
import frankensearch_tpu_torch.core.contract_sanity as port_cs
import frankensearch_tpu_torch.core.distributed_observability as port_do
import frankensearch_tpu_torch.core.e2e_artifact as port_e2e

#: registry name -> (module under each package, constant); the modules
#: ``check_schema_lockstep`` imports at call time
CONSTANTS = {
    "telemetry": ("core.collectors", "TELEMETRY_SCHEMA_VERSION"),
    "output_envelope": ("cli.output", "ENVELOPE_VERSION"),
    "e2e_artifact": ("core.e2e_artifact", "E2E_SCHEMA_VERSION"),
    "golden_profile": ("utils.bench_regression", "GOLDEN_SCHEMA_VERSION"),
    "model_manifest": ("embed.model_manifest", "MANIFEST_SCHEMA_VERSION"),
    "generation_manifest": ("core.generation", "MANIFEST_VERSION"),
    "flex_lexical": ("lexical.persist", "FLEX_VERSION"),
    "fleet_node": ("fleet.registry", "NODE_SCHEMA_VERSION"),
    "acquisition_receipt": ("embed.model_download", "RECEIPT_SCHEMA_VERSION"),
    "footprint_advisor": ("runtime.footprint", "ADVISOR_VERSION"),
}


def test_registry_equals_reference():
    assert port_cs.EXPECTED_VERSIONS == ref_cs.EXPECTED_VERSIONS
    assert list(port_cs.EXPECTED_VERSIONS) == list(ref_cs.EXPECTED_VERSIONS) == list(CONSTANTS)


@pytest.mark.parametrize("name", list(CONSTANTS))
def test_each_constant_is_the_ports_and_equals_reference(name):
    module, const = CONSTANTS[name]
    port = importlib.import_module(f"frankensearch_tpu_torch.{module}")
    ref = importlib.import_module(f"frankensearch_tpu.{module}")
    assert getattr(port, const) == getattr(ref, const) == port_cs.EXPECTED_VERSIONS[name]


def test_lockstep_reads_the_ports_modules(monkeypatch):
    report = port_cs.check_schema_lockstep()
    assert report.ok and report.checked == 10
    assert (report.checked, report.violations) == (ref_cs.check_schema_lockstep().checked, [])
    import frankensearch_tpu_torch.lexical.persist as port_persist

    monkeypatch.setattr(port_persist, "FLEX_VERSION", 2)  # a drifted port constant is caught
    assert port_cs.check_schema_lockstep().violations == ["flex_lexical: runtime v2 != registry v1"]
    assert ref_cs.check_schema_lockstep().ok


STREAMS = {
    "clean": [
        {"kind": "search", "seq": 1, "at": 10.0, "correlation_id": "c",
         "payload": {"query": "redacted:abcd", "latency_ms": 2.0}},
        {"kind": "search", "seq": 2, "at": 11.0, "correlation_id": "c", "payload": {"latency_ms": 3.0}},
    ],
    "violations": [
        {"seq": 5, "at": 10.0},
        {"kind": "x", "seq": 4, "at": 9.0, "correlation_id": "c", "payload": {"query": "raw user query"}},
    ],
    "uncorrelated": [
        {"type": "t", "emitted_at": 3.0, "payload": {"path": "/a/b", "content_len": 4}},
        {"kind": "k", "emitted_at": 2.0, "payload": {"preview": "redacted:1", "text": 5}},
        {"kind": "k", "seq": 1, "payload": "not a mapping"},
        {"kind": "k", "seq": 1},
    ],
    "artifacts": [
        {"v": 1, "kind": "manifest", "run_id": "r", "lane": "gauntlet", "started_at": 1.0, "config": {}},
        {"v": 1, "kind": "oracle_report", "run_id": "r", "oracle": "f64", "cases": 50, "agreements": 48,
         "agreement_rate": 0.96, "divergences": []},
    ],
    "empty": [],
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_lint_evidence_stream_equals_reference(stream):
    got = port_cs.lint_evidence_stream(STREAMS[stream])
    assert got == ref_cs.lint_evidence_stream(STREAMS[stream])
    assert (got == []) == (stream in ("clean", "artifacts", "empty"))


ARTIFACTS = [
    {"v": 1, "kind": "manifest", "run_id": "r", "lane": "cli", "started_at": 0.0},
    {"v": 1, "kind": "manifest", "run_id": "r"},
    {"v": 2, "kind": "oracle_report", "run_id": "", "oracle": "x"},
    {"v": 1, "run_id": "r"},
    {"v": 1, "kind": "snapshot_diff", "run_id": "r"},
    {"v": 1, "kind": "unknown_kind", "run_id": "r"},
    {},
]


@pytest.mark.parametrize("i", range(len(ARTIFACTS)))
def test_validate_artifact_equals_reference(i):
    assert port_e2e.validate_artifact(ARTIFACTS[i]) == ref_e2e.validate_artifact(ARTIFACTS[i])


def test_artifact_files_are_byte_equal(tmp_path):
    files = {}
    for name, e2e in (("port", port_e2e), ("ref", ref_e2e)):
        path = str(tmp_path / f"{name}.jsonl")
        w = e2e.E2eArtifactWriter(path)
        w.write(e2e.E2eManifest(run_id="run-1", lane="gauntlet", started_at=1_700_000_000.5,
                                config={"k": 10, "tolerance": 1e-3}, corpus_fingerprint="abc"))
        report = e2e.OracleReport(run_id="run-1", oracle="exact-f64-bm25", cases=50, agreements=47,
                                  divergences=[{"query": "q", "detail": "swap"}])
        w.write(report)
        diff = e2e.SnapshotDiff(run_id="run-1", subject="index", added=["d1"], changed=["d2"])
        w.write(diff)
        w.write({"kind": "note", "at": object.__name__})
        files[name] = open(path, "rb").read()
        records = w.read_all()
        assert [e2e.validate_artifact(r) for r in records[:3]] == [[], [], []]
        assert report.agreement_rate == 0.94 and not diff.clean and e2e.SnapshotDiff("r", "s").clean
    assert files["port"] == files["ref"]


def test_lifecycle_events_equal_reference(monkeypatch):
    from frankensearch_tpu.core.collectors import RuntimeMetricsCollector as RefCollector
    from frankensearch_tpu_torch.core.collectors import RuntimeMetricsCollector

    out = {}
    for name, do, collector_cls in (("port", port_do, RuntimeMetricsCollector), ("ref", ref_do, RefCollector)):
        monkeypatch.setattr(do.time, "time", lambda: 1_700_000_000.0)
        sunk = []
        em = do.GenerationLifecycleEmitter(node_id="n1", collector=collector_cls(sink=sunk.append, cadence_ms=0))
        K = do.GenerationEventKind
        for kind, gen, seq in ((K.BUILD_STARTED, "g1", 0), (K.BUILD_COMPLETED, "g1", 5),
                               (K.VERIFICATION_PASSED, "g1", 5), (K.ACTIVATED, "g1", 5),
                               (K.ACTIVATED, "g2", 0), (K.ROLLBACK, "g3", 1)):
            em.emit(kind, gen, commit_seq=seq, reason=seq)
        out[name] = ([e.to_dict() for e in em.emitted],
                     [do.validate_lifecycle(em.lifecycle_of(g)) for g in ("g1", "g2", "g3")],
                     [(e.kind, e.correlation_id) for env in sunk for e in env.events])
    assert out["port"] == out["ref"]
    assert out["port"][1] == [[], ["activated without a verification pass"], ["rollback without a prior activation"]]
    assert [k.value for k in port_do.GenerationEventKind] == [k.value for k in ref_do.GenerationEventKind]
