"""The port's generation lifecycle (activation, time travel, commit
replay, repair, recovery plan) against the JAX reference, on the CPU.

The reference's tests are the oracles (tests/test_generation.py
``TestActivation`` / ``TestTimeTravel`` / ``TestRepair`` /
``TestCommitReplay``, tests/test_core_schemas.py ``TestRecoveryPlan``,
tests/test_schemas.py:197). Everything here is host data and must be
equal: activation results and the bytes of ``CURRENT_GENERATION`` and
``COMMIT_FLOOR`` (a generation activated by either package is read back
by the other), historical lookups and pruned ids, replayed states and
commit-log bytes, repair state machines under a fixed clock, and every
recovery plan's wire form.
"""

import json
import os
from pathlib import Path

import jsonschema
import numpy as np
import pytest

from frankensearch_tpu.core import activation as ract
from frankensearch_tpu.core import commit_replay as rreplay
from frankensearch_tpu.core import generation as rgen
from frankensearch_tpu.core import recovery_plan as rplan
from frankensearch_tpu.core import repair as rrepair
from frankensearch_tpu.core import time_travel as rtt
from frankensearch_tpu_torch.core import activation as pact
from frankensearch_tpu_torch.core import commit_replay as preplay
from frankensearch_tpu_torch.core import generation as pgen
from frankensearch_tpu_torch.core import recovery_plan as pplan
from frankensearch_tpu_torch.core import repair as prepair
from frankensearch_tpu_torch.core import time_travel as ptt

REPO = Path(__file__).resolve().parents[1]
PKG = {
    "ref": {"act": ract, "gen": rgen, "tt": rtt},
    "port": {"act": pact, "gen": pgen, "tt": ptt},
}


def make_generation(pkg, root, gen_id, commit_seq, content=b"data", embedders=None, created_at=None):
    mods = PKG[pkg]
    ctl = mods["act"].GenerationController(str(root))
    gdir = ctl.generation_dir(gen_id)
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, "vector.fast.idx"), "wb") as f:
        f.write(content)
    m = mods["gen"].build_manifest(
        gdir, gen_id, commit_seq,
        embedders=embedders or {"fast": {"embedder_id": "m2v", "is_semantic": True}}, doc_count=1)
    if created_at is not None:
        m.created_at = created_at
    mods["gen"].write_manifest(gdir, m)
    return ctl


def _pointer_files(root):
    return {name: (Path(root) / name).read_bytes() for name in (pact.CURRENT_POINTER, pact.FLOOR_FILE)
            if (Path(root) / name).exists()}


def _result(r):
    return (r.activated, r.generation_id, list(r.violations), r.verification_ok)


# -- core/activation ----------------------------------------------------------------


def _activation_world(pkg, root, seed):
    rng = np.random.default_rng(seed)
    seqs = [int(s) for s in rng.choice(np.arange(1, 100), size=6, replace=False)]
    for i, seq in enumerate(seqs):
        emb = {"fast": {"embedder_id": "hash" if i == 4 else "m2v", "is_semantic": i != 4},
               "quality": {"embedder_id": "minilm" if i % 2 else "other"}}
        make_generation(pkg, root, f"gen-{i}", seq, content=rng.bytes(32), embedders=emb)
    # gen-5's artifact tampered after its manifest: verification must refuse it
    with open(os.path.join(root, "generations", "gen-5", "vector.fast.idx"), "wb") as f:
        f.write(b"tampered")
    return seqs


def _activation_script(pkg, root, seed):
    act = PKG[pkg]["act"]
    ctl = act.GenerationController(str(root))
    rng = np.random.default_rng(seed + 50)
    trace = []
    for _ in range(14):
        gen_id = f"gen-{int(rng.integers(0, 6))}"
        kind = rng.choice(["activate", "rollback", "semantic", "quality", "fast", "floor", "noverify"])
        if kind == "rollback":
            r = ctl.rollback(gen_id)
        elif kind == "semantic":
            r = ctl.activate(gen_id, act.ActivationInvariants(require_semantic=True))
        elif kind == "quality":
            r = ctl.activate(gen_id, act.ActivationInvariants(required_quality_embedder="minilm"))
        elif kind == "fast":
            r = ctl.activate(gen_id, act.ActivationInvariants(required_fast_embedder="hash"))
        elif kind == "floor":
            r = ctl.activate(gen_id, act.ActivationInvariants(min_commit_seq=int(rng.integers(0, 100))))
        elif kind == "noverify":
            r = ctl.activate(gen_id, verify=False)
        else:
            r = ctl.activate(gen_id)
        trace.append((str(kind), _result(r), ctl.current_generation(), ctl.commit_floor(),
                      _pointer_files(root)))
    trace.append(ctl.list_generations())
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_activation_equals_reference(tmp_path, seed):
    traces = {}
    for pkg in ("ref", "port"):
        _activation_world(pkg, tmp_path / pkg, seed)
        traces[pkg] = _activation_script(pkg, tmp_path / pkg, seed)
    assert traces["port"] == traces["ref"]
    results = [step[1] for step in traces["port"][:-1]]
    assert any(r[0] for r in results) and any(not r[0] for r in results)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_generation_activated_by_one_package_read_by_the_other(tmp_path, writer, reader):
    root = tmp_path / "root"
    for i, seq in enumerate((10, 20, 30)):
        make_generation(writer, root, f"gen-{i}", seq)
    w = PKG[writer]["act"].GenerationController(str(root))
    assert w.activate("gen-1").activated
    files = _pointer_files(root)
    assert files == {"CURRENT_GENERATION": b"gen-1", "COMMIT_FLOOR": b"20"}
    r = PKG[reader]["act"].GenerationController(str(root))
    assert (r.current_generation(), r.commit_floor()) == ("gen-1", 20)
    assert r.list_generations() == w.list_generations() == ["gen-0", "gen-1", "gen-2"]
    # the reader's controller keeps the writer's floor (anti-rollback) ...
    assert _result(r.rollback("gen-0")) == _result(w.rollback("gen-0"))
    assert not r.rollback("gen-0").activated and _pointer_files(root) == files
    # ... and moves the pointer forward in the same bytes
    assert r.activate("gen-2").activated
    assert _pointer_files(root) == {"CURRENT_GENERATION": b"gen-2", "COMMIT_FLOOR": b"30"}
    assert (w.current_generation(), w.commit_floor()) == ("gen-2", 30)


def test_activation_oracle_cases_on_the_port(tmp_path):
    """tests/test_generation.py::TestActivation on the port."""
    ctl = make_generation("port", tmp_path, "gen-2", 20)
    make_generation("port", tmp_path, "gen-1", 10)
    assert ctl.activate("gen-2").activated and ctl.commit_floor() == 20
    res = ctl.rollback("gen-1")
    assert not res.activated and any("anti-rollback" in v for v in res.violations)
    assert ctl.current_generation() == "gen-2"
    make_generation("port", tmp_path, "gen-3", 30, embedders={"fast": {"embedder_id": "hash", "is_semantic": False}})
    res = ctl.activate("gen-3", pact.ActivationInvariants(require_semantic=True))
    assert not res.activated and any("non-semantic" in v for v in res.violations)


# -- core/time_travel ----------------------------------------------------------------


def _history_world(pkg, root, seed):
    rng = np.random.default_rng(seed)
    seqs = sorted(int(s) for s in rng.choice(np.arange(1, 200), size=7, replace=False))
    for i, seq in enumerate(seqs):
        make_generation(pkg, root, f"gen-{chr(97 + i)}", seq, created_at=1_700_000_000.0 + 86400.0 * i)
    # an unreadable generation: manifests() skips it (reference time_travel.py:35)
    os.makedirs(os.path.join(root, "generations", "gen-zzz"))
    (Path(root) / "generations" / "gen-zzz" / "MANIFEST.json").write_text("{broken")
    return seqs


def _history_script(pkg, root, seed):
    mods = PKG[pkg]
    ctl = mods["act"].GenerationController(str(root))
    hist = mods["tt"].GenerationHistory(ctl)
    rng = np.random.default_rng(seed + 7)
    ctl.activate(f"gen-{chr(97 + int(rng.integers(0, 4)))}")
    trace = [[m.generation_id for m in hist.manifests()], hist.latest().generation_id]
    for q in rng.integers(0, 220, size=12):
        m = hist.at_commit_seq(int(q))
        trace.append(None if m is None else (m.generation_id, m.commit_seq))
    policy = mods["tt"].RetentionPolicy(keep_latest=int(rng.integers(1, 4)), keep_days=float(rng.integers(0, 4)))
    trace.append(hist.prune(policy, now=1_700_000_000.0 + 86400.0 * 7))
    trace.append((ctl.list_generations(), ctl.current_generation()))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_time_travel_equals_reference(tmp_path, seed):
    traces = {}
    for pkg in ("ref", "port"):
        _history_world(pkg, tmp_path / pkg, seed)
        traces[pkg] = _history_script(pkg, tmp_path / pkg, seed)
    assert traces["port"] == traces["ref"]
    assert "gen-zzz" not in traces["port"][0] and "gen-zzz" in traces["port"][-1][0]
    assert traces["port"][-1][1] in traces["port"][-1][0]  # CURRENT survives the prune


def test_prune_keeps_going_past_a_generation_it_cannot_delete(tmp_path, monkeypatch):
    """``prune`` removes with ``ignore_errors=True`` (reference
    time_travel.py:72): a directory that will not go is still reported."""
    ctl = make_generation("port", tmp_path, "gen-a", 10, created_at=1.0)
    make_generation("port", tmp_path, "gen-b", 20, created_at=2.0)
    make_generation("port", tmp_path, "gen-c", 30, created_at=3.0)
    removed = []

    def rmtree(path, ignore_errors=False):
        assert ignore_errors
        removed.append(os.path.basename(path))

    monkeypatch.setattr(ptt.shutil, "rmtree", rmtree)
    deleted = ptt.GenerationHistory(ctl).prune(ptt.RetentionPolicy(keep_latest=1, keep_days=0.0), now=1e9)
    assert deleted == removed == ["gen-a", "gen-b"]


# -- core/commit_replay -------------------------------------------------------------


def _ops(mod, seed, n=60):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        seq = int(rng.integers(1, n))
        doc = f"d{int(rng.integers(0, 8))}"
        if rng.random() < 0.3:
            ops.append(mod.CommitOp(seq, mod.OpKind.DELETE, doc))
        else:
            meta = {"k": int(rng.integers(0, 3))} if rng.random() < 0.3 else None
            ops.append(mod.CommitOp(seq, mod.OpKind.UPSERT, doc, f"content {seq}", "t" if seq % 2 else None, meta))
    return ops


def _state(st):
    return (st.applied_seq, st.skipped_stale, st.skipped_duplicate,
            sorted((d, op.to_json()) for d, op in st.docs.items()))


@pytest.mark.parametrize("seed", range(4))
def test_replay_equals_reference(seed):
    got_ops, want_ops = _ops(preplay, seed), _ops(rreplay, seed)
    assert [o.to_json() for o in got_ops] == [o.to_json() for o in want_ops]
    for up_to in (None, 5, 30):
        got = preplay.replay(got_ops, up_to_seq=up_to)
        want = rreplay.replay(want_ops, up_to_seq=up_to)
        assert _state(got) == _state(want)
        again = preplay.replay(got_ops[::-1], from_state=got)
        assert _state(again) == _state(rreplay.replay(want_ops[::-1], from_state=want))
    for raw in (o.to_json() for o in got_ops):
        assert preplay.CommitOp.from_json(raw) == preplay.CommitOp.from_json(raw)
        assert preplay.CommitOp.from_json(raw).to_json() == rreplay.CommitOp.from_json(raw).to_json() == raw


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_commit_log_bytes_and_reopen_equal_reference(tmp_path, writer, reader):
    mods = {"ref": rreplay, "port": preplay}
    logs = {}
    for pkg in ("ref", "port"):
        mod, log = mods[pkg], mods[pkg].CommitLog(str(tmp_path / f"{pkg}.jsonl"))
        log.append(mod.OpKind.UPSERT, "a", "content a", title="A", metadata={"x": 1})
        log.append(mod.OpKind.DELETE, "a")
        log.append(mod.OpKind.UPSERT, "b", "content ü")
        logs[pkg] = (tmp_path / f"{pkg}.jsonl").read_bytes()
    assert logs["port"] == logs["ref"]
    path = str(tmp_path / f"{writer}.jsonl")
    other = mods[reader].CommitLog(path)
    op = other.append(mods[reader].OpKind.UPSERT, "c", "content c")
    assert op.seq == 4
    assert sorted(mods[reader].replay(other.read()).docs) == ["b", "c"]
    assert [o.to_json() for o in mods[writer].CommitLog(path).read(from_seq=2)] == \
        [o.to_json() for o in other.read(from_seq=2)]


# -- core/repair ---------------------------------------------------------------------


def _repair_run(mod, seed):
    rng = np.random.default_rng(seed)
    ticks = iter(range(10_000))
    outcomes = {a: list(rng.choice(["ok", "fail", "raise"], size=8)) for a in ("fast.idx", "quality.idx", "lex")}

    def action(artifact):
        def run():
            o = outcomes[artifact].pop(0)
            if o == "raise":
                raise OSError(f"{artifact}: replica unreachable")
            return o == "ok"
        return run

    orch = mod.RepairOrchestrator(repair_actions={a: action(a) for a in ("fast.idx", "quality.idx")},
                                  max_attempts_per_artifact=int(rng.integers(1, 4)), clock=lambda: float(next(ticks)))
    trace = []
    for _ in range(20):
        artifact = str(rng.choice(["fast.idx", "quality.idx", "lex"]))
        step = rng.choice(["report", "attempt", "attempt", "all"])
        if step == "report":
            trace.append(orch.report_corruption(artifact, detail="crc").value)
        elif step == "attempt":
            trace.append(orch.attempt_repair(artifact))
        else:
            trace.append(orch.repair_all())
        trace.append(orch.state.value)
    trace.append([(e.artifact, e.detail, e.detected_at) for e in orch.events])
    trace.append([(a.artifact, a.succeeded, a.detail, a.attempted_at) for a in orch.attempts])
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_repair_equals_reference(seed):
    got = _repair_run(prepair, seed)
    assert got == _repair_run(rrepair, seed)


def test_failed_repair_action_is_recorded():
    """A repair action that raises is an attempt that failed (reference
    repair.py:75): the state machine reads it."""
    def broken():
        raise OSError("disk unreadable")

    orch = prepair.RepairOrchestrator(repair_actions={"x": broken}, max_attempts_per_artifact=1)
    assert orch.report_corruption("x") is prepair.ServiceState.DEGRADED
    assert not orch.attempt_repair("x")
    assert orch.state is prepair.ServiceState.SUSPENDED
    assert orch.attempts[-1].detail == "OSError: disk unreadable" and not orch.attempts[-1].succeeded


# -- core/recovery_plan --------------------------------------------------------------


def _plans(mod):
    out = []
    auths = (None, mod.ModelAcquisitionAuthorization("m", "r", "operator", "test"))
    for requested in mod.SearchMode:
        for fast in mod.ModelState:
            for quality in mod.ModelState:
                for index in mod.IndexState:
                    for lexical in (True, False):
                        for auth in auths:
                            plan = mod.plan_recovery(requested, fast_model=fast, quality_model=quality, index=index,
                                                     lexical_available=lexical, authorization=auth)
                            out.append(plan.to_dict())
    return out


def test_recovery_plans_equal_reference_and_validate():
    got = _plans(pplan)
    assert got == _plans(rplan) and len(got) == 3 * 4 * 4 * 5 * 2 * 2
    schema = json.loads((REPO / "schemas" / "recovery-plan-v1.schema.json").read_text())
    for plan in got:
        jsonschema.validate(plan, schema)
    assert {p["action"] for p in got} == {a.value for a in pplan.NextAction}
