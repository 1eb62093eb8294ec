"""The port's fleet console (``fleet/``, ``serve --fleet-dir``, ``daemon
--fleet-dir`` and the ``fleet`` command) against the JAX package's on the CPU.

Oracles: tests/test_fleet_live.py (the registrar and the reconciliation,
replayed on the port), the fleet cases of tests/test_tui_fleet.py,
tests/test_slo.py, and tests/test_cli_e2e.py::test_fleet_live_sees_real_serve_process
(a real ``serve --fleet-dir --device cpu`` subprocess, and a ``daemon
--fleet-dir`` one, killed). The simulator, the rollups, the SLO reports and
the fleet screen are bitwise the reference's on the same inputs; a node file
equals the reference's on the same clock, status and observations.

Divergence (ROADMAP queue 3): the reference's registrar publishes an empty
status when ``status_fn`` raises and its beat thread swallows every
exception, so a failed read of the card would publish ``hbm_used_frac``
0.0. The port's ``publish`` (and so ``start()``) raises; its beat thread
survives an ``OSError`` (a full disk) and keeps any other exception, which
``check()`` and ``close()`` raise: ``serve`` raises it at its next frame.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jsonschema
import numpy as np
import pytest

import frankensearch_tpu.fleet.datasource as ref_ds
import frankensearch_tpu.fleet.registry as ref_registry
import frankensearch_tpu.fleet.slo as ref_slo
import frankensearch_tpu.fleet.storage as ref_storage
import frankensearch_tpu.tui.screens as ref_screens
import frankensearch_tpu_torch.fleet.datasource as port_ds
import frankensearch_tpu_torch.fleet.registry as port_registry
import frankensearch_tpu_torch.fleet.slo as port_slo
import frankensearch_tpu_torch.fleet.storage as port_storage
import frankensearch_tpu_torch.tui.screens as port_screens
from frankensearch_tpu_torch.cli import main as port_cli
from frankensearch_tpu_torch.fleet.registry import NODE_SUFFIX, LiveDataSource, NodeRegistrar
from frankensearch_tpu_torch.ops import pressure
from tests.test_torch_cli import (  # noqa: F401
    env_of, no_pallas, reference_logger_untouched, run, write_corpus,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMAS = os.path.join(REPO, "schemas")
PKG = {"port": (port_ds, port_registry, port_storage, port_slo, port_screens),
       "ref": (ref_ds, ref_registry, ref_storage, ref_slo, ref_screens)}
DEAD_PID = 4194303  # 2**22 - 1: above the kernel's pid ceiling
WAIT_S = 60.0


def schema(name: str) -> dict:
    with open(os.path.join(SCHEMAS, name), encoding="utf-8") as f:
        return json.load(f)


def write_node(d, node_id, *, pid, at, **fields) -> str:
    rec = {"node_id": node_id, "pid": pid, "host": "h", "generation_id": "g", "at": at, "qps": 1.0,
           "p50_ms": 1.0, "p99_ms": 2.0, "hbm_used_frac": 0.0, "queue_pressure": 0.0, "doc_count": 1,
           "errors": 0, **fields}
    path = os.path.join(str(d), node_id + NODE_SUFFIX)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rec, f)
    return path


def wait_for(cond, what: str, timeout: float = WAIT_S):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    corpus = write_corpus(tmp_path_factory.mktemp("corpus") / "docs.jsonl")
    out = {}
    for pkg in ("port", "ref"):
        out[pkg] = str(tmp_path_factory.mktemp(f"fleet_{pkg}"))
        env_of(pkg, "index", corpus, "--root", out[pkg])
    return out


# -- tests/test_fleet_live.py on the port -------------------------------------------------------


def test_publish_roundtrip(tmp_path):
    reg = NodeRegistrar(str(tmp_path), "n1", root="/ix",
                        status_fn=lambda: {"doc_count": 42, "generation_id": "gen-7"})
    reg.publish()
    src = LiveDataSource(str(tmp_path))
    (n,) = src.nodes()
    assert n.node_id == "n1" and n.healthy and n.generation_id == "gen-7"
    (s,) = src.samples()
    assert s.doc_count == 42 and s.qps == 0.0


def test_observe_query_telemetry(tmp_path):
    reg = NodeRegistrar(str(tmp_path), "n1")
    for _ in range(20):
        reg.observe_query(5.0)
    reg.observe_query(50.0)  # tail
    reg.observe_error()
    reg.publish()
    (s,) = LiveDataSource(str(tmp_path)).samples()
    assert s.qps > 0 and s.p50_ms == 5.0 and s.p99_ms == 50.0 and s.errors == 1


def test_node_file_qps_is_count_over_its_own_stamp(tmp_path, monkeypatch):
    """qps and ``at`` come from one clock reading: a reader that divides
    the window's count by ``at - started_at`` gets the published qps, even
    when the clock moves between the window and the stamp (here 10 ms a
    reading, as a busy serving thread can make it)."""
    clock = iter(1000.0 + 0.01 * i for i in range(10_000))
    monkeypatch.setattr(port_registry.time, "time", lambda: next(clock))
    reg = NodeRegistrar(str(tmp_path), "n1")
    for _ in range(264):
        reg.observe_query(1.0)
    reg.publish()
    rec = json.load(open(reg.path))
    assert rec["qps"] == round(264 / (rec["at"] - rec["started_at"]), 2)


def test_close_deregisters(tmp_path):
    reg = NodeRegistrar(str(tmp_path), "n1").start()
    assert os.path.exists(reg.path)
    reg.close()
    assert not os.path.exists(reg.path) and LiveDataSource(str(tmp_path)).nodes() == []


def test_heartbeat_thread_beats(tmp_path):
    with NodeRegistrar(str(tmp_path), "n1", heartbeat_s=0.05) as reg:
        first = json.load(open(reg.path))["at"]
        time.sleep(0.2)
        second = json.load(open(reg.path))["at"]
    assert second > first


def test_dead_pid_unhealthy_then_reaped(tmp_path):
    path = write_node(tmp_path, "dead", pid=DEAD_PID, at=time.time())
    src = LiveDataSource(str(tmp_path))
    (n,) = src.nodes()
    assert not n.healthy and not os.path.exists(path)  # reaped after being reported
    assert src.nodes() == []


def test_stale_heartbeat_unhealthy_but_kept(tmp_path):
    write_node(tmp_path, "wedged", pid=os.getpid(), at=time.time() - 300)
    src = LiveDataSource(str(tmp_path), stale_after_s=15.0)
    (n,) = src.nodes()
    assert not n.healthy and len(src.nodes()) == 1  # a live pid's file stays


def test_samples_first_still_reports_dead_node_once(tmp_path):
    path = write_node(tmp_path, "dead", pid=DEAD_PID, at=time.time())
    src = LiveDataSource(str(tmp_path))
    src.samples()
    assert os.path.exists(path)
    (n,) = src.nodes()
    assert not n.healthy and not os.path.exists(path)


def test_malformed_pid_is_dead_not_crash(tmp_path):
    with open(os.path.join(str(tmp_path), "bad" + NODE_SUFFIX), "w", encoding="utf-8") as f:
        json.dump({"v": 1, "node_id": "bad", "pid": "abc", "host": "h", "at": time.time()}, f)
    write_node(tmp_path, "ok", pid=os.getpid(), at=time.time())
    by_id = {n.node_id: n for n in LiveDataSource(str(tmp_path)).nodes()}
    assert by_id["ok"].healthy and not by_id["bad"].healthy


def test_torn_json_skipped(tmp_path):
    with open(os.path.join(str(tmp_path), "torn" + NODE_SUFFIX), "w") as f:
        f.write('{"node_id": "to')
    write_node(tmp_path, "ok", pid=os.getpid(), at=time.time())
    assert [n.node_id for n in LiveDataSource(str(tmp_path)).nodes()] == ["ok"]


def test_missing_dir_is_empty_fleet(tmp_path):
    src = LiveDataSource(str(tmp_path / "nope"))
    assert src.nodes() == [] and src.samples() == []


@pytest.mark.parametrize("bad", ["../../evil", "a/b", "a\\b", ".hidden", "", "x\x00y"])
def test_node_id_path_traversal_rejected(tmp_path, bad):
    for registry in (port_registry, ref_registry):
        with pytest.raises(ValueError):
            registry.NodeRegistrar(str(tmp_path), bad)
    assert os.listdir(tmp_path) == []


def test_hostile_node_id_neutralized_in_fleet_screen(tmp_path):
    path = write_node(tmp_path, "evil", pid=os.getpid(), at=time.time(), generation_id="g\rX")
    rec = json.load(open(path))
    rec["node_id"] = "ev\x1b[2Jil"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rec, f)
    frames = []
    for ds_reg, store_mod, screens in ((port_registry, port_storage, port_screens),
                                       (ref_registry, ref_storage, ref_screens)):
        src = ds_reg.LiveDataSource(str(tmp_path))
        store = store_mod.FleetStore()
        store.ingest(list(src.samples()))
        nodes = src.nodes()
        frames.append(screens.FleetScreen(nodes_fn=lambda nodes=nodes: nodes, rollups_fn=store.rollups).render(100))
    assert "\x1b" not in frames[0] and "\r" not in frames[0] and "\\x1b" in frames[0]
    assert frames[0] == frames[1]


# -- the node file against the reference's ---------------------------------------------------------


@pytest.mark.parametrize("lats,errors,status", [
    ([], 0, None),
    ([5.0] * 20 + [50.0], 1, {"doc_count": 42, "generation_id": "gen-7", "hbm_used_frac": 0.25,
                              "queue_pressure": 0.5}),
    ([0.5, 3.25, 1.125, 7.0, 2.0], 3, {"doc_count": 7}),
], ids=["idle", "served", "partial-status"])
def test_node_file_equals_reference(tmp_path, monkeypatch, lats, errors, status):
    """On one clock, status and set of observations the two registrars
    write the same node file (pid and host are this process's in both)."""
    clock = [1_800_000_000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    files = {}
    for pkg in ("port", "ref"):
        registry = PKG[pkg][1]
        d = tmp_path / pkg
        reg = registry.NodeRegistrar(str(d), "node-a", root="/ix",
                                     status_fn=None if status is None else (lambda: dict(status)))
        clock[0] += 0.0  # both start at the same instant
        for i, lat in enumerate(lats):
            reg.observe_query(lat, n=1 + i % 2)
        for _ in range(errors):
            reg.observe_error()
        clock[0] = 1_800_000_004.5
        reg.publish()
        clock[0] = 1_800_000_000.0
        with open(reg.path, encoding="utf-8") as f:
            files[pkg] = json.load(f)
    assert files["port"] == files["ref"]
    jsonschema.validate(files["port"], schema("fleet-node-v1.schema.json"))


# -- the registrar's divergence: faults propagate -------------------------------------------------


def test_status_failure_propagates_from_publish_and_start(tmp_path):
    def broken():
        raise RuntimeError("the card could not be read")

    reg = NodeRegistrar(str(tmp_path), "n1", status_fn=broken)
    with pytest.raises(RuntimeError, match="could not be read"):
        reg.publish()
    with pytest.raises(RuntimeError, match="could not be read"):
        reg.start()
    assert not os.path.exists(reg.path) and reg._thread is None
    # the reference publishes an empty status instead
    ref = ref_registry.NodeRegistrar(str(tmp_path / "ref"), "n1", status_fn=broken)
    ref.publish()
    assert json.load(open(ref.path))["hbm_used_frac"] == 0.0


def test_os_error_in_a_beat_does_not_stop_the_beats(tmp_path):
    calls = []

    def flaky():
        calls.append(time.time())
        if len(calls) in (2, 3):  # the first two beats: a full disk
            raise OSError(28, "No space left on device")
        return {"doc_count": len(calls)}

    with NodeRegistrar(str(tmp_path), "n1", status_fn=flaky, heartbeat_s=0.02) as reg:
        wait_for(lambda: json.load(open(reg.path))["doc_count"] >= 5, "beats after the OSError")
        reg.check()  # nothing kept
    assert not os.path.exists(reg.path)


def test_other_fault_in_a_beat_is_kept_and_raised(tmp_path):
    calls = []

    def dies():
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("CUDA error: device lost")
        return {"doc_count": 1}

    reg = NodeRegistrar(str(tmp_path), "n1", status_fn=dies, heartbeat_s=0.02).start()
    wait_for(lambda: reg._fault is not None, "the beat's fault")
    time.sleep(0.1)
    assert len(calls) == 2  # the beat thread stopped at the fault
    with pytest.raises(RuntimeError, match="device lost"):
        reg.check()
    with pytest.raises(RuntimeError, match="device lost"):
        reg.close()
    assert not os.path.exists(reg.path)


@contextlib.contextmanager
def piped_serve(argv):
    """``cli serve`` of the port in process on a pipe: yields (send,
    replies, box); ``box`` gets the call's return code or exception."""
    read_fd, write_fd = os.pipe()
    reader, writer = os.fdopen(read_fd, "r"), os.fdopen(write_fd, "w")
    out = _Lines()
    box: dict = {}

    def serve():
        try:
            box["rc"] = port_cli.main(argv)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            box["error"] = e

    def send(frame: dict) -> None:
        writer.write(json.dumps(frame) + "\n")
        writer.flush()

    old_in, old_out = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = reader, out
    t = threading.Thread(target=serve, daemon=True)
    try:
        t.start()
        yield send, out, box
    finally:
        writer.close()
        t.join(timeout=WAIT_S)
        sys.stdin, sys.stdout = old_in, old_out
        reader.close()
    assert not t.is_alive()


class _Lines(io.TextIOBase):
    def __init__(self) -> None:
        self.lines: list[str] = []
        self._part = ""

    def write(self, text: str) -> int:
        self._part += text
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append(line)
        return len(text)

    def wait(self, n: int) -> list[dict]:
        wait_for(lambda: len(self.lines) >= n, f"{n} reply lines")
        return [json.loads(x) for x in self.lines[:n]]


def test_serve_raises_when_the_card_read_fails_at_start(roots, tmp_path, monkeypatch):
    def lost(device):
        raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(pressure, "sense_device_hbm", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        run("port", "serve", "--root", roots["port"], "--fleet-dir", str(tmp_path / "f"), stdin="")


def test_serve_raises_a_beat_fault_at_its_next_frame(roots, tmp_path, monkeypatch):
    """The first publish reads the card; a beat's read fails; the next
    frame raises it out of ``main`` (a non-zero exit), unanswered."""
    real, failed = pressure.sense_device_hbm, threading.Event()

    def lost_in_beats(device):
        if threading.current_thread().name.startswith("fleet-beat"):
            failed.set()
            raise RuntimeError("CUDA error: device lost")
        return real(device)

    monkeypatch.setattr(pressure, "sense_device_hbm", lost_in_beats)
    fleet = tmp_path / "f"
    with piped_serve(["--format", "json", "serve", "--root", roots["port"], "--fleet-dir", str(fleet),
                      "--node-id", "s1", "--device", "cpu"]) as (send, out, box):
        send({"op": "ping"})
        assert out.wait(1)[0]["data"] == {"op": "pong"}
        assert os.path.exists(fleet / ("s1" + NODE_SUFFIX))
        wait_for(failed.is_set, "a beat's failed read")
        send({"op": "ping"})
    assert isinstance(box.get("error"), RuntimeError) and "device lost" in str(box["error"])
    assert len(out.lines) == 1


# -- the simulator, the store, the SLO contract, the screen ---------------------------------------


def samples_of(batch) -> list:
    return [dataclasses.astuple(s) for s in batch]


@pytest.mark.parametrize("n_nodes,seed,incidents,ticks", [
    (4, 0, {}, 30), (3, 5, {}, 10), (2, 1, {"node-1": (2, 5)}, 8), (6, 11, {"node-0": (0, 4), "node-5": (3, 9)}, 12),
])
def test_simulator_bitwise_reference(n_nodes, seed, incidents, ticks):
    sims = [PKG[p][0].FleetSimulator(n_nodes=n_nodes, seed=seed, incidents=dict(incidents)) for p in ("port", "ref")]
    for _ in range(ticks):
        assert [dataclasses.astuple(n) for n in sims[0].nodes()] == [dataclasses.astuple(n) for n in sims[1].nodes()]
        assert samples_of(sims[0].step()) == samples_of(sims[1].step())
    assert samples_of(sims[0].samples()) == samples_of(sims[1].samples())


def test_simulator_deterministic():
    s1, s2 = port_ds.FleetSimulator(n_nodes=3, seed=5), port_ds.FleetSimulator(n_nodes=3, seed=5)
    assert [s1.step() for _ in range(10)] == [s2.step() for _ in range(10)]


def test_incident_drops_node():
    sim = port_ds.FleetSimulator(n_nodes=2, seed=1, incidents={"node-1": (2, 5)})
    for _ in range(2):
        sim.step()
    assert {n.node_id: n.healthy for n in sim.nodes()} == {"node-0": True, "node-1": False}
    assert all(s.node_id != "node-1" for s in sim.step())
    for _ in range(3):
        sim.step()
    assert {n.node_id: n.healthy for n in sim.nodes()}["node-1"] is True


def test_mock_datasource():
    m = port_ds.MockDataSource()
    m.add_node(port_ds.NodeInfo("n1", "h", "g", True, 0.0))
    m.add_sample(port_ds.NodeSample("n1", 0.0, 1.0, 1.0, 2.0, 0.1, 0.0, 3))
    assert m.nodes()[0].node_id == "n1" and m.samples()[0].doc_count == 3


@pytest.mark.parametrize("n_nodes,seed,ticks", [(2, 3, 20), (5, 9, 7)])
def test_store_rollups_equal_reference(n_nodes, seed, ticks):
    stores = {p: PKG[p][2].FleetStore() for p in PKG}
    sims = {p: PKG[p][0].FleetSimulator(n_nodes=n_nodes, seed=seed) for p in PKG}
    for _ in range(ticks):
        for p in PKG:
            assert stores[p].ingest(sims[p].step()) == n_nodes
    got, want = ([dataclasses.astuple(r) for r in stores[p].rollups()] for p in ("port", "ref"))
    assert got == want and len(got) == n_nodes and all(r[1] == ticks for r in got)
    assert stores["port"].fleet_qps() == stores["ref"].fleet_qps() > 0
    screens = [PKG[p][4].FleetScreen(nodes_fn=sims[p].nodes, rollups_fn=stores[p].rollups).render(100)
               for p in ("port", "ref")]
    assert screens[0] == screens[1]


def seeded_events(seed: int, now: float) -> list[tuple[str, float, float]]:
    """A latency stream with a spike in the last 15 minutes, failures,
    and the two backlog metrics, at seeded times over the past week."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(300):
        at = now - float(rng.uniform(0, 7 * 86400))
        out.append(("search_latency_p95", float(rng.gamma(4.0, 15.0)), at))
        out.append(("query_failure_rate", float(rng.random() < 0.02), at))
        out.append(("stale_index_lag", float(rng.exponential(200.0)), at))
        out.append(("embedding_backlog_age", float(rng.exponential(300.0)), at))
    for i in range(12):
        out.append(("search_latency_p95", 400.0 + float(rng.random()) * 50, now - i * 30.0))
    for i in range(40):  # a dense baseline inside the 6 h window
        out.append(("search_latency_p95", 50.0 + float(rng.random()), now - 1000.0 - i * 400.0))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_report_bitwise_reference(seed):
    now = 1_000_000_000.0
    reports = []
    for p in ("port", "ref"):
        ev = PKG[p][3].SloEvaluator()
        for metric, value, at in seeded_events(seed, now):
            ev.record(metric, value, at)
        reports.append(json.dumps(ev.report(now)))
    assert reports[0] == reports[1]
    assert json.loads(reports[0])["anomalies"], "the spike is an anomaly"


def test_slo_contract_vectors_and_alerts():
    b = port_slo.error_budget(5, 100, metric_id="search_latency_p95", window="1h")
    assert (b["formula_version"], b["bad_ratio"], b["consumed"], b["remaining"]) == ("v1", 0.05, 1.0, 0.0)
    assert b["burn_rate"] == pytest.approx(10.0)
    b = port_slo.error_budget(0, 0, metric_id="query_failure_rate", window="1w")
    assert b["consumed"] == 0.0 and b["remaining"] == 1.0
    hot = port_slo.error_budget(50, 100, metric_id="query_failure_rate", window="1m")
    assert hot["consumed"] == 1.0 and hot["burn_rate"] == pytest.approx(1.0 / port_slo.BUDGET_FRACTIONS["1m"])
    a = port_slo.budget_alert(hot)
    assert a["reason_code"] == "slo.query_failure_rate.budget_burn_high" and a["severity"] == "critical"
    assert port_slo.budget_alert(port_slo.error_budget(0, 100, metric_id="query_failure_rate", window="1m")) is None
    assert port_slo.METRICS == ref_slo.METRICS and port_slo.WINDOWS == ref_slo.WINDOWS
    assert port_slo.BUDGET_FRACTIONS == ref_slo.BUDGET_FRACTIONS
    with pytest.raises(KeyError):
        port_slo.SloEvaluator().record("made_up", 1.0, 0.0)


def test_slo_window_bucketing_and_quiet_stream():
    ev = port_slo.SloEvaluator()
    now = 1_000_000.0
    for i in range(10):
        ev.record("search_latency_p95", 150.0 if i < 2 else 50.0, now - i)
    ev.record("search_latency_p95", 900.0, now - port_slo.WINDOWS["3d"] - 1)
    budgets = {(b["metric_id"], b["window"]): b for b in ev.budgets(now)}
    assert (budgets[("search_latency_p95", "1m")]["bad_events"], budgets[("search_latency_p95", "1m")]["total_events"]) == (2, 10)
    assert (budgets[("search_latency_p95", "1w")]["bad_events"], budgets[("search_latency_p95", "1w")]["total_events"]) == (3, 11)
    quiet = port_slo.SloEvaluator()
    for i in range(60):
        quiet.record("search_latency_p95", 50.0 + (i % 5), 5000.0 - i * 60)
    assert quiet.anomalies(5000.0) == []


def test_slo_from_fleet_samples_equals_reference():
    sim = port_ds.FleetSimulator(n_nodes=3, seed=4, incidents={"node-2": (3, 6)})
    samples = [s for _ in range(20) for s in sim.step()]
    samples.append(port_ds.NodeSample("n1", 19.5, 10.0, 1.0, 250.0, 0.1, 0.0, 10, errors=1))
    reports = [json.dumps(PKG[p][3].from_fleet_samples(samples).report(20.0)) for p in ("port", "ref")]
    assert reports[0] == reports[1]
    budgets = {(b["metric_id"], b["window"]): b for b in json.loads(reports[0])["budgets"]}
    assert budgets[("search_latency_p95", "1m")]["bad_events"] == 1
    assert budgets[("query_failure_rate", "1m")]["bad_events"] >= 1


# -- the fleet command ------------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--incident", "node-1"], ["--nodes", "3", "--ticks", "12", "--seed", "7"],
                                  ["--nodes", "1", "--ticks", "1"]], ids=lambda a: " ".join(a) or "default")
@pytest.mark.parametrize("fmt", ["json", "table"])
def test_fleet_simulator_command_equals_reference(argv, fmt):
    outs = [run(pkg, "--format", fmt, "fleet", *argv) for pkg in ("port", "ref")]
    assert outs[0] == outs[1] and outs[0][0] == 0
    if fmt == "table":
        assert outs[0][1].splitlines()[0].startswith("node")


def live_registry(d) -> None:
    """Node files of live pids (this process): six old samples (the
    anomaly baseline), two recent slow ones with an error, one stale."""
    now = time.time()
    for i in range(6):
        write_node(d, f"base-{i}", pid=os.getpid(), at=now - 3600 - 300 * i, p99_ms=50.0 + i, qps=10.0 + i)
    write_node(d, "hot-0", pid=os.getpid(), at=now - 5, p99_ms=420.0, errors=2, qps=3.5)
    write_node(d, "hot-1", pid=os.getpid(), at=now - 10, p99_ms=410.0, qps=2.25)


@pytest.mark.parametrize("argv", [["--format", "json"], ["--format", "json", "--slo"], ["--format", "table"],
                                  ["--format", "json", "--stale-after", "100000"]],
                         ids=["json", "slo", "table", "stale-after"])
def test_fleet_live_command_equals_reference(tmp_path, argv):
    live_registry(tmp_path)
    outs = [run(pkg, argv[0], argv[1], "fleet", "--live", str(tmp_path), *argv[2:]) for pkg in ("port", "ref")]
    assert outs[0] == outs[1] and outs[0][0] == 0
    if "--slo" in argv:
        data = json.loads(outs[0][1])["data"]
        assert data["nodes"] == 8 and data["anomalies"][0]["reason_code"] == "anomaly.search_latency_p95.spike"


# -- real processes ---------------------------------------------------------------------------------


def port_subprocess(*argv, **kw) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "frankensearch_tpu_torch.cli", *argv, "--device", "cpu"],
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), text=True, **kw)


def fleet_live(fleet: str) -> dict:
    return env_of("port", "fleet", "--live", fleet)["data"]


def test_fleet_live_sees_real_serve_process(roots, tmp_path):
    """tests/test_cli_e2e.py::test_fleet_live_sees_real_serve_process on
    the port: healthy while serving, with its telemetry after a beat;
    gone after a clean shutdown."""
    fleet = str(tmp_path / "fleet")
    proc = port_subprocess("--format", "json", "serve", "--root", roots["port"], "--fleet-dir", fleet,
                           "--node-id", "e2e-serve", stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        proc.stdin.write(json.dumps({"op": "search", "query": "jax tpu", "k": 2}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["ok"]
        node = os.path.join(fleet, "e2e-serve" + NODE_SUFFIX)
        rec = wait_for(lambda: (r := json.load(open(node))) and r["qps"] > 0 and r, "a beat with the telemetry")
        assert rec["pid"] == proc.pid and rec["doc_count"] == 64 and rec["errors"] == 0
        assert rec["hbm_used_frac"] == 0.0 and 0 < rec["p50_ms"] <= rec["p99_ms"]
        with open(os.path.join(roots["port"], "lexical", "CURRENT")) as f:
            assert rec["generation_id"] == f.read().strip()
        jsonschema.validate(rec, schema("fleet-node-v1.schema.json"))
        data = fleet_live(fleet)
        assert [(n["node"], n["healthy"]) for n in data["nodes"]] == [("e2e-serve", True)]
        assert data["rollups"][0]["node"] == "e2e-serve" and data["rollups"][0]["samples"] == 1
    finally:
        proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
        proc.stdin.flush()
        proc.wait(timeout=WAIT_S)
    assert proc.returncode == 0 and fleet_live(fleet)["nodes"] == []


def test_fleet_live_sees_a_killed_daemon_go_down(roots, tmp_path):
    fleet, sock = str(tmp_path / "fleet"), str(tmp_path / "d.sock")
    proc = port_subprocess("--format", "json", "daemon", "--root", roots["port"], "--socket", sock,
                           "--fleet-dir", fleet, "--node-id", "d1", "--quiet", stdout=subprocess.PIPE)
    try:
        node = os.path.join(fleet, "d1" + NODE_SUFFIX)
        wait_for(lambda: os.path.exists(node), "the daemon's node file")
        rec = json.load(open(node))
        assert rec["pid"] == proc.pid and rec["doc_count"] == 64 and rec["generation_id"] == ""
        assert [(n["node"], n["healthy"]) for n in fleet_live(fleet)["nodes"]] == [("d1", True)]
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=WAIT_S)
    assert os.path.exists(node)  # a crash leaves the file behind
    assert [(n["node"], n["healthy"]) for n in fleet_live(fleet)["nodes"]] == [("d1", False)]
    assert not os.path.exists(node) and fleet_live(fleet)["nodes"] == []


def test_daemon_fleet_dir_registers_and_deregisters(roots, tmp_path):
    """``daemon --fleet-dir`` in process, port and reference: the node
    is live while it serves (its doc count and no generation), and its
    file is gone when it exits; the envelopes are equal."""
    envs = {}
    for pkg in ("port", "ref"):
        fleet, sock = tmp_path / f"fleet_{pkg}", str(tmp_path / f"{pkg}.sock")
        daemon = (port_registry if pkg == "port" else ref_registry)
        seen = []

        def client(fleet=fleet, sock=sock, daemon_pkg=pkg, seen=seen):
            from frankensearch_tpu.core.daemon import DaemonClient as RefClient
            from frankensearch_tpu_torch.core.daemon import DaemonClient as PortClient

            wait_for(lambda: os.path.exists(sock), "the socket")
            seen.append(json.load(open(fleet / ("d-" + daemon_pkg + NODE_SUFFIX))))
            seen.append([(n.node_id, n.healthy) for n in LiveDataSource(str(fleet)).nodes()])
            (PortClient if daemon_pkg == "port" else RefClient)(sock, timeout_s=10.0).ping()

        t = threading.Thread(target=client)
        t.start()
        rc, out = run(pkg, "--format", "json", "daemon", "--root", roots[pkg], "--socket", sock, "--fleet-dir",
                      str(fleet), "--node-id", f"d-{pkg}", "--max-requests", "1", "--accept-timeout", "0.2",
                      "--idle-timeout", "20", "--quiet")
        t.join(timeout=WAIT_S)
        assert rc == 0 and not t.is_alive() and os.listdir(fleet) == []
        rec, nodes = seen
        assert nodes == [(f"d-{pkg}", True)]
        assert rec["doc_count"] == 64 and rec["generation_id"] == "" and rec["pid"] == os.getpid()
        assert daemon.NODE_SCHEMA_VERSION == rec["v"]
        envs[pkg] = json.loads(out)
        envs[pkg]["data"]["socket"] = os.path.basename(envs[pkg]["data"]["socket"])[len(pkg):]
    assert envs["port"] == envs["ref"]


def test_serve_fleet_node_matches_reference_fields(roots, tmp_path):
    """``serve --fleet-dir`` in process, port and reference, the same
    frames: each node file, read after a beat that follows the replies,
    has the reference's keys, doc count, memory and queue fractions and
    errors; the replies are equal; the file is gone after ``shutdown``."""
    recs = {}
    for pkg in ("port", "ref"):
        fleet = tmp_path / f"fleet_{pkg}"
        node = fleet / ("s" + NODE_SUFFIX)
        frames = [{"op": "search", "query": q, "k": 3} for q in ("jax tpu", "rust ownership", "w001 w002")]
        stdin_r, stdin_w = os.pipe()
        out = _Lines()
        old_in, old_out = sys.stdin, sys.stdout
        sys.stdin, sys.stdout = os.fdopen(stdin_r, "r"), out
        main = port_cli.main if pkg == "port" else __import__("frankensearch_tpu.cli.main", fromlist=["main"]).main
        argv = ["--format", "json", "serve", "--root", roots[pkg], "--fleet-dir", str(fleet), "--node-id", "s"]
        box = {}
        t = threading.Thread(target=lambda: box.setdefault("rc", main(argv + (["--device", "cpu"] if pkg == "port"
                                                                                 else []))), daemon=True)
        try:
            t.start()
            with os.fdopen(stdin_w, "w") as w:
                for f in frames:
                    w.write(json.dumps(f) + "\n")
                    w.flush()
                    out.wait(len(out.lines) + 1)
                t_sent = time.time()
                recs[pkg] = wait_for(lambda: node.exists() and (r := json.load(open(node)))["at"] > t_sent and r,
                                     "a beat after the replies")
                w.write(json.dumps({"op": "shutdown"}) + "\n")
            t.join(timeout=WAIT_S)
        finally:
            sys.stdin.close()
            sys.stdin, sys.stdout = old_in, old_out
        assert box["rc"] == 0 and not node.exists() and len(out.lines) == 4
    got, want = recs["port"], recs["ref"]
    assert set(got) == set(want)
    for key in ("v", "node_id", "doc_count", "errors", "hbm_used_frac", "queue_pressure"):
        assert got[key] == want[key], key
    assert got["doc_count"] == 64 and got["errors"] == 0 and got["qps"] > 0 and got["p50_ms"] <= got["p99_ms"]
    jsonschema.validate(got, schema("fleet-node-v1.schema.json"))
