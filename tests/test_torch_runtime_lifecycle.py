"""The port's lock ordering, access matrix, redaction and host adapter
against the JAX reference, on the CPU.

The reference's tests are the oracles (tests/test_concurrency_lifecycle.py
``TestLockOrder`` / ``TestAccessMatrix``, tests/test_runtime_product.py
``TestRedaction``, tests/test_core_schemas.py ``TestHostAdapter``). Every
output is host data and must be equal: which acquisition violates the
order and its message, every component x resource decision of the access
matrix, the single-writer audit, redacted payloads of seeded nested
dicts under each policy, and the host adapter's delivered payloads,
counters and conformance verdicts.
"""

import threading
import time

import numpy as np
import pytest

from frankensearch_tpu.core import collectors as rcol
from frankensearch_tpu.core import host_adapter as rhost
from frankensearch_tpu.runtime import concurrency as rconc
from frankensearch_tpu.runtime import redaction as rred
from frankensearch_tpu_torch.core import collectors as pcol
from frankensearch_tpu_torch.core import host_adapter as phost
from frankensearch_tpu_torch.runtime import concurrency as pconc
from frankensearch_tpu_torch.runtime import redaction as pred

# -- runtime/concurrency ---------------------------------------------------------


def _nest(mod, levels, names):
    """Acquire ``levels`` nested; returns (held count, violation message)."""
    locks = [mod.OrderedLock(mod.LockLevel[lv], nm) for lv, nm in zip(levels, names)]
    entered = []
    try:
        for lock in locks:
            lock.__enter__()
            entered.append(lock)
        return len(entered), None
    except mod.LockOrderViolation as e:
        return len(entered), str(e)
    finally:
        for lock in reversed(entered):
            lock.__exit__(None, None, None)


@pytest.mark.parametrize("seed", range(4))
def test_lock_order_equals_reference(seed):
    rng = np.random.default_rng(seed)
    names = [lv.name for lv in pconc.LockLevel]
    assert names == [lv.name for lv in rconc.LockLevel]
    assert [int(lv) for lv in pconc.LockLevel] == [int(lv) for lv in rconc.LockLevel]
    outcomes = []
    for trial in range(40):
        levels = list(rng.choice(names, size=int(rng.integers(1, 5))))
        tags = [f"l{trial}.{i}" if rng.random() < 0.5 else "" for i in range(len(levels))]
        got, want = _nest(pconc, levels, tags), _nest(rconc, levels, tags)
        assert got == want, levels
        outcomes.append(got[1] is None)
    assert True in outcomes and False in outcomes


def test_lock_stack_is_per_thread_and_balanced():
    a, b = pconc.OrderedLock(pconc.LockLevel.CATALOG), pconc.OrderedLock(pconc.LockLevel.VECTOR_WRITER)
    seen = []

    def other():
        with b:  # another thread holds nothing: any level is allowed
            seen.append(True)

    with a:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with b:
            pass
    assert seen == [True] and a.stats.acquisitions == 1 and b.stats.acquisitions == 2
    with pconc.OrderedLock(pconc.LockLevel.CONFIG):  # the stack unwound
        pass


def test_contention_is_counted():
    lock = pconc.OrderedLock(pconc.LockLevel.TELEMETRY)

    def worker():
        with lock:
            time.sleep(0.01)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert lock.stats.acquisitions == 4 and lock.stats.contended >= 1 and lock.stats.total_wait_s > 0


def _access(mod, component, resource):
    try:
        mod.check_access(component, resource)
        return None
    except mod.AccessViolation as e:
        return str(e)


def test_access_matrix_equals_reference():
    assert pconc.PIPELINE_ACCESS_MATRIX == rconc.PIPELINE_ACCESS_MATRIX
    resources = sorted(set().union(*pconc.PIPELINE_ACCESS_MATRIX.values())) + ["nonsense"]
    for component in list(pconc.PIPELINE_ACCESS_MATRIX) + ["nobody"]:
        for resource in resources:
            assert _access(pconc, component, resource) == _access(rconc, component, resource)
    assert pconc.single_writer_resources() == rconc.single_writer_resources()
    assert {"lexical_write", "publication"} <= pconc.single_writer_resources()


# -- runtime/redaction ----------------------------------------------------------------

KEYS = ["query", "latency_ms", "kind", "doc_path", "count", "at", "preview_text", "internal", "nested",
        "correlation_id", "score", "Content", "label"]


def _payload(rng, depth=0):
    out = {}
    for key in rng.choice(KEYS, size=int(rng.integers(2, 8)), replace=False):
        r = rng.random()
        if key == "nested" and depth < 2:
            out[key] = _payload(rng, depth + 1)
        elif r < 0.5:
            out[key] = "".join(rng.choice(list("abcdefgh /._-ü"), size=int(rng.integers(0, 120))))
        elif r < 0.8:
            out[key] = float(rng.standard_normal())
        else:
            out[key] = [int(x) for x in rng.integers(0, 9, size=3)]
    return out


def _policies(mod):
    fa = mod.FieldAction
    return {
        "default": mod.RedactionPolicy(),
        "strict": mod.STRICT_POLICY,
        "rules": mod.RedactionPolicy(rules={"internal": fa.DROP, "label": fa.TRUNCATE, "query": fa.KEEP},
                                     truncate_chars=5, salt="other-salt"),
        "truncate_default": mod.RedactionPolicy(default_action=fa.TRUNCATE, truncate_chars=3,
                                                sensitive_markers=("path",)),
    }


@pytest.mark.parametrize("policy", ["default", "strict", "rules", "truncate_default"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_redaction_equals_reference(policy, seed):
    rng = np.random.default_rng(seed)
    p, r = _policies(pred)[policy], _policies(rred)[policy]
    assert (p.retention.value, p.default_action.value) == (r.retention.value, r.default_action.value)
    for _ in range(30):
        payload = _payload(rng)
        got = p.redact(payload)
        assert got == r.redact(payload) and got == p.redact(payload)
        for key in payload:
            assert p.action_for(key).value == r.action_for(key).value


def test_redaction_hashes_sensitive_fields():
    """tests/test_runtime_product.py::TestRedaction on the port."""
    out = pred.RedactionPolicy(rules={"internal": pred.FieldAction.DROP}).redact(
        {"query": "secret terms", "latency_ms": 12, "internal": "x", "nested": {"path": "/home/user/doc"}})
    assert out["query"].startswith("redacted:") and out["latency_ms"] == 12
    assert "internal" not in out and out["nested"]["path"].startswith("redacted:")
    strict = pred.STRICT_POLICY.redact({"anything": "value", "kind": "search"})
    assert strict["anything"].startswith("redacted:") and strict["kind"] == "search"


# -- core/host_adapter --------------------------------------------------------------


def _envelope(col, rng, n=4):
    events = tuple(
        col.TelemetryEvent(kind=str(rng.choice(["search", "refresh", "index"])), payload=_payload(rng),
                           at=1_790_000_000.0 + i, correlation_id=f"c{i}" if i % 2 else "")
        for i in range(n)
    )
    return col.TelemetryEnvelope(v=1, source="node-a", emitted_at=1_790_000_100.5, events=events)


def _adapter_run(host, col, red, seed, policy):
    rng = np.random.default_rng(seed)
    got = []
    adapter = host.HostAdapter(name="t", sink=got.append, policy=_policies(red)[policy])
    counters = []
    for step in range(6):
        if step == 2:
            adapter.attach()
        if step == 4:
            adapter.detach()
        adapter.deliver(_envelope(col, rng))
        counters.append((adapter.attached, adapter.delivered, adapter.dropped_while_detached))
    conf = host.run_adapter_conformance(adapter)
    return got, counters, (conf.passed, conf.failures), adapter.attached


@pytest.mark.parametrize("policy", ["default", "strict", "rules", "truncate_default"])
def test_host_adapter_equals_reference(policy):
    got = _adapter_run(phost, pcol, pred, 3, policy)
    assert got == _adapter_run(rhost, rcol, rred, 3, policy)
    payloads, counters, conformance, attached = got
    assert len(payloads) == 2 and counters[-1] == (False, 2, 4) and attached
    assert conformance == ((False, ("sensitive field not redacted",)) if policy == "rules" else (True, ()))


def test_host_adapter_conformance_and_detached_drop():
    """tests/test_core_schemas.py::TestHostAdapter on the port."""
    adapter = phost.HostAdapter(name="test", sink=lambda d: None)
    result = phost.run_adapter_conformance(adapter)
    assert result.passed, result.failures
    got = []
    adapter = phost.HostAdapter(name="t", sink=got.append)
    env = pcol.TelemetryEnvelope(v=1, source="s", emitted_at=time.time(),
                                 events=(pcol.TelemetryEvent("k", {}, time.time(), "c"),))
    adapter.deliver(env)
    assert not got and adapter.dropped_while_detached == 1
