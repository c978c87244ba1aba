"""The port's consistency auditor (audit.py) and resilience tracker
(utils/resilience.py ``TRACKER``), against the JAX package's.

The JAX ``tests/test_audit.py`` engine and node cases, each run on both
planes through ``tests/torch_kube_planes.py``: the JAX auditor over a fake
v5p host and the port's over four H100s of the fake NVML, each with its own
controller, fake API server and fake PodResources. Each corruption fires
exactly its invariant on both planes, with the same labels, and clears
after the repair. Then the port's daemon: the flag and the auditor's
lifecycle, ``degraded_consistency`` over the tracker, ``lock_order`` on a
seeded lockdep cycle, the flight dump of a new critical finding, and SIGHUP
leaving the tracker one degraded mode per live generation.
"""

import json
import os
import signal
import threading
import time
import types

import pytest

from k8s_device_plugin_tpu import audit as jax_audit
from k8s_device_plugin_tpu.utils import decisions as jax_decisions
from k8s_device_plugin_tpu.utils import flightrecorder as jax_flight
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import profiling as jax_profiling
from k8s_device_plugin_tpu.utils import resilience as jax_resilience
from k8s_device_plugin_tpu_torch import audit
from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin, PluginConfig
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.utils import (decisions, flightrecorder, metrics, profiling,
                                               resilience)
from tests import torch_fake_nvml as fk
from tests import torch_kube_planes as planes
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakeKubelet, FakePodResources

NODE = planes.NODE
WAIT_S = 10

PLANES = {
    "jax": types.SimpleNamespace(audit=jax_audit, metrics=jax_metrics,
                                 recorder=jax_flight.RECORDER, ledger=jax_decisions.LEDGER,
                                 resilience=jax_resilience),
    "torch": types.SimpleNamespace(audit=audit, metrics=metrics,
                                   recorder=flightrecorder.RECORDER, ledger=decisions.LEDGER,
                                   resilience=resilience),
}
NODE_INVARIANTS = {"checkpoint_vs_podresources", "annotation_vs_kubelet",
                   "attribution_vs_kubelet", "gauge_vs_state", "orphaned_chip",
                   "thread_liveness", "lock_order", "loop_inventory",
                   "degraded_consistency"}


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture(autouse=True)
def _clean_audit_state():
    """Audit families, recorders and ledgers are process-global: every test
    ends with none of its findings, events or records left in either
    plane."""
    yield
    for p in PLANES.values():
        p.metrics.AUDIT_FINDINGS.remove_matching()
        p.audit.install_engine(None)
        p.recorder.clear()
        p.recorder.disable()
        p.ledger.clear()
        p.ledger.disable()


def wait_for(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        time.sleep(0.02)


def names(findings):
    return {f.invariant for f in findings}


def flight_states(p):
    return [(e["attrs"]["state"], e["attrs"]["severity"])
            for e in p.recorder.export()["events"] if e["kind"] == "audit_divergence"]


# -- engine mechanics ---------------------------------------------------------

@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_engine_metrics_flight_ledger_lockstep(plane):
    """One drifting invariant through the reporting chain: the gauge series
    appears and is pruned on clear, the sweeps counter carries the outcome,
    detection and clear each flight-record once, the ledger records the
    machine reason."""
    p = PLANES[plane]
    p.recorder.enable(service="plugin")
    p.ledger.enable(service="plugin")
    drift = {"on": False}

    def check():
        if not drift["on"]:
            return []
        return [p.audit.Finding.make("orphaned_chip", p.audit.CRITICAL,
                                     "chips held by a vanished pod", pod="ml/ghost",
                                     node=NODE, chips="card-a,card-b")]

    engine = p.audit.AuditEngine(
        "plugin", [p.audit.Invariant("orphaned_chip", ("a", "b"), "test", check)],
        interval_s=60)
    before_clean = p.metrics.AUDIT_SWEEPS.get(outcome="clean")
    assert engine.sweep_once() == []
    assert p.metrics.AUDIT_SWEEPS.get(outcome="clean") == before_clean + 1
    assert p.metrics.AUDIT_FINDINGS.series() == []
    clean_ts = p.metrics.AUDIT_LAST_CLEAN.get()
    assert clean_ts > 0
    drift["on"] = True
    assert names(engine.sweep_once()) == {"orphaned_chip"}
    assert p.metrics.AUDIT_FINDINGS.get(invariant="orphaned_chip", severity="critical") == 1
    assert p.metrics.AUDIT_LAST_CLEAN.get() == clean_ts  # a dirty sweep does not advance it
    engine.sweep_once()  # the finding persists: nothing new recorded
    events = [e for e in p.recorder.export()["events"] if e["kind"] == "audit_divergence"]
    assert len(events) == 1
    assert (events[0]["attrs"]["state"], events[0]["attrs"]["invariant"],
            events[0]["attrs"]["pod"]) == ("detected", "orphaned_chip", "ml/ghost")
    recs = p.ledger.query(kind="audit_divergence")
    assert len(recs) == 1
    assert (recs[0]["reason"], recs[0]["pod"], recs[0]["attrs"]["severity"]) == (
        "orphaned_chip", "ml/ghost", "critical")
    drift["on"] = False
    assert engine.sweep_once() == []
    assert p.metrics.AUDIT_FINDINGS.series() == []  # pruned, not zeroed
    assert [s for s, _ in flight_states(p)] == ["detected", "cleared"]
    assert p.metrics.AUDIT_LAST_CLEAN.get() >= clean_ts


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_severity_escalation_is_a_new_detection(plane, tmp_path):
    p = PLANES[plane]
    p.recorder.enable(service="plugin", dump_dir=str(tmp_path))
    p.ledger.enable(service="plugin")
    sev = {"v": p.audit.WARNING}
    engine = p.audit.AuditEngine("plugin", [p.audit.Invariant(
        "gauge_vs_state", ("a", "b"), "test",
        lambda: [p.audit.Finding.make("gauge_vs_state", sev["v"], "drift", node=NODE)])],
        interval_s=60)
    engine.sweep_once()
    sev["v"] = p.audit.CRITICAL
    engine.sweep_once()
    assert flight_states(p) == [("detected", "warning"), ("detected", "critical"),
                                ("cleared", "warning")]
    assert [f for f in os.listdir(tmp_path) if "audit_critical" in f]


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_new_critical_finding_dumps_the_ring_once(plane, tmp_path):
    """A critical finding's first detection dumps the flight ring to the
    flight dir (``audit_critical``); while it persists no sweep dumps
    again, and a warning never dumps."""
    p = PLANES[plane]
    p.recorder.enable(service="plugin", dump_dir=str(tmp_path))
    p.ledger.enable(service="plugin")
    found = {"v": []}
    engine = p.audit.AuditEngine("plugin", [p.audit.Invariant(
        "orphaned_chip", ("a", "b"), "test", lambda: list(found["v"]))], interval_s=60)
    p.recorder.record("allocate", "lead-up", chips="c0")
    found["v"] = [p.audit.Finding.make("orphaned_chip", p.audit.WARNING, "w", node=NODE)]
    engine.sweep_once()
    assert not os.listdir(tmp_path)
    found["v"] = [p.audit.Finding.make("orphaned_chip", p.audit.CRITICAL, "leak", pod="ml/x",
                                       node=NODE)]
    for _ in range(3):
        engine.sweep_once()
    (dump,) = [f for f in os.listdir(tmp_path) if "audit_critical" in f]
    doc = json.load(open(tmp_path / dump))
    assert doc["reason"] == "audit_critical" and doc["service"] == "plugin"
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds[0] == "allocate" and "audit_divergence" in kinds


def _nest(a, b):
    with a:
        with b:
            pass


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_lock_order_goes_critical_on_a_seeded_cycle(plane, monkeypatch, tmp_path):
    """Two TimedLocks nested in opposite orders on a private graph: the
    lock_order invariant reports one CRITICAL finding naming both locks,
    and the engine's sweep dumps the ring for it."""
    p = PLANES[plane]
    prof = jax_profiling if plane == "jax" else profiling
    g = prof.LockdepGraph().enable()
    a = prof.TimedLock("lock_a", lockdep=g)
    b = prof.TimedLock("lock_b", lockdep=g)
    for pair in ((a, b), (b, a)):
        t = threading.Thread(target=_nest, args=pair)
        t.start()
        t.join()
    monkeypatch.setattr(prof, "LOCKDEP", g)
    (f,) = p.audit.check_lock_order()
    assert (f.invariant, f.severity) == ("lock_order", p.audit.CRITICAL)
    assert "lock_a@" in f.message and "lock_b@" in f.message
    assert int(dict(f.details)["witnesses"]) == 2
    p.recorder.enable(service="plugin", dump_dir=str(tmp_path))
    engine = p.audit.AuditEngine("plugin", [p.audit.lock_order_invariant()], interval_s=60)
    assert [x.invariant for x in engine.sweep_once()] == ["lock_order"]
    assert [x for x in os.listdir(tmp_path) if "audit_critical" in x]
    assert p.metrics.AUDIT_FINDINGS.get(invariant="lock_order", severity="critical") == 1


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_lock_order_clean_without_cycles(plane, monkeypatch):
    prof = jax_profiling if plane == "jax" else profiling
    monkeypatch.setattr(prof, "LOCKDEP", prof.LockdepGraph().enable())
    assert PLANES[plane].audit.check_lock_order() == []


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_engine_isolates_raising_invariant(plane):
    p = PLANES[plane]

    def boom():
        raise RuntimeError("plane unavailable")

    engine = p.audit.AuditEngine("plugin", [
        p.audit.Invariant("broken", ("x",), "raises", boom),
        p.audit.Invariant("fine", ("y",), "works",
                          lambda: [p.audit.Finding.make("fine", p.audit.WARNING, "drift")]),
    ], interval_s=60)
    before = p.metrics.AUDIT_SWEEPS.get(outcome="error")
    assert names(engine.sweep_once()) == {"fine"}  # the others still ran
    assert p.metrics.AUDIT_SWEEPS.get(outcome="error") == before + 1
    errors = engine.snapshot()["errors"]
    assert "broken" in errors and "RuntimeError" in errors["broken"]


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_build_info_gauge_and_helper(plane):
    p = PLANES[plane]
    p.metrics.set_build_info("plugin")
    text = p.metrics.REGISTRY.render()
    assert 'component="plugin"' in text and "tpu_build_info{" in text
    info = p.metrics.build_info()
    assert f'version="{info["version"]}"' in text and info["python"]
    snap = p.audit.debug_snapshot()
    assert snap["enabled"] is False and snap["build"]["version"] == info["version"]


# -- the node invariants, end to end ------------------------------------------

@pytest.fixture(params=["jax", "torch"])
def node_stack(request, tmp_path):
    """A plugin, controller, fake API server and fake PodResources on one
    plane, with one reconciled pod holding two cards: the clean baseline
    every corruption below starts from."""
    plane = planes.make_plane(request.param, tmp_path,
                              lambda: request.getfixturevalue("fake"))
    p = PLANES[request.param]
    plugin = plane.make_plugin()
    api = FakeApiServer()
    client = plane.KubeClient(api.start())
    api.add_node(NODE)
    podres = FakePodResources(str(tmp_path / "podres" / "kubelet.sock"))
    podres.start()
    checkpoint_path = str(tmp_path / "kubelet_internal_checkpoint")
    controller = plane.Controller(client, plugin, node_name=NODE,
                                  checkpoint_path=checkpoint_path,
                                  podresources_socket=podres.socket_path)
    ids = plane.ids(plugin)
    want = ids[:2]
    podres.set_pod("ml", "w0", plane.resource, want)
    pod = {
        "metadata": {"name": "w0", "namespace": "ml", "uid": "uid-w0",
                     "annotations": {plane.constants.POD_DEVICES_ANNOTATION: ",".join(want)}},
        "spec": {"nodeName": NODE, "containers": [
            {"name": "main", "resources": {"requests": {plane.resource: "2"}}}]},
        "status": {"phase": "Running"},
    }
    api.add_pod(pod)
    controller._handle_update(client.get_pod("ml", "w0"))
    node_audit = p.audit.NodeAudit(plugin, controller=controller, client=client,
                                   node_name=NODE, checkpoint_path=checkpoint_path,
                                   podres=controller.podres, resource_name=plane.resource)
    try:
        yield types.SimpleNamespace(
            name=request.param, p=p, plane=plane, api=api, client=client, podres=podres,
            plugin=plugin, controller=controller, ids=ids, engine=node_audit.engine(60),
            pod=pod, want=want, checkpoint_path=checkpoint_path)
    finally:
        controller.podres.close()
        podres.stop()
        planes.stop_in_background(api)
        plane.close()


def test_e2e_clean_cluster_zero_findings_across_two_sweeps(node_stack):
    s = node_stack
    assert s.engine.sweep_once() == []
    assert s.engine.sweep_once() == []
    assert s.p.metrics.AUDIT_FINDINGS.series() == []
    snap = s.engine.snapshot()
    assert snap["errors"] == {}
    invariants = {i["name"] for i in snap["invariants"]}
    assert invariants == NODE_INVARIANTS


def test_e2e_stale_annotation_fires_and_clears(node_stack):
    s = node_stack
    key = s.plane.constants.POD_DEVICES_ANNOTATION
    assert s.engine.sweep_once() == []
    good = s.pod["metadata"]["annotations"][key]
    s.pod["metadata"]["annotations"][key] = s.want[0]  # one card dropped
    s.api.update_pod(s.pod)
    findings = s.engine.sweep_once()
    assert names(findings) == {"annotation_vs_kubelet"}
    (f,) = findings
    assert f.pod == "ml/w0" and f.severity == s.p.audit.WARNING
    assert s.want[1] in dict(f.details)["kubelet"]
    assert s.p.metrics.AUDIT_FINDINGS.get(invariant="annotation_vs_kubelet",
                                          severity="warning") == 1
    # An id no generation of the node knows is the same drift.
    s.pod["metadata"]["annotations"][key] = f"{good},ghost-generation"
    s.api.update_pod(s.pod)
    findings = s.engine.sweep_once()
    assert names(findings) == {"annotation_vs_kubelet"}
    assert "ghost-generation" in dict(findings[0].details)["annotation"]
    s.pod["metadata"]["annotations"][key] = good
    s.api.update_pod(s.pod)
    assert s.engine.sweep_once() == []
    assert s.p.metrics.AUDIT_FINDINGS.series() == []


def test_e2e_orphaned_chip_fires_and_clears(node_stack):
    s = node_stack
    s.p.recorder.enable(service="plugin")
    s.p.ledger.enable(service="plugin")
    assert s.engine.sweep_once() == []
    # The kubelet holds a card for a pod the API server never heard of.
    s.podres.set_pod("ml", "ghost", s.plane.resource, [s.ids[3]])
    findings = s.engine.sweep_once()
    assert names(findings) == {"orphaned_chip"}
    (f,) = findings
    assert (f.severity, f.pod) == (s.p.audit.CRITICAL, "ml/ghost")
    assert s.ids[3] in dict(f.details)["chips"]
    assert s.p.ledger.query(kind="audit_divergence")[0]["reason"] == "orphaned_chip"
    assert [st for st, _ in flight_states(s.p)] == ["detected"]
    s.podres.set_pod("ml", "ghost", s.plane.resource, [])
    assert s.engine.sweep_once() == []


def test_e2e_attribution_drift_fires_and_clears(node_stack):
    s = node_stack
    assert s.engine.sweep_once() == []
    # A card attributed to a pod the kubelet never assigned it to.
    s.controller._record_attribution({"namespace": "ml", "name": "phantom"}, [s.ids[1]])
    findings = s.engine.sweep_once()
    assert names(findings) == {"attribution_vs_kubelet"}
    (f,) = findings
    assert (f.chip, f.pod, dict(f.details)["kubelet_pod"]) == (s.ids[1], "ml/phantom", "ml/w0")
    # A card attributed while the kubelet holds it for nobody.
    s.controller._record_attribution({"namespace": "ml", "name": "w0"}, [s.ids[1]],
                                     {s.ids[1]: "main"})
    s.controller._record_attribution({"namespace": "ml", "name": "gone"}, [s.ids[2]])
    findings = s.engine.sweep_once()
    assert names(findings) == {"attribution_vs_kubelet"}
    assert findings[0].chip == s.ids[2] and "unassigned" in findings[0].message
    s.controller._drop_attribution([s.ids[2]])
    assert s.engine.sweep_once() == []


def test_e2e_skewed_gauge_fires_and_clears(node_stack):
    s = node_stack
    assert s.engine.sweep_once() == []
    s.p.metrics.CHIPS.set(99, state="available")
    findings = s.engine.sweep_once()
    assert names(findings) == {"gauge_vs_state"}
    (f,) = findings
    assert (dict(f.details)["state"], dict(f.details)["expected"]) == ("available", "4")
    s.plugin._update_chip_gauges()
    assert s.engine.sweep_once() == []
    s.p.metrics.CHIPS.set(0, state="unhealthy")  # a lingering zero series
    findings = s.engine.sweep_once()
    assert names(findings) == {"gauge_vs_state"}
    assert "stale series" in findings[0].message
    s.plugin._update_chip_gauges()
    assert s.engine.sweep_once() == []


def test_e2e_checkpoint_podresources_divergence(node_stack):
    s = node_stack
    assert s.engine.sweep_once() == []
    with open(s.checkpoint_path, "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [{
            "PodUID": "uid-w0", "ContainerName": "main", "ResourceName": s.plane.resource,
            "DeviceIDs": [s.ids[0], s.ids[2]]}]}}, f)
    findings = s.engine.sweep_once()
    assert names(findings) == {"checkpoint_vs_podresources"}
    details = [dict(f.details) for f in findings]
    assert any(s.ids[1] in d.get("only_in_podresources", "") for d in details)
    assert any(s.ids[2] in d.get("only_in_checkpoint", "") for d in details)
    os.unlink(s.checkpoint_path)
    assert s.engine.sweep_once() == []


def test_node_audit_without_apiserver_skips_not_errors(node_stack):
    s = node_stack
    engine = s.p.audit.NodeAudit(
        s.plugin, controller=s.controller, client=None, node_name=NODE,
        checkpoint_path=s.checkpoint_path, podres=s.controller.podres,
        resource_name=s.plane.resource).engine(interval_s=60)
    assert engine.sweep_once() == []
    assert engine.snapshot()["errors"] == {}


def test_node_audit_apiserver_down_is_a_sweep_error(node_stack):
    s = node_stack

    class DownClient:
        def list_pods(self, **kw):
            raise OSError("connection refused")

    engine = s.p.audit.NodeAudit(
        s.plugin, controller=s.controller, client=DownClient(), node_name=NODE,
        checkpoint_path=s.checkpoint_path, podres=s.controller.podres,
        resource_name=s.plane.resource).engine(interval_s=60)
    engine.sweep_once()
    errors = engine.snapshot()["errors"]
    assert "annotation_vs_kubelet" in errors and "orphaned_chip" in errors
    assert "gauge_vs_state" not in errors  # the local planes are still audited


# -- the tracker ----------------------------------------------------------------

@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_degraded_consistency_over_the_tracker(plane):
    """A mutation that lands inside a breaker-open window is a CRITICAL
    finding naming its verb; the wrapper itself never lands one, since an
    open breaker fails the call before it is made."""
    p = PLANES[plane]
    tracker = p.resilience.TRACKER
    tracker.reset()
    try:
        assert p.audit.check_degraded_consistency() == []
        tracker.record_mutation("PATCH")  # before any window: fine
        tracker.record_circuit(p.resilience.OPEN)
        res = p.resilience.Resilience(
            breaker=p.resilience.CircuitBreaker(failure_threshold=1, reset_timeout_s=3600),
            sleep=lambda s: None)
        res.breaker.record_failure()
        with pytest.raises(p.resilience.CircuitOpenError):
            res.call(lambda: {}, verb="PATCH", mutating=True)
        assert p.audit.check_degraded_consistency() == []
        tracker.record_mutation("POST")  # a write that bypassed the wrapper
        (f,) = p.audit.check_degraded_consistency()
        assert (f.invariant, f.severity, f.chip, dict(f.details)["count"]) == (
            "degraded_consistency", "critical", "POST", "1")
        snap = tracker.snapshot()
        assert snap["breaker_open"] and snap["mutations_while_open"] == 1
        assert snap["call_outcomes"]["PATCH"] == {"circuit_open": 1}
        tracker.record_circuit(p.resilience.CLOSED)
        res = p.resilience.Resilience(sleep=lambda s: None)
        assert res.call(lambda: {"ok": 1}, verb="PATCH", mutating=True) == {"ok": 1}
        # The evidence never shrinks: the finding stands until restart.
        assert names(p.audit.check_degraded_consistency()) == {"degraded_consistency"}
    finally:
        tracker.reset()


def test_each_generation_detaches_its_degraded_mode_on_sighup(tmp_path, fake):
    """The daemon builds a DegradedMode for each generation's kube client;
    each teardown detaches it, so after three SIGHUPs the tracker holds the
    one live generation's mode, and none after SIGTERM."""
    resilience.TRACKER.reset()
    api = FakeApiServer()
    url = api.start()
    api.add_node(NODE)
    kubeconfig = tmp_path / "kc.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "cl", "user": "u"}}],
        "clusters": [{"name": "cl", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    dp_dir = tmp_path / "dp"
    dp_dir.mkdir()
    kubelet = FakeKubelet(str(dp_dir))
    kubelet.start()
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 2)
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(dp_dir), sysfs_pci_dir=str(tmp_path / "sys"),
        dev_dir=str(tmp_path / "dev"), nvml_library=fake.path, node_name=NODE,
        kubeconfig=str(kubeconfig), podresources_socket="", audit_interval_s=0.2))
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        seen = []
        for _ in range(3):
            assert kubelet.registered.wait(WAIT_S)
            kubelet.registered.clear()
            wait_for(lambda: daemon.controller is not None and daemon.auditor is not None)
            assert len(resilience.TRACKER.snapshot()["degraded"]) == 1
            mode = daemon._kube_client.resilience.degraded
            assert all(mode is not m for m in seen)  # a new generation, a new mode
            seen.append(mode)
            assert audit.ENGINE is daemon.auditor
            daemon.events.put(("signal", signal.SIGHUP))
        assert kubelet.registered.wait(WAIT_S)
    finally:
        daemon.events.put(("signal", signal.SIGTERM))
        t.join(timeout=WAIT_S)
        kubelet.stop()
        planes.stop_in_background(api)
    assert not t.is_alive()
    assert resilience.TRACKER.snapshot()["degraded"] == []
    assert audit.ENGINE is None
    assert not [th for th in threading.enumerate() if th.name == "tpu-audit" and th.is_alive()]
    resilience.TRACKER.reset()


def test_supervisor_flag_and_auditor_lifecycle(tmp_path, fake):
    assert main.parse_args(["--audit-interval-s", "45"]).audit_interval_s == 45.0
    assert main.parse_args([]).audit_interval_s == 0.0  # off by default
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 2)
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(tmp_path), sysfs_pci_dir=str(tmp_path / "sys"),
        dev_dir=str(tmp_path / "dev"), nvml_library=fake.path, enable_controller=False,
        audit_interval_s=60.0))
    chips = daemon.discover()
    daemon.plugin = GpuDevicePlugin(LinkTopology(chips, daemon.backend),
                                    config=PluginConfig(device_plugin_dir=str(tmp_path)))
    daemon._start_audit()
    try:
        assert daemon.auditor is not None and audit.ENGINE is daemon.auditor
        assert metrics.BUILD_INFO.series()  # published at the daemon's construction
        wait_for(lambda: daemon.auditor.snapshot()["sweeps"] >= 1)
        assert daemon.auditor.snapshot()["findings"] == []
    finally:
        daemon.plugin = None
        daemon.teardown()
    assert daemon.auditor is None and audit.ENGINE is None
    daemon.cfg.audit_interval_s = 0.0  # 0 is no auditor at all
    daemon._start_audit()
    assert daemon.auditor is None
    daemon.backend.close()
