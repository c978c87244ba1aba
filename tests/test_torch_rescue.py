"""The port's hardware-failure rescue and node drain (extender/rescue.py)
against the JAX ones.

The tests of the JAX ``tests/test_rescue.py`` are parametrised over the two
planes of tests/torch_extender_planes.py: ``jax`` (v5p hosts of 4 chips)
and ``torch`` (4-card H100 hosts of the fake NVML), each against its own
fake API server. Card i stands for chip i; a withdrawn card is moved from
``available`` to ``failed`` in the plane's own topology annotation, as the
daemon republishes a health withdrawal. The cases: a card withdrawn under a
running gang rescued through a lower-priority victim, never an equal or
higher one, a cordon that excludes placement and never evacuates, a NotReady
node evacuated, a spent budget parking the gang, ``rescue_vs_health`` firing
on a lost episode, the SIGKILL kill-points (in the middle of the evictions,
between the evictions and the fence, in the middle of a drain), the drain end
to end and its HTTP verb with the doctor's driver.

Port only: the entry point wires the plane, singleton and sharded: its node
cache feeds the tracker, and ``tpu-doctor drain`` evacuates a running gang
off a node through ``/drain`` and uncordons it; a node's changed annotation
wakes the running gangs bound to it (JAX waits for the full sweep); the
auditor reads a rescued gang's pod-less fence and its gated replacements as
the plan (JAX warns until they release); and the module's ``--self-test``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import requests

from k8s_device_plugin_tpu.tools import doctor as jax_doctor
from k8s_device_plugin_tpu_torch.extender.sharding import ShardRing
from k8s_device_plugin_tpu_torch.tools import doctor
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.test_torch_chaos_journal import KillPointClient, SigKill
from tests.torch_extender_planes import (
    JaxPlane,
    TorchPlane,
    gang_pod,
    gates_of,
    port_lockdep_acyclic,  # noqa: F401 - the autouse lockdep gate
    read_layouts,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCTOR = {"jax": jax_doctor, "torch": doctor}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("rescue_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


@pytest.fixture
def api(plane):
    s = FakeApiServer()
    url = s.start()
    yield s, plane.KubeClient(url)
    s.stop()


def running_gang_pod(plane, name, gang, size, cards, node, priority=None, ckpt_ts=None):
    """A placed, running, ungated gang member."""
    p = gang_pod(plane, name, gang, size, cards)
    p["spec"]["schedulingGates"] = []
    p["spec"]["nodeName"] = node
    p["metadata"]["uid"] = f"uid-{name}"
    if priority is not None:
        p["spec"]["priority"] = priority
    if ckpt_ts is not None:
        p["metadata"]["annotations"] = {
            plane.constants.CHECKPOINT_TS_ANNOTATION: str(ckpt_ts)}
    return p


def fail_card(plane, server, node, index):
    """The daemon's republish after a health withdrawal of card ``index``."""
    server.fail_chips(node, [plane.ids[index]], annotation=plane.constants.TOPOLOGY_ANNOTATION)


def build(plane, client, tmp_path, tracker=None, **engine_kw):
    """A journaled admitter with the rescue plane wired as the entry point
    wires it (the preemption resolver shared, grace 1 for one-tick tests)."""
    table = plane.reservations.ReservationTable()
    journal = plane.journal.AdmissionJournal(str(tmp_path / "journal"))
    table.observer = journal.observe
    adm = plane.gang.GangAdmission(client, reservations=table, journal=journal)
    resolver = plane.preemption.PriorityResolver(client)
    adm.priority_resolver = resolver
    adm.preemption = plane.preemption.PreemptionEngine(adm, resolver)
    engine_kw.setdefault("grace_ticks", 1)
    engine = plane.rescue.RescueEngine(adm, resolver, tracker=tracker, **engine_kw)
    adm.rescue = engine
    return adm, table, engine


def two_node_cluster(plane, server, victim_priority=-10):
    """train (priority 0, two pods of 2 cards) fills n1; a cheap victim gang
    fills n2: any rescue of train goes through n2's resident."""
    server.add_node("n1", plane.node("n1", []))
    server.add_node("n2", plane.node("n2", []))
    now = time.time()
    for i in range(2):
        server.add_pod(running_gang_pod(plane, f"train-w{i}", "train", 2, 2, "n1", priority=0))
    for i in range(2):
        server.add_pod(running_gang_pod(plane, f"batch-w{i}", "batch", 2, 2, "n2",
                                        priority=victim_priority, ckpt_ts=now - 5))


def audit_clean(plane, adm, table):
    eng = plane.audit.ExtenderAudit(reservations=table, journal=adm.journal, gang=adm).engine()
    assert "rescue_vs_health" in {i.name for i in eng.invariants}
    findings = eng.sweep_once()
    crit = [f for f in findings if f.severity == plane.audit.CRITICAL]
    assert crit == [], crit
    return findings


# ---------------------------------------------------------------------------
# detection and execution
# ---------------------------------------------------------------------------


def test_chip_withdrawal_rescues_through_lower_priority_victim(plane, api, tmp_path):
    """A card withdrawn under running train is found by the count proof,
    the strictly lower-priority resident of the only healthy node is
    evicted, train's own pods are evacuated, the freed node is fenced under
    train's key, and the gated replacements release against the standing
    hold."""
    server, client = api
    two_node_cluster(plane, server)
    adm, table, engine = build(plane, client, tmp_path)
    assert adm.tick() == []
    assert server.evictions == []
    assert engine.degraded_state() == {}
    fail_card(plane, server, "n1", 0)
    assert adm.tick() == []
    # Four pods left through the eviction door: the two victims and train's.
    assert len(server.evictions) == 4
    hold = table.active()[("default", "train")]
    assert hold.hosts == {"n2": 4}
    assert hold.priority == 0
    assert engine.open_intents() == {}
    assert engine.last_outcome == "executed"
    audit_clean(plane, adm, table)
    for i in range(2):
        server.add_pod(gang_pod(plane, f"train-r{i}", "train", 2, 2))
    assert adm.tick() == [("default", "train")]
    assert plane.gang.GATE_NAME not in gates_of(server, "default", "train-r0")
    assert table.reserved_chips("n2") == 4
    audit_clean(plane, adm, table)
    adm.journal.close()


def test_rescue_never_evicts_equal_or_higher_priority(plane, api, tmp_path):
    """The only possible victim is of the same tier: the rescue parks
    RESCUE_PENDING instead of trading a healthy job for a degraded one."""
    server, client = api
    two_node_cluster(plane, server, victim_priority=0)
    adm, table, engine = build(plane, client, tmp_path)
    fail_card(plane, server, "n1", 0)
    assert adm.tick() == []
    assert server.evictions == []
    assert table.active() == {}
    assert ("default", "train") in engine.pending_state()
    assert engine.tracked(("default", "train"))
    audit_clean(plane, adm, table)
    adm.journal.close()


def test_cordon_excludes_placement_but_never_evacuates(plane, api, tmp_path):
    """kubectl cordon's meaning: an unschedulable node leaves the admission
    targets (a gated gang cannot land there) but its running residents stay
    through any number of ticks."""
    server, client = api
    server.add_node("n1", plane.node("n1", []))
    server.add_node("n2", plane.node("n2"))
    for i in range(2):
        server.add_pod(running_gang_pod(plane, f"train-w{i}", "train", 2, 2, "n1", priority=0))
    tracker = plane.rescue.NodeStateTracker()
    adm, table, engine = build(plane, client, tmp_path, tracker=tracker)
    server.set_node_unschedulable("n2", True)
    tracker.update_node(server.nodes["n2"])
    assert not tracker.placeable("n2")
    assert not tracker.evacuate("n2")
    server.add_pod(gang_pod(plane, "queued-w0", "queued", 1, 4))
    for _ in range(3):
        assert adm.tick() == []
    assert server.evictions == []
    assert engine.degraded_state() == {}
    assert plane.gang.GATE_NAME in gates_of(server, "default", "queued-w0")
    server.set_node_unschedulable("n2", False)
    tracker.update_node(server.nodes["n2"])
    assert adm.tick() == [("default", "queued")]
    audit_clean(plane, adm, table)
    adm.journal.close()


def test_notready_node_evacuates_residents(plane, api, tmp_path):
    """A NotReady node's resident gang is rescued onto free healthy
    capacity, with no victim."""
    server, client = api
    server.add_node("n1", plane.node("n1", []))
    server.add_node("n2", plane.node("n2"))
    for i in range(2):
        server.add_pod(running_gang_pod(plane, f"train-w{i}", "train", 2, 2, "n1", priority=0))
    tracker = plane.rescue.NodeStateTracker()
    adm, table, engine = build(plane, client, tmp_path, tracker=tracker)
    assert adm.tick() == []
    server.set_node_ready("n1", False)
    tracker.update_node(server.nodes["n1"])
    assert tracker.evacuate("n1")
    assert adm.tick() == []
    assert len(server.evictions) == 2  # train's own pods only
    assert table.active()[("default", "train")].hosts == {"n2": 4}
    audit_clean(plane, adm, table)
    adm.journal.close()


def test_budget_exhaustion_parks_rescue_pending(plane, api, tmp_path):
    """A victim plan that would overrun the rolling budget parks the gang
    instead of half-evicting; the episode is tracked, so rescue_vs_health
    stays quiet."""
    server, client = api
    two_node_cluster(plane, server)
    adm, table, engine = build(plane, client, tmp_path, max_evictions_per_hour=1)
    fail_card(plane, server, "n1", 0)
    assert adm.tick() == []
    assert server.evictions == []
    assert table.active() == {}
    assert engine.pending_state()[("default", "train")]["reason"] == "budget_exhausted"
    assert engine.last_outcome == "pending"
    findings = audit_clean(plane, adm, table)
    assert [f for f in findings if f.invariant == "rescue_vs_health"] == []
    adm.journal.close()


def test_rescue_vs_health_invariant_fires_on_lost_episode(plane, api, tmp_path):
    """A degraded episode past the grace window that the engine is not
    moving (no open round, no parking, no completed rescue) is critical: a
    job burning on dead hardware."""
    server, client = api
    two_node_cluster(plane, server)
    adm, table, engine = build(plane, client, tmp_path)
    key = ("default", "train")
    with engine._lock:
        engine._degraded[key] = {"hosts": {"n1": "chip_failed"}, "ticks": 5, "since": 0.0}
    eng = plane.audit.ExtenderAudit(reservations=table, journal=adm.journal, gang=adm).engine()
    crit = [f for f in eng.sweep_once()
            if f.invariant == "rescue_vs_health" and f.severity == plane.audit.CRITICAL]
    assert len(crit) == 1
    assert "burning on failed hardware" in crit[0].message
    with engine._lock:
        engine._pending[key] = {"since": 0.0, "reason": "no_target"}
    assert [f for f in eng.sweep_once() if f.invariant == "rescue_vs_health"] == []
    adm.journal.close()


# ---------------------------------------------------------------------------
# SIGKILL kill-points: each recovers exactly once
# ---------------------------------------------------------------------------


def test_sigkill_mid_evacuation_aborts_then_rescues_once(plane, api, tmp_path):
    """After rescue_intent, one of the two victim pods evicted: recovery
    aborts the intent (nothing fenced, train still running degraded) and
    the next tick plans again from the cluster's truth, each remaining pod
    evicted exactly once."""
    server, client = api
    two_node_cluster(plane, server)
    fail_card(plane, server, "n1", 0)
    adm1, table1, _ = build(plane, KillPointClient(client, "evict_pod", 1), tmp_path)
    with pytest.raises(SigKill):
        adm1.tick()
    assert len(server.evictions) == 1
    assert table1.active() == {}
    adm2, table2, _ = build(plane, client, tmp_path)
    summary = adm2.recover()
    assert (summary["rescue_aborted"], summary["rescue_refenced"]) == (1, 0)
    assert table2.active() == {}
    # The daemon frees the dead victim pod's 2 cards and republishes n2.
    server.add_node("n2", plane.node("n2", [0, 1]))
    assert adm2.tick() == []
    assert len(server.evictions) == 4
    assert len(set(server.evictions)) == 4
    assert table2.active()[("default", "train")].hosts == {"n2": 4}
    audit_clean(plane, adm2, table2)
    adm2.journal.close()


def test_sigkill_between_evict_and_refence_restores_fence(plane, api, tmp_path):
    """After rescue_evicted, before the reserve: the gang's own pods are
    gone, which for every other protocol means "gang vanished, abort". A
    rescue's evicted phase survives that: recovery restores the fence from
    the journaled plan, the shield keeps the pod-less hold, and the gated
    replacements release against it."""
    server, client = api
    two_node_cluster(plane, server)
    fail_card(plane, server, "n1", 0)
    adm1, table1, _ = build(plane, client, tmp_path)

    def die_on_reserve(*a, **kw):
        raise SigKill("between rescue_evicted and reserve")

    table1.reserve = die_on_reserve
    with pytest.raises(SigKill):
        adm1.tick()
    assert len(server.evictions) == 4
    adm2, table2, eng2 = build(plane, client, tmp_path)
    summary = adm2.recover()
    assert (summary["rescue_refenced"], summary["rescue_aborted"]) == (1, 0)
    hold = table2.active()[("default", "train")]
    assert hold.hosts == {"n2": 4}
    assert hold.priority == 0
    assert eng2.shield(("default", "train"))
    assert adm2.tick() == []
    assert ("default", "train") in table2.active()
    for i in range(2):
        server.add_pod(gang_pod(plane, f"train-r{i}", "train", 2, 2))
    assert adm2.tick() == [("default", "train")]
    assert plane.gang.GATE_NAME not in gates_of(server, "default", "train-r0")
    assert table2.reserved_chips("n2") == 4
    assert len(server.evictions) == 4  # recovery evicted nothing again
    audit_clean(plane, adm2, table2)
    adm2.journal.close()


# ---------------------------------------------------------------------------
# the node drain
# ---------------------------------------------------------------------------


def drain_setup(plane, server, client, tmp_path):
    server.add_node("n1", plane.node("n1", []))
    server.add_node("n2", plane.node("n2"))
    for i in range(2):
        server.add_pod(running_gang_pod(plane, f"train-w{i}", "train", 2, 2, "n1", priority=0))
    tracker = plane.rescue.NodeStateTracker()
    adm, table, engine = build(plane, client, tmp_path, tracker=tracker)
    coord = plane.rescue.DrainCoordinator(client, adm, tracker)
    engine.drain_coordinator = coord
    return adm, table, engine, tracker, coord


def test_drain_end_to_end(plane, api, tmp_path):
    """Drain n1: the cordon and the maintenance taint stay in the API
    server, the resident gang is rescued off under the ordinary journal, the
    node ends with no held card and the drain-complete stamp, and placement
    refuses it until the uncordon."""
    server, client = api
    c = plane.constants
    adm, table, engine, tracker, coord = drain_setup(plane, server, client, tmp_path)
    assert adm.tick() == []
    st = coord.drain("n1")
    assert st["draining"] is True
    node = server.nodes["n1"]
    assert node["spec"]["unschedulable"] is True
    taints = {t["key"]: t for t in node["spec"]["taints"]}
    assert taints[c.MAINTENANCE_TAINT]["value"] == c.DRAIN_TAINT_VALUE
    assert tracker.draining("n1")
    assert adm.tick() == []
    assert len(server.evictions) == 2
    assert table.active()[("default", "train")].hosts == {"n2": 4}
    for i in range(2):
        server.add_pod(gang_pod(plane, f"train-r{i}", "train", 2, 2))
    assert adm.tick() == [("default", "train")]
    st = coord.status("n1")
    assert (st["resident_pods"], st["held_chips"], st["done"]) == (0, 0, True)
    assert c.DRAIN_COMPLETE_ANNOTATION in server.nodes["n1"]["metadata"]["annotations"]
    # Placement refuses the drained node: a gated 4-card gang (n2 is now
    # full) stays gated.
    server.add_pod(gang_pod(plane, "queued-w0", "queued", 1, 4))
    assert adm.tick() == []
    assert plane.gang.GATE_NAME in gates_of(server, "default", "queued-w0")
    coord.uncordon("n1")
    node = server.nodes["n1"]
    assert not node["spec"].get("unschedulable")
    assert all(t["key"] != c.MAINTENANCE_TAINT for t in node["spec"].get("taints", []))
    assert c.DRAIN_COMPLETE_ANNOTATION not in node["metadata"]["annotations"]
    # The daemon republishes n1's freed cards after the maintenance.
    server.add_node("n1", plane.node("n1"))
    assert adm.tick() == [("default", "queued")]
    audit_clean(plane, adm, table)
    adm.journal.close()


def test_sigkill_mid_drain_resumes_from_cluster_truth(plane, api, tmp_path):
    """A SIGKILL in the middle of a drain (cordon and taint landed, the
    evacuation died at its first eviction). There is no drain journal: the
    cordon and the taint are the durable intent, and a fresh incarnation
    rebuilds the tracker from the node object and finishes the evacuation
    exactly once."""
    server, client = api
    adm1, _, _, _, coord1 = drain_setup(plane, server, client, tmp_path)
    adm1.client = KillPointClient(client, "evict_pod", 0)
    coord1.drain("n1")
    with pytest.raises(SigKill):
        adm1.tick()
    assert server.evictions == []
    tracker2 = plane.rescue.NodeStateTracker()
    tracker2.update_node(client.get_node("n1"))
    assert tracker2.draining("n1")
    adm2, table2, _ = build(plane, client, tmp_path, tracker=tracker2)
    coord2 = plane.rescue.DrainCoordinator(client, adm2, tracker2)
    summary = adm2.recover()
    assert summary["rescue_aborted"] + summary["rescue_refenced"] <= 1
    assert adm2.tick() == []
    assert len(server.evictions) == 2
    assert len(set(server.evictions)) == 2
    assert table2.active()[("default", "train")].hosts == {"n2": 4}
    for i in range(2):
        server.add_pod(gang_pod(plane, f"train-r{i}", "train", 2, 2))
    assert adm2.tick() == [("default", "train")]
    st = coord2.status("n1")
    assert st["done"] is True and st["held_chips"] == 0
    audit_clean(plane, adm2, table2)
    adm2.journal.close()


def test_drain_http_verb_and_doctor_driver(plane, api, tmp_path):
    """The /drain wire protocol the doctor speaks: 404 with no handler, 400
    without a node, the coordinator's status round trip, and the doctor's
    poll to completion and its uncordon."""
    server, client = api
    adm, table, engine, tracker, coord = drain_setup(plane, server, client, tmp_path)
    srv = plane.server.ExtenderHTTPServer(host="127.0.0.1")
    base = srv.start()
    try:
        r = requests.post(f"{base}/drain", json={"node": "n1"}, timeout=5)
        assert r.status_code == 404

        def drain_verb(node, action):
            if action == "drain":
                return coord.drain(node)
            if action == "uncordon":
                return coord.uncordon(node)
            return coord.status(node)

        srv.drain_handler = drain_verb
        assert requests.post(f"{base}/drain", json={}, timeout=5).status_code == 400
        r = requests.post(f"{base}/drain", json={"node": "n1", "action": "drain"}, timeout=5)
        assert r.status_code == 200
        assert r.json()["draining"] is True
        adm.tick()
        for i in range(2):
            server.add_pod(gang_pod(plane, f"train-r{i}", "train", 2, 2))
        adm.tick()
        tool = DOCTOR[plane.name]
        assert tool.drain(base, "n1", wait=True, poll_s=0.0, timeout_s=5.0) == 0
        assert tool.drain(base, "n1", uncordon=True, wait=False) == 0
        assert not server.nodes["n1"]["spec"].get("unschedulable")
    finally:
        srv.stop()
    adm.journal.close()


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _named(prefix, shard, of):
    return next(f"{prefix}{i}" for i in range(1000) if of(f"{prefix}{i}") == shard)


@pytest.mark.parametrize("mode", ["singleton", "sharded"])
def test_entry_point_drains_through_the_rescue_plane(layouts, tmp_path, mode):
    """``python -m ...extender --gang-admission``: the node cache's tap
    feeds the tracker, /debug/defrag and /debug/rescue show the wired
    engines, and ``tpu-doctor drain`` evacuates a running gang off its node
    (in the home shard when sharded) onto the free one, then uncordons it;
    tpu_node_cordoned reads 1 while cordoned and is gone after."""
    plane = TorchPlane(layouts["grid4"])
    ring = ShardRing(2)
    home = 1
    api = FakeApiServer()
    url = api.start()
    if mode == "sharded":
        busy = _named("busy-", home, ring.shard_of)
        spare = _named("spare-", home, ring.shard_of)
        gang = _named("train-", home, lambda g: ring.gang_shard(("default", g)))
    else:
        busy, spare, gang = "busy", "spare", "train"
    api.add_node(busy, plane.node(busy, []))
    api.add_node(spare, plane.node(spare))
    api.add_pod(running_gang_pod(plane, f"{gang}-w0", gang, 1, 4, busy, priority=0))
    kc = tmp_path / "kc.json"
    kc.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "c", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {}}],
        "contexts": [{"name": "x", "context": {"cluster": "c", "user": "u"}}],
        "current-context": "x"}))
    port = _free_port()
    cmd = [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--host", "127.0.0.1",
           "--port", str(port), "--kubeconfig", str(kc), "--node-cache", "--gang-admission",
           "--gang-resync-s", "0.2", "--gang-full-sweep-s", "0.4", "--rescue-grace-ticks", "1",
           "--journal-dir", str(tmp_path / "j")]
    if mode == "sharded":
        cmd += ["--shards", "2", "--shard-index", str(home)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=5) as r:
            return r.read().decode()

    try:
        deadline = time.time() + 30
        while True:
            try:
                if requests.get(f"{base}/readyz", timeout=2).status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.05)
        defrag_doc, rescue_doc = (json.loads(get(p)) for p in ("/debug/defrag", "/debug/rescue"))
        assert defrag_doc["enabled"] and rescue_doc["enabled"]
        want_shard = home if mode == "sharded" else None
        assert [e["shard"] for e in rescue_doc["engines"]] == [want_shard]
        assert [e["shard"] for e in defrag_doc["engines"]] == [want_shard]
        out = subprocess.run(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.tools.doctor", "drain", busy,
             "--url", base, "--poll-s", "0.2", "--timeout-s", "30"],
            capture_output=True, text=True, timeout=60, cwd=ROOT)
        assert out.returncode == 0, out
        assert f"node {busy} drained" in out.stdout
        assert api.evictions == [("default", f"{gang}-w0")]
        assert api.nodes[busy]["spec"]["unschedulable"] is True
        assert f'tpu_node_cordoned{{node="{busy}"}} 1' in get("/metrics")
        holds = json.loads(get("/reservations"))["holds"]
        assert [(h["gang"], h["hosts"]) for h in holds] == [(gang, {spare: 4})]
        out = subprocess.run(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.tools.doctor", "drain", busy,
             "--uncordon", "--url", base], capture_output=True, text=True, timeout=60, cwd=ROOT)
        assert out.returncode == 0, out
        assert not api.nodes[busy]["spec"]["unschedulable"]
        assert f'tpu_node_cordoned{{node="{busy}"}}' not in get("/metrics")
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        api.stop()
    assert rc == 0


def test_a_withdrawn_card_wakes_the_gangs_bound_to_its_node(layouts, tmp_path):
    """The node cache's change of a node's annotation marks the released
    gangs bound there dirty when the rescue plane is wired, so a card's
    withdrawal is evaluated at the next resync, not at the full-sweep
    backstop; without the plane nothing but the waiting gangs wakes."""
    plane = TorchPlane(layouts["grid4"])
    server = FakeApiServer()
    client = plane.KubeClient(server.start())
    try:
        two_node_cluster(plane, server)
        plain = plane.gang.GangAdmission(client,
                                         reservations=plane.reservations.ReservationTable())
        assert plain.tick() == []
        assert plain.note_node_event((), node="n1") == 0
        adm, table, engine = build(plane, client, tmp_path)
        assert adm.tick() == []  # the full sweep maps n1 to train, n2 to batch
        fail_card(plane, server, "n1", 0)
        assert adm.tick(full=False) == [] and server.evictions == []  # nothing marked
        assert adm.note_node_event((), node="n1") == 1
        assert adm.tick(full=False) == []
        assert len(server.evictions) == 4
        assert table.active()[("default", "train")].hosts == {"n2": 4}
        adm.journal.close()
    finally:
        server.stop()


def test_a_rescue_fence_reads_as_the_plan_to_the_port_audit(plane, api, tmp_path):
    """Between the evacuation and the replacements' release the rescued
    gang has no pod, then only gated ones, under its fence. The port's
    auditor reads both as the plan (the upkeep's own shield rule); the JAX
    auditor warns (``reservation_vs_cluster``, then ``gate_vs_hold``)."""
    server, client = api
    two_node_cluster(plane, server)
    adm, table, engine = build(plane, client, tmp_path)
    fail_card(plane, server, "n1", 0)
    assert adm.tick() == []
    eng = plane.audit.ExtenderAudit(reservations=table, journal=adm.journal, gang=adm).engine()
    warned = {"jax": {"reservation_vs_cluster"}, "torch": set()}[plane.name]
    assert {f.invariant for f in eng.sweep_once()} == warned
    for i in range(2):
        server.add_pod(gang_pod(plane, f"train-r{i}", "train", 2, 2))
    warned = {"jax": {"gate_vs_hold"}, "torch": set()}[plane.name]
    assert {f.invariant for f in eng.sweep_once()} == warned
    assert adm.tick() == [("default", "train")]
    assert eng.sweep_once() == []
    adm.journal.close()


def test_self_test_runs(capsys):
    from k8s_device_plugin_tpu_torch.extender import rescue

    assert rescue.main(["--self-test"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict == {"rescue_self_test": "ok", "evacuated": ["batch", "train"],
                       "fenced": {"n2": 4}, "waiter_still_gated": True,
                       "budget_remaining": 10}
