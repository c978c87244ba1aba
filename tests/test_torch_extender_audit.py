"""The port's extender auditor (audit.ExtenderAudit) against the JAX one.

The extender cases of the JAX ``tests/test_audit.py`` that hold on the
port's planes, parametrised over the two planes of
tests/torch_extender_planes.py: a clean sweep and a leaked hold, a hold on a
vanished node, a table the journal would not rehydrate, the gates against
the holds (an undrained lapse included), the defrag plane's open
``defrag_evicted`` phase against the fences, and the admission loop driving
the sweeps, and the placeable recount over the index's aggregate (a seeded
corrupt gauge, corrupt counts and a corrupt entry tuple each found, a clean
index found clean, an index that keeps no aggregate never recounted). The port's set is the three invariants of the gang
plane, ``placeable_recount`` with the index, and the shared four;
``defrag_vs_reservations`` joins them where a defrag engine is wired (the
JAX plane registers it with any journal).
"""

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import requests

from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.torch_extender_planes import (
    JaxPlane,
    TorchPlane,
    gang_pod,
    port_lockdep_acyclic,  # noqa: F401 - the autouse lockdep gate
    read_layouts,
)

PORT_INVARIANTS = {"reservation_vs_journal", "reservation_vs_cluster", "gate_vs_hold",
                   "placeable_recount", "thread_liveness", "lock_order",
                   "loop_inventory", "degraded_consistency"}
JAX_ONLY = {"defrag_vs_reservations"}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ext_audit_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


@pytest.fixture
def stack(plane, tmp_path):
    """The JAX ``extender_stack``: a fake API server, a table journaled to
    disk, an index of two nodes feeding an admitter, and its auditor. The
    resilience layer's process-global record starts empty: a breaker window
    another file's chaos case left in this worker is not this stack's."""
    importlib.import_module(
        plane.metrics.__name__.rsplit(".", 1)[0] + ".resilience").TRACKER.reset()
    # The placeable gauge is process-global: series another file's index
    # left in this worker are not this index's.
    plane.metrics.EXT_PLACEABLE_NODES.remove_matching()
    api = FakeApiServer()
    client = plane.KubeClient(api.start())
    reservations = plane.reservations.ReservationTable()
    journal = plane.journal.AdmissionJournal(str(tmp_path / "journal"))
    index = plane.index.TopologyIndex()
    for name in ("node-a", "node-b"):
        index.update(name, plane.raw(name))
    gang = plane.gang.GangAdmission(client, reservations=reservations, journal=journal,
                                    topo_source=index.topologies)
    ext_audit = plane.audit.ExtenderAudit(reservations=reservations, journal=journal,
                                          gang=gang, index=index)

    def add_gang_pod(gang_name, name, gated=False, node=""):
        p = gang_pod(plane, name, gang_name, 2, 2)
        if not gated:
            p["spec"]["schedulingGates"] = []
        if node:
            p["spec"]["nodeName"] = node
        api.add_pod(p)

    yield {"api": api, "reservations": reservations, "journal": journal, "gang": gang,
           "index": index,
           "engine": ext_audit.engine(interval_s=60), "add_gang_pod": add_gang_pod}
    journal.close()
    api.stop()


def names(findings) -> set:
    return {f.invariant for f in findings}


def test_extender_clean_and_leaked_reservation(plane, stack):
    engine = stack["engine"]
    assert engine.sweep_once() == []
    got = {i["name"] for i in engine.snapshot()["invariants"]}
    assert got == (PORT_INVARIANTS | JAX_ONLY if plane.name == "jax" else PORT_INVARIANTS)
    stack["reservations"].reserve(("default", "ghost-gang"), {"node-a": 2}, demands=(2,))
    findings = engine.sweep_once()
    assert names(findings) == {"reservation_vs_cluster"}
    assert findings[0].gang == "default/ghost-gang"
    stack["reservations"].drop(("default", "ghost-gang"))
    assert engine.sweep_once() == []


def test_extender_reservation_on_vanished_node(stack):
    engine = stack["engine"]
    stack["add_gang_pod"]("train", "train-w0", node="node-a")
    stack["add_gang_pod"]("train", "train-w1", node="node-a")
    stack["reservations"].reserve(("default", "train"), {"node-gone": 2}, demands=(2,))
    findings = engine.sweep_once()
    assert names(findings) == {"reservation_vs_cluster"}
    assert findings[0].node == "node-gone"
    stack["reservations"].drop(("default", "train"))
    assert engine.sweep_once() == []


def test_extender_journal_divergence_fires_critical(plane, stack):
    engine = stack["engine"]
    stack["add_gang_pod"]("train", "train-w0", node="node-a")
    stack["add_gang_pod"]("train", "train-w1", node="node-a")
    # The observer detached: the table moves and the journal never hears.
    stack["reservations"].observer = None
    stack["reservations"].reserve(("default", "train"), {"node-a": 4}, demands=(2, 2))
    findings = engine.sweep_once()
    assert names(findings) == {"reservation_vs_journal"}
    assert findings[0].severity == plane.audit.CRITICAL
    assert findings[0].gang == "default/train"
    stack["reservations"].observer = stack["journal"].observe
    stack["reservations"].reserve(("default", "train"), {"node-a": 4}, demands=(2, 2))
    assert engine.sweep_once() == []
    # A hold only the journal has is conservative: a warning.
    stack["reservations"].observer = None
    stack["reservations"].drop(("default", "train"))
    findings = engine.sweep_once()
    assert names(findings) == {"reservation_vs_journal"}
    assert findings[0].severity == plane.audit.WARNING
    stack["reservations"].observer = stack["journal"].observe


def test_extender_defrag_vs_reservations(plane, stack):
    """An open defrag_evicted phase with no standing fence is critical (the
    victims are gone and nothing protects the freed cards), a fence that no
    longer covers the plan is a warning, and a closed round or an open
    intent is clean."""
    gang = stack["gang"]
    gang.defrag = plane.defrag.DefragEngine(gang, plane.preemption.PriorityResolver())
    engine = plane.audit.ExtenderAudit(reservations=stack["reservations"],
                                       journal=stack["journal"], gang=gang).engine()
    key = ("default", "stranded")
    # The gang exists and is placed, so the cluster and gate invariants stay
    # quiet and the defrag plane's is alone.
    stack["add_gang_pod"]("stranded", "stranded-w0", node="node-a")
    stack["add_gang_pod"]("stranded", "stranded-w1", node="node-a")
    stack["journal"].record("defrag_evicted", key, victims=[["default", "frag"]],
                            consumed={"node-a": 4}, demands=[2, 2])
    findings = engine.sweep_once()
    assert names(findings) == {"defrag_vs_reservations"}
    (f,) = findings
    assert f.severity == plane.audit.CRITICAL
    assert f.gang == "default/stranded"
    # The fence lands (the round's reserve): protected though still open.
    stack["reservations"].reserve(key, {"node-a": 4}, demands=(2, 2))
    assert engine.sweep_once() == []
    # A fence that no longer covers the plan: drift, a warning.
    stack["reservations"].drop(key)
    stack["reservations"].reserve(key, {"node-a": 2}, demands=(2, 2))
    findings = engine.sweep_once()
    assert names(findings) == {"defrag_vs_reservations"}
    assert findings[0].severity == plane.audit.WARNING
    # The round closed, then a fresh intent: never a finding.
    stack["reservations"].drop(key)
    stack["journal"].record("defrag_done", key)
    stack["journal"].record("defrag_intent", key, victims=[["default", "frag"]],
                            consumed={"node-a": 4}, demands=[2, 2])
    assert engine.sweep_once() == []


def test_extender_gate_vs_hold(plane, stack):
    engine = stack["engine"]
    stack["add_gang_pod"]("naked", "naked-w0")
    stack["add_gang_pod"]("naked", "naked-w1")
    findings = engine.sweep_once()
    assert names(findings) == {"gate_vs_hold"}
    (f,) = findings
    assert f.severity == plane.audit.CRITICAL
    assert f.gang == "default/naked"
    assert "naked-w0" in dict(f.details)["pods"]
    stack["gang"]._lapsed_gangs.add(("default", "naked"))  # a lapse bar clears it
    assert engine.sweep_once() == []
    stack["add_gang_pod"]("stuck", "stuck-w0", gated=True)
    stack["add_gang_pod"]("stuck", "stuck-w1", gated=True)
    stack["reservations"].reserve(("default", "stuck"), {"node-b": 4}, demands=(2, 2))
    findings = engine.sweep_once()
    assert names(findings) == {"gate_vs_hold"}
    assert findings[0].severity == plane.audit.WARNING
    assert findings[0].gang == "default/stuck"


def test_gate_vs_hold_respects_undrained_lapse(stack):
    stack["add_gang_pod"]("naked", "naked-w0")
    stack["add_gang_pod"]("naked", "naked-w1")
    stack["reservations"].reserve(("default", "naked"), {"node-a": 4}, demands=(2, 2))
    stack["reservations"].lapse(("default", "naked"))
    assert ("default", "naked") not in stack["gang"]._lapsed_gangs
    assert stack["engine"].sweep_once() == []


def test_gang_loop_drives_maybe_sweep(stack):
    gang = stack["gang"]
    gang.auditor = stack["engine"]
    gang.resync_interval_s = 0.05
    gang.start()
    try:
        deadline = time.time() + 5
        while stack["engine"].snapshot()["sweeps"] == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert stack["engine"].snapshot()["sweeps"] >= 1
    finally:
        gang.stop()


def test_extender_sweeps_export_on_the_extender_registry(plane, stack):
    """The extender's sweeps count on its own registry, under the JAX
    family names."""
    fam = plane.metrics.EXT_AUDIT_SWEEPS
    before = fam.get(outcome="clean")
    assert stack["engine"].sweep_once() == []
    assert fam.get(outcome="clean") == before + 1
    assert "tpu_audit_sweeps_total" in plane.metrics.EXTENDER_REGISTRY.render()


def test_an_audit_of_no_plane_has_no_invariant(plane):
    """The JAX rule: with nothing wired the audit holds no invariant at all,
    so the entry point refuses to sweep nothing clean."""
    assert plane.audit.ExtenderAudit().invariants() == []


def test_extender_placeable_recount(plane, stack):
    """The JAX case, with each corruption seeded on its own: a gauge that
    drifted, incremental counts that drifted, and a cached entry tuple the
    from-scratch derivation disagrees with. Each is found, and restoring it
    reads clean."""
    engine, index = stack["engine"], stack["index"]
    gauge = plane.metrics.EXT_PLACEABLE_NODES
    assert engine.sweep_once() == []
    top = str(plane.chip_count)
    assert gauge.get(size=top) == 2
    # A seeded gauge.
    gauge.set(99, size=top)
    findings = engine.sweep_once()
    assert names(findings) == {"placeable_recount"}
    assert "gauge" in dict(findings[0].details)
    gauge.set(2, size=top)
    assert engine.sweep_once() == []
    # Seeded counts: the incremental aggregate drifts from its entries.
    index._placeable_counts[1] += 1
    findings = engine.sweep_once()
    assert names(findings) == {"placeable_recount"}
    assert ["incremental" in dict(f.details) for f in findings] == [True]
    index._placeable_counts[1] -= 1
    assert engine.sweep_once() == []
    # A seeded entry tuple: the aggregate and the sampled recompute disagree.
    entry = index.get("node-a")
    index._entries["node-a"] = dataclasses.replace(entry, placeable=(1,))
    findings = engine.sweep_once()
    assert names(findings) == {"placeable_recount"}
    assert any(f.node == "node-a" for f in findings)
    index._entries["node-a"] = entry
    assert engine.sweep_once() == []


def test_placeable_recount_samples_a_rotating_window(plane):
    """Past ``RECOUNT_SAMPLE`` entries the per-entry recompute walks a
    rotating window: at 40 entries and a sample of 32, the second sweep
    covers entries 32-39 and 0-23, the third 24-39 and 0-15. An entry tuple
    seeded at 28, with the aggregate and the gauge kept consistent with it,
    is missed by the second sweep and found by the third."""
    plane.metrics.EXT_PLACEABLE_NODES.remove_matching()
    index = plane.index.TopologyIndex()
    assert plane.audit.ExtenderAudit.RECOUNT_SAMPLE == 32
    for i in range(40):
        index.update(f"n{i:03d}", plane.raw(f"n{i:03d}"))
    ext_audit = plane.audit.ExtenderAudit(index=index)
    assert ext_audit.check_placeable_recount() == []
    good = index.entries()[28]
    top = good.placeable[-1]
    index._entries[good.name] = dataclasses.replace(good, placeable=good.placeable[:-1])
    index._placeable_counts[top] -= 1
    plane.metrics.EXT_PLACEABLE_NODES.set(index._placeable_counts[top], size=str(top))
    try:
        assert ext_audit.check_placeable_recount() == []
        (f,) = ext_audit.check_placeable_recount()
        assert f.invariant == "placeable_recount" and f.node == good.name
        assert dict(f.details)["recompute"] == str(list(good.placeable))
    finally:
        plane.metrics.EXT_PLACEABLE_NODES.remove_matching()


def test_placeable_recount_reads_clean_on_an_index_that_tracks_nothing(plane):
    """An index built with ``track_placeable=False`` (the scale bench's
    control arm) keeps no aggregate, so the recount has none to hold to its
    entries: it finds nothing, even beside a gauge another index wrote."""
    plane.metrics.EXT_PLACEABLE_NODES.remove_matching()
    index = plane.index.TopologyIndex(track_placeable=False)
    for i in range(4):
        index.update(f"n{i:03d}", plane.raw(f"n{i:03d}"))
    try:
        assert [e.placeable for e in index.entries()] == [()] * 4
        plane.metrics.EXT_PLACEABLE_NODES.set(7, size="1")
        assert plane.audit.ExtenderAudit(index=index).check_placeable_recount() == []
    finally:
        plane.metrics.EXT_PLACEABLE_NODES.remove_matching()


def test_entry_point_sweeps_the_index_alone_on_its_own_thread(plane, tmp_path):
    """``--node-cache --audit-interval-s`` without gang admission: the index's
    ``placeable_recount`` (with the shared invariants) is the whole set, and
    the engine sweeps on its own thread, as JAX's does, instead of riding
    an admission loop that does not exist."""
    api = FakeApiServer()
    url = api.start()
    api.add_node("node-a", plane.node("node-a"))
    kc = tmp_path / "kc.json"
    kc.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "c", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {}}],
        "contexts": [{"name": "x", "context": {"cluster": "c", "user": "u"}}],
        "current-context": "x"}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    module = plane.leader.__name__.rsplit(".", 1)[0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", module, "--host", "127.0.0.1", "--port",
                             str(port), "--kubeconfig", str(kc), "--node-cache",
                             "--audit-interval-s", "0.2"],
                            cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 30
        snap = {}
        while time.time() < deadline and proc.poll() is None:
            try:
                snap = requests.get(f"{base}/debug/audit", timeout=2).json()
                if snap.get("sweeps", 0) >= 2:
                    break
            except (requests.ConnectionError, ValueError):
                pass
            time.sleep(0.1)
        assert snap.get("sweeps", 0) >= 2, snap
        names = {i["name"] for i in snap["invariants"]}
        assert "placeable_recount" in names
        assert not names & {"reservation_vs_journal", "gate_vs_hold"}
        assert snap["findings"] == []
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
        api.stop()
    assert rc == 0
