"""The port's extender auditor (audit.ExtenderAudit) against the JAX one.

The extender cases of the JAX ``tests/test_audit.py`` that hold on the
port's planes, parametrised over the two planes of
tests/torch_extender_planes.py: a clean sweep and a leaked hold, a hold on a
vanished node, a table the journal would not rehydrate, the gates against
the holds (an undrained lapse included), the defrag plane's open
``defrag_evicted`` phase against the fences, and the admission loop driving
the sweeps. The port's set is the three invariants of the gang plane and the
shared three; ``defrag_vs_reservations`` joins them where a defrag engine is
wired (the JAX plane registers it with any journal), ``placeable_recount``
is not ported, and the JAX ``loop_inventory`` comes with the registry lint.
"""

import importlib
import time

import pytest

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
                   "thread_liveness", "lock_order", "degraded_consistency"}
JAX_ONLY = {"defrag_vs_reservations", "placeable_recount", "loop_inventory"}


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
