"""Gang admission's own death, on both planes: the kill-point cases of the
JAX ``tests/test_chaos_journal.py`` (post-reserve, mid-release,
mid-compaction, torn tail, lapsed hold) and ``test_chaos.py::test_gang_
admission_serves_last_known_topology_through_outage``, parametrised over the
two planes of tests/torch_extender_planes.py.

Each case drives a real admitter and its journal against the fake API
server and kills it at an injected point (``SigKill`` is a BaseException:
it tears through every best-effort ``except Exception`` as process death
does, and only the journal's bytes survive), then recovers a fresh admitter
over the same journal dir and holds it to the fake server's and the table's
state: no card double-booked, no gang left gateless and unfenced, a lapsed
hold lapsed across restarts, a torn tail or a mid-compaction crash falling
back to the durable prefix. The JAX file's three sharded cases (a shard's
SIGKILL at 1,000 nodes until its takeover, a shard's split brain, a death in
the middle of a takeover) and its two preemption kill-points (a death in the
middle of the evictions, and one between the evictions and the fence) are
here too, and so are its two defrag kill-points (the same two windows of a
migration); the rescue plane's kill-points are in tests/test_torch_rescue.py,
as the JAX file keeps them in tests/test_rescue.py.
"""

import importlib
import os
import time

import pytest

from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.torch_extender_planes import (
    JaxPlane,
    TorchPlane,
    gang_pod,
    gates_of,
    port_lockdep_acyclic,  # noqa: F401 - the autouse lockdep gate
    pod,
    read_layouts,
)


class SigKill(BaseException):
    """Process death: not an Exception, so every best-effort handler is
    blown through."""


class KillPointClient:
    """A pass-through kube client that dies on the Nth call of one
    method."""

    def __init__(self, inner, method: str, calls_before_kill: int = 0):
        self._inner = inner
        self._method = method
        self._remaining = calls_before_kill

    def __getattr__(self, name):
        real = getattr(self._inner, name)
        if name != self._method:
            return real

        def wrapper(*a, **kw):
            if self._remaining <= 0:
                raise SigKill(name)
            self._remaining -= 1
            return real(*a, **kw)

        return wrapper


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_journal_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


@pytest.fixture
def api(plane):
    s = FakeApiServer()
    url = s.start()
    s.add_node("n1", plane.node("n1"))
    yield s, plane.KubeClient(url)
    s.stop()


def add_gang(plane, server, gang, n_pods=2, chips=2, gated=True):
    for i in range(n_pods):
        p = gang_pod(plane, f"{gang}-w{i}", gang, n_pods, chips)
        if not gated:
            p["spec"]["schedulingGates"] = []
        server.add_pod(p)


def admission(plane, client, tmp_path=None, journal=None):
    if journal is None and tmp_path is not None:
        journal = plane.journal.AdmissionJournal(str(tmp_path))
    table = plane.reservations.ReservationTable()
    return plane.gang.GangAdmission(client, reservations=table, journal=journal), table


def bind(server, names, node="n1"):
    for name in names:
        with server._lock:
            server.pods[("default", name)]["spec"]["nodeName"] = node


def test_sigkill_post_reserve_pre_gate_patch_no_double_booking(plane, api, tmp_path):
    server, client = api
    gate = plane.gang.GATE_NAME
    add_gang(plane, server, "atrain")
    # The first gate patch kills the admitter: reserve and admit are on the
    # OS already.
    adm1, _ = admission(plane, KillPointClient(client, "remove_pod_scheduling_gate", 0),
                        tmp_path)
    with pytest.raises(SigKill):
        adm1.tick()
    for i in range(2):
        assert gate in gates_of(server, "default", f"atrain-w{i}")
    adm2, table2 = admission(plane, client, tmp_path)
    assert adm2.recover()["holds_restored"] == 1
    assert table2.reserved_chips("n1") == 4  # fenced before any tick
    # A competitor's /filter is shielded by the rehydrated hold.
    ext = plane.server.TopologyExtender(reservations=table2)
    passing, failed = ext.filter(pod(plane, 2), [plane.node("n1")])
    assert passing == []
    assert "reserved for a released gang" in failed["n1"]
    # A competitor gang is not admitted into the reserved cards, while the
    # killed gang's release finishes.
    add_gang(plane, server, "btrain")
    assert adm2.tick() == [("default", "atrain")]
    for i in range(2):
        assert gate not in gates_of(server, "default", f"atrain-w{i}")
        assert gate in gates_of(server, "default", f"btrain-w{i}")
    assert adm2.tick() == []
    bind(server, [f"atrain-w{i}" for i in range(2)])
    # The tick that sees a's members bound drops its fence, and b admits.
    assert adm2.tick() == [("default", "btrain")]
    assert ("default", "atrain") not in table2.active()
    adm2.journal.close()


def test_sigkill_mid_release_finishes_gates_and_keeps_fence(plane, api, tmp_path):
    server, client = api
    gate = plane.gang.GATE_NAME
    add_gang(plane, server, "atrain")
    adm1, _ = admission(plane, KillPointClient(client, "remove_pod_scheduling_gate", 1),
                        tmp_path)
    with pytest.raises(SigKill):
        adm1.tick()
    assert sorted(gate in gates_of(server, "default", f"atrain-w{i}") for i in range(2)) == [
        False, True]
    adm2, table2 = admission(plane, client, tmp_path)
    adm2.recover()
    assert table2.reserved_chips("n1") == 4
    assert adm2.tick() == [("default", "atrain")]  # finish_partial_release
    for i in range(2):
        assert gate not in gates_of(server, "default", f"atrain-w{i}")
    assert table2.reserved_chips("n1") == 4  # fenced until the members bind
    adm2.journal.close()


def test_sigkill_mid_compaction_keeps_authoritative_state(plane, api, tmp_path, monkeypatch):
    server, client = api
    add_gang(plane, server, "atrain")
    j1 = plane.journal.AdmissionJournal(str(tmp_path))
    adm1, _ = admission(plane, client, journal=j1)
    assert adm1.tick() == [("default", "atrain")]
    real_replace = os.replace

    def die_on_rename(src, dst):
        if str(dst).endswith("admission.snapshot.json"):
            raise SigKill("mid-compaction")
        return real_replace(src, dst)

    monkeypatch.setattr(plane.statestore.os, "replace", die_on_rename)
    with pytest.raises(SigKill):
        j1.compact(adm1._journal_state())
    monkeypatch.setattr(plane.statestore.os, "replace", real_replace)
    assert os.path.exists(j1.store.snapshot_path + ".tmp")
    adm2, table2 = admission(plane, client, tmp_path)
    assert adm2.recover()["holds_restored"] == 1
    assert table2.reserved_chips("n1") == 4
    assert not os.path.exists(j1.store.snapshot_path + ".tmp")
    adm2.journal.close()


def test_sigkill_torn_tail_degrades_to_durable_prefix(plane, api, tmp_path):
    server, client = api
    add_gang(plane, server, "atrain")
    j1 = plane.journal.AdmissionJournal(str(tmp_path))
    adm1, _ = admission(plane, client, journal=j1)
    assert adm1.tick() == [("default", "atrain")]
    j1.record("drop", ("default", "atrain"))
    j1.close()
    path = j1.store.journal_path
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 7)
    rehydrations = plane.metrics.STATE_REHYDRATIONS
    before = rehydrations.get(outcome="torn_tail")
    adm2, table2 = admission(plane, client, tmp_path)
    summary = adm2.recover()
    assert summary["status"] == "torn_tail"
    assert rehydrations.get(outcome="torn_tail") == before + 1
    # The torn drop never committed: the durable prefix (the hold) stands.
    assert summary["holds_restored"] == 1
    assert table2.reserved_chips("n1") == 4
    bind(server, [f"atrain-w{i}" for i in range(2)])
    adm2.tick()
    assert table2.active() == {}
    adm2.journal.close()


def test_lapsed_hold_stays_lapsed_across_restarts(plane, api, tmp_path):
    server, client = api
    # Released (gates off) but unscheduled: what _maybe_refence re-fences.
    add_gang(plane, server, "atrain", gated=False)
    old = plane.journal.AdmissionJournal(str(tmp_path), clock=lambda: time.time() - 10000.0)
    old.record("reserve", ("default", "atrain"), hosts={"n1": 4}, demands=[2, 2], age_s=0.0)
    old.close()
    adm2, table2 = admission(plane, client, tmp_path)
    assert adm2.recover()["holds_lapsed_on_restore"] == 1
    for _ in range(3):
        adm2.tick()
        assert table2.active() == {}, "re-fenced a lapsed hold"
    adm2.journal.close()
    # A second restart: the lapse was journaled, so the bar survives.
    adm3, table3 = admission(plane, client, tmp_path)
    adm3.recover()
    assert ("default", "atrain") in adm3._lapsed_gangs
    for _ in range(3):
        adm3.tick()
        assert table3.active() == {}, "re-fenced a lapsed hold"
    adm3.journal.close()
    # The control: without the journal the same state re-fences.
    adm0, table0 = admission(plane, client)
    adm0.tick()
    assert table0.reserved_chips("n1") == 4


# ---------------------------------------------------------------------------
# the preemption kill-points
# ---------------------------------------------------------------------------


def _preemption_cluster(plane, server):
    """n1 full, held by a running batch gang of two 2-card pods; a gated
    critical gang asking its 4 cards."""
    server.add_node("n1", plane.node("n1", []))
    for i in range(2):
        p = gang_pod(plane, f"b{i}", "batch", 2, 2)
        p["metadata"]["uid"] = f"uid-b{i}"
        p["spec"].update(schedulingGates=[], nodeName="n1", priority=-10)
        server.add_pod(p)
    hp = gang_pod(plane, "prod-w0", "prod", 1, 4)
    hp["spec"]["priority"] = 1_000_000
    server.add_pod(hp)


def _wire_preemption(plane, adm, client):
    resolver = plane.preemption.PriorityResolver(client)
    adm.priority_resolver = resolver
    adm.preemption = plane.preemption.PreemptionEngine(adm, resolver)


def test_sigkill_mid_preemption_evictions_aborts_then_replans(plane, api, tmp_path):
    """After preempt_intent, one victim pod evicted and the other not:
    recovery aborts the open intent (nothing was fenced, the preemptor is
    still gated, never gateless and unfenced), and the next tick plans again
    from the cluster's truth and finishes exactly once."""
    server, client = api
    gate = plane.gang.GATE_NAME
    _preemption_cluster(plane, server)
    adm1, _ = admission(plane, KillPointClient(client, "evict_pod", 1), tmp_path)
    _wire_preemption(plane, adm1, client)
    with pytest.raises(SigKill):
        adm1.tick()
    # One victim pod went through the eviction door; the intent is durable
    # and nothing was reserved.
    assert len(server.evictions) == 1
    adm2, table2 = admission(plane, client, tmp_path)
    _wire_preemption(plane, adm2, client)
    summary = adm2.recover()
    assert (summary["preempt_aborted"], summary["preempt_refenced"]) == (1, 0)
    assert table2.active() == {}
    assert gate in gates_of(server, "default", "prod-w0")
    # The node daemon frees the evicted pod's 2 cards and republishes: the
    # next round evicts only the remaining victim pod and admits.
    server.add_node("n1", plane.node("n1", [0, 1]))
    assert adm2.tick() == [("default", "prod")]
    assert len(server.evictions) == 2  # one more, not an eviction storm
    assert gate not in gates_of(server, "default", "prod-w0")
    assert table2.reserved_chips("n1") == 4  # the whole demand fenced
    assert adm2.preemption.open_intents() == {}
    adm2.journal.close()


def test_sigkill_between_evictions_and_fence_refences_on_recovery(plane, api, tmp_path):
    """After preempt_evicted, before the reserve, the window where freed
    cards could be stolen: recovery re-installs the planned fence before any
    tick or /filter, the release finishes against the standing hold, and the
    audit sweeps clean."""
    server, client = api
    gate = plane.gang.GATE_NAME
    _preemption_cluster(plane, server)
    adm1, table1 = admission(plane, client, tmp_path)
    _wire_preemption(plane, adm1, client)

    def die_on_reserve(*a, **kw):
        raise SigKill("between preempt_evicted and reserve")

    table1.reserve = die_on_reserve
    with pytest.raises(SigKill):
        adm1.tick()
    assert len(server.evictions) == 2  # both victim pods gone, the phase durable
    adm2, table2 = admission(plane, client, tmp_path)
    _wire_preemption(plane, adm2, client)
    summary = adm2.recover()
    assert (summary["preempt_refenced"], summary["preempt_aborted"]) == (1, 0)
    # The fence is back from the journaled plan before any tick, with the
    # preemptor's priority.
    assert table2.reserved_chips("n1") == 4
    assert table2.active()[("default", "prod")].priority == 1_000_000
    # The daemon republishes the freed cards: a competitor's /filter is
    # shielded by the rehydrated fence.
    fresh = plane.node("n1")
    server.add_node("n1", fresh)
    passing, failed = plane.server.TopologyExtender(reservations=table2).filter(
        pod(plane, 2), [fresh])
    assert passing == []
    assert "reserved for a released gang" in failed["n1"]
    # The next tick finishes the release against the standing hold: gates
    # off, fence standing, never gateless and unfenced.
    assert adm2.tick() == [("default", "prod")]
    assert gate not in gates_of(server, "default", "prod-w0")
    assert table2.reserved_chips("n1") == 4
    assert adm2.preemption.open_intents() == {}
    eng = plane.audit.ExtenderAudit(reservations=table2, journal=adm2.journal,
                                    gang=adm2).engine()
    findings = eng.sweep_once()
    assert [f for f in findings if f.severity == plane.audit.CRITICAL] == []
    assert [f for f in findings if f.invariant == "gate_vs_hold"] == []
    adm2.journal.close()


def _defrag_cluster(plane, server):
    """Two fragmented nodes (cards 0 and 2 free: free cards on each, room for
    4 on neither); n1's other two cards are held by a cheap batch gang whose
    migration onto n2's free pair frees n1 for a gated 4-card gang."""
    for name in ("n1", "n2"):
        server.add_node(name, plane.node(name, [0, 2]))
    for i in range(2):
        p = gang_pod(plane, f"frag-w{i}", "frag", 2, 1)
        p["metadata"]["uid"] = f"uid-frag-w{i}"
        p["metadata"]["annotations"] = {
            plane.constants.CHECKPOINT_TS_ANNOTATION: str(time.time() - 5)}
        p["spec"].update(schedulingGates=[], nodeName="n1", priority=-10)
        server.add_pod(p)
    server.add_pod(gang_pod(plane, "prod-w0", "prod", 1, 4))


def _wire_defrag(plane, adm, client):
    resolver = plane.preemption.PriorityResolver(client)
    adm.priority_resolver = resolver
    # No hysteresis wait in the kill-point cases (the victim saved 5 s ago,
    # so no checkpoint deferral either).
    adm.defrag = plane.defrag.DefragEngine(adm, resolver, stranded_ticks=1)


def test_sigkill_mid_defrag_evictions_aborts_then_replans(plane, bare_api, tmp_path):
    """After defrag_intent, one victim pod evicted and the other not:
    recovery aborts the open intent (nothing was fenced, the stranded gang
    is still gated, never gateless and unfenced), and the next tick plans
    again from the cluster's truth and finishes the migration once."""
    server, client = bare_api
    gate = plane.gang.GATE_NAME
    _defrag_cluster(plane, server)
    adm1, _ = admission(plane, KillPointClient(client, "evict_pod", 1), tmp_path)
    _wire_defrag(plane, adm1, client)
    with pytest.raises(SigKill):
        adm1.tick()
    assert len(server.evictions) == 1  # the intent is durable, nothing reserved
    adm2, table2 = admission(plane, client, tmp_path)
    _wire_defrag(plane, adm2, client)
    summary = adm2.recover()
    assert (summary["defrag_aborted"], summary["defrag_refenced"]) == (1, 0)
    assert table2.active() == {}
    assert gate in gates_of(server, "default", "prod-w0")
    # The node daemon frees the evicted pod's card and republishes: the next
    # round migrates only the remaining victim pod and the gang admits.
    server.add_node("n1", plane.node("n1", [0, 1, 2]))
    assert adm2.tick() == [("default", "prod")]
    assert len(server.evictions) == 2  # one more, not an eviction storm
    assert gate not in gates_of(server, "default", "prod-w0")
    assert table2.reserved_chips("n1") == 4  # the whole demand fenced
    assert adm2.defrag.open_intents() == {}
    adm2.journal.close()


def test_sigkill_between_defrag_evictions_and_fence_refences(plane, bare_api, tmp_path):
    """After defrag_evicted, before the reserve, the window where the freed
    cards could go to a scavenger: recovery re-installs the planned fence
    under the stranded gang's key before any tick, the release finishes
    against the standing hold, and the audit, defrag_vs_reservations
    included, sweeps clean."""
    server, client = bare_api
    gate = plane.gang.GATE_NAME
    _defrag_cluster(plane, server)
    adm1, table1 = admission(plane, client, tmp_path)
    _wire_defrag(plane, adm1, client)

    def die_on_reserve(*a, **kw):
        raise SigKill("between defrag_evicted and reserve")

    table1.reserve = die_on_reserve
    with pytest.raises(SigKill):
        adm1.tick()
    assert len(server.evictions) == 2  # both victim pods gone, the phase durable
    adm2, table2 = admission(plane, client, tmp_path)
    _wire_defrag(plane, adm2, client)
    summary = adm2.recover()
    assert (summary["defrag_refenced"], summary["defrag_aborted"]) == (1, 0)
    assert table2.reserved_chips("n1") == 4
    assert ("default", "prod") in table2.active()
    # The daemon republishes the freed cards: a competitor's /filter is
    # shielded by the rehydrated fence.
    fresh = plane.node("n1")
    server.add_node("n1", fresh)
    passing, failed = plane.server.TopologyExtender(reservations=table2).filter(
        pod(plane, 2), [fresh])
    assert passing == []
    assert "reserved for a released gang" in failed["n1"]
    assert adm2.tick() == [("default", "prod")]
    assert gate not in gates_of(server, "default", "prod-w0")
    assert table2.reserved_chips("n1") == 4
    assert adm2.defrag.open_intents() == {}
    eng = plane.audit.ExtenderAudit(reservations=table2, journal=adm2.journal,
                                    gang=adm2).engine()
    assert "defrag_vs_reservations" in {i.name for i in eng.invariants}
    findings = eng.sweep_once()
    assert [f for f in findings if f.severity == plane.audit.CRITICAL] == []
    assert [f for f in findings
            if f.invariant in ("gate_vs_hold", "defrag_vs_reservations")] == []
    adm2.journal.close()


def test_gang_admission_serves_last_known_topology_through_outage(plane, api):
    """With the node list failing, the capacity view falls back to the last
    successful relist instead of failing the tick."""
    server, client = api
    rz = importlib.import_module(plane.metrics.__name__.rsplit(".", 1)[0] + ".resilience")
    client.resilience = rz.Resilience(
        policy=rz.RetryPolicy(max_attempts=2, base_delay_s=0.01, max_delay_s=0.05,
                              deadline_s=2.0),
        breaker=rz.CircuitBreaker(failure_threshold=100, reset_timeout_s=0.3))
    adm, _ = admission(plane, client)
    assert len(adm._node_topologies()) == 1  # warm the last-known view
    server.faults.add(kind="status", status=503, times=-1, method="GET")
    assert [t.hostname for t in adm._node_topologies()] == ["n1"]
    server.faults.clear()


# ---------------------------------------------------------------------------
# sharded admission: a shard's takeover, a shard's split brain and a death
# in the middle of a takeover (the JAX file's sharded cases)
# ---------------------------------------------------------------------------


@pytest.fixture
def bare_api(plane):
    """A fake API server with no node: the sharded cases place their own."""
    s = FakeApiServer()
    url = s.start()
    yield s, plane.KubeClient(url)
    s.stop()


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _sharded_factory(plane, client, tmp_path, kill_gang_patch_for=frozenset()):
    """Admitters over real per-shard journals; a shard in
    ``kill_gang_patch_for`` dies at its first gate patch."""

    def factory(shard_id, gang_filter, topo_filter):
        c = client
        if shard_id in kill_gang_patch_for:
            c = KillPointClient(client, "remove_pod_scheduling_gate", 0)
        return plane.gang.GangAdmission(
            c, reservations=plane.reservations.ReservationTable(),
            journal=plane.journal.AdmissionJournal(os.path.join(str(tmp_path), f"shard-{shard_id}")),
            gang_filter=gang_filter, topo_filter=topo_filter, shard_id=shard_id)

    return factory


def _host_index(hosts):
    import types

    entries = [types.SimpleNamespace(hostname=h, slice_key=None) for h in hosts]
    return types.SimpleNamespace(entries=lambda: entries)


def test_sigkill_one_shard_stalls_only_its_gangs_until_takeover(plane, bare_api, tmp_path):
    """3 shards over 1,000 nodes: SIGKILL of one shard after its reserve and
    before its gate patch stalls only that shard's gangs while the others
    admit; the takeover replays the dead shard's journal within the lease
    bound, with the hold's original age, and the ownership invariant (every
    held host against its own shard, no host held by two) sweeps clean
    throughout."""
    server, client = bare_api
    sh = plane.sharding
    ring = sh.ShardRing(3)
    hosts = [f"node-{i:04d}" for i in range(1000)]
    for name in hosts:
        server.add_node(name, plane.node(name))
    gangs = {s: [] for s in range(3)}
    for s in range(3):
        for j in range(2):
            gname = plane.pick_key(ring, s, "default/g{0:04d}-" + f"{s}{j}").split("/", 1)[1]
            add_gang(plane, server, gname)
            gangs[s].append(gname)
    managers = []
    for s in range(3):
        m = sh.ShardManager(
            client, shards=3, home_shard=s,
            admitter_factory=_sharded_factory(plane, client, tmp_path,
                                              {2} if s == 2 else frozenset()),
            identity=f"rep-{s}", lease_seconds=2.0, takeover=(s == 0), auto_start=False)
        m._adopt_shard(s, reason="home")
        managers.append(m)
    index = _host_index(hosts)

    def audit_clean(tables):
        mgr = type("M", (), {"ring": ring, "shard_tables": staticmethod(lambda: tables)})()
        return plane.audit.ExtenderAudit(index=index, shard_manager=mgr).check_shard_ownership()

    gate = plane.gang.GATE_NAME
    for s in (0, 1):
        released = managers[s].ticked_admissions()[0].tick()
        assert sorted(released) == sorted(("default", g) for g in gangs[s])
    with pytest.raises(SigKill):
        managers[2].ticked_admissions()[0].tick()
    managers[2].abandon()
    stalled = gangs[2][0]
    for g in gangs[0] + gangs[1]:
        for i in range(2):
            assert gate not in gates_of(server, "default", f"{g}-w{i}")
    for i in range(2):
        assert gate in gates_of(server, "default", f"{stalled}-w{i}")
    for s in (0, 1):
        managers[s].ticked_admissions()[0].tick()
    assert audit_clean([(s, managers[s].ticked_admissions()[0].reservations)
                        for s in (0, 1)]) == []
    kill_ts = time.time()
    assert _wait(lambda: managers[0].scan_once() or 2 in managers[0].owned_shards(), 10), \
        "no takeover within the lease bound"
    adopted = [a for a in managers[0].ticked_admissions() if a.shard_id == 2][0]
    key = ("default", stalled)
    st = adopted.reservations.export_state()
    assert st[key]["age_s"] >= (time.time() - kill_ts) - 0.5  # the original age
    adopted.tick()
    for g in gangs[2]:
        for i in range(2):
            assert gate not in gates_of(server, "default", f"{g}-w{i}")
    assert sum(adopted.reservations.export_state()[key]["hosts"].values()) == 4
    tables = [(a.shard_id, a.reservations) for a in managers[0].ticked_admissions()]
    tables.append((1, managers[1].ticked_admissions()[0].reservations))
    assert sum(len(t.active()) for _, t in tables) == 6
    assert audit_clean(tables) == []
    managers[0].stop()
    managers[1].stop()


def test_shard_split_brain_partitioned_holder_self_demotes_first(plane, bare_api):
    """A shard's holder cut off from the API server demotes itself (the
    renew deadline) strictly before its lease can be taken over: when
    on_lost fires a competitor still reads the lease live, and only past
    the published duration does the takeover succeed."""

    class PartitionedClient:
        def __init__(self, inner):
            self._inner = inner
            self.partitioned = False

        def __getattr__(self, name):
            real = getattr(self._inner, name)
            if not callable(real):
                return real

            def wrapper(*a, **kw):
                if self.partitioned:
                    raise OSError("network partition")
                return real(*a, **kw)

            return wrapper

    server, client = bare_api
    holder_client = PartitionedClient(client)
    lost = []
    name = plane.sharding.shard_lease_name(1, 3)
    holder = plane.leader.LeaderLease(holder_client, name=name, identity="rep-holder",
                                      lease_seconds=6.0, renew_deadline_s=0.8,
                                      on_lost=lambda: lost.append(time.time()))
    holder.start()
    try:
        holder_client.partitioned = True
        assert _wait(lambda: lost, 15), "the partitioned holder never demoted"
        competitor = plane.leader.LeaderLease(client, name=name, identity="rep-competitor",
                                              lease_seconds=6.0)
        with pytest.raises(plane.leader.SecondReplica):
            competitor.acquire()
        competitor._clock = lambda: time.time() + 7.0
        competitor.acquire()
        assert server.leases[("kube-system", name)]["spec"]["holderIdentity"] == "rep-competitor"
    finally:
        holder._stop.set()
        if holder._thread is not None:
            holder._thread.join(timeout=5)


def test_mid_rebalance_death_second_takeover_replays_idempotently(plane, bare_api, tmp_path):
    """A replica dies after taking a dead shard's lease and before its
    journal's replay; the next owner replays the same journal: the gang is
    admitted exactly once, with its original fence."""
    server, client = bare_api
    sh = plane.sharding
    ring = sh.ShardRing(2)
    host = plane.pick_key(ring, 1, "n-{0:04d}")
    server.add_node(host, plane.node(host))
    gname = plane.pick_key(ring, 1, "default/g-{0:04d}").split("/", 1)[1]
    add_gang(plane, server, gname)
    gate = plane.gang.GATE_NAME
    m1 = sh.ShardManager(client, shards=2, home_shard=1,
                         admitter_factory=_sharded_factory(plane, client, tmp_path, {1}),
                         identity="rep-1", lease_seconds=2.0, takeover=False, auto_start=False)
    m1._adopt_shard(1, reason="home")
    with pytest.raises(SigKill):
        m1.ticked_admissions()[0].tick()
    m1.abandon()
    time.sleep(2.3)

    class FactoryKill(BaseException):
        pass

    def dying_factory(shard_id, gang_filter, topo_filter):
        raise FactoryKill("died between the lease and the replay")

    m2 = sh.ShardManager(client, shards=2, home_shard=0, admitter_factory=dying_factory,
                         identity="rep-2", lease_seconds=2.0, auto_start=False)
    with pytest.raises(FactoryKill):
        m2._adopt_shard(1, reason="takeover")
    m2.abandon()
    for i in range(2):
        assert gate in gates_of(server, "default", f"{gname}-w{i}")
    time.sleep(2.3)
    m3 = sh.ShardManager(client, shards=2, home_shard=0,
                         admitter_factory=_sharded_factory(plane, client, tmp_path),
                         identity="rep-3", lease_seconds=2.0, auto_start=False)
    m3._adopt_shard(0, reason="home")
    m3.scan_once()
    assert m3.owned_shards() == {0, 1}
    adopted = [a for a in m3.ticked_admissions() if a.shard_id == 1][0]
    assert sum(adopted.reservations.held_by_host().values()) == 4
    assert adopted.tick() == [("default", gname)]
    for i in range(2):
        assert gate not in gates_of(server, "default", f"{gname}-w{i}")
    assert adopted.tick() == []  # exactly once
    m3.stop()
