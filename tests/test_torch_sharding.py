"""The port's sharded gang admission (extender/sharding.py) against the JAX one.

The scenarios of the JAX ``tests/test_sharding.py`` are tests parametrised
over the two planes of tests/torch_extender_planes.py: the consistent-hash
ring's stability, the per-shard lease and its jittered acquire, the peers'
holds through the lease annotation, the takeover of a dead shard, the
handback, each shard's journal restored as it was, the /readyz payload,
/debug/shards and the audit's ownership invariant. 31 of the JAX file's 32
tests have a case here.

``test_audit_shard_index_maps_slice_members_together`` has none: a GPU node
forms no multi-host slice, so each node's capacity key is its hostname. In
its place ``test_audit_resolves_every_held_host_by_its_hostname`` holds
every held host to its own hostname's shard. The docs test checks the
port's README section and manifest, the JAX clause on ``--shard-scaling``
against the port's scale bench.

Beside them: the ring agrees with the JAX ring key for key, the port's
lease names, and the entry point run sharded over a fake API server.
"""

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import pytest
import requests

from k8s_device_plugin_tpu.extender import sharding as jax_sharding
from k8s_device_plugin_tpu_torch.extender import sharding as torch_sharding
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharding_nvml")
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


def kube_error(plane):
    return importlib.import_module(plane.KubeClient.__module__).KubeError


def lease_name(plane) -> str:
    return plane.leader.LEASE_NAME


# ---------------------------------------------------------------------------
# the consistent-hash ring
# ---------------------------------------------------------------------------

KEYS = [f"slice-{i:05d}" for i in range(4000)]


def test_ring_deterministic_and_single_mapping(plane):
    a, b = plane.sharding.ShardRing(5), plane.sharding.ShardRing(5)
    for key in KEYS:
        s = a.shard_of(key)
        assert s == b.shard_of(key)
        assert 0 <= s < 5


def test_ring_every_shard_owns_keys(plane):
    ring = plane.sharding.ShardRing(6)
    assert {ring.shard_of(k) for k in KEYS} == set(range(6))


def test_ring_grow_remaps_about_one_over_n(plane):
    before, after = plane.sharding.ShardRing(4), plane.sharding.ShardRing(5)
    moved = [k for k in KEYS if before.shard_of(k) != after.shard_of(k)]
    frac = len(moved) / len(KEYS)
    assert 0.02 < frac < 0.40, f"grow remapped {frac:.0%} (~20% expected)"
    assert all(after.shard_of(k) == 4 for k in moved)


def test_ring_shrink_moves_only_the_removed_shards_keys(plane):
    big, small = plane.sharding.ShardRing(5), plane.sharding.ShardRing(4)
    for k in KEYS:
        if big.shard_of(k) != 4:
            assert small.shard_of(k) == big.shard_of(k)


def test_ring_one_shard_is_identity_and_lease_name_compat(plane):
    ring = plane.sharding.ShardRing(1)
    assert all(ring.shard_of(k) == 0 for k in KEYS[:100])
    assert plane.sharding.shard_lease_name(0, 1) == lease_name(plane)
    assert plane.sharding.shard_lease_name(2, 8) == f"{lease_name(plane)}-shard-2"


def test_gang_and_topo_shard_helpers(plane):
    """A gang's key is ``ns/name``; a standalone host's capacity key is its
    hostname. A multi-host slice hashes its member list together in JAX; a
    GPU node forms no slice, so the port's key is the hostname whatever the
    topology carries."""
    ring = plane.sharding.ShardRing(3)
    assert ring.gang_shard(("ns", "g")) == ring.shard_of("ns/g")
    solo = types.SimpleNamespace(hostname="h1", slice_hosts=["h1"])
    sliced = types.SimpleNamespace(hostname="h2", slice_hosts=["h2", "h3"])
    assert ring.topo_shard(solo) == ring.shard_of("h1")
    want = "h2|h3" if plane.name == "jax" else "h2"
    assert ring.topo_shard(sliced) == ring.shard_of(want)


@pytest.mark.parametrize("shards", range(1, 9))
def test_ring_agrees_with_jax_key_for_key(shards):
    """The same blake2b points, so both planes put every key on the same
    shard: a replica of either reads the other's partition alike."""
    j, t = jax_sharding.ShardRing(shards), torch_sharding.ShardRing(shards)
    assert [t.shard_of(k) for k in KEYS] == [j.shard_of(k) for k in KEYS]
    assert t.gang_shard(("default", "g-1")) == j.gang_shard(("default", "g-1"))


def test_port_names_its_leases_and_keeps_the_jax_annotation_keys():
    assert torch_sharding.shard_lease_name(0, 1) == "nvidia-scheduler-extender"
    assert torch_sharding.shard_lease_name(3, 4) == "nvidia-scheduler-extender-shard-3"
    assert (torch_sharding.standby_lease_name(3, 4)
            == "nvidia-scheduler-extender-shard-3-standby")
    assert torch_sharding.HOLDS_ANNOTATION == jax_sharding.HOLDS_ANNOTATION
    assert torch_sharding.HOME_ANNOTATION == jax_sharding.HOME_ANNOTATION
    assert (torch_sharding.MAX_HOLDS_ANNOTATION_BYTES
            == jax_sharding.MAX_HOLDS_ANNOTATION_BYTES)


# ---------------------------------------------------------------------------
# the jittered acquire
# ---------------------------------------------------------------------------


class _RacingClient:
    """A lease client whose first create conflicts (a peer won the race);
    the peer's record then reads stale, so the retry wins."""

    def __init__(self, error):
        self.error = error
        self.creates = 0
        self.lease = None

    def get(self, path, **kw):
        if self.lease is None:
            raise self.error(404, "not found")
        return json.loads(json.dumps(self.lease))

    def create(self, collection, body, **kw):
        self.creates += 1
        if self.creates == 1:
            self.lease = {"metadata": body["metadata"],
                          "spec": {"holderIdentity": "peer", "renewTime": ""}}
            raise self.error(409, "conflict")
        self.lease = json.loads(json.dumps(body))
        return body

    def replace(self, path, body, **kw):
        self.lease = json.loads(json.dumps(body))
        return body


def test_acquire_retry_is_jittered_and_counted(plane):
    slept = []
    before = plane.metrics.SHARD_ACQUIRE_CONFLICTS.get()

    class Rng:
        def uniform(self, lo, hi):
            assert (lo, hi) == (0, 0.5)
            return 0.123

    lease = plane.leader.LeaderLease(_RacingClient(kube_error(plane)), identity="rep-a",
                                     retry_jitter_s=0.5, rng=Rng(), sleep=slept.append)
    lease.acquire()
    assert slept == [0.123]
    assert plane.metrics.SHARD_ACQUIRE_CONFLICTS.get() == before + 1


def test_acquire_zero_jitter_restores_immediate_retry(plane):
    slept = []
    lease = plane.leader.LeaderLease(_RacingClient(kube_error(plane)), identity="rep-a",
                                     retry_jitter_s=0.0, sleep=slept.append)
    lease.acquire()
    assert slept == []


# ---------------------------------------------------------------------------
# ShardedReservations: the union /filter is shielded with
# ---------------------------------------------------------------------------


def test_sharded_reservations_union_and_exclude(plane):
    t1, t2 = plane.reservations.ReservationTable(), plane.reservations.ReservationTable()
    t1.reserve(("default", "a"), {"n1": 2})
    t2.reserve(("default", "b"), {"n1": 1, "n2": 4})
    peers = [{"namespace": "default", "gang": "c", "hosts": {"n2": 2}},
             {"namespace": "default", "gang": "a", "hosts": {"n3": 1}}]
    view = plane.sharding.ShardedReservations(lambda: [t1, t2], lambda: peers)
    assert view.held_by_host() == {"n1": 3, "n2": 6, "n3": 1}
    assert view.held_by_host(exclude=("default", "a")) == {"n1": 1, "n2": 6}
    assert view.held_by_host().get("n2", 0) == 6
    assert view.held_by_host(exclude=("default", "c")).get("n2", 0) == 4
    assert [e["gang"] for e in view.snapshot()] == ["a", "b"]


def test_sharded_reservations_filter_shield(plane):
    """/filter over the facade withholds a peer shard's published cards as
    it does a local hold, and passes the hold's own gang."""
    peers = [{"namespace": "default", "gang": "g", "hosts": {"n1": 4}}]
    view = plane.sharding.ShardedReservations(lambda: [], lambda: peers)
    ext = plane.server.TopologyExtender(reservations=view)
    passing, failed = ext.filter(pod(plane, 2), [plane.node("n1")])
    assert passing == []
    assert "reserved for a released gang" in failed["n1"]
    gp = gang_pod(plane, "g-w0", "g", 2, 2)
    passing, _ = ext.filter(gp, [plane.node("n1")])
    assert [n["metadata"]["name"] for n in passing] == ["n1"]


# ---------------------------------------------------------------------------
# ShardManager over the fake API server
# ---------------------------------------------------------------------------


class _DummyAdmission:
    """The surface the manager drives."""

    def __init__(self, plane):
        self.reservations = plane.reservations.ReservationTable()
        self.recovered = self.started = self.stopped = False

    def recover(self):
        self.recovered = True

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True

    def tick(self, full=True):
        return []


def _manager(plane, client, home, shards=2, identity=None, **kw):
    kw.setdefault("lease_seconds", 30.0)
    return plane.sharding.ShardManager(client, shards=shards, home_shard=home,
                                       admitter_factory=lambda *_: _DummyAdmission(plane),
                                       identity=identity or f"rep-{home}", **kw)


def shard_key(plane, shard):
    return ("kube-system", f"{lease_name(plane)}-shard-{shard}")


def test_home_shard_acquire_and_status(plane, api):
    server, client = api
    m = _manager(plane, client, home=0)
    m._adopt_shard(0, reason="home")
    try:
        assert server.leases[shard_key(plane, 0)]["spec"]["holderIdentity"] == "rep-0"
        assert m.owned_shards() == {0}
        st = m.status()
        assert st["shards"] == 2 and st["home"] == 0 and st["owned"] == [0]
        assert st["shard_phases"]["0"]["phase"] == "ready"
        assert plane.metrics.SHARD_OWNED.get(shard="0") == 1
    finally:
        m.stop()
    assert server.leases[shard_key(plane, 0)]["spec"]["holderIdentity"] == ""
    assert plane.metrics.SHARD_OWNED.get(shard="0") == 0


def test_second_replica_same_home_shard_fails_fast(plane, api):
    _, client = api
    m0 = _manager(plane, client, home=0, identity="rep-a")
    m0._adopt_shard(0, reason="home")
    try:
        m1 = _manager(plane, client, home=0, identity="rep-b")
        with pytest.raises(plane.leader.SecondReplica, match="rep-a"):
            m1.start()
    finally:
        m0.stop()


def test_peer_holds_flow_through_lease_annotation(plane, api):
    server, client = api
    m0 = _manager(plane, client, home=0, identity="rep-a")
    m0._adopt_shard(0, reason="home")
    m1 = _manager(plane, client, home=1, identity="rep-b", takeover=False)
    m1._adopt_shard(1, reason="home")
    try:
        m0._owned[0].admission.reservations.reserve(("default", "g"), {"n1": 4})
        m0._owned[0].lease._renew_once()  # publish the overlay
        ann = server.leases[shard_key(plane, 0)]["metadata"].get("annotations", {})
        raw = ann[plane.sharding.HOLDS_ANNOTATION]
        assert raw.startswith("tpb1:")
        recs = plane.holdscodec.decode_holds(raw)
        assert recs == [{"namespace": "default", "gang": "g", "hosts": {"n1": 4}}]
        m1.scan_once()
        assert m1.peer_hold_records() == recs
        assert m1.reservations_view().held_by_host() == {"n1": 4}
        assert plane.metrics.SHARD_PEER_HELD_CHIPS.get() == 4
        assert m0.peer_hold_records() == []
        assert m0.reservations_view().held_by_host() == {"n1": 4}
    finally:
        m1.stop()
        m0.stop()


def test_takeover_of_dead_shard(plane, api):
    # renewTime has second precision, so the lease is 2 s: short enough to
    # wait out, long enough that truncation cannot fake staleness.
    server, client = api
    m1 = _manager(plane, client, home=1, identity="rep-b", lease_seconds=2.0, takeover=False)
    m1._adopt_shard(1, reason="home")
    m0 = _manager(plane, client, home=0, identity="rep-a", lease_seconds=2.0)
    m0._adopt_shard(0, reason="home")
    try:
        before = plane.metrics.SHARD_TAKEOVERS.get(shard="1")
        m1.abandon()
        m0.scan_once()
        assert m0.owned_shards() == {0}  # the first sight starts the clock
        time.sleep(2.3)
        m0.scan_once()
        assert m0.owned_shards() == {0, 1}
        assert m0.takeovers == 1
        assert plane.metrics.SHARD_TAKEOVERS.get(shard="1") == before + 1
        assert server.leases[shard_key(plane, 1)]["spec"]["holderIdentity"] == "rep-a"
        assert m0._owned[1].admission.recovered
        assert m0.status()["shard_phases"]["1"]["phase"] == "ready"
    finally:
        m0.stop()


def test_takeover_race_has_one_winner(plane, api):
    _, client = api
    dead = _manager(plane, client, home=2, identity="rep-dead", lease_seconds=2.0,
                    takeover=False, shards=3)
    dead._adopt_shard(2, reason="home")
    dead.abandon()
    a = _manager(plane, client, home=0, identity="rep-a", lease_seconds=2.0, shards=3)
    a._adopt_shard(0, reason="home")
    b = _manager(plane, client, home=1, identity="rep-b", lease_seconds=2.0, shards=3)
    b._adopt_shard(1, reason="home")
    try:
        a.scan_once()
        b.scan_once()
        assert a.owned_shards() == {0} and b.owned_shards() == {1}
        time.sleep(2.3)
        a.scan_once()  # wins
        b.scan_once()  # sees a live holder and skips
        assert a.owned_shards() == {0, 2}
        assert b.owned_shards() == {1}
    finally:
        a.stop()
        b.stop()


def test_takeover_keeps_overlay_shield_until_replay_completes(plane, api):
    _, client = api
    m1 = _manager(plane, client, home=1, identity="rep-b", lease_seconds=2.0, takeover=False)
    m1._adopt_shard(1, reason="home")
    m1._owned[1].admission.reservations.reserve(("default", "g"), {"n9": 4})
    m1._owned[1].lease._renew_once()
    m0 = _manager(plane, client, home=0, identity="rep-a", lease_seconds=2.0)
    m0._adopt_shard(0, reason="home")
    m0.scan_once()
    assert m0.reservations_view().held_by_host() == {"n9": 4}
    seen = {}

    class _ReplayingAdm(_DummyAdmission):
        def recover(self):
            seen["held"] = m0.reservations_view().held_by_host()
            super().recover()

    m0.admitter_factory = lambda *_: _ReplayingAdm(plane)
    try:
        m1.abandon()
        time.sleep(2.3)
        m0.scan_once()
        assert m0.owned_shards() == {0, 1}
        assert seen["held"] == {"n9": 4}, "overlay dropped before the replay installed the holds"
    finally:
        m0.stop()


def test_holds_annotation_degrades_at_size_ceiling(plane, api, monkeypatch):
    _, client = api
    m = _manager(plane, client, home=0)
    m._adopt_shard(0, reason="home")
    ann = plane.sharding.HOLDS_ANNOTATION
    try:
        table = m._owned[0].admission.reservations
        table.reserve(("default", "a"), {"n1": 2, "n2": 1})
        table.reserve(("default", "b"), {"n1": 1})
        full_raw = m._holds_payload_fn(0)()[ann]
        assert len(plane.holdscodec.decode_holds(full_raw)) == 2
        monkeypatch.setattr(plane.sharding, "MAX_HOLDS_ANNOTATION_BYTES", len(full_raw) - 1)
        agg_raw = m._holds_payload_fn(0)()[ann]
        assert plane.holdscodec.decode_holds(agg_raw) == [
            {"namespace": "", "gang": "", "hosts": {"n1": 3, "n2": 1}}]
        monkeypatch.setattr(plane.sharding, "MAX_HOLDS_ANNOTATION_BYTES", len(agg_raw) - 1)
        assert m._holds_payload_fn(0)()[ann] == "[]"
    finally:
        m.stop()


def test_never_created_lease_gets_rollout_grace(plane, api):
    _, client = api
    m0 = _manager(plane, client, home=0, identity="rep-a", lease_seconds=1.0)
    m0._adopt_shard(0, reason="home")
    try:
        m0.scan_once()
        assert m0.owned_shards() == {0}
        m0.scan_once()
        assert m0.owned_shards() == {0}
        time.sleep(1.2)
        m0.scan_once()
        assert m0.owned_shards() == {0, 1}
    finally:
        m0.stop()


def test_home_handback_after_takeover(plane, api):
    server, client = api
    m1 = _manager(plane, client, home=1, identity="rep-b", lease_seconds=2.0, takeover=False)
    m1._adopt_shard(1, reason="home")
    m0 = _manager(plane, client, home=0, identity="rep-a", lease_seconds=2.0)
    m0._adopt_shard(0, reason="home")
    try:
        m1.abandon()
        m0.scan_once()
        time.sleep(2.3)
        m0.scan_once()
        assert m0.owned_shards() == {0, 1}
        # The restarted replica stands by: no SecondReplica for an interim
        # owner.
        m1b = _manager(plane, client, home=1, identity="rep-b2", lease_seconds=2.0)
        assert m1b._try_adopt_home(fail_fast=True) is False
        assert m1b._standby is not None and m1b.status()["standby"] is True
        standby = ("kube-system", f"{lease_name(plane)}-shard-1-standby")
        assert server.leases[standby]["spec"]["holderIdentity"] == "rep-b2"
        m0.scan_once()  # sees the claim and hands the shard back
        assert m0.owned_shards() == {0}
        assert server.leases[shard_key(plane, 1)]["spec"]["holderIdentity"] == ""
        adopted_with = []
        m1b.on_home_adopted = adopted_with.append
        assert m1b._try_adopt_home() is True
        assert m1b.owned_shards() == {1}
        assert m1b._standby is None and m1b.status()["standby"] is False
        assert adopted_with == [m1b.home_admission()]
        m1b.stop()
    finally:
        m0.stop()


def test_genuine_duplicate_home_still_fails_fast(plane, api):
    _, client = api
    m0 = _manager(plane, client, home=0, identity="rep-a", lease_seconds=30)
    m0._adopt_shard(0, reason="home")
    m0._owned[0].lease._renew_once()  # the home annotation rides a renew
    try:
        dup = _manager(plane, client, home=0, identity="rep-dup", lease_seconds=30)
        with pytest.raises(plane.leader.SecondReplica):
            dup._try_adopt_home(fail_fast=True)
        assert dup._standby is None
    finally:
        m0.stop()


def test_fresh_reserve_wakes_immediate_publish(plane, api):
    server, client = api
    m = _manager(plane, client, home=0, identity="rep-a")
    m._adopt_shard(0, reason="home")
    try:
        assert not m._publish_wake.is_set()
        m._owned[0].admission.reservations.reserve(("default", "g"), {"n1": 4})
        assert m._publish_wake.is_set()
        m.publish_holds()
        ann = server.leases[shard_key(plane, 0)]["metadata"]["annotations"]
        assert plane.holdscodec.decode_holds(ann[plane.sharding.HOLDS_ANNOTATION]) == [
            {"namespace": "default", "gang": "g", "hosts": {"n1": 4}}]
        assert ann["tpu.google.com/home-shard"] == "0"
    finally:
        m.stop()


# ---------------------------------------------------------------------------
# disjoint admission, and each shard's journal restored as it was
# ---------------------------------------------------------------------------


def _shard_fixture(plane, server, ring):
    """A 4-card node and a gang of 2 x 2 cards per shard, named onto it."""
    hosts, gangs = [], []
    for s in (0, 1):
        host = plane.pick_key(ring, s, "node-{0:04d}-" + str(s))
        server.add_node(host, plane.node(host))
        hosts.append(host)
        gname = plane.pick_key(ring, s, "default/gang-{0:04d}-" + str(s)).split("/")[1]
        for i in range(2):
            server.add_pod(gang_pod(plane, f"{gname}-w{i}", gname, 2, 2))
        gangs.append(gname)
    return hosts, gangs


def _shard_admission(plane, client, tmp_path, ring, shard):
    return plane.gang.GangAdmission(
        client, reservations=plane.reservations.ReservationTable(),
        journal=plane.journal.AdmissionJournal(os.path.join(str(tmp_path), f"shard-{shard}")),
        gang_filter=lambda key, s=shard: ring.gang_shard(key) == s,
        topo_filter=lambda t, s=shard: ring.topo_shard(t) == s, shard_id=shard)


def test_disjoint_admission_and_restored_equals_fresh(plane, api, tmp_path):
    server, client = api
    ring = plane.sharding.ShardRing(2)
    hosts, gangs = _shard_fixture(plane, server, ring)
    admitted = {s: plane.metrics.SHARD_ADMITTED.get(shard=str(s)) for s in (0, 1)}
    adms = [_shard_admission(plane, client, tmp_path, ring, s) for s in (0, 1)]
    for s, adm in enumerate(adms):
        assert adm.tick() == [("default", gangs[s])]
        assert set(adm.reservations.held_by_host()) == {hosts[s]}
        assert plane.metrics.SHARD_ADMITTED.get(shard=str(s)) == admitted[s] + 1
    for s in (0, 1):
        for i in range(2):
            assert plane.gang.GATE_NAME not in gates_of(server, "default", f"{gangs[s]}-w{i}")
    pre_kill = [adm.reservations.export_state() for adm in adms]
    for adm in adms:
        adm.journal.flush()  # the process then dies: no stop(), no compaction
    for s in (0, 1):
        fresh = _shard_admission(plane, client, tmp_path, ring, s)
        assert fresh.recover()["holds_restored"] == 1
        got, want = fresh.reservations.export_state(), pre_kill[s]
        assert set(got) == set(want)
        for key in want:
            assert got[key]["hosts"] == want[key]["hosts"]
            assert got[key]["counted"] == want[key]["counted"]
            assert abs(got[key]["age_s"] - want[key]["age_s"]) < 2.0
        fresh.journal.close()


def test_gang_filter_scopes_dirty_marks_and_collect(plane, api, tmp_path):
    server, client = api
    ring = plane.sharding.ShardRing(2)
    _, gangs = _shard_fixture(plane, server, ring)
    adm0 = _shard_admission(plane, client, tmp_path, ring, 0)
    adm0.note_pod_event(gang_pod(plane, f"{gangs[1]}-w0", gangs[1], 2, 2))
    assert adm0._dirty == set()
    adm0.note_pod_event(gang_pod(plane, f"{gangs[0]}-w0", gangs[0], 2, 2))
    assert adm0._dirty == {("default", gangs[0])}
    assert set(adm0._collect_gangs()) == {("default", gangs[0])}
    adm0.journal.close()


# ---------------------------------------------------------------------------
# /readyz, /debug/shards
# ---------------------------------------------------------------------------


def test_readyz_carries_shard_payload(plane, api):
    _, client = api
    m = _manager(plane, client, home=0)
    m._adopt_shard(0, reason="home")
    try:
        status = plane.server.ReadyStatus(threading.Event(), shard_status=m.status)
        status.mark_ready()
        snap = status.snapshot()
        assert snap["ok"] is True
        assert snap["shard"]["shards"] == 2 and snap["shard"]["home"] == 0
        assert snap["shard"]["owned"] == [0]
        assert snap["shard"]["phases"]["0"]["phase"] == "ready"
        assert snap["shard"]["takeovers"] == 0
    finally:
        m.stop()


def test_debug_shards_endpoint(plane, api):
    _, client = api
    m = _manager(plane, client, home=1)
    m._adopt_shard(1, reason="home")
    try:
        plane.metrics.SHARD_PROVIDER = m.status
        body = json.loads(plane.metrics.debug_payload("/debug/shards"))
        assert body["owned"] == [1]
        assert body["shard_phases"]["1"]["phase"] == "ready"
    finally:
        plane.metrics.SHARD_PROVIDER = None
        m.stop()
    body = json.loads(plane.metrics.debug_payload("/debug/shards"))
    assert body == {"configured": False, "note": body["note"]} and "not wired" in body["note"]


def test_debug_index_lists_shards_endpoint(plane):
    body = json.loads(plane.metrics.debug_payload("/debug"))
    assert "/debug/shards" in body["endpoints"]


# ---------------------------------------------------------------------------
# the audit's ownership invariant
# ---------------------------------------------------------------------------


def _stub_manager(ring, tables):
    return types.SimpleNamespace(ring=ring, shard_tables=lambda: tables)


def _host_index(*hosts):
    """An index whose entries are standalone hosts (slice_key None)."""
    entries = [types.SimpleNamespace(hostname=h, slice_key=None) for h in hosts]
    return types.SimpleNamespace(entries=lambda: entries)


def test_audit_shard_ownership_clean_and_registered(plane):
    ring = plane.sharding.ShardRing(2)
    host0 = plane.pick_key(ring, 0, "h-{0:04d}")
    t0 = plane.reservations.ReservationTable()
    t0.reserve(("default", "g"), {host0: 2})
    ea = plane.audit.ExtenderAudit(index=_host_index(host0),
                                   shard_manager=_stub_manager(ring, [(0, t0)]))
    assert "reservation_shard_ownership" in [i.name for i in ea.invariants()]
    assert ea.check_shard_ownership() == []


def test_audit_flags_hold_on_foreign_shards_capacity(plane):
    ring = plane.sharding.ShardRing(2)
    host1 = plane.pick_key(ring, 1, "h-{0:04d}")
    t0 = plane.reservations.ReservationTable()
    t0.reserve(("default", "g"), {host1: 2})
    ea = plane.audit.ExtenderAudit(index=_host_index(host1),
                                   shard_manager=_stub_manager(ring, [(0, t0)]))
    (f,) = ea.check_shard_ownership()
    assert f.severity == plane.audit.CRITICAL
    assert f.node == host1
    assert dict(f.details)["owner_shard"] == "1"


def test_audit_flags_host_held_by_two_shards(plane):
    ring = plane.sharding.ShardRing(2)
    host0 = plane.pick_key(ring, 0, "h-{0:04d}")
    t0, t1 = plane.reservations.ReservationTable(), plane.reservations.ReservationTable()
    t0.reserve(("default", "a"), {host0: 2})
    t1.reserve(("default", "b"), {host0: 1})
    ea = plane.audit.ExtenderAudit(index=_host_index(host0),
                                   shard_manager=_stub_manager(ring, [(0, t0), (1, t1)]))
    findings = ea.check_shard_ownership()
    assert {f.severity for f in findings} == {plane.audit.CRITICAL}
    assert any("two shards" in f.message for f in findings)


def test_audit_unresolvable_host_skips_ownership_not_pages(plane):
    ring = plane.sharding.ShardRing(2)
    host1 = plane.pick_key(ring, 1, "h-{0:04d}")
    t0 = plane.reservations.ReservationTable()
    t0.reserve(("default", "g"), {host1: 2})
    ea = plane.audit.ExtenderAudit(shard_manager=_stub_manager(ring, [(0, t0)]))
    assert ea.check_shard_ownership() == []
    t1 = plane.reservations.ReservationTable()
    t1.reserve(("default", "h"), {host1: 1})
    ea2 = plane.audit.ExtenderAudit(shard_manager=_stub_manager(ring, [(0, t0), (1, t1)]))
    (f,) = ea2.check_shard_ownership()
    assert "two shards" in f.message


def test_audit_resolves_every_held_host_by_its_hostname():
    """In place of the JAX slice-member case: with the index wired, each held
    host is audited against its own hostname's shard, one node at a time
    (a GPU node forms no slice: every entry's ``slice_key`` is None)."""
    from k8s_device_plugin_tpu_torch import audit
    from k8s_device_plugin_tpu_torch.extender.reservations import ReservationTable

    ring = torch_sharding.ShardRing(3)
    hosts = [f"gpu-node-{i}" for i in range(12)]
    table = {s: ReservationTable() for s in range(3)}
    for i, h in enumerate(hosts):
        table[ring.shard_of(h)].reserve(("default", f"g{i}"), {h: 2})
    ea = audit.ExtenderAudit(index=_host_index(*hosts),
                             shard_manager=_stub_manager(ring, sorted(table.items())))
    assert ea.check_shard_ownership() == []
    wrong = {s: table[(s + 1) % 3] for s in range(3)}
    ea2 = audit.ExtenderAudit(index=_host_index(*hosts),
                              shard_manager=_stub_manager(ring, sorted(wrong.items())))
    assert sorted(f.node for f in ea2.check_shard_ownership()) == sorted(hosts)


def test_sharding_docs_in_lockstep():
    """The port's README runbook and manifest name the real flags, keys and
    surfaces."""
    readme = open(os.path.join(ROOT, "README.md")).read()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    for word in ("--shards", "--shard-index", "--no-shard-takeover",
                 torch_sharding.HOLDS_ANNOTATION, "shard-<k>",
                 "k8s_device_plugin_tpu_torch.extender.sharding --shard-self-test",
                 "k8s_device_plugin_tpu_torch.extender.scale_bench --shard-scaling",
                 "/debug/shards", "tpu_extender_shard_owned", "StatefulSet"):
        assert word in port, word
    manifest = open(os.path.join(ROOT, "deploy", "nvidia-extender-torch.yml")).read()
    assert '"--shards", "1"' in manifest
    assert "StatefulSet" in manifest and "nvidia-scheduler-extender" in manifest


# ---------------------------------------------------------------------------
# the entry point, sharded
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kubeconfig(tmp_path, url) -> str:
    kc = tmp_path / "kc.json"
    kc.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "c", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {}}],
        "contexts": [{"name": "x", "context": {"cluster": "c", "user": "u"}}],
        "current-context": "x"}))
    return str(kc)


def test_sharded_entry_point_serves_its_home_shard_and_releases_it(layouts, tmp_path):
    """``--shards 2`` with the home from HOSTNAME's ordinal: /readyz carries
    the shard payload, /debug/shards the manager's status, the shard's
    gauge reads 1, and SIGTERM exits 0 with the lease released;
    ``--no-singleton-lease`` with it is refused (exit 2)."""
    api = FakeApiServer()
    url = api.start()
    plane = TorchPlane(layouts["grid4"])
    api.add_node("n1", plane.node("n1"))
    kc = _kubeconfig(tmp_path, url)
    port = _free_port()
    cmd = [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--host", "127.0.0.1",
           "--kubeconfig", kc, "--node-cache", "--gang-admission", "--shards", "2",
           "--journal-dir", str(tmp_path / "j"), "--lease-seconds", "6"]
    env = dict(os.environ, HOSTNAME="nvidia-scheduler-extender-1")
    proc = subprocess.Popen([*cmd, "--port", str(port)], cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 30
        while True:
            try:
                r = requests.get(f"{base}/readyz", timeout=2)
                if r.status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.1)
        shard = r.json()["shard"]
        assert (shard["shards"], shard["home"], shard["owned"]) == (2, 1, [1])
        assert requests.get(f"{base}/debug/shards", timeout=5).json()["owned"] == [1]
        assert 'tpu_extender_shard_owned{shard="1"} 1' in requests.get(
            f"{base}/metrics", timeout=5).text
        assert (tmp_path / "j" / "shard-1").is_dir()
        lease = ("kube-system", "nvidia-scheduler-extender-shard-1")
        assert api.leases[lease]["spec"]["holderIdentity"] == "nvidia-scheduler-extender-1"
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        refused = subprocess.run([*cmd, "--port", str(_free_port()), "--no-singleton-lease"],
                                 cwd=ROOT, env=env, capture_output=True, timeout=60)
        api.stop()
    assert rc == 0
    assert api.leases[lease]["spec"]["holderIdentity"] == ""
    assert refused.returncode == 2
