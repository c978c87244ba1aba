"""The port's crash-consistent admission state (utils/statestore.StateStore,
extender/journal.py) against the JAX one.

The scenarios of the JAX ``tests/test_journal.py`` are tests parametrised
over the two planes of tests/torch_extender_planes.py: the store's format,
torn tails and corruption (fuzzed), compaction's atomicity, the replay's
semantics, the reservation table's observer and age-keeping restore, gang
admission's recovery and the /readyz gate. Each of the JAX file's 41
tests has a case; ``test_journal_overhead_probe_schema`` runs the port's
scale bench (extender/scale_bench.py) under the JAX bounds, and
``test_crash_recovery_docs_in_lockstep`` holds the port's own documents and
manifest.

Across the planes: a journal and snapshot written by either plane replay in
the other to an equal ``RehydratedState``, and the store's records are the
same bytes.
"""

import json
import os
import time
import zlib

import pytest
import requests

from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.torch_extender_planes import (
    JaxPlane,
    TorchPlane,
    gang_pod,
    gates_of,
    port_lockdep_acyclic,  # noqa: F401 - the autouse lockdep gate
    read_layouts,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("journal_nvml")
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


def journal_ops(path) -> list:
    raw = open(path, "rb").read().decode()
    return [json.loads(ln.split(" ", 1)[1])["op"] for ln in raw.splitlines() if ln]


# ---------------------------------------------------------------------------
# statestore: format, torn tails, corruption, compaction
# ---------------------------------------------------------------------------


def test_append_load_roundtrip(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a", "x": 1}, flush=True)
    st.append({"op": "b"}, flush=True)
    st.close()
    out = ss.StateStore(str(tmp_path)).load()
    assert out.status == ss.CLEAN
    assert [r["op"] for r in out.records] == ["a", "b"]
    assert [r["seq"] for r in out.records] == [1, 2]
    assert out.seq == 2


def test_empty_store_reads_empty(plane, tmp_path):
    out = plane.statestore.StateStore(str(tmp_path)).load()
    assert out.status == plane.statestore.EMPTY
    assert out.snapshot is None and out.records == []


def test_buffered_appends_surface_after_flush(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=False)
    st.flush()
    assert [r["op"] for r in ss.StateStore(str(tmp_path)).load().records] == ["a"]
    st.close()


def test_torn_tail_keeps_durable_prefix(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    st.append({"op": "b"}, flush=True)
    st.close()
    path = os.path.join(str(tmp_path), "admission.journal")
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 5)
    out = ss.StateStore(str(tmp_path)).load()
    assert out.status == ss.TORN_TAIL
    assert [r["op"] for r in out.records] == ["a"]
    assert out.dropped == 1


def test_bitflip_stops_replay_at_corruption(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    for op in ("a", "b", "c"):
        st.append({"op": op}, flush=True)
    st.close()
    path = os.path.join(str(tmp_path), "admission.journal")
    data = bytearray(open(path, "rb").read())
    data[len(bytes(data).split(b"\n")[0]) + 1 + 12] ^= 0xFF  # inside record 2
    open(path, "wb").write(bytes(data))
    out = ss.StateStore(str(tmp_path)).load()
    assert out.status == ss.CORRUPT
    assert [r["op"] for r in out.records] == ["a"]
    assert out.dropped == 2


def test_journal_fuzz_truncation_never_crashes(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    for i in range(6):
        st.append({"op": f"op{i}", "i": i}, flush=True)
    st.close()
    path = os.path.join(str(tmp_path), "admission.journal")
    full = open(path, "rb").read()
    for cut in range(len(full)):
        open(path, "wb").write(full[:cut])
        ids = [r["i"] for r in ss.StateStore(str(tmp_path)).load().records]
        assert ids == list(range(len(ids))), f"not a prefix at cut={cut}"


def test_journal_fuzz_bitflip_never_crashes(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    for i in range(4):
        st.append({"op": f"op{i}", "i": i}, flush=True)
    st.close()
    path = os.path.join(str(tmp_path), "admission.journal")
    full = bytearray(open(path, "rb").read())
    for pos in range(len(full)):
        mutated = bytearray(full)
        mutated[pos] ^= 0x41
        open(path, "wb").write(bytes(mutated))
        ids = [r.get("i") for r in ss.StateStore(str(tmp_path)).load().records]
        assert ids == list(range(len(ids)))


def test_append_after_damaged_load_stays_readable(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    st.append({"op": "b"}, flush=True)
    st.close()
    path = os.path.join(str(tmp_path), "admission.journal")
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 5)
    st2 = ss.StateStore(str(tmp_path))
    assert st2.load().status == ss.TORN_TAIL  # heals the tail
    st2.append({"op": "c"}, flush=True)
    st2.close()
    out = ss.StateStore(str(tmp_path)).load()
    assert out.status == ss.CLEAN
    assert [r["op"] for r in out.records] == ["a", "c"]


def test_compact_preserves_records_newer_than_captured_seq(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    seq = st.current_seq()
    st.append({"op": "raced"}, flush=True)
    st.compact({"covers": "a only"}, seq=seq)
    st.close()
    out = ss.StateStore(str(tmp_path)).load()
    assert out.snapshot == {"covers": "a only"}
    assert [r["op"] for r in out.records] == ["raced"]


def test_compact_sees_buffered_records_in_keep_scan(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    seq = st.current_seq()
    st.append({"op": "buffered-race"}, flush=False)
    st.compact({"covers": "a only"}, seq=seq)
    st.close()
    assert [r["op"] for r in ss.StateStore(str(tmp_path)).load().records] == ["buffered-race"]


def test_compaction_roundtrip_and_truncation(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    st.compact({"state": ["x"]})
    assert st.size_bytes() == 0
    st.append({"op": "b"}, flush=True)
    st.close()
    out = ss.StateStore(str(tmp_path)).load()
    assert out.snapshot == {"state": ["x"]}
    assert [r["op"] for r in out.records] == ["b"]
    assert out.status == ss.CLEAN


def test_crash_between_rename_and_truncate_replays_idempotently(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    st.append({"op": "b"}, flush=True)
    path = os.path.join(str(tmp_path), "admission.journal")
    journal_bytes = open(path, "rb").read()
    st.compact({"covered": True})
    st.close()
    open(path, "wb").write(journal_bytes)  # the truncate never happened
    out = ss.StateStore(str(tmp_path)).load()
    assert out.snapshot == {"covered": True}
    assert out.records == []


def test_crash_mid_compaction_leaves_old_snapshot_authoritative(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    st.compact({"gen": 1})
    st.append({"op": "b"}, flush=True)
    open(st.snapshot_path + ".tmp", "w").write('{"gen": 2, "junk": ')
    st.close()
    out = ss.StateStore(str(tmp_path)).load()
    assert out.snapshot == {"gen": 1}
    assert [r["op"] for r in out.records] == ["b"]
    assert not os.path.exists(st.snapshot_path + ".tmp")


def test_corrupt_snapshot_checksum_is_ignored(plane, tmp_path):
    ss = plane.statestore
    st = ss.StateStore(str(tmp_path))
    st.append({"op": "a"}, flush=True)
    st.compact({"gen": 1})
    st.append({"op": "b"}, flush=True)
    st.close()
    doc = json.load(open(st.snapshot_path))
    doc["data"] = {"gen": "tampered"}
    json.dump(doc, open(st.snapshot_path, "w"))
    out = ss.StateStore(str(tmp_path)).load()
    assert out.status == ss.SNAPSHOT_CORRUPT
    assert out.snapshot is None
    assert [r["op"] for r in out.records] == ["b"]


def test_record_crc_is_real(plane):
    line = plane.statestore.encode_record({"op": "a", "seq": 1})
    crc, payload = line.rstrip(b"\n").split(b" ", 1)
    assert int(crc, 16) == zlib.crc32(payload) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# AdmissionJournal replay semantics
# ---------------------------------------------------------------------------


def test_replay_reserve_shrink_drop_lapse(plane, tmp_path):
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    a, b = ("ns", "a"), ("ns", "b")
    j.record("reserve", a, hosts={"n1": 4}, demands=[2, 2], age_s=0.0)
    j.record("shrink", a, pod="w0", host="n1", chips=2)
    j.record("shrink", a, pod="w0", host="n1", chips=2)  # a replayed event
    j.record("reserve", b, hosts={"n2": 2}, demands=[2], age_s=0.0)
    j.record("lapse", b)
    j.record("renew", a)
    j.close()
    st = jr.AdmissionJournal(str(tmp_path)).replay()
    assert st.holds[a].hosts == {"n1": 2}
    assert b not in st.holds
    assert st.lapsed == {b}
    assert st.status == plane.statestore.CLEAN


def test_replay_reserve_clears_predecessor_lapse_bar(plane, tmp_path):
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    key = ("ns", "g")
    j.record("reserve", key, hosts={"n1": 2}, demands=[2], age_s=0.0)
    j.record("lapse", key)
    j.record("reserve", key, hosts={"n1": 2}, demands=[2], age_s=0.0)
    j.close()
    st = jr.AdmissionJournal(str(tmp_path)).replay()
    assert key in st.holds and key not in st.lapsed


def test_replay_preserves_age_through_reserve_record(plane, tmp_path):
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path), clock=FakeClock(5000.0))
    key = ("ns", "g")
    j.record("reserve", key, hosts={"n1": 2}, demands=[2], age_s=120.0)
    j.close()
    st = jr.AdmissionJournal(str(tmp_path)).replay()
    assert st.holds[key].created_ts == pytest.approx(4880.0, abs=0.1)
    assert st.holds[key].age_s(now=5010.0) == pytest.approx(130.0, abs=0.1)


def test_replay_wait_episodes(plane, tmp_path):
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    a, b = ("ns", "a"), ("ns", "b")
    j.record("wait", a, since=100.0)
    j.record("wait", b, since=200.0)
    j.record("wait_clear", b)
    j.close()
    assert jr.AdmissionJournal(str(tmp_path)).replay().waiting_since == {a: 100.0}


def test_journal_compaction_snapshot_roundtrip(plane, tmp_path):
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    key = ("ns", "g")
    j.record("reserve", key, hosts={"n1": 4}, demands=[4], age_s=0.0)
    st = j.replay()
    j.compact(jr.AdmissionJournal.state_data(st.holds, {("ns", "dead")},
                                             {("ns", "slow"): 42.0}))
    j.record("shrink", key, pod="w0", host="n1", chips=4)
    j.close()
    st2 = jr.AdmissionJournal(str(tmp_path)).replay()
    assert key not in st2.holds
    assert st2.lapsed == {("ns", "dead")}
    assert st2.waiting_since == {("ns", "slow"): 42.0}


def test_journal_append_failure_degrades_not_raises(plane, tmp_path):
    j = plane.journal.AdmissionJournal(str(tmp_path))
    j.record("reserve", ("ns", "g"), hosts={"n1": 1}, age_s=0.0)
    j.close()
    j.store.dir = str(tmp_path / "gone")
    j.store.journal_path = os.path.join(str(tmp_path), "nope", "x.j")
    j.record("renew", ("ns", "g"))  # swallowed and counted


def test_self_test_smoke(plane, capsys):
    assert plane.journal.self_test() == 0
    assert json.loads(capsys.readouterr().out) == {"journal_self_test": "ok"}


# ---------------------------------------------------------------------------
# the reservation table: observer and age-keeping restore
# ---------------------------------------------------------------------------


def test_observer_sees_every_mutation_kind(plane):
    clock = FakeClock()
    t = plane.reservations.ReservationTable(ttl_s=10, max_age_s=25, clock=clock)
    seen = []
    t.observer = lambda op, key, payload: seen.append((op, key, payload))
    key = ("ns", "g")
    t.reserve(key, {"n1": 4}, demands=(2, 2))
    t.note_scheduled(key, "w0", "n1", 2)
    t.renew(key)
    t.drop(key)
    assert [s[0] for s in seen] == ["reserve", "shrink", "renew", "drop"]
    assert seen[0][2]["hosts"] == {"n1": 4}
    assert seen[0][2]["age_s"] == 0.0
    assert seen[1][2] == {"pod": "w0", "host": "n1", "chips": 2}
    t.reserve(key, {"n1": 4})
    clock.t += 26
    t.lapse(key)
    assert seen[-1][0] == "lapse"


def test_observer_sees_prune_path_exits(plane):
    clock = FakeClock()
    t = plane.reservations.ReservationTable(ttl_s=10, max_age_s=25, clock=clock)
    seen = []
    t.observer = lambda op, key, payload: seen.append((op, key))
    t.reserve(("ns", "ttl"), {"n1": 1})
    clock.t += 11
    t.active()
    assert ("drop", ("ns", "ttl")) in seen
    t.reserve(("ns", "cap"), {"n1": 1})
    for _ in range(3):
        clock.t += 9
        t.renew(("ns", "cap"))
    clock.t += 9
    t.active()
    assert ("lapse", ("ns", "cap")) in seen


def test_renew_skip_if_remaining_suppresses_churn(plane):
    clock = FakeClock()
    t = plane.reservations.ReservationTable(ttl_s=60, max_age_s=300, clock=clock)
    seen = []
    t.observer = lambda op, key, payload: seen.append(op)
    t.reserve(("ns", "g"), {"n1": 1})
    assert t.renew(("ns", "g"), skip_if_remaining_s=15.0)
    assert seen == ["reserve"]
    clock.t += 50
    assert t.renew(("ns", "g"), skip_if_remaining_s=15.0)
    assert seen == ["reserve", "renew"]
    assert t.active()[("ns", "g")].expires_at == clock.t + 60


def test_restore_preserves_age_and_cap(plane):
    clock = FakeClock()
    t = plane.reservations.ReservationTable(ttl_s=10, max_age_s=100, clock=clock)
    key = ("ns", "g")
    assert t.restore(key, {"n1": 4}, age_s=60.0, demands=(4,))
    assert t.renew(key)
    assert t.active()[key].expires_at == clock.t + 10
    clock.t += 39
    assert t.renew(key)
    clock.t += 2
    assert not t.renew(key)
    t.lapse(key)
    assert t.drain_lapsed() == {key}


def test_restore_refuses_past_cap_age(plane):
    t = plane.reservations.ReservationTable(ttl_s=10, max_age_s=100, clock=FakeClock())
    assert not t.restore(("ns", "g"), {"n1": 4}, age_s=101.0)
    assert t.active() == {}


# ---------------------------------------------------------------------------
# gang admission's journal and recovery
# ---------------------------------------------------------------------------


def released_gang_setup(plane, server):
    server.add_node("n1", plane.node("n1"))
    for i in range(2):
        server.add_pod(gang_pod(plane, f"w{i}", "train", 2, 2))


def admission(plane, client, journal=None, table=None):
    return plane.gang.GangAdmission(
        client, reservations=table or plane.reservations.ReservationTable(), journal=journal)


def test_tick_journals_reserve_and_admit(plane, api, tmp_path):
    server, client = api
    released_gang_setup(plane, server)
    j = plane.journal.AdmissionJournal(str(tmp_path))
    adm = admission(plane, client, j)
    assert adm.tick() == [("default", "train")]
    ops = journal_ops(j.store.journal_path)
    assert "reserve" in ops and "admit" in ops
    assert ops.index("reserve") < ops.index("admit")
    j.close()


def test_recover_restores_holds_and_finishes_release(plane, api, tmp_path):
    server, client = api
    released_gang_setup(plane, server)
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    j.record("reserve", ("default", "train"), hosts={"n1": 4}, demands=[2, 2], age_s=0.0)
    j.record("admit", ("default", "train"), hosts={"n1": 4}, demands=[2, 2])
    j.close()
    table = plane.reservations.ReservationTable()
    adm = admission(plane, client, jr.AdmissionJournal(str(tmp_path)), table)
    assert adm.recover()["holds_restored"] == 1
    assert table.reserved_chips("n1") == 4
    assert adm.tick() == [("default", "train")]
    for i in range(2):
        assert plane.gang.GATE_NAME not in gates_of(server, "default", f"w{i}")
    adm.journal.close()


def test_recover_drops_holds_of_vanished_gangs(plane, api, tmp_path):
    server, client = api
    server.add_node("n1", plane.node("n1"))
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    j.record("reserve", ("default", "ghost"), hosts={"n1": 4}, demands=[4], age_s=0.0)
    j.close()
    table = plane.reservations.ReservationTable()
    adm = admission(plane, client, jr.AdmissionJournal(str(tmp_path)), table)
    assert adm.recover()["holds_dropped"] == 1
    assert table.active() == {}
    adm.journal.close()


def test_recover_without_cluster_truth_restores_conservatively(plane, api, tmp_path):
    server, client = api
    released_gang_setup(plane, server)
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    j.record("reserve", ("default", "train"), hosts={"n1": 4}, demands=[2, 2], age_s=0.0)
    j.close()
    server.faults.add(kind="status", status=503, times=100)
    table = plane.reservations.ReservationTable()
    client.timeout = 0.5
    adm = admission(plane, client, jr.AdmissionJournal(str(tmp_path)), table)
    assert adm.recover()["cluster_truth"] is False
    assert table.reserved_chips("n1") == 4
    adm.journal.close()


def test_recover_lapses_hold_aged_past_cap_while_dead(plane, api, tmp_path):
    server, client = api
    released_gang_setup(plane, server)
    jr = plane.journal
    old = jr.AdmissionJournal(str(tmp_path), clock=lambda: time.time() - 10000.0)
    old.record("reserve", ("default", "train"), hosts={"n1": 4}, demands=[2, 2], age_s=0.0)
    old.close()
    table = plane.reservations.ReservationTable()
    adm = admission(plane, client, jr.AdmissionJournal(str(tmp_path)), table)
    assert adm.recover()["holds_lapsed_on_restore"] == 1
    assert table.active() == {}
    assert ("default", "train") in adm._lapsed_gangs
    adm.journal.close()


def test_recover_restores_wait_clock(plane, api, tmp_path):
    server, client = api
    server.add_node("n1", plane.node("n1"))
    for i in range(2):
        server.add_pod(gang_pod(plane, f"s{i}", "starved", 2, 4))
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    t_wait = time.time() - 123.0
    j.record("wait", ("default", "starved"), since=t_wait)
    j.close()
    adm = admission(plane, client, jr.AdmissionJournal(str(tmp_path)))
    adm.recover()
    assert adm._waiting_since[("default", "starved")] == pytest.approx(t_wait, abs=0.01)
    assert (time.monotonic() - adm._first_complete[("default", "starved")]) == pytest.approx(
        123.0, abs=5.0)
    adm.journal.close()


def test_recover_disabled_without_journal(plane, api):
    _, client = api
    assert admission(plane, client).recover() == {"status": "disabled"}


def test_early_return_tick_still_flushes_buffered_records(plane, api, tmp_path):
    server, client = api
    released_gang_setup(plane, server)
    j = plane.journal.AdmissionJournal(str(tmp_path))
    adm = admission(plane, client, j)
    assert adm.tick() == [("default", "train")]
    for i in range(2):
        server.delete_pod("default", f"w{i}")
    adm.mark_dirty(("default", "train"))
    assert adm.tick(full=False) == []
    # The buffered drop is on disk already, with no close or flush here.
    assert "drop" in journal_ops(j.store.journal_path)
    j.close()


def test_recover_drops_fully_consumed_hold_without_lapse(plane, api, tmp_path):
    server, client = api
    released_gang_setup(plane, server)
    jr = plane.journal
    j = jr.AdmissionJournal(str(tmp_path))
    j.compact(jr.AdmissionJournal.state_data(
        {("default", "train"): jr.Hold(hosts={}, demands=(2, 2), counted_pods={"w0", "w1"},
                                       created_ts=0.0)},
        set(), {}))
    j.close()
    adm = admission(plane, client, jr.AdmissionJournal(str(tmp_path)))
    summary = adm.recover()
    assert summary["holds_lapsed_on_restore"] == 0
    assert summary["holds_dropped"] == 1
    assert ("default", "train") not in adm._lapsed_gangs
    adm.journal.close()


def test_lapse_bar_survives_dirty_tick_of_other_gangs(plane, api):
    server, client = api
    released_gang_setup(plane, server)
    adm = admission(plane, client)
    adm._lapsed_gangs.add(("default", "train"))
    server.add_pod(gang_pod(plane, "x0", "other", 2, 2))
    adm.mark_dirty(("default", "other"))
    adm.tick(full=False)
    assert ("default", "train") in adm._lapsed_gangs
    for name in ("w0", "w1"):
        server.delete_pod("default", name)
    adm.tick(full=True)
    assert ("default", "train") not in adm._lapsed_gangs


# ---------------------------------------------------------------------------
# the readiness gate
# ---------------------------------------------------------------------------


def test_readiness_gate_holds_filter_until_rehydrated(plane):
    state = {"ready": False}
    srv = plane.server.ExtenderHTTPServer(
        extender=plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable()),
        host="127.0.0.1", ready_check=lambda: state["ready"])
    url = srv.start()
    try:
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 200
        r = requests.get(f"{url}/readyz", timeout=5)
        assert r.status_code == 503
        assert "rehydrating" in r.json()["reason"]
        body = {"pod": {}, "nodes": {"items": [plane.node("n1")]}}
        r = requests.post(f"{url}/filter", json=body, timeout=5)
        assert r.status_code == 503
        assert "rehydrating" in r.json()["error"]
        assert requests.post(f"{url}/prioritize", json=body, timeout=5).status_code == 503
        state["ready"] = True
        assert requests.get(f"{url}/readyz", timeout=5).status_code == 200
        r = requests.post(f"{url}/filter", json=body, timeout=5)
        assert r.status_code == 200
        assert [n["metadata"]["name"] for n in r.json()["nodes"]["items"]] == ["n1"]
    finally:
        srv.stop()


def test_default_server_is_ready_immediately(plane):
    srv = plane.server.ExtenderHTTPServer(
        extender=plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable()),
        host="127.0.0.1")
    url = srv.start()
    try:
        assert requests.get(f"{url}/readyz", timeout=5).status_code == 200
    finally:
        srv.stop()


def test_journal_overhead_probe_schema():
    from k8s_device_plugin_tpu_torch.extender import scale_bench

    r = scale_bench.journal_overhead(n_nodes=30, n_gangs=5, tick_rounds=6)
    assert r["nodes"] == 30 and r["gangs"] == 5
    assert r["unjournaled"]["samples"] == 6
    assert r["journaled"]["samples"] == 6
    assert r["journal_bytes"] > 0
    assert "tick_p99_overhead_pct" in r
    # The JAX bound: journaled p99 <= 1.1x, with an absolute slack floor at
    # toy scale against a shared host's scheduler noise.
    assert r["journaled"]["p99_ms"] <= max(1.1 * r["unjournaled"]["p99_ms"],
                                           r["unjournaled"]["p99_ms"] + 2.0)


def test_crash_recovery_docs_in_lockstep():
    """The port's README names the journal's files, its self-test and its
    flags, and the port's manifest wires the journal and the readiness
    probe."""
    readme = open(os.path.join(ROOT, "README.md")).read()
    for word in ("admission.journal", "admission.snapshot.json", "--journal-dir",
                 "--journal-fsync", "k8s_device_plugin_tpu_torch.extender.journal --self-test",
                 "/readyz"):
        assert word in readme, word
    manifest = open(os.path.join(ROOT, "deploy", "nvidia-extender-torch.yml")).read()
    assert "--journal-dir" in manifest and "/readyz" in manifest


# ---------------------------------------------------------------------------
# across the planes
# ---------------------------------------------------------------------------


def _write_history(jr, d):
    """A history with every kind of record and a compaction between two
    stretches of the journal; the clock is fixed so both planes write the
    same timestamps."""
    clock = FakeClock(5000.0)
    j = jr.AdmissionJournal(d, clock=clock)
    a, b, c = ("ns", "a"), ("ns", "b"), ("other", "c")
    j.record("reserve", a, hosts={"n1": 4, "n2": 2}, demands=[2, 4], age_s=30.0, priority=5)
    j.record("admit", a, hosts={"n1": 4, "n2": 2}, demands=[2, 4])
    j.record("reserve", b, hosts={"n3": 1}, demands=[1], age_s=0.0)
    j.record("wait", c, since=4900.5)
    st = j.replay()
    j.compact(jr.AdmissionJournal.state_data(st.holds, st.lapsed, st.waiting_since,
                                             st.preempting, st.defragging, st.defrag_spend,
                                             st.rescuing))
    clock.t += 10
    j.record("shrink", a, pod="w0", host="n2", chips=2)
    j.record("renew", a)
    j.record("lapse", b)
    j.record("preempt_intent", c, victims=[["ns", "v"]], consumed={"n4": 8}, demands=[8])
    j.record("defrag_evicted", a, victims=[], consumed={"n1": 1}, demands=[1])
    j.record("defrag_spend", a, stamps=[4999.25])
    j.flush()
    j.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_journal_of_either_plane_replays_in_the_other(layouts, tmp_path, writer, reader):
    """A journal and snapshot written by one plane replay in the other to a
    RehydratedState equal to the writer's own replay, from the same bytes."""
    planes = {"jax": JaxPlane(), "torch": TorchPlane(layouts["grid4"])}
    wdir, rdir = str(tmp_path / "w"), str(tmp_path / "r")
    _write_history(planes[writer].journal, wdir)
    _write_history(planes[reader].journal, rdir)
    for name in ("admission.journal", "admission.snapshot.json"):
        with open(os.path.join(wdir, name), "rb") as fw, open(os.path.join(rdir, name),
                                                               "rb") as fr:
            assert fw.read() == fr.read(), name
    own = planes[writer].journal.AdmissionJournal(wdir).replay_readonly()
    other = planes[reader].journal.AdmissionJournal(wdir).replay_readonly()
    assert dataclasses_dict(other) == dataclasses_dict(own)
    assert own.holds[("ns", "a")].hosts == {"n1": 4}
    assert own.lapsed == {("ns", "b")}
    assert set(own.preempting) == {("other", "c")} and set(own.defragging) == {("ns", "a")}


def dataclasses_dict(state) -> dict:
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "holds":
            v = {k: dataclasses.asdict(h) for k, h in v.items()}
        out[f.name] = v
    return out


def test_concurrent_journaling_and_compaction_lose_no_hold(layouts, tmp_path):
    """More writer threads than cores mutate one journaled table (reserve,
    shrink, drop, as the tick and /filter's prunes do) while the main thread
    compacts with the state callable over and over, the switch interval
    shortened: a record truncated away by a compaction it raced would leave
    the replay unequal to the live table."""
    import sys
    import threading

    plane = TorchPlane(layouts["grid4"])
    j = plane.journal.AdmissionJournal(str(tmp_path), compact_every=1)
    table = plane.reservations.ReservationTable(ttl_s=600, max_age_s=1200)
    table.observer = j.observe
    errors = []

    def writer(w):
        try:
            for i in range(60):
                key = ("ns", f"g{w}-{i}")
                table.reserve(key, {f"n{w}": 4, f"m{i % 3}": 2}, demands=(2, 2, 2))
                table.note_scheduled(key, "p0", f"n{w}", 2)
                if i % 3 == 0:
                    table.drop(key)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def state():
        now = time.time()
        return plane.journal.AdmissionJournal.state_data(
            {k: plane.journal.Hold(hosts=st["hosts"], demands=tuple(st["demands"]),
                                   counted_pods=set(st["counted"]),
                                   created_ts=now - st["age_s"])
             for k, st in table.export_state().items()}, set(), {})

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(2 * os.cpu_count())]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            j.maybe_compact(state)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    j.flush()
    replayed = {k: h.hosts for k, h in j.replay_readonly().holds.items()}
    live = {k: st["hosts"] for k, st in table.export_state().items()}
    assert replayed == live
    assert len(live) == 2 * os.cpu_count() * 40
    j.close()
