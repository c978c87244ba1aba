"""The port's reservation table (extender/reservations.py) against the JAX
one, and the /filter shield it feeds.

The table's own cases of the JAX ``tests/test_reservations.py`` run on both
planes' tables (tests/torch_extender_planes.py), plus the rest of its
surface that this slice serves: age-preserving restores, the skip-renew
window, lapses, the journal observer's records and the /reservations
snapshot. A reservation then withholds cards from every other gang's
/filter and /prioritize, on the object and the name-only paths alike, and
never from its own gang. The cases that need ``GangAdmission``
(``test_release_reserves_before_gates_and_filter_enforces`` and the rest)
wait for it: gang admission is the extender's next slice.
"""

import pytest

from tests import torch_fake_nvml as fk
from tests.torch_extender_planes import JaxPlane, ListClient, TorchPlane, pod, read_layouts


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("res_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


def test_reserve_and_exclusion(plane):
    t = plane.reservations.ReservationTable()
    t.reserve(("ns", "g1"), {"n1": 2, "n2": 4})
    assert (t.reserved_chips("n1"), t.reserved_chips("n2"), t.reserved_chips("n3")) == (2, 4, 0)
    assert t.reserved_chips("n1", exclude=("ns", "g1")) == 0
    t.reserve(("ns", "g2"), {"n1": 1})
    assert t.reserved_chips("n1") == 3
    assert t.reserved_chips("n1", exclude=("ns", "g1")) == 1
    assert t.held_by_host(exclude=("ns", "g2")) == {"n1": 2, "n2": 4}


def test_note_scheduled_shrinks_idempotently(plane):
    t = plane.reservations.ReservationTable()
    t.reserve(("ns", "g"), {"n1": 3})
    t.note_scheduled(("ns", "g"), "pod-a", "n1", 2)
    assert t.reserved_chips("n1") == 1
    t.note_scheduled(("ns", "g"), "pod-a", "n1", 2)  # a replayed event
    assert t.reserved_chips("n1") == 1
    t.note_scheduled(("ns", "g"), "pod-b", "elsewhere", 1)
    assert t.reserved_chips("n1") == 1
    t.note_scheduled(("ns", "g"), "pod-c", "n1", 1)
    assert t.reserved_chips("n1") == 0
    assert t.active() == {}


def test_ttl_expiry_and_hard_age_cap(plane):
    clock = FakeClock()
    t = plane.reservations.ReservationTable(ttl_s=10, max_age_s=25, clock=clock)
    t.reserve(("ns", "g"), {"n1": 4})
    clock.t += 9
    assert t.renew(("ns", "g"))
    clock.t += 9
    assert t.reserved_chips("n1") == 4
    clock.t += 8  # age 26: past the cap
    assert not t.renew(("ns", "g"))
    assert t.reserved_chips("n1") == 0
    assert t.lapsed_total == 1
    t.reserve(("ns", "g2"), {"n1": 1})
    clock.t += 11
    assert t.reserved_chips("n1") == 0


def test_restore_keeps_the_age_and_the_observer_sees_every_transition(plane):
    """The surface the admission journal will ride: the same records, in
    the same order, with the same payloads on both planes."""
    clock = FakeClock()
    t = plane.reservations.ReservationTable(ttl_s=10, max_age_s=25, clock=clock)
    seen = []
    t.observer = lambda op, gang, payload: seen.append((op, gang, payload))
    assert not t.restore(("ns", "old"), {"n1": 1}, age_s=30)  # past the cap
    assert t.restore(("ns", "g"), {"n1": 2, "n2": 0}, age_s=20, demands=(2, 1),
                     counted_pods={"p0"}, priority=5)
    assert t.renew(("ns", "g"), skip_if_remaining_s=1.0)  # runway left: no record
    clock.t += 4.5
    assert t.renew(("ns", "g"))
    t.note_scheduled(("ns", "g"), "p1", "n1", 1)
    clock.t += 1  # age 25.5: lapses in the next prune
    assert t.active() == {}
    assert t.drain_lapsed() == {("ns", "g")}
    t.reserve(("ns", "h"), {"n3": 1})
    t.drop(("ns", "h"))
    assert [op for op, _, _ in seen] == ["reserve", "renew", "shrink", "lapse", "reserve", "drop"]
    assert seen[0][2] == {"hosts": {"n1": 2}, "demands": [1, 2], "counted": ["p0"],
                          "age_s": 20.0, "priority": 5}
    assert seen[2][2] == {"pod": "p1", "host": "n1", "chips": 1}


def test_snapshot_orders_by_priority_and_loads_back(plane):
    clock = FakeClock()
    t = plane.reservations.ReservationTable(clock=clock)
    t.reserve(("ns", "low"), {"n1": 1}, priority=-1)
    t.reserve(("ns", "high"), {"n2": 2}, priority=10)
    snap = t.snapshot()
    assert [(e["gang"], e["priority"], e["hosts"]) for e in snap] == [
        ("high", 10, {"n2": 2}), ("low", -1, {"n1": 1})]
    u = plane.reservations.ReservationTable()
    u.load_snapshot(snap)
    assert u.held_by_host() == {"n1": 1, "n2": 2}
    assert set(t.export_state()) == {("ns", "low"), ("ns", "high")}


@pytest.mark.parametrize("names_only", [False, True])
def test_filter_withholds_reserved_cards_from_other_gangs(plane, names_only):
    nodes = [plane.node("n-free"), plane.node("n-three", (0, 1, 2))]
    names = [n["metadata"]["name"] for n in nodes]
    table = plane.reservations.ReservationTable()
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600)
    cache.refresh()
    ext = plane.server.TopologyExtender(reservations=table, node_cache=cache)

    def run(p):
        if names_only:
            return ext.filter_names(p, names), ext.prioritize_names(p, names)
        passing, failed = ext.filter(p, [dict(n) for n in nodes])
        return ([n["metadata"]["name"] for n in passing], failed), ext.prioritize(p, nodes)

    (passing, failed), _ = run(pod(plane, 3))
    assert passing == ["n-free", "n-three"]
    # A released gang holds one card of n-three: a 3-card pod of another
    # gang no longer fits there, and scores 0 on it.
    table.reserve(("default", "g"), {"n-three": 1})
    (passing, failed), scores = run(pod(plane, 3, gang=("other", 2)))
    assert passing == ["n-free"]
    assert failed == {"n-three": "2 chips available, 3 needed (1 reserved for a released gang)"}
    assert {s["host"]: s["score"] for s in scores}["n-three"] == 0
    # The hold is for its own gang's pods: they still pass.
    (passing, _), scores = run(pod(plane, 3, gang=("g", 2)))
    assert passing == ["n-free", "n-three"]
    assert {s["host"]: s["score"] for s in scores}["n-three"] > 0
    # Shielding the cache's shared entry never mutates it.
    assert cache.index.get("n-three").avail == 3
