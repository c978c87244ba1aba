"""The port's priority tiers and preemption (extender/preemption.py) against
the JAX one.

The tests of the JAX ``tests/test_preemption.py`` are parametrised over the
two planes of tests/torch_extender_planes.py wherever a plane drives them:
``jax`` (v5p hosts of 4 chips) and ``torch`` (4-card H100 hosts of the fake
NVML whose NVLinks join the v5p host's ICI pairs), each against its own fake
API server. Card i stands for chip i. The eviction door is held to all three
of its outcomes (405: the plain delete; 429 and 403: a refusal, no delete).
``explain --evicted`` renders both planes' ledger records through the port's
``tools.explain.render_evicted``. The victim's Event is ``TPUGangPreempted``
on the JAX plane and ``GPUGangPreempted`` on the port's.

Port only: the planner makes the same plan (victims, freed and consumed
cards) on both planes over seeded random clusters, at the member sizes where
the two capacity pools agree (1, 2 and 4 of a 4-card node, as the gang
parity case of tests/test_torch_gang.py chooses them); ``credited_topos``
credits a failed card back as JAX does (the optimistic credit, pinned); and
the module's ``--self-test``.
"""

import importlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from k8s_device_plugin_tpu_torch.extender.sharding import ShardRing
from k8s_device_plugin_tpu_torch.tools.explain import render_evicted
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

# The victim's kube Event, by plane.
VICTIM_EVENT = {"jax": "TPUGangPreempted", "torch": "GPUGangPreempted"}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("preemption_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


@pytest.fixture
def api(plane):
    s = FakeApiServer()
    url = s.start()
    yield s, plane.KubeClient(url), url
    s.stop()


def ledger(plane):
    if plane.name == "jax":
        from k8s_device_plugin_tpu.utils.decisions import LEDGER
    else:
        from k8s_device_plugin_tpu_torch.utils.decisions import LEDGER
    return LEDGER


def running_gang_pod(plane, name, gang, size, cards, node, priority=None, ckpt_ts=None,
                     ns="default"):
    """A placed (running, ungated) gang member: preemption's victim shape."""
    p = gang_pod(plane, name, gang, size, cards, ns=ns)
    p["spec"]["schedulingGates"] = []
    p["spec"]["nodeName"] = node
    p["metadata"]["uid"] = f"uid-{name}"
    if priority is not None:
        p["spec"]["priority"] = priority
    if ckpt_ts is not None:
        p["metadata"].setdefault("annotations", {})[
            plane.constants.CHECKPOINT_TS_ANNOTATION] = str(ckpt_ts)
    return p


def full_node(plane, server, name):
    """A node whose published availability is zero (every card held)."""
    server.add_node(name, plane.node(name, []))


def admission(plane, client):
    return plane.gang.GangAdmission(client, reservations=plane.reservations.ReservationTable())


def wire(plane, adm, client):
    resolver = plane.preemption.PriorityResolver(client)
    adm.priority_resolver = resolver
    adm.preemption = plane.preemption.PreemptionEngine(adm, resolver)
    return adm.preemption


# ---------------------------------------------------------------------------
# tiers and the resolver
# ---------------------------------------------------------------------------


def test_tier_label_thresholds(plane):
    tier_label = plane.preemption.tier_label
    assert tier_label(2_000_000_000) == "critical"
    assert tier_label(1_000_000) == "critical"
    assert tier_label(100_000) == "high"
    assert tier_label(1_000) == "high"
    assert tier_label(999) == "standard"
    assert tier_label(0) == "standard"
    assert tier_label(-1) == "batch"


def test_priority_resolver_resolves_priorityclass(plane, api):
    server, client, _ = api
    server.add_priority_class("prod-inference", 100000)
    server.add_priority_class("batch", -10, global_default=True)
    r = plane.preemption.PriorityResolver(client)
    p = pod(plane, 2)
    # spec.priority wins outright (the admission chain resolved it).
    p["spec"]["priority"] = 7
    assert r.pod_priority(p) == 7
    del p["spec"]["priority"]
    p["spec"]["priorityClassName"] = "prod-inference"
    assert r.pod_priority(p) == 100000
    # No class, no priority: the cluster's globalDefault.
    del p["spec"]["priorityClassName"]
    assert r.pod_priority(p) == -10
    # An unknown class name reads as the default, never raises.
    p["spec"]["priorityClassName"] = "no-such-class"
    assert r.pod_priority(p) == -10
    # A gang's priority is its members' maximum.
    hi = pod(plane, 2)
    hi["spec"]["priority"] = 50
    assert r.gang_priority([p, hi]) == 50


def test_priority_resolver_without_client(plane):
    r = plane.preemption.PriorityResolver(None)
    p = pod(plane, 1)
    assert r.pod_priority(p) == 0
    p["spec"]["priority"] = -5
    assert r.pod_priority(p) == -5


def test_priority_resolver_refreshes_on_a_miss(plane, api):
    """A class created after the first listing is found on the next miss
    once the 30 s miss window has passed, not before; a known class costs no
    request."""
    server, client, _ = api
    now = [0.0]
    lists = []
    real = client.list_priority_classes

    def counted():
        lists.append(now[0])
        return real()

    client.list_priority_classes = counted
    server.add_priority_class("gold", 5000)
    r = plane.preemption.PriorityResolver(client, clock=lambda: now[0])
    assert r.class_value("gold") == 5000
    server.add_priority_class("platinum", 9000)
    now[0] = 10.0
    assert r.class_value("platinum") is None  # inside the miss window
    now[0] = 31.0
    assert r.class_value("platinum") == 9000
    assert r.class_value("gold") == 5000
    assert lists == [0.0, 31.0]


# ---------------------------------------------------------------------------
# the fake API server's PriorityClass and pod DELETE endpoints
# ---------------------------------------------------------------------------


def test_fake_apiserver_priorityclass_endpoints(plane, api):
    server, client, url = api
    server.add_priority_class("gold", 5000)
    listing = client.list_priority_classes()
    assert [i["value"] for i in listing["items"]] == [5000]
    with urllib.request.urlopen(f"{url}/apis/scheduling.k8s.io/v1/priorityclasses/gold") as r:
        assert json.loads(r.read())["value"] == 5000


def test_fake_apiserver_plain_pod_delete(plane, api):
    server, client, _ = api
    server.add_pod(running_gang_pod(plane, "v0", "victim", 1, 2, "n1"))
    client.delete_pod("default", "v0")
    assert ("default", "v0") not in server.pods
    assert server.deletions == [("default", "v0")]
    assert server.evictions == []  # the other door stayed shut
    # Already gone is success, as the API server's contract has it.
    assert client.delete_pod("default", "v0") == {}


@pytest.mark.parametrize("status,evicted,deleted", [
    (405, True, True),    # the subresource unsupported: the plain delete
    (429, False, False),  # a disruption budget: the round aborts
    (403, False, False),  # any other refusal: no forced delete either
])
def test_eviction_door(plane, api, status, evicted, deleted):
    server, client, _ = api
    server.add_pod(running_gang_pod(plane, "v0", "victim", 1, 2, "n1"))
    server.faults.add(kind="status", status=status, times=-1, method="POST",
                      path_re=r"/eviction$")
    assert plane.preemption.evict_gang_pod(client, "default", "v0") is evicted
    assert server.deletions == ([("default", "v0")] if deleted else [])
    assert (("default", "v0") in server.pods) is not deleted


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def planner(plane, duty=None):
    return plane.preemption.PreemptionPlanner(plane.preemption.PriorityResolver(None),
                                              duty_source=lambda: duty or {})


def topo_of(plane, name, avail_idx=()):
    return plane.schema.parse_topology_cached(plane.raw(name, list(avail_idx)))


def mk_victim(plane, gang, priority, hosts, duty=None, ckpt_age=None):
    pods = [{"ns": "default", "name": f"{gang}-w{i}", "uid": f"u-{gang}{i}", "host": h,
             "chips": c} for i, (h, c) in enumerate(hosts.items())]
    return plane.preemption.Victim(key=("default", gang), priority=priority, hosts=dict(hosts),
                                   pods=pods, duty_cycle=duty, checkpoint_age_s=ckpt_age)


def test_planner_prefers_lower_tier(plane):
    topos = [topo_of(plane, "n1"), topo_of(plane, "n2")]  # both full
    victims = [mk_victim(plane, "standard-job", 0, {"n1": 4}),
               mk_victim(plane, "batch-job", -10, {"n2": 4})]
    plan = planner(plane).plan(("default", "prod"), [4], 100000, topos, victims)
    assert plan is not None
    assert [v.key[1] for v in plan.victims] == ["batch-job"]


def test_planner_prefers_recent_checkpoint_and_low_duty(plane):
    topos = [topo_of(plane, "n1"), topo_of(plane, "n2")]
    # Equal priority: the idle gang that saved recently is cheaper than the
    # busy one with an hour of unsaved work.
    victims = [mk_victim(plane, "busy-stale", -10, {"n1": 4}, duty=95.0, ckpt_age=3600.0),
               mk_victim(plane, "idle-fresh", -10, {"n2": 4}, duty=2.0, ckpt_age=10.0)]
    plan = planner(plane).plan(("default", "prod"), [4], 1000, topos, victims)
    assert [v.key[1] for v in plan.victims] == ["idle-fresh"]
    # Only the duty differing (no beacons): idle still goes first.
    victims = [mk_victim(plane, "busy", -10, {"n1": 4}, duty=95.0),
               mk_victim(plane, "idle", -10, {"n2": 4}, duty=1.0)]
    plan = planner(plane).plan(("default", "prod"), [4], 1000, topos, victims)
    assert [v.key[1] for v in plan.victims] == ["idle"]


def test_planner_never_evicts_more_than_needed(plane):
    """Greedy picks the cheap but insufficient victim first; the prune pass
    drops it once the sufficient one lands: exactly one gang pays."""
    topos = [topo_of(plane, "n1"), topo_of(plane, "n2")]
    victims = [mk_victim(plane, "cheap-small", -10, {"n2": 2}, duty=0.0),
               mk_victim(plane, "pricey-big", -10, {"n1": 4}, duty=90.0)]
    plan = planner(plane).plan(("default", "prod"), [4], 1000, topos, victims)
    assert plan is not None
    assert [v.key[1] for v in plan.victims] == ["pricey-big"]
    assert plan.freed == {"n1": 4}


def test_planner_only_strictly_lower_priority(plane, api):
    """Victims at or above the preemptor's priority are untouchable."""
    server, client, _ = api
    server.add_pod(running_gang_pod(plane, "eq0", "equal", 1, 4, "n1", priority=1000))
    adm = admission(plane, client)
    eng = wire(plane, adm, client)
    victims = eng.planner.collect_victims(adm._collect_gangs(), ("default", "prod"), 1000)
    assert victims == []  # 1000 is not < 1000


def test_planner_no_plan_when_nothing_frees_a_box(plane):
    topos = [topo_of(plane, "n1")]
    victims = [mk_victim(plane, "small", -10, {"n1": 2})]
    # Demand 4 with 2 cards evictable: no plan, no partial eviction.
    assert planner(plane).plan(("default", "p"), [4], 1000, topos, victims) is None


# ---------------------------------------------------------------------------
# the engine: a full cluster, one round
# ---------------------------------------------------------------------------


def test_high_tier_gang_admitted_within_one_preemption_round(plane, api):
    server, client, _ = api
    m = plane.metrics
    server.add_priority_class("prod-inference", 100000)
    full_node(plane, server, "n1")
    full_node(plane, server, "n2")
    now = time.time()
    # Two batch gangs hold the cluster: batch-a saved seconds ago (cheap),
    # batch-b has about an hour of unsaved work (expensive).
    for i in range(2):
        server.add_pod(running_gang_pod(plane, f"ba{i}", "batch-a", 2, 2, "n1", priority=-10,
                                        ckpt_ts=now - 5))
        server.add_pod(running_gang_pod(plane, f"bb{i}", "batch-b", 2, 2, "n2", priority=-10,
                                        ckpt_ts=now - 3500))
    hp = gang_pod(plane, "prod-w0", "prod", 1, 4)
    hp["spec"]["priorityClassName"] = "prod-inference"
    server.add_pod(hp)
    pre_exec = m.PREEMPTIONS.get(tier="high", outcome="executed")
    pre_victims = m.PREEMPTION_VICTIMS.get(victim_tier="batch")
    adm = admission(plane, client)
    table = adm.reservations
    wire(plane, adm, client)
    # Admitted within one round: the gates come off this very tick.
    assert adm.tick() == [("default", "prod")]
    assert plane.gang.GATE_NAME not in gates_of(server, "default", "prod-w0")
    # The cheaper victim paid; batch-b survived.
    assert {name for _, name in server.evictions} == {"ba0", "ba1"}
    for i in range(2):
        assert ("default", f"bb{i}") in server.pods
    # The freed cards are fenced for the preemptor, its priority carried.
    hold = table.active()[("default", "prod")]
    assert hold.hosts == {"n1": 4}
    assert hold.priority == 100000
    snap = table.snapshot()
    assert snap[0]["gang"] == "prod" and snap[0]["priority"] == 100000
    assert m.PREEMPTIONS.get(tier="high", outcome="executed") == pre_exec + 1
    assert m.PREEMPTION_VICTIMS.get(victim_tier="batch") == pre_victims + 1
    assert m.GANG_RELEASED.get(tier="high") >= 1
    assert adm.preemption.open_intents() == {}
    (event,) = [e for e in server.events if e.get("reason") == VICTIM_EVENT[plane.name]]
    assert event["involvedObject"]["name"] in ("ba0", "ba1")
    assert event["type"] == "Warning"


def test_preemption_blocked_by_pdb_aborts_round(plane, api):
    server, client, _ = api
    full_node(plane, server, "n1")
    server.add_pod(running_gang_pod(plane, "b0", "batch", 1, 4, "n1", priority=-10))
    hp = gang_pod(plane, "prod-w0", "prod", 1, 4)
    hp["spec"]["priority"] = 100000
    server.add_pod(hp)
    server.block_evictions = True
    pre_blocked = plane.metrics.PREEMPTIONS.get(tier="high", outcome="blocked")
    adm = admission(plane, client)
    wire(plane, adm, client)
    assert adm.tick() == []
    # The round aborted cleanly: the victim alive, the preemptor gated,
    # nothing fenced, no open intent (retried next tick).
    assert ("default", "b0") in server.pods
    assert plane.gang.GATE_NAME in gates_of(server, "default", "prod-w0")
    assert adm.reservations.active() == {}
    assert adm.preemption.open_intents() == {}
    assert plane.metrics.PREEMPTIONS.get(tier="high", outcome="blocked") == pre_blocked + 1
    # The budget lifted: the next round succeeds.
    server.block_evictions = False
    assert adm.tick() == [("default", "prod")]


def test_low_priority_gang_cannot_preempt(plane, api):
    server, client, _ = api
    full_node(plane, server, "n1")
    server.add_pod(running_gang_pod(plane, "b0", "batch", 1, 4, "n1", priority=-10))
    # The arriving gang is priority 0, below the preemptor floor of 1.
    server.add_pod(gang_pod(plane, "p0", "plain", 1, 4))
    adm = admission(plane, client)
    wire(plane, adm, client)
    assert adm.tick() == []
    assert server.evictions == []
    assert plane.gang.GATE_NAME in gates_of(server, "default", "p0")


def test_waiting_gauge_carries_tier(plane, api):
    server, client, _ = api
    waiting = plane.metrics.GANG_WAITING
    full_node(plane, server, "n1")
    server.add_pod(running_gang_pod(plane, "b0", "batch", 1, 4, "n1", priority=0))
    hp = gang_pod(plane, "prod-w0", "prod", 1, 4)
    hp["spec"]["priority"] = 100000
    server.add_pod(hp)
    adm = admission(plane, client)
    # A resolver and no engine: prod waits, labelled by its tier.
    adm.priority_resolver = plane.preemption.PriorityResolver(client)
    assert adm.tick() == []
    assert waiting.get(tier="high") == 1
    # Capacity appears: the wait clears and the tier's series goes.
    server.add_node("n2", plane.node("n2"))
    assert adm.tick() == [("default", "prod")]
    assert all(labels.get("tier") != "high" or v == 0 for labels, v in waiting.series())


# ---------------------------------------------------------------------------
# the /preemption verb
# ---------------------------------------------------------------------------


def post_json(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read())


def test_preemption_verb_serves_dry_run_victims(plane, api):
    server, client, _ = api
    full_node(plane, server, "n1")
    server.add_pod(running_gang_pod(plane, "b0", "batch", 1, 4, "n1", priority=-10))
    hp = gang_pod(plane, "prod-w0", "prod", 1, 4)
    hp["spec"]["priority"] = 100000
    server.add_pod(hp)
    adm = admission(plane, client)
    eng = wire(plane, adm, client)
    srv = plane.server.ExtenderHTTPServer(
        extender=plane.server.TopologyExtender(reservations=adm.reservations),
        host="127.0.0.1", preemption_handler=eng.dry_run)
    url = srv.start()
    try:
        status, body = post_json(url, "/preemption", {"pod": hp})
        assert status == 200
        victims = body["nodeNameToMetaVictims"]
        assert set(victims) == {"n1"}
        assert [p["uid"] for p in victims["n1"]["pods"]] == ["uid-b0"]
        # A dry run: nothing evicted, nothing fenced.
        assert server.evictions == []
        assert adm.reservations.active() == {}
    finally:
        srv.stop()


def test_preemption_verb_404_when_not_wired(plane):
    srv = plane.server.ExtenderHTTPServer(host="127.0.0.1")
    url = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            post_json(url, "/preemption", {"pod": pod(plane, 2)})
        assert ei.value.code == 404
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# explain --evicted end to end
# ---------------------------------------------------------------------------


def test_explain_evicted_answers_end_to_end(plane, api):
    server, client, _ = api
    full_node(plane, server, "n1")
    server.add_pod(running_gang_pod(plane, "b0", "victim-gang", 1, 4, "n1", priority=-10,
                                    ckpt_ts=time.time() - 30))
    hp = gang_pod(plane, "prod-w0", "prod", 1, 4)
    hp["spec"]["priority"] = 2_000_000
    server.add_pod(hp)
    led = ledger(plane)
    led.enable(service="extender")
    try:
        adm = admission(plane, client)
        wire(plane, adm, client)
        assert adm.tick() == [("default", "prod")]
        lines = render_evicted(led.snapshot()["records"], [], "victim-gang")
    finally:
        led.disable()
        led.clear()
    text = "\n".join(lines)
    assert "evicted by default/prod" in text
    assert "victim tier batch" in text
    assert "preempt_victim" in text
    assert "preemption" in text
    assert "last checkpoint" in text


# ---------------------------------------------------------------------------
# the checkpoint beacon
# ---------------------------------------------------------------------------


def test_checkpoint_beacon_stamps_annotation(plane, api):
    if plane.name == "jax":
        beacon_mod = pytest.importorskip("k8s_device_plugin_tpu.workload.checkpointing")
    else:
        from k8s_device_plugin_tpu_torch.workload import beacon as beacon_mod
    server, client, _ = api
    server.add_pod(running_gang_pod(plane, "w0", "train", 1, 2, "n1"))
    beacon = beacon_mod.CheckpointBeacon.for_pod(client, namespace="default", name="w0")
    assert beacon.note_saved(50) is True
    ann = server.pods[("default", "w0")]["metadata"]["annotations"]
    assert abs(float(ann[plane.constants.CHECKPOINT_TS_ANNOTATION]) - time.time()) < 5.0
    # Best effort: a dead API server costs the stamp, nothing else.
    err = importlib.import_module(plane.KubeClient.__module__).KubeError
    bad = beacon_mod.CheckpointBeacon(lambda ann: (_ for _ in ()).throw(err(500, "down")))
    assert bad.note_saved(51) is False


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def _random_cluster(rng):
    """Full 4-card nodes each held by running victim pods of 1, 2 or 4 cards
    (so every credit is a prefix of the card order, where the two pools
    agree), victim gangs of random priority, duty and checkpoint age, and a
    preemptor of random priority with 1 to 3 members of 1, 2 or 4 cards."""
    nodes = [f"n{i}" for i in range(rng.randint(2, 4))]
    pods = []  # (gang, node, cards)
    for node in nodes:
        left = 4
        while left:
            cards = rng.choice([c for c in (1, 2, 4) if c <= left])
            pods.append((f"g{rng.randrange(5)}", node, cards))
            left -= cards
    gangs = {}
    for gang, node, cards in pods:
        g = gangs.setdefault(gang, {"hosts": {}, "priority": rng.choice([-10, -5, 0, 5, 2000])})
        g["hosts"][node] = g["hosts"].get(node, 0) + cards
    for g in gangs.values():
        g["duty"] = rng.choice([None, rng.uniform(0, 100)])
        g["ckpt"] = rng.choice([None, rng.uniform(0, 5000)])
    demands = [rng.choice([1, 2, 4]) for _ in range(rng.randint(1, 3))]
    return nodes, gangs, demands, rng.choice([1, 1000, 1_000_000])


def _plan_on(plane, nodes, gangs, demands, priority):
    # Strictly lower priority only, as collect_victims gathers them.
    victims = [mk_victim(plane, name, g["priority"], g["hosts"], g["duty"], g["ckpt"])
               for name, g in sorted(gangs.items()) if g["priority"] < priority]
    plan = planner(plane).plan(("default", "prod"), demands, priority,
                               [topo_of(plane, n) for n in nodes], victims)
    if plan is None:
        return None
    return plan.victim_keys(), plan.freed, plan.consumed


def test_both_planes_plan_alike_on_seeded_clusters(layouts):
    torch_plane = TorchPlane(layouts["grid4"])
    plans = []
    for seed in range(40):
        case = _random_cluster(random.Random(seed))
        want = _plan_on(JaxPlane(), *case)
        assert _plan_on(torch_plane, *case) == want, (seed, case)
        plans.append(want)
    # The seeds exercise what they name: plans of one and of several
    # victims, and requests no eviction set can serve.
    assert any(p is None for p in plans)
    assert any(p and len(p[0]) == 1 for p in plans)
    assert any(p and len(p[0]) > 1 for p in plans)


def test_credited_topos_credits_a_failed_card_as_jax_does(layouts):
    """The credit names the first cards not available in card order, a
    failed card among them, on both planes: a count-based fit is right, a
    set score after it may be optimistic."""
    import dataclasses

    out = {}
    for plane in (JaxPlane(), TorchPlane(layouts["grid4"])):
        topo = topo_of(plane, "n1", [2, 3])
        topo = dataclasses.replace(topo, failed=[plane.ids[0]])
        (credited,) = plane.preemption.credited_topos([topo], {"n1": 1})
        assert credited.available == [plane.ids[2], plane.ids[3], plane.ids[0]]
        assert topo.available == [plane.ids[2], plane.ids[3]]  # the input untouched
        out[plane.name] = [plane.ids.index(i) for i in credited.available]
    assert out["jax"] == out["torch"]


def test_self_test_runs(capsys):
    from k8s_device_plugin_tpu_torch.extender import preemption

    assert preemption.main(["--self-test"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict == {"preemption_self_test": "ok", "evicted": ["batch-a"],
                       "journal": ["preempt_intent", "preempt_evicted", "preempt_done"]}


def test_gang_duty_cycles_read_the_sampler_as_jax_does():
    """The planner's duty source: {} with no sampler in the process (the
    extender's case), else each gang's mean duty over its attributed cards,
    as the JAX ``telemetry.gang_duty_cycles`` reads the same snapshot."""
    from k8s_device_plugin_tpu import telemetry as jax_telemetry
    from k8s_device_plugin_tpu_torch import telemetry

    class Sampler:
        @staticmethod
        def snapshot():
            return {"chips": [
                {"chip": "GPU-0", "gang": "train", "duty_cycle_pct": 90.0},
                {"chip": "GPU-1", "gang": "train", "duty_cycle_pct": 30.0},
                {"chip": "GPU-2", "gang": "batch", "duty_cycle_pct": None},
                {"chip": "GPU-3", "duty_cycle_pct": 50.0},
            ]}

    was, jax_was = telemetry.SAMPLER, jax_telemetry.SAMPLER
    try:
        telemetry.install_sampler(None)
        assert telemetry.gang_duty_cycles() == {}
        telemetry.install_sampler(Sampler())
        jax_telemetry.SAMPLER = Sampler()
        assert telemetry.gang_duty_cycles() == {"train": 60.0}
        assert jax_telemetry.gang_duty_cycles() == telemetry.gang_duty_cycles()
    finally:
        telemetry.install_sampler(was)
        jax_telemetry.SAMPLER = jax_was


# ---------------------------------------------------------------------------
# the entry point wires the plane (the port's process)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _named(prefix, shard, ring, of):
    """The first ``prefix<i>`` the ring places on ``shard`` (``of`` maps the
    name to what the ring hashes)."""
    return next(f"{prefix}{i}" for i in range(1000) if of(f"{prefix}{i}") == shard)


def _wait(cond, what, proc, timeout=30.0):
    deadline = time.time() + timeout
    while not cond():
        assert proc.poll() is None, f"the extender exited ({proc.returncode}) waiting for {what}"
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


@pytest.mark.parametrize("mode", ["singleton", "sharded", "no-preemption"])
def test_entry_point_wires_preemption_into_its_admitters(layouts, tmp_path, mode):
    """``python -m ...extender --gang-admission``: the singleton's admitter,
    or with ``--shards 2`` the home shard's, carries the resolver and an
    engine. Its tick evicts the batch victim for a critical gang, and
    /preemption answers that admitter's dry run: sharded, only the home
    shard's gangs and nodes, never the other shard's identical pair.
    ``--no-preemption`` leaves both unset: /preemption answers 404, the
    critical gang waits FIFO under the ``standard`` tier (no resolver ranks
    it), and nothing is evicted."""
    plane = TorchPlane(layouts["grid4"])
    ring = ShardRing(2)
    home = 1
    api = FakeApiServer()
    url = api.start()
    api.add_priority_class("batch", -10)
    api.add_priority_class("prod", 1_000_000)
    # One full node with a running batch victim per shard; the gang and node
    # names hash to the shard they are meant for.
    on = {}
    for shard in (0, 1):
        node = _named(f"n{shard}-", shard, ring, ring.shard_of)
        victim = _named(f"batch{shard}-", shard, ring, lambda g: ring.gang_shard(("default", g)))
        full_node(plane, api, node)
        v = running_gang_pod(plane, f"{victim}-w0", victim, 1, 4, node)
        v["spec"]["priorityClassName"] = "batch"
        api.add_pod(v)
        on[shard] = (node, victim)
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
           "--gang-resync-s", "0.2", "--journal-dir", str(tmp_path / "j")]
    cmd += {"singleton": [], "sharded": ["--shards", "2", "--shard-index", str(home)],
            "no-preemption": ["--no-preemption"]}[mode]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ),
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"

    def ready():
        try:
            with urllib.request.urlopen(f"{base}/readyz", timeout=2) as r:
                return r.status == 200
        except OSError:
            return False

    def metrics_text():
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            return r.read().decode()

    try:
        _wait(ready, "/readyz", proc)
        # The verb: a bare critical pod asking a whole node's cards.
        ask = pod(plane, 4, name="ask")
        ask["spec"]["priorityClassName"] = "prod"
        if mode == "no-preemption":
            with pytest.raises(urllib.error.HTTPError) as ei:
                post_json(base, "/preemption", {"pod": ask})
            assert ei.value.code == 404
            assert json.loads(ei.value.read()) == {"error": "preemption not enabled"}
        else:
            status, body = post_json(base, "/preemption", {"pod": ask})
            assert status == 200
            victims = body["nodeNameToMetaVictims"]
            if mode == "sharded":
                node, victim = on[home]
                assert victims == {node: {"pods": [{"uid": f"uid-{victim}-w0"}],
                                          "numPDBViolations": 0}}
            else:
                assert len(victims) == 1  # one node's victim suffices
        assert api.evictions == []  # a dry run
        # The round: a gated critical gang (in the home shard when sharded).
        preemptor = _named("prod-", home, ring, lambda g: ring.gang_shard(("default", g)))
        hp = gang_pod(plane, f"{preemptor}-w0", preemptor, 1, 4)
        hp["spec"]["priorityClassName"] = "prod"
        api.add_pod(hp)
        gated = lambda: plane.gang.GATE_NAME in gates_of(api, "default", f"{preemptor}-w0")
        if mode == "no-preemption":
            _wait(lambda: 'tpu_gang_waiting{tier="standard"} 1' in metrics_text(),
                  "the gang waiting as standard", proc)
            time.sleep(1.0)  # five more ticks
            assert gated() and api.evictions == []
        else:
            _wait(lambda: not gated(), "the preemptor's release", proc)
            (evicted,) = api.evictions
            if mode == "sharded":
                assert evicted == ("default", f"{on[home][1]}-w0")
            assert 'tpu_extender_preemptions_total{outcome="executed",tier="critical"} 1' in (
                metrics_text())
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        api.stop()
    assert rc == 0
