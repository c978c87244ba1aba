"""The port's defragmentation (extender/defrag.py) against the JAX one.

The tests of the JAX ``tests/test_defrag.py`` are parametrised over the two
planes of tests/torch_extender_planes.py wherever a plane drives them:
``jax`` (v5p hosts of 4 chips) and ``torch`` (4-card H100 hosts of the fake
NVML whose NVLinks join the v5p host's ICI pairs). Card i stands for chip i.
A "fragmented" node has cards 0 and 2 free: room for 2 on both planes, for 4
on neither. The one shape the planes read apart is two free cards that no
link joins (0 and 3): no 2-box on the torus, while any two free GPU cards
place 2; the shapes test holds each plane to its own answer.

Port only: stranding by scatter on 8-card HGX nodes (free cards enough, no
node with n free) and its end when one node has n free; the same plan
(victim keys, freed, consumed and relocation cards) on both planes over
seeded random clusters whose free sets the two capacity pools read alike;
the module's ``main(["--self-test"])``.
"""

import dataclasses
import json
import random
import time

import pytest

from k8s_device_plugin_tpu.tools import tputop as jax_tputop
from k8s_device_plugin_tpu_torch.topology.schema import hgx_topology
from k8s_device_plugin_tpu_torch.tools import tputop
from tests import torch_fake_nvml as fk
from tests.torch_extender_planes import (
    JaxPlane,
    TorchPlane,
    port_lockdep_acyclic,  # noqa: F401 - the autouse lockdep gate
    read_layouts,
)

TPUTOP = {"jax": jax_tputop, "torch": tputop}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("defrag_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


def topo(plane, host, avail_idx):
    return plane.schema.parse_topology_cached(plane.raw(host, list(avail_idx)))


def fragmented(plane, host):
    """Cards 0 and 2 free: free cards on the node, room for 4 nowhere."""
    return topo(plane, host, [0, 2])


class StubClient:
    """The in-memory client the engine drives: list/get/evict/delete pods,
    gate removal, annotation patch; no HTTP."""

    def __init__(self, plane):
        self.plane = plane
        self.pods = {}
        self.evicted = []
        self.evict_error = None

    def add(self, pod):
        m = pod["metadata"]
        self.pods[(m["namespace"], m["name"])] = pod

    def list_pods(self, label_selector="", **_):
        return {"items": [dict(p) for p in self.pods.values()]}

    def get_pod(self, ns, name):
        return dict(self.pods[(ns, name)])

    def evict_pod(self, ns, name):
        if self.evict_error is not None:
            raise self.evict_error
        self.evicted.append((ns, name))
        self.pods.pop((ns, name), None)
        return {}

    def delete_pod(self, ns, name):
        self.pods.pop((ns, name), None)
        return {}

    def remove_pod_scheduling_gate(self, ns, name, gate, gates):
        pod = self.pods[(ns, name)]
        pod["spec"]["schedulingGates"] = [g for g in gates if g.get("name") != gate]

    def patch_pod_annotations(self, ns, name, ann):
        pod = self.pods.get((ns, name))
        if pod is not None:
            pod.setdefault("metadata", {}).setdefault("annotations", {}).update(
                {k: v for k, v in ann.items() if v is not None})

    def create_event(self, *a, **kw):
        pass


def pod(plane, gang, name, cards, size, gated, node="", priority=None, ckpt=None):
    p = {
        "metadata": {"name": name, "namespace": "default", "uid": f"uid-{name}",
                     "labels": {plane.gang.GANG_NAME_LABEL: gang,
                                plane.gang.GANG_SIZE_LABEL: str(size)},
                     "annotations": {}},
        "spec": {"schedulingGates": [{"name": plane.gang.GATE_NAME}] if gated else [],
                 "containers": [{"name": "c", "resources": {
                     "requests": {plane.resource: str(cards)}}}]},
        "status": {},
    }
    if node:
        p["spec"]["nodeName"] = node
    if priority is not None:
        p["spec"]["priority"] = priority
    if ckpt is not None:
        p["metadata"]["annotations"][plane.constants.CHECKPOINT_TS_ANNOTATION] = str(ckpt)
    return p


def victim(plane, gang, host, cards_per_pod, n_pods=1, priority=-10, duty=None,
           ckpt_age=None):
    return plane.preemption.Victim(
        key=("default", gang), priority=priority, hosts={host: cards_per_pod * n_pods},
        pods=[{"ns": "default", "name": f"{gang}-w{w}", "uid": f"uid-{gang}-{w}", "host": host,
               "chips": cards_per_pod} for w in range(n_pods)],
        duty_cycle=duty, checkpoint_age_s=ckpt_age)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


def test_stranded_size_shapes(plane):
    stranded_size = plane.defrag.stranded_size
    frag = [fragmented(plane, "n1"), fragmented(plane, "n2")]
    # The stranded shape: 4 free cards over the cluster, room for 4 nowhere.
    assert stranded_size(frag, [4]) == 4
    # Room somewhere: not stranded.
    whole = [topo(plane, "n1", range(4)), fragmented(plane, "n2")]
    assert stranded_size(whole, [4]) is None
    # A member larger than every node's card count is no node's.
    assert stranded_size(frag, [8]) is None
    # A real shortage (free cards short of the whole demand): migration
    # conserves cards, so a repack cannot help.
    short = [fragmented(plane, "n1"), topo(plane, "n2", [])]
    assert stranded_size(short, [4]) is None
    # Cards 0 and 3, which no link joins: no 2-box on the torus, while two
    # free GPU cards place 2 whatever joins them.
    diag = [topo(plane, h, [0, 3]) for h in ("n1", "n2")]
    assert stranded_size(diag, [2, 2]) == (2 if plane.name == "jax" else None)
    # The linked pair of a fragmented node places 2 on both planes.
    assert stranded_size(frag, [2, 2]) is None
    assert stranded_size(frag, []) is None


def test_detector_hysteresis_and_gauge(plane):
    det = plane.defrag.StrandedDemandDetector(stranded_ticks=3)
    key = ("default", "train")
    assert det.observe(key, 4) == 1
    assert not det.ready(key)
    assert det.observe(key, 4) == 2
    # A new size (the gang recreated with another shape) restarts the count.
    assert det.observe(key, 2) == 1
    assert det.observe(key, 2) == 2
    assert det.observe(key, 2) == 3
    assert det.ready(key)
    det.publish()
    assert plane.metrics.STRANDED_DEMAND.get(size="2", shard="") == 1
    snap = det.snapshot()
    assert snap[0]["size"] == 2 and snap[0]["ticks"] == 3
    det.clear(key)
    det.publish()
    # An emptied size prunes its series.
    assert plane.metrics.STRANDED_DEMAND.series() == []
    assert not det.ready(key)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def planner(plane):
    return plane.defrag.DefragPlanner(plane.preemption.PriorityResolver())


def test_planner_prefers_cheapest_host_and_proves_relocation(plane):
    topos = [fragmented(plane, n) for n in ("n1", "n2", "n3")]
    cheap = victim(plane, "cheap", "n1", 1, n_pods=2, duty=5.0, ckpt_age=10.0)
    costly = victim(plane, "costly", "n2", 1, n_pods=2, duty=95.0, ckpt_age=3000.0)
    plan = planner(plane).plan(("default", "train"), [4], 0, topos, [costly, cheap])
    assert plan is not None
    assert plan.target_host == "n1"
    assert [v.key for v in plan.victims] == [("default", "cheap")]
    assert plan.size == 4
    # The stranded gang's fence lands on the freed node.
    assert plan.consumed == {"n1": 4}
    assert plan.freed == {"n1": 2}
    # The relocation proof: the victims' pods land on the remaining
    # fragmented capacity, not into thin air.
    assert sum(plan.relocation.values()) == 2
    assert "n1" not in plan.relocation
    assert 4 not in plan.placeable_before
    assert 4 in plan.placeable_after


def test_planner_requires_relocation_capacity(plane):
    """A gang that cannot land elsewhere is never migrated: that would be
    preemption under another name."""
    topos = [fragmented(plane, "n1"), topo(plane, "n2", [])]
    v = victim(plane, "cheap", "n1", 1, n_pods=2)
    assert planner(plane).plan(("default", "train"), [4], 0, topos, [v]) is None


def test_planner_minimal_set_and_max_victims(plane):
    topos = [topo(plane, "n1", []), fragmented(plane, "n2"), fragmented(plane, "n3")]
    a = victim(plane, "aa", "n1", 2, duty=5.0, ckpt_age=10.0)
    b = victim(plane, "bb", "n1", 2, duty=20.0, ckpt_age=100.0)
    # Room for 4 needs the whole node: both victims migrate.
    plan = planner(plane).plan(("default", "t"), [4], 0, topos, [a, b])
    assert plan is not None
    assert {v.key[1] for v in plan.victims} == {"aa", "bb"}
    assert plan.consumed == {"n1": 4}
    # A 2-card demand needs only the cheapest victim.
    plan2 = planner(plane).plan(("default", "t"), [2], 0, topos, [a, b])
    assert plan2 is not None
    assert [v.key[1] for v in plan2.victims] == ["aa"]
    # max_victims caps the set: a plan needing two is rejected.
    assert planner(plane).plan(("default", "t"), [4], 0, topos, [a, b], max_victims=1) is None


# ---------------------------------------------------------------------------
# execution, through the real admission tick
# ---------------------------------------------------------------------------


def build_admission(plane, client, tmp_path, topos, **engine_kw):
    table = plane.reservations.ReservationTable()
    journal = plane.journal.AdmissionJournal(str(tmp_path / "journal"))
    table.observer = journal.observe
    adm = plane.gang.GangAdmission(
        client, reservations=table, journal=journal,
        topo_source=lambda: [dataclasses.replace(t, available=list(t.available))
                             for t in topos])
    resolver = plane.preemption.PriorityResolver()
    adm.priority_resolver = resolver
    engine_kw.setdefault("stranded_ticks", 1)
    engine = plane.defrag.DefragEngine(adm, resolver, **engine_kw)
    adm.defrag = engine
    return adm, table, engine


def stranded_cluster(plane, client):
    """Two fragmented nodes, a cheap batch victim that saved 5 s ago on n1,
    and a gated standard-priority 4-card gang."""
    topos = [fragmented(plane, "n1"), fragmented(plane, "n2")]
    now = time.time()
    for w in range(2):
        client.add(pod(plane, "frag", f"frag-w{w}", 1, 2, gated=False, node="n1",
                       priority=-10, ckpt=now - 5))
    client.add(pod(plane, "train", "train-w0", 4, 1, gated=True, priority=0))
    return topos


def test_engine_budget_gate(plane, tmp_path):
    client = StubClient(plane)
    topos = stranded_cluster(plane, client)
    # Budget 1: the 2-pod victim's eviction would exceed it.
    adm, table, engine = build_admission(plane, client, tmp_path, topos,
                                         max_evictions_per_hour=1)
    plans = plane.metrics.DEFRAG_PLANS
    before = plans.get(outcome="blocked_budget")
    assert adm.tick() == []
    assert client.evicted == []
    assert engine.last_outcome == "blocked_budget"
    assert plans.get(outcome="blocked_budget") == before + 1
    # Once an episode: the next tick does not count it again.
    assert adm.tick() == []
    assert plans.get(outcome="blocked_budget") == before + 1
    assert table.active() == {}
    adm.journal.close()


def test_engine_checkpoint_deferral(plane, tmp_path):
    client = StubClient(plane)
    topos = [fragmented(plane, "n1"), fragmented(plane, "n2")]
    for w in range(2):
        # No checkpoint stamp: the victim is stale by definition, and the
        # plan is held one tick for a save in flight.
        client.add(pod(plane, "frag", f"frag-w{w}", 1, 2, gated=False, node="n1",
                       priority=-10))
    client.add(pod(plane, "train", "train-w0", 4, 1, gated=True))
    adm, table, engine = build_admission(plane, client, tmp_path, topos)
    assert adm.tick() == []
    assert engine.last_outcome == "deferred"
    assert client.evicted == []
    # Once an episode: the next tick executes though the save never landed.
    assert adm.tick() == [("default", "train")]
    assert engine.last_outcome == "executed"
    assert len(client.evicted) == 2
    adm.journal.close()


def test_engine_eviction_blocked_aborts_and_retries(plane, tmp_path):
    client = StubClient(plane)
    topos = stranded_cluster(plane, client)
    adm, table, engine = build_admission(plane, client, tmp_path, topos)
    # A disruption budget's 429: the round aborts, journaled, nothing is
    # fenced and nothing escalates into a plain delete.
    kube_error = __import__(plane.KubeClient.__module__, fromlist=["KubeError"]).KubeError
    client.evict_error = kube_error(429, "pdb")
    aborted = plane.metrics.DEFRAG_ABORTED
    before = aborted.get(reason="eviction_blocked")
    assert adm.tick() == []
    assert engine.last_outcome == "aborted"
    assert client.evicted == [] and client.pods
    assert table.active() == {}
    assert engine.open_intents() == {}
    assert aborted.get(reason="eviction_blocked") == before + 1
    # The journal holds no open round: a SIGKILL now recovers clean.
    adm.journal.flush()
    assert adm.journal.replay_readonly().defragging == {}
    # The budget lifts; the retry finishes the migration.
    client.evict_error = None
    assert adm.tick() == [("default", "train")]
    assert table.active()[("default", "train")].hosts == {"n1": 4}
    adm.journal.close()


def test_debug_snapshot_and_cli_renderers(plane, tmp_path):
    dfg = plane.defrag
    assert dfg.debug_snapshot()["enabled"] is False
    client = StubClient(plane)
    topos = stranded_cluster(plane, client)
    adm, table, engine = build_admission(plane, client, tmp_path, topos)
    dfg.install(engine)
    dfg.install(engine)  # idempotent
    try:
        assert adm.tick() == [("default", "train")]
        doc = dfg.debug_snapshot()
        assert doc["enabled"] is True
        (eng,) = doc["engines"]
        assert eng["last_outcome"] == "executed"
        assert eng["last_plan"]["target_host"] == "n1"
        assert eng["budget"]["remaining"] <= eng["budget"]["max_evictions_per_hour"]
        status = "\n".join(dfg._render_status(doc))
        assert "budget" in status and "last outcome executed" in status
        plan_txt = "\n".join(dfg._render_plan(doc))
        assert "free a size-4 box on n1" in plan_txt
        assert "migrate default/frag" in plan_txt
    finally:
        dfg.uninstall(engine)
    assert dfg.debug_snapshot()["enabled"] is False
    # The admitter's stop() takes the engine off (a shard handed back).
    dfg.install(engine)
    adm.stop()
    assert dfg.debug_snapshot()["enabled"] is False


def test_defrag_self_test_smoke(plane):
    assert plane.defrag.self_test() == 0


# ---------------------------------------------------------------------------
# the acceptance case, at 1,000 nodes
# ---------------------------------------------------------------------------


def test_acceptance_fragmented_1000_node_cluster(plane, tmp_path):
    """A fragmented 1,000-node cluster with a waiting 4-card gang gets room
    for 4 back within the eviction budget: the cheapest victim (recent save,
    batch tier) migrates, equal and higher tiers are untouched, the stranded
    gang admits onto the freed node, and the extender's audit, with
    defrag_vs_reservations, sweeps clean after every tick. Preemption is
    wired too and declines the standard-tier gang; defragmentation takes
    it."""
    client = StubClient(plane)
    topos = [fragmented(plane, f"node-{i:04d}") for i in range(1000)]
    now = time.time()
    for gang, node, prio, ckpt in (("cheap", "node-0000", -10, now - 5),
                                   ("costly", "node-0001", -10, now - 3000),
                                   ("equal", "node-0002", 0, now - 5),
                                   ("prod", "node-0003", 1_000_000, now - 5)):
        for w in range(2):
            client.add(pod(plane, gang, f"{gang}-w{w}", 1, 2, gated=False, node=node,
                           priority=prio, ckpt=ckpt))
    client.add(pod(plane, "train", "train-w0", 4, 1, gated=True, priority=0))
    table = plane.reservations.ReservationTable()
    journal = plane.journal.AdmissionJournal(str(tmp_path / "journal"))
    table.observer = journal.observe
    adm = plane.gang.GangAdmission(
        client, reservations=table, journal=journal,
        topo_source=lambda: [dataclasses.replace(t, available=list(t.available))
                             for t in topos])
    resolver = plane.preemption.PriorityResolver()
    adm.priority_resolver = resolver
    adm.preemption = plane.preemption.PreemptionEngine(adm, resolver)
    engine = plane.defrag.DefragEngine(adm, resolver, stranded_ticks=2,
                                       max_evictions_per_hour=2, max_concurrent=2)
    adm.defrag = engine
    auditor = plane.audit.ExtenderAudit(reservations=table, journal=journal,
                                        gang=adm).engine()
    assert "defrag_vs_reservations" in {i.name for i in auditor.invariants}

    def assert_clean():
        crit = [f for f in auditor.sweep_once() if f.severity == plane.audit.CRITICAL]
        assert crit == [], crit

    released, ticks = [], 0
    while not released and ticks < 5:
        released = adm.tick()
        ticks += 1
        assert_clean()
    assert released == [("default", "train")]
    assert ticks == engine.detector.stranded_ticks
    evicted_gangs = {n.rsplit("-w", 1)[0] for _, n in client.evicted}
    assert evicted_gangs == {"cheap"}, evicted_gangs
    for name in ("costly-w0", "equal-w0", "prod-w0"):
        assert ("default", name) in client.pods
    assert table.active()[("default", "train")].hosts == {"node-0000": 4}
    assert client.pods[("default", "train-w0")]["spec"]["schedulingGates"] == []
    assert engine.last_plan["target_host"] == "node-0000"
    assert 4 in engine.last_plan["placeable_after"]
    assert engine.last_outcome == "executed"
    assert engine.budget_remaining() == 0
    assert engine.open_intents() == {}
    journal.flush()
    assert journal.replay_readonly().defragging == {}
    assert plane.metrics.STRANDED_DEMAND.series() == []
    assert plane.metrics.DEFRAG_MIGRATIONS.get(victim_tier="batch") >= 1
    # Steady state: no eviction storm, no dangling round.
    assert adm.tick() == []
    assert len(client.evicted) == 2
    assert_clean()
    journal.close()


def test_detector_shard_scoped_series(plane):
    """Shard engines share one registry: a shard's publish prunes only its
    own series, never a peer's."""
    det = plane.defrag.StrandedDemandDetector
    series = plane.metrics.STRANDED_DEMAND
    d0, d1 = det(1, shard=0), det(1, shard=1)
    try:
        d0.observe(("a", "g"), 4)
        d0.publish()
        d1.publish()
        assert series.get(size="4", shard="0") == 1
        d1.observe(("b", "h"), 4)
        d1.publish()
        assert series.get(size="4", shard="1") == 1
        d0.clear(("a", "g"))
        d0.publish()
        assert series.get(size="4", shard="1") == 1
        assert not any(labels.get("shard") == "0" for labels, _ in series.series())
    finally:
        d1.clear(("b", "h"))
        d1.publish()
        d0.publish()
    assert series.series() == []


def test_tputop_footer_aggregates_shards_and_skips_placeholders(plane):
    """tputop's defrag footer: an empty family's unlabelled placeholder does
    not render (an extender without defrag is not "budget 0"), and the
    shards' series add up."""
    t = TPUTOP[plane.name]
    placeholders = {f: [({}, 0.0)] for f in t.DEFRAG_FAMILIES}
    assert t._defrag_footer(placeholders) is None
    real = dict(placeholders)
    real["tpu_extender_defrag_budget_remaining"] = [({"shard": ""}, 10.0),
                                                    ({"shard": "1"}, 2.0)]
    real["tpu_extender_stranded_demand"] = [({"shard": "", "size": "4"}, 1.0),
                                            ({"shard": "1", "size": "4"}, 2.0)]
    footer = t._defrag_footer(real)
    assert "budget 12 eviction(s) left/h" in footer
    assert "stranded size=4×3" in footer


def test_budget_window_survives_restart(plane, tmp_path):
    """The rolling budget is journaled (defrag_spend and the compaction
    snapshot): a crash-looping extender cannot grant itself a fresh budget
    every incarnation."""
    client = StubClient(plane)
    topos = stranded_cluster(plane, client)
    adm, table, engine = build_admission(plane, client, tmp_path, topos,
                                         max_evictions_per_hour=3)
    assert adm.tick() == [("default", "train")]
    assert engine.budget_remaining() == 1  # two pods evicted
    adm.journal.flush()
    adm.journal.close()
    table2 = plane.reservations.ReservationTable()
    journal2 = plane.journal.AdmissionJournal(str(tmp_path / "journal"))
    table2.observer = journal2.observe
    adm2 = plane.gang.GangAdmission(StubClient(plane), reservations=table2, journal=journal2,
                                    topo_source=lambda: [])
    resolver = plane.preemption.PriorityResolver()
    adm2.priority_resolver = resolver
    engine2 = plane.defrag.DefragEngine(adm2, resolver, max_evictions_per_hour=3)
    adm2.defrag = engine2
    adm2.recover()
    assert engine2.budget_remaining() == 1
    # And a second restart, through the compaction recover() wrote.
    journal2.close()
    journal3 = plane.journal.AdmissionJournal(str(tmp_path / "journal"))
    spend = journal3.replay().defrag_spend
    journal3.close()
    assert len(spend) == 2


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def hgx(name, free):
    """A synthetic 8-card HGX node with its first ``free`` cards free."""
    t = hgx_topology(name, 8)
    return dataclasses.replace(t, available=[c.id for c in t.chips[:free]])


@pytest.mark.parametrize("free,want", [
    ((4, 4), 8),      # 8 free cards over two nodes, no node with 8: scattered
    ((3, 3, 2), 8),   # the same over three nodes
    ((8, 0), None),   # one node with 8 free places the member
    ((3, 3), None),   # 6 free cards short of 8: a shortage, not scatter
])
def test_stranded_by_scatter_on_gpu_nodes(free, want):
    from k8s_device_plugin_tpu_torch.extender.defrag import stranded_size

    topos = [hgx(f"n{i}", f) for i, f in enumerate(free)]
    assert stranded_size(topos, [8]) == want


def test_a_wholly_freed_gpu_node_places_its_card_count():
    """_frees_box: a node the migration empties places up to its card count;
    one left partly held places what its credited cards hold."""
    from k8s_device_plugin_tpu_torch.extender.defrag import DefragPlanner

    t = hgx("n", 4)
    assert DefragPlanner._frees_box(t, 4, 8)
    assert not DefragPlanner._frees_box(t, 3, 8)
    assert DefragPlanner._frees_box(t, 3, 7)
    assert not DefragPlanner._frees_box(t, 0, 1)


def _random_cluster(rng):
    """3 to 5 nodes of 4 cards, each held from card 0 on by running pods of
    1, 2 or 4 cards of victim gangs that live on that node alone, its last
    cards free: every free set the pools meet is one the torus places as the
    GPU node does (no lone pair of unlinked cards), so the two capacity
    pools agree. A requestor of priority 1 or 10 asking 4 cards, maybe with
    one more member of 1 or 2."""
    nodes = [f"n{i}" for i in range(rng.randint(3, 5))]
    gangs = {}
    free = {}
    g = 0
    for node in nodes:
        held = rng.choice([0, 1, 2, 3, 4])
        if held == 3:
            held = 4 if rng.random() < 0.5 else 2
        left, pods = held, []
        while left:
            cards = rng.choice([c for c in (1, 2, 4) if c <= left])
            pods.append(cards)
            left -= cards
        while pods:
            take = pods[:rng.randint(1, 2)]
            pods = pods[len(take):]
            gangs[f"g{g}"] = {"node": node, "pods": take,
                              "priority": rng.choice([-10, -5, 0, 5]),
                              "duty": rng.choice([None, rng.uniform(0, 100)]),
                              "ckpt": rng.choice([None, rng.uniform(0, 5000)])}
            g += 1
        free[node] = list(range(held, 4))
    demands = [4] + rng.choice([[], [1], [2]])
    return nodes, free, gangs, demands, rng.choice([1, 10]), rng.choice([0, 1, 2])


def _plan_on(plane, nodes, free, gangs, demands, priority, max_victims):
    victims = []
    for name, g in sorted(gangs.items()):
        if g["priority"] >= priority:
            continue
        pods = [{"ns": "default", "name": f"{name}-w{w}", "uid": f"u-{name}{w}",
                 "host": g["node"], "chips": c} for w, c in enumerate(g["pods"])]
        victims.append(plane.preemption.Victim(
            key=("default", name), priority=g["priority"], hosts={g["node"]: sum(g["pods"])},
            pods=pods, duty_cycle=g["duty"], checkpoint_age_s=g["ckpt"]))
    plan = planner(plane).plan(("default", "want"), demands, priority,
                               [topo(plane, n, free[n]) for n in nodes], victims,
                               max_victims=max_victims)
    if plan is None:
        return None
    return plan.victim_keys(), plan.freed, plan.consumed, plan.relocation


def test_both_planes_plan_alike_on_seeded_clusters(layouts):
    torch_plane = TorchPlane(layouts["grid4"])
    plans = []
    for seed in range(60):
        case = _random_cluster(random.Random(seed))
        want = _plan_on(JaxPlane(), *case)
        assert _plan_on(torch_plane, *case) == want, (seed, case)
        plans.append(want)
    # The seeds exercise what they name: plans of one victim and of
    # several, and clusters no migration serves.
    assert any(p is None for p in plans)
    assert any(p and len(p[0]) == 1 for p in plans)
    assert any(p and len(p[0]) > 1 for p in plans)


def test_self_test_runs(capsys):
    from k8s_device_plugin_tpu_torch.extender import defrag

    assert defrag.main(["--self-test"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict == {"defrag_self_test": "ok", "migrated": ["frag"], "target": "n1",
                       "budget_remaining": 10}
