"""The port's scheduling-quality simulator (extender/simulator.py, with
tools/simreport.py) against the JAX one.

The twelve cases of the JAX ``tests/test_simulator.py`` run on both planes
under their JAX names, each plane over its own traces and golden
(``sim.trace_dir()``: the JAX ``tests/sim_traces/`` and the port's
``extender/sim_traces/``). The JAX plane replays v5e meshes, the port's
synthetic HGX nodes. Where a case's premise reads otherwise on GPU nodes the
port's case says so: a GPU node places every size up to its free count, so
the per-node fragmentation term is 0 there and ``churn_strand``'s stranding
is the scatter of free cards across both hosts.

Port only:
- cross-plane parity on two-card hosts, where a v5e host and an HGX host
  place the same sizes {1, 2}: ``steady_mixed`` at 6 nodes of 2 cards with
  rescue on, and ``churn_strand``'s 429 plan at two cards a host, each
  scorecard equal byte for byte;
- wall-clock independence: replays with ``time.time`` in the port's
  preemption, defrag, rescue, gang and reservations modules a year after
  ``SIM_EPOCH`` give the same scorecard, and no eviction-plane read but the
  two JAX also takes on the wall clock reaches it;
- the four canned traces replayed on both planes: every score but
  ``fragmentation_avg`` equal, to each other and to both goldens;
- the eviction planes' hooks (``checkpoint_wait_ticks``,
  ``min_preemptor_priority``) and their defaults, on both planes' engines;
- the strict chaos-plan reader on both planes; the port's traces (the four
  canned ones equal to JAX's, and ``hgx_su``); the scheduling-quality probe.
"""

import copy
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
import types

import pytest

from k8s_device_plugin_tpu.extender import defrag as jax_defrag
from k8s_device_plugin_tpu.extender import preemption as jax_preemption
from k8s_device_plugin_tpu.extender import rescue as jax_rescue
from k8s_device_plugin_tpu.extender import simulator as jax_sim
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu_torch.extender import defrag, gang, preemption, rescue, reservations
from k8s_device_plugin_tpu_torch.extender import simulator as sim
from k8s_device_plugin_tpu_torch.utils import metrics
from k8s_device_plugin_tpu_torch.utils.resilience import FAULT_KEYS, WINDOW_KEYS, FaultPlan
from tests.fake_apiserver import Fault, FaultInjector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = {"jax": jax_sim, "torch": sim}
METRICS = {"jax": jax_metrics, "torch": metrics}
# Each plane's preemption, defrag and rescue modules.
ENGINES = {"jax": (jax_preemption, jax_defrag, jax_rescue), "torch": (preemption, defrag, rescue)}
PACKAGE = {"jax": "k8s_device_plugin_tpu", "torch": "k8s_device_plugin_tpu_torch"}


@pytest.fixture(params=["jax", "torch"])
def plane(request):
    return request.param


@pytest.fixture(autouse=True)
def quiet_planes():
    """The planes log every round at WARNING; a replay makes dozens."""
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def _trace(plane, name):
    s = SIM[plane]
    return s.load_trace(os.path.join(s.trace_dir(), name + ".json"))


def _trace_doc(name):
    with open(os.path.join(sim.trace_dir(), name + ".json"), encoding="utf-8") as f:
        return json.load(f)


# -- the JAX cases, on both planes -------------------------------------------


def test_canned_traces_all_load_and_validate(plane):
    for name in SIM[plane].CANNED_TRACES:
        t = _trace(plane, name)
        assert t.name == name
        assert t.ticks > 0 and t.tick_s > 0
        assert t.node_count > 0 and t.chips_per_host > 0


def test_trace_rejects_wrong_schema(plane):
    doc = {"schema": "tpu-sim-trace/v0", "name": "x"}
    with pytest.raises(ValueError):
        SIM[plane].Trace.from_dict(doc)


def test_same_trace_and_seed_is_byte_identical(plane):
    s = SIM[plane]
    t = _trace(plane, "priority_burst")
    a = s.run_trace(t, seed=t.seed)
    b = s.run_trace(_trace(plane, "priority_burst"), seed=t.seed)
    assert s.canonical_json(a) == s.canonical_json(b)


def test_different_seed_changes_the_generated_workload(plane):
    # steady_mixed uses the seeded generator: another seed must give another
    # arrival stream and scorecard, or the RNG is being ignored.
    s = SIM[plane]
    t = _trace(plane, "steady_mixed")
    a = s.run_trace(t, seed=t.seed)
    b = s.run_trace(_trace(plane, "steady_mixed"), seed=t.seed + 1)
    assert s.canonical_json(a) != s.canonical_json(b)


def test_determinism_across_processes(plane):
    # Byte-identity survives a fresh interpreter with another hash seed: no
    # dict-iteration or hash-order leak in the replay.
    code = (f"from {PACKAGE[plane]}.extender import simulator as s\n"
            "import os\n"
            "t = s.load_trace(os.path.join(s.trace_dir(), 'priority_burst.json'))\n"
            "print(s.canonical_json(s.run_trace(t, seed=t.seed)))\n")
    env = dict(os.environ, PYTHONHASHSEED="271828", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    s = SIM[plane]
    t = _trace(plane, "priority_burst")
    assert out.stdout.strip() == s.canonical_json(s.run_trace(t, seed=t.seed))


def test_disabling_preemption_zeroes_churn_and_worsens_high_tier(plane):
    s = SIM[plane]
    t = _trace(plane, "priority_burst")
    base = s.run_trace(t, seed=t.seed)
    off = s.run_trace(_trace(plane, "priority_burst"), seed=t.seed,
                      policy_overrides={"preemption": False})
    assert base["policy"]["preemption"] is True
    assert off["policy"]["preemption"] is False
    # Tier ordering is bought with preemption: churn with it on, none off...
    assert base["score"]["preemption_churn_cost"] > 0
    assert off["score"]["preemption_churn_cost"] == 0
    # ...and without it the critical gang waits for a natural departure.
    assert (off["time_to_admit_s"]["critical"]["p50_s"]
            > base["time_to_admit_s"]["critical"]["p50_s"])


def test_disabling_defrag_strands_the_big_gang(plane):
    s = SIM[plane]
    t = _trace(plane, "churn_strand")
    base = s.run_trace(t, seed=t.seed)
    off = s.run_trace(_trace(plane, "churn_strand"), seed=t.seed,
                      policy_overrides={"defrag": False})
    assert base["score"]["defrag_efficiency_chips_per_eviction"] > 0
    assert off["score"]["defrag_efficiency_chips_per_eviction"] == 0
    # Without defrag the cluster never repacks: the 4-card gang stays
    # stranded and fewer scored gangs are admitted.
    assert off["score"]["admitted_ratio"] < base["score"]["admitted_ratio"]
    if plane == "torch":
        # On GPU nodes no node ever reads fragmented (each places every size
        # up to its free count): the stranding defrag repaired was the free
        # cards scattered across both hosts, none with 4 free.
        assert base["fragmentation"]["avg"] == off["fragmentation"]["max"] == 0
        assert base["fragmentation"]["samples"] > 0


def test_score_deltas_against_golden_are_zero_for_a_clean_replay(plane):
    s = SIM[plane]
    golden = s.load_golden()
    assert golden is not None, f"{s.golden_path()} missing"
    t = _trace(plane, "churn_strand")
    card = s.run_trace(t, seed=t.seed)
    deltas = s.score_deltas(card, golden)
    assert deltas, "no overlapping score keys with the golden"
    assert all(v == 0 for v in deltas.values()), deltas


def test_score_deltas_report_a_regression_numerically(plane):
    s = SIM[plane]
    golden = s.load_golden()
    t = _trace(plane, "churn_strand")
    card = copy.deepcopy(s.run_trace(t, seed=t.seed))
    card["score"]["utilization"] = round(card["score"]["utilization"] - 0.25, 6)
    deltas = s.score_deltas(card, golden)
    assert deltas["utilization"] == pytest.approx(-0.25)


def test_publish_then_prune_round_trips_the_sim_families(plane):
    s, m = SIM[plane], METRICS[plane]
    t = _trace(plane, "priority_burst")
    card = s.run_trace(t, seed=t.seed)
    try:
        s.publish_metrics(card, s.score_deltas(card, s.load_golden()))
        assert m.SIM_UTILIZATION.get(trace="priority_burst") == card["score"]["utilization"]
        assert m.SIM_RUNS.get(trace="priority_burst", outcome="ok") >= 1
        s.note_run(card, {})
        snap = s.debug_snapshot()
        assert snap["enabled"] is True
        assert "priority_burst" in snap["runs"]
        assert snap["runs"]["priority_burst"]["scorecard"]["schema"] == s.SCORECARD_SCHEMA
    finally:
        s.prune_metrics()
    for fam in (m.SIM_TIME_TO_ADMIT, m.SIM_UTILIZATION, m.SIM_FRAGMENTATION,
                m.SIM_PREEMPTION_CHURN, m.SIM_DEFRAG_EFFICIENCY, m.SIM_BASELINE_DELTA):
        assert fam.series() == []


def test_scorecard_is_json_and_schema_stamped(plane):
    s = SIM[plane]
    t = _trace(plane, "churn_strand")
    card = s.run_trace(t, seed=t.seed)
    assert card["schema"] == s.SCORECARD_SCHEMA
    json.loads(s.canonical_json(card))  # round-trips
    for key in ("admitted_ratio", "time_to_admit_p50_s", "utilization", "fragmentation_avg",
                "preemption_churn_cost", "defrag_efficiency_chips_per_eviction",
                "evictions_total"):
        assert key in card["score"]
    if plane == "torch":
        # The JAX formula through placeable_sizes: 0 on every GPU node.
        assert card["score"]["fragmentation_avg"] == 0 and card["fragmentation"]["samples"] == 40


def test_cli_self_test_exits_zero(plane, capsys):
    assert SIM[plane].main(["--self-test"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["simulator_self_test"] == "ok" and line["deterministic"] is True


# -- cross-plane parity on two-card hosts ------------------------------------


def two_card_steady_mixed() -> dict:
    """steady_mixed on 6 nodes of 2 cards: a v5e host of 2 chips and an HGX
    host of 2 cards place the same sizes {1, 2}. The size mix keeps
    steady_mixed's weights (1x1, 1x2, 2x2 pods x cards), rescue is on, its
    card failure stays at tick 60, and the checkpoint wait is 0."""
    doc = _trace_doc("steady_mixed")
    doc["name"] = "steady_mixed_two_card"
    doc["nodes"] = {"count": 6, "chips_per_host": 2}
    doc["workload"]["size_mix"] = [{"pods": 1, "chips": 1, "weight": 3},
                                   {"pods": 1, "chips": 2, "weight": 2},
                                   {"pods": 2, "chips": 2, "weight": 1}]
    doc["policy"].update(rescue=True, checkpoint_wait_ticks=0)
    return doc


def two_card_churn_strand() -> dict:
    """churn_strand's cluster at two cards a host, its 429 plan unchanged: a
    one-card filler, a two-pod batch gang of one card a pod left on both
    hosts, and a 2-card standard gang stranded by the scatter."""
    doc = _trace_doc("churn_strand")
    doc["name"] = "churn_strand_two_card"
    doc["nodes"] = {"count": 2, "chips_per_host": 2}
    doc["arrivals"][0].update(pods=1, chips=1)
    doc["arrivals"][1].update(pods=2, chips=1)
    doc["arrivals"][2].update(pods=1, chips=2)
    return doc


def test_two_card_steady_mixed_scorecards_equal_byte_for_byte():
    doc = two_card_steady_mixed()
    cards = {p: SIM[p].run_trace(copy.deepcopy(doc)) for p in SIM}
    assert sim.canonical_json(cards["torch"]) == jax_sim.canonical_json(cards["jax"])
    card = cards["torch"]
    assert card["arrivals"]["scored"] == 64 and card["arrivals"]["admitted"] == 59
    assert card["score"]["evictions_total"] == 14
    # Every eviction plane acted: preemption evicted, defrag and rescue each
    # executed a round.
    assert card["preemption"]["pods_evicted"] > 0
    assert card["defrag"]["rounds_executed"] >= 1 and card["rescue"]["rounds_executed"] >= 1


def test_two_card_churn_strand_with_its_429_plan_equal_byte_for_byte():
    doc = two_card_churn_strand()
    runs = {p: SIM[p].SimRun(SIM[p].Trace.from_dict(copy.deepcopy(doc))) for p in SIM}
    cards = {p: run.run() for p, run in runs.items()}
    assert sim.canonical_json(cards["torch"]) == jax_sim.canonical_json(cards["jax"])
    # The plan's one 429 was consumed on both planes (the first defrag
    # eviction refused, the round aborted and planned again).
    assert runs["jax"].client._injector.rules[0].times == 0
    assert runs["torch"].client._plan.pick("POST", "/api/v1/namespaces/sim/pods/x/eviction") is None
    assert cards["torch"]["defrag"]["rounds_executed"] == 1
    assert cards["torch"]["arrivals"]["admitted"] == 1


# -- wall-clock independence -------------------------------------------------

HOOKED = (preemption, defrag, rescue, gang, reservations)
YEAR_LATER = sim.SIM_EPOCH + 365 * 86400.0
# The reads JAX too takes on the wall clock: the preemption round's journal
# payload stamps (JAX preemption.py:715,776) and the gang's wait origin
# (JAX gang.py:1830). None feeds a decision of the replay.
WALL_READS = {("preemption.py", "_execute"), ("gang.py", "_tick_inner")}


class _WallClock(types.ModuleType):
    """``time`` with ``time()`` a year past the virtual epoch, recording the
    (file, function) of every caller."""

    def __init__(self):
        super().__init__("time")
        self.callers = set()

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        f = sys._getframe(1)
        self.callers.add((os.path.basename(f.f_code.co_filename), f.f_code.co_name))
        return YEAR_LATER


def _read_every_hooked_path(run):
    """Drive every eviction-plane method that reads the clock and no replay
    reaches: the snapshots, the recovery seeds, the rescue plane's window
    and episode reads, its own budget (no defrag engine), and the node
    tracker on the run's clock."""
    key = ("sim", "probe")
    run.defrag.snapshot()
    run.defrag.seed_spend([sim.SIM_EPOCH])
    run.rescue.note_refenced(key)
    run.rescue.prune(set())
    run.rescue.shield(key)
    run.rescue.admit_boost(key)
    run.rescue.seed_spend([sim.SIM_EPOCH])
    run.rescue._park(key, "sim/probe", 0, reason="no_target", detail="probe")
    run.rescue.snapshot()
    shared, run.adm.defrag = run.adm.defrag, None
    try:
        run.rescue.budget_remaining()
    finally:
        run.adm.defrag = shared
    tracker = rescue.NodeStateTracker(clock=run.clock.now)
    tracker.update_node({"metadata": {"name": "sim-0"}, "spec": {"unschedulable": True}})
    assert tracker.snapshot()[0]["state_for_s"] == 0.0
    tracker.remove_node("sim-0")


@pytest.mark.parametrize("name", ["priority_burst", "chip_failure_rescue", "churn_strand"])
def test_replay_reads_no_wall_clock(name, monkeypatch):
    t = sim.load_trace(os.path.join(sim.trace_dir(), name + ".json"))
    expected = sim.canonical_json(sim.run_trace(t))
    wall = _WallClock()
    for mod in HOOKED:
        monkeypatch.setattr(mod, "time", wall)
    run = sim.SimRun(t)
    assert sim.canonical_json(run.run()) == expected
    _read_every_hooked_path(run)
    assert wall.callers <= WALL_READS, sorted(wall.callers - WALL_READS)


# -- the hooks and their defaults, on both planes' engines --------------------


def _burst_trace(priority: int) -> dict:
    """The self-test's cluster: two 4-card nodes full of batch filler, then
    one 4-card gang of ``priority``."""
    return {
        "schema": sim.TRACE_SCHEMA, "name": "hooks", "seed": 7, "tick_s": 10.0, "ticks": 6,
        "nodes": {"count": 2, "chips_per_host": 4}, "policy": {"defrag": False, "rescue": False},
        "arrivals": [
            {"at_tick": 0, "gang": f"filler-{c}", "pods": 1, "chips": 4, "priority": -10,
             "duration_ticks": 30, "duty_cycle": 10, "checkpoint_age_s": 30, "warmup": True}
            for c in "ab"] + [
            {"at_tick": 2, "gang": "g", "pods": 1, "chips": 4, "priority": priority,
             "duration_ticks": 3}],
    }


def _with_preemption(plane, trace: dict, **engine_kw):
    """A run whose preemption engine is built with ``engine_kw`` alone, its
    Events recorded."""
    s = SIM[plane]
    pre, _d, _r = ENGINES[plane]
    run = s.SimRun(s.Trace.from_dict(trace))
    events = []
    run.client.create_event = lambda *a, **kw: events.append(kw.get("reason"))
    resolver = run.adm.priority_resolver
    planner = pre.PreemptionPlanner(resolver, clock=run.clock.now)
    run.preemption = run.adm.preemption = pre.PreemptionEngine(run.adm, resolver,
                                                               planner=planner, **engine_kw)
    return run, events


def test_hook_defaults_equal_the_entry_points_behaviour(plane):
    pre, dfg, rsc = ENGINES[plane]
    s = SIM[plane]
    run = s.SimRun(s.Trace.from_dict(_burst_trace(0)))
    resolver = run.adm.priority_resolver
    engine = pre.PreemptionEngine(run.adm, resolver)
    assert engine.min_preemptor_priority == 1
    assert engine.planner._clock is time.time
    d = dfg.DefragEngine(run.adm, resolver)
    assert d.checkpoint_wait_ticks == 1
    assert d._clock is time.time and d.detector._clock is time.time
    r = rsc.RescueEngine(run.adm, resolver)
    assert r._clock is time.time and r.planner._clock is time.time
    assert rsc.NodeStateTracker()._clock is time.time
    d.close()
    r.close()


def test_preemption_posts_one_victim_event(plane):
    run, events = _with_preemption(plane, _burst_trace(2_000_000))
    card = run.run()
    assert card["preemption"]["pods_evicted"] == 1
    victim = {"jax": "TPUGangPreempted", "torch": "GPUGangPreempted"}[plane]
    assert events == [victim]


@pytest.mark.parametrize("floor,evicts", [(None, True), (2_000_001, False), (1, True)])
def test_min_preemptor_priority_sets_the_floor(plane, floor, evicts):
    kw = {} if floor is None else {"min_preemptor_priority": floor}
    run, _events = _with_preemption(plane, _burst_trace(2_000_000), **kw)
    card = run.run()
    assert (card["preemption"]["pods_evicted"] > 0) is evicts
    if not evicts:
        # Below the floor the critical gang waits out the filler.
        assert card["arrivals"]["admitted"] == 0


def test_min_preemptor_priority_default_floor_is_one(plane):
    for priority, evicts in ((0, False), (1, True)):
        run, _events = _with_preemption(plane, _burst_trace(priority))
        assert (run.run()["preemption"]["pods_evicted"] > 0) is evicts, priority


def _stale_strand_trace() -> dict:
    """churn_strand without its fault plan, the batch victim's last save
    3,000 s old (past the 300 s freshness): defrag's plan is due at the
    detector's second stranded tick."""
    doc = _trace_doc("churn_strand")
    doc.pop("faults")
    doc["arrivals"][1]["checkpoint_age_s"] = 3000.0
    return doc


@pytest.mark.parametrize("wait", [None, 0])
def test_checkpoint_wait_ticks_zero_plans_in_the_stale_tick(plane, wait):
    s = SIM[plane]
    _p, dfg, _r = ENGINES[plane]
    run = s.SimRun(s.Trace.from_dict(_stale_strand_trace()))
    events = []
    run.client.create_event = lambda *a, **kw: events.append(kw.get("reason"))
    resolver = run.adm.priority_resolver
    run.defrag.close()
    kw = {} if wait is None else {"checkpoint_wait_ticks": wait}
    run.defrag = run.adm.defrag = s._RecordingDefragEngine(
        run.adm, resolver, planner=dfg.DefragPlanner(resolver, clock=run.clock.now),
        stranded_ticks=2, clock=run.clock.now, **kw)
    run.run()
    first = min(t for t, _ns, _name in run.client.evictions)
    # The gang strands at tick 8 (its arrival) and its plan is due at the
    # second stranded tick, 9; the default holds it one more tick for the
    # stale victim's save.
    assert first == sim.SIM_EPOCH + (9 if wait == 0 else 10) * 10.0
    assert events, "the defrag round posted no victim Event"


# -- the plan reader ---------------------------------------------------------


def test_unknown_fault_key_raises_on_both_planes():
    typo = {"name": "typo", "faults": [{"knid": "status", "times": 1}]}
    with pytest.raises(ValueError, match="knid"):
        FaultInjector().load_plan(typo)
    with pytest.raises(ValueError, match="knid"):
        FaultPlan().load(typo)
    doc = dict(_trace_doc("churn_strand"), faults=typo)
    for s in SIM.values():
        with pytest.raises(ValueError, match="knid"):
            s.run_trace(copy.deepcopy(doc))


def test_fault_keys_are_the_fake_apiservers_fields():
    assert FAULT_KEYS == {f.name for f in dataclasses.fields(Fault)} - {"activated_at"}
    assert WINDOW_KEYS <= FAULT_KEYS


@pytest.mark.parametrize("window", sorted(WINDOW_KEYS))
def test_a_fault_window_is_refused_not_replayed_forever(window):
    plan = {"name": "window", "faults": [{"kind": "reset", "times": -1, window: 5}]}
    FaultInjector().load_plan(plan)
    with pytest.raises(ValueError, match=window):
        FaultPlan().load(plan)
    # The field's default (0) is no window, and loads.
    FaultPlan().load({"faults": [{"kind": "reset", "times": -1, window: 0}]})


def test_canned_plans_load_on_both_planes():
    with open(os.path.join(ROOT, "tests", "chaos_plans", "brownout.json")) as f:
        brownout = json.load(f)
    strand = _trace_doc("churn_strand")["faults"]
    for plan in (brownout, strand):
        assert len(FaultInjector().load_plan(plan)) == len(plan["faults"])
        FaultPlan().load(plan)
    # The matcher: method, path_re and times.
    fp = FaultPlan()
    fp.load(strand)
    assert fp.pick("GET", "/api/v1/namespaces/sim/pods/p/eviction") is None
    assert fp.pick("POST", "/api/v1/namespaces/sim/pods/p") is None
    assert fp.pick("POST", "/api/v1/namespaces/sim/pods/p/eviction")["status"] == 429
    assert fp.pick("POST", "/api/v1/namespaces/sim/pods/p/eviction") is None
    fp.load(brownout)
    assert [fp.pick("GET", "/api/v1/nodes")["status"] for _ in range(3)] == [429, 503, 503]
    assert all(fp.pick("PATCH", "/x")["kind"] == "reset" for _ in range(3))


# -- the port's traces -------------------------------------------------------


def test_port_canned_traces_equal_the_jax_ones():
    for name in sim.CANNED_TRACES:
        with open(os.path.join(jax_sim.trace_dir(), name + ".json"), encoding="utf-8") as f:
            assert _trace_doc(name) == json.load(f), name
    assert set(sim.load_golden()["traces"]) == set(sim.CANNED_TRACES)


def _but_fragmentation(score: dict) -> dict:
    return {k: v for k, v in score.items() if k != "fragmentation_avg"}


@pytest.mark.parametrize("name", sim.CANNED_TRACES)
def test_canned_replay_scores_equal_jax_but_fragmentation(name):
    """Each canned trace (4-card hosts) replayed on both planes: every
    score but the per-node fragmentation term, which reads 0 on GPU nodes,
    equals JAX's replay and JAX's golden, and the port's golden equals
    JAX's the same way. A policy regression in the port's preemption,
    defrag or rescue fails here even after ``--update-golden``."""
    scores = {}
    for plane, s in SIM.items():
        t = _trace(plane, name)
        scores[plane] = s.run_trace(t, seed=t.seed)["score"]
    jax_golden = jax_sim.load_golden()["traces"][name]["score"]
    port_golden = sim.load_golden()["traces"][name]["score"]
    assert set(scores["torch"]) == set(jax_golden) == set(port_golden)
    assert _but_fragmentation(scores["torch"]) == _but_fragmentation(scores["jax"])
    assert _but_fragmentation(scores["jax"]) == _but_fragmentation(jax_golden)
    assert _but_fragmentation(port_golden) == _but_fragmentation(jax_golden)
    assert scores["torch"]["fragmentation_avg"] == port_golden["fragmentation_avg"] == 0


def test_hgx_su_loads_and_a_prefix_replays_byte_identical():
    t = sim.load_trace(os.path.join(sim.trace_dir(), "hgx_su.json"))
    assert (t.node_count, t.chips_per_host, t.ticks, t.tick_s) == (32, 8, 480, 60.0)
    assert "hgx_su" not in sim.CANNED_TRACES and "hgx_su" not in sim.load_golden()["traces"]
    sizes = {(s["pods"], s["chips"]) for s in t.workload["size_mix"]}
    assert sizes == {(1, 1), (1, 2), (1, 4), (1, 8), (2, 8), (4, 8)}
    assert 1_000_000 in {p["priority"] for p in t.workload["priority_mix"]}
    assert len(t.chip_failures) == 2
    prefix = dict(_trace_doc("hgx_su"), ticks=48)
    a, b = sim.run_trace(copy.deepcopy(prefix)), sim.run_trace(copy.deepcopy(prefix))
    assert sim.canonical_json(a) == sim.canonical_json(b)
    assert a["arrivals"]["admitted"] > 0 and a["utilization"]["chip_seconds_capacity"] == (
        256 * 48 * 60.0)


def test_scheduling_quality_probe_is_deterministic_and_publishes():
    try:
        out = sim.scheduling_quality()
        assert out["deterministic"] is True and out["golden_found"] is True
        assert len(out["determinism_sha256"]) == 64
        assert set(out["traces"]) == set(sim.CANNED_TRACES)
        assert all(v == 0 for d in out["deltas"].values() for v in d.values())
        for name in sim.CANNED_TRACES:
            assert metrics.SIM_RUNS.get(trace=name, outcome="ok") >= 1
            assert (metrics.SIM_UTILIZATION.get(trace=name)
                    == out["traces"][name]["score"]["utilization"])
        assert sim.debug_snapshot()["enabled"] is True
    finally:
        sim.prune_metrics()
