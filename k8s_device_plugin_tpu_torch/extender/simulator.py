"""Trace-driven scheduling-quality simulator: replay arrival traces through
the real admission, preemption, defragmentation and rescue stack at
compressed time and score the decisions, not the latencies. The twin of the
JAX package's ``extender/simulator.py`` over GPU nodes.

The flamegraphs, the audit plane and the extender's timings show how fast
the scheduler is; nothing else shows whether a change to the three eviction
planes (``preemption.py``, ``defrag.py``, ``rescue.py``) makes their
decisions worse: a refactor can keep ``/filter`` fast while admitting
high-tier gangs later, stranding demand longer or paying more restart cost
per eviction. This module measures that:

* **Replay.** A discrete-event loop drives a virtual cluster of synthetic
  HGX nodes (H100 cards, every pair NV18, ``topology/schema.hgx_topology``)
  with mutable availability, and a trace (explicit arrivals and/or a seeded
  generator: gang size mix, priority mix, bursts, churn, card failures, and
  an API-server fault plan of the chaos-plan shape) through a real
  ``GangAdmission``, ``PreemptionEngine``, ``DefragEngine`` and
  ``RescueEngine`` wired as the extender's entry point wires them (the same
  planners, cost model and eviction door) against a client defined here. The
  simulator plays the scheduler's part: a released gang binds onto its
  reservation's hosts, departures and evictions free cards, an evicted gang
  re-arrives gated.

* **Determinism.** Every decision-relevant clock is the run's virtual clock
  (the reservations, the resolver, the planners, the three engines and the
  detector, through their ``clock`` options), arrivals come from an explicit
  list or ``random.Random(seed)``, and the scorecard is computed from virtual
  timestamps alone: one trace and seed give a byte-identical scorecard
  (``canonical_json``), so a difference between two runs is the code's.

* **Scoring.** Time to admit by priority tier, utilisation (bound
  card-seconds over live capacity), fragmentation over time (1 - largest
  placeable size / free cards per node, sampled per tick through
  ``placeable_sizes``: a GPU node places every n up to its free count, so
  this reads 0 here, and a GPU cluster's stranding is only the scatter of
  free cards across nodes), preemption churn (``Victim.restart_cost`` as
  paid), defrag efficiency (stranded-size cards made placeable per eviction
  spent) and the rescue plane's time to rescue.

Surfaces: the ``tpu_sim_*`` families on the extender registry (published per
completed run), ``/debug/simreport`` (the last scorecards of this process and
their golden deltas, served at once, never running a replay inline), and the
``tpu-simreport`` CLI (``python -m k8s_device_plugin_tpu_torch.tools.simreport``)
rendering score deltas against the port's golden baseline
(``extender/sim_traces/golden.json``).

A run's own event counts live on a run-local registry, never the production
one: a replay inside the extender's process must not inflate production
counters (tpu-lint's TPL011 polices the naming half of that boundary). This
module imports neither ``torch`` nor ``jax``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
from typing import Dict, List, Optional, Tuple

from ..api import constants
from ..kube.client import KubeError
from ..topology.placement import placeable_sizes
from ..topology.schema import NodeTopology, hgx_topology
from ..utils import metrics
from ..utils.resilience import FaultPlan
from .preemption import PreemptionEngine, PreemptionPlanner, PriorityResolver, Victim, tier_label

GangKey = Tuple[str, str]

TRACE_SCHEMA = "tpu-sim-trace/v1"
SCORECARD_SCHEMA = "tpu-sim-scorecard/v1"
GOLDEN_SCHEMA = "tpu-sim-golden/v1"

# Virtual epoch: a plausible unix-scale origin so checkpoint-beacon
# timestamps parse the way production stamps do (age = now - ts).
SIM_EPOCH = 1_700_000_000.0

# Ticks an evicted or failed gang stays gone before re-arriving gated: the
# restart the churn score prices.
RESTART_DELAY_TICKS = 1

DEFAULT_SEED = 1234

# The canned traces every golden run replays (``sim_traces/<name>.json``).
CANNED_TRACES = (
    "steady_mixed", "priority_burst", "churn_strand",
    "chip_failure_rescue",
)


def trace_dir() -> str:
    """The traces beside this module (``extender/sim_traces/``): the
    package carries its own, so ``tpu-simreport`` runs from it alone."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "sim_traces")


def golden_path() -> str:
    return os.path.join(trace_dir(), "golden.json")


class VirtualClock:
    """The run's only time source: advanced by the event loop, read by every
    decision-relevant component (the reservations' TTLs, the resolver's
    cache, the planners' checkpoint ages, the engines' budget windows, the
    detector's and the rescue plane's episodes)."""

    def __init__(self, start: float = SIM_EPOCH):
        self.t = float(start)

    def now(self) -> float:
        return self.t


def canonical_json(doc: dict) -> str:
    """The byte-identity form of a scorecard: sorted keys, no whitespace
    variance. Two runs are identical iff these strings are equal."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _rounded(obj):
    """Every float rounded to 6 decimals, recursively: float noise from
    another summation order must not break byte-identity for a difference
    no score cares about."""
    if isinstance(obj, float):
        return round(obj, 6)
    if isinstance(obj, dict):
        return {k: _rounded(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_rounded(v) for v in obj]
    return obj


def _pctls(samples: List[float]) -> Dict[str, float]:
    """A deterministic percentile summary over virtual seconds."""
    xs = sorted(samples)
    if not xs:
        return {"p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0, "samples": 0}
    return {
        "p50_s": xs[len(xs) // 2],
        "p99_s": xs[min(len(xs) - 1, int(len(xs) * 0.99))],
        "max_s": xs[-1],
        "samples": len(xs),
    }


# -- the trace ---------------------------------------------------------------


@dataclasses.dataclass
class Arrival:
    at_tick: int
    gang: str
    pods: int
    chips: int
    priority: int
    duration_ticks: Optional[int] = None  # None: runs forever
    duty_cycle: Optional[float] = None
    checkpoint_age_s: Optional[float] = None
    # Warmup arrivals occupy capacity but stay out of the time-to-admit
    # score: instantly admitted batch filler must not drag the batch tier's
    # p50 to zero and fake the tier ordering.
    warmup: bool = False


@dataclasses.dataclass
class Trace:
    name: str
    seed: int
    tick_s: float
    ticks: int
    node_count: int
    chips_per_host: int
    arrivals: List[Arrival]
    workload: Optional[dict] = None
    chip_failures: List[dict] = dataclasses.field(default_factory=list)
    faults: Optional[dict] = None
    policy: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(doc: dict) -> "Trace":
        if doc.get("schema") != TRACE_SCHEMA:
            raise ValueError(f"not a {TRACE_SCHEMA} trace: schema={doc.get('schema')!r}")
        nodes = doc.get("nodes") or {}
        return Trace(
            name=str(doc.get("name", "unnamed")),
            seed=int(doc.get("seed", DEFAULT_SEED)),
            tick_s=float(doc.get("tick_s", 10.0)),
            ticks=int(doc.get("ticks", 60)),
            node_count=int(nodes.get("count", 2)),
            chips_per_host=int(nodes.get("chips_per_host", 4)),
            arrivals=[
                Arrival(
                    at_tick=int(a["at_tick"]),
                    gang=str(a["gang"]),
                    pods=int(a.get("pods", 1)),
                    chips=int(a.get("chips", 1)),
                    priority=int(a.get("priority", 0)),
                    duration_ticks=(None if a.get("duration_ticks") is None
                                    else int(a["duration_ticks"])),
                    duty_cycle=(None if a.get("duty_cycle") is None
                                else float(a["duty_cycle"])),
                    checkpoint_age_s=(None if a.get("checkpoint_age_s") is None
                                      else float(a["checkpoint_age_s"])),
                    warmup=bool(a.get("warmup", False)),
                )
                for a in doc.get("arrivals") or []
            ],
            workload=doc.get("workload"),
            chip_failures=list(doc.get("chip_failures") or []),
            faults=doc.get("faults"),
            policy=dict(doc.get("policy") or {}),
        )


def load_trace(path: str) -> Trace:
    with open(path, encoding="utf-8") as f:
        return Trace.from_dict(json.load(f))


def _expand_workload(trace: Trace, rng: random.Random) -> List[Arrival]:
    """Expand the generator spec into concrete arrivals (the seeded RNG's
    draws in the JAX order, so a trace expands alike on both planes);
    explicit arrivals pass through untouched and sort stably in front of
    generated ones at the same tick."""
    spec = trace.workload
    out = list(trace.arrivals)
    if not spec:
        return out

    def _weighted(pairs, pick):
        total = sum(w for _, w in pairs)
        x = pick * total
        for item, w in pairs:
            x -= w
            if x < 0:
                return item
        return pairs[-1][0]

    sizes = [
        ((int(s.get("pods", 1)), int(s.get("chips", 1))), float(s.get("weight", 1)))
        for s in spec.get("size_mix") or [{"pods": 1, "chips": 1}]
    ]
    prios = [
        (int(p.get("priority", 0)), float(p.get("weight", 1)))
        for p in spec.get("priority_mix") or [{"priority": 0}]
    ]
    rate = float(spec.get("rate_per_tick", 0.5))
    dur_lo, dur_hi = spec.get("duration_ticks") or [4, 12]
    duty_lo, duty_hi = spec.get("duty_cycle") or [10.0, 90.0]
    ck_lo, ck_hi = spec.get("checkpoint_age_s") or [0.0, 600.0]
    start = int(spec.get("start_tick", 0))
    end = int(spec.get("end_tick") or trace.ticks)
    n = 0
    for tick in range(start, min(end, trace.ticks)):
        # floor(rate) arrivals a tick, plus one more with probability
        # frac(rate).
        count = int(rate) + (1 if rng.random() < (rate - int(rate)) else 0)
        for _ in range(count):
            pods, chips = _weighted(sizes, rng.random())
            out.append(Arrival(
                at_tick=tick,
                gang=f"gen-{n:03d}",
                pods=pods,
                chips=chips,
                priority=_weighted(prios, rng.random()),
                duration_ticks=rng.randint(int(dur_lo), int(dur_hi)),
                duty_cycle=round(rng.uniform(duty_lo, duty_hi), 1),
                checkpoint_age_s=round(rng.uniform(ck_lo, ck_hi), 1),
            ))
            n += 1
    out.sort(key=lambda a: (a.at_tick, a.gang))
    return out


# -- the virtual cluster -----------------------------------------------------


class _SimNode:
    """One synthetic HGX node of ``chips`` H100 cards. Availability and
    withdrawals stay in card order, as the JAX node keeps mesh order."""

    def __init__(self, name: str, chips: int):
        self.name = name
        self._template = hgx_topology(name, chips)
        # The link topology is built once; every tick's published view
        # shares it (NodeTopology memoizes it per instance).
        self.links = self._template.to_topology()
        self.ids: List[str] = [c.id for c in self._template.chips]
        self._order = {cid: i for i, cid in enumerate(self.ids)}
        self.avail: List[str] = list(self.ids)
        # Withdrawn card ids, published on the topology as the controller
        # publishes the health watcher's withdrawals: the rescue plane's
        # detection reads this field.
        self.failed_ids: List[str] = []

    def take(self, n: int) -> List[str]:
        ids, self.avail = self.avail[:n], self.avail[n:]
        return ids

    def give(self, ids: List[str]) -> None:
        # Card-order availability keeps the binder's pick deterministic and
        # stable across runs. A withdrawn card never returns to the pool.
        dead = set(self.failed_ids)
        self.avail = sorted((set(self.avail) | set(ids)) - dead,
                            key=lambda c: self._order.get(c, 1 << 30))

    def fail(self, n: int) -> Tuple[int, List[str]]:
        """Take ``n`` cards out of service, free cards last-first. Returns
        (cards actually failed from the free pool, ids): the caller handles
        a bound pod's cards for the remainder."""
        took = self.avail[-n:] if n > 0 else []
        self.avail = self.avail[: len(self.avail) - len(took)]
        self.failed_ids.extend(took)
        return len(took), took

    def fail_bound(self, ids: List[str]) -> None:
        """Withdraw cards a bound pod holds without killing the pod: the
        overcommit (bound above healthy) is what the rescue plane's count
        join detects."""
        self.failed_ids.extend(cid for cid in ids if cid not in self.failed_ids)

    @property
    def failed(self) -> int:
        return len(self.failed_ids)

    @property
    def capacity(self) -> int:
        return len(self.ids) - len(self.failed_ids)

    def topology(self) -> NodeTopology:
        """The node as its daemon publishes it now (``available`` and
        ``failed`` sorted, as ``NodeTopology.from_topology`` sorts them)."""
        topo = dataclasses.replace(self._template, available=sorted(self.avail),
                                   failed=sorted(self.failed_ids))
        topo.__dict__["_topology"] = self.links
        return topo


class SimClient:
    """The client surface GangAdmission and the eviction planes touch, with
    the chaos-plan shape riding the same verbs through ``FaultPlan``: a
    matched ``status`` fault raises the KubeError the real client would, so
    the eviction door's 429/405 semantics (and the tick's survive-anything
    wrapper) run as against the hostile API server."""

    def __init__(self, clock: VirtualClock, plan: Optional[FaultPlan] = None):
        self.pods: Dict[Tuple[str, str], dict] = {}
        self.evictions: List[Tuple[float, str, str]] = []
        self._clock = clock
        self._plan = plan

    def _fault(self, method: str, path: str) -> None:
        if self._plan is None:
            return
        f = self._plan.pick(method, path)
        if f is None:
            return
        kind = f.get("kind", "status")
        if kind == "status":
            raise KubeError(int(f.get("status", 500)), str(f.get("message", "injected fault")))
        # reset, hang and truncate degrade to a connection-shaped failure at
        # this layer (there is no wire to cut in-process).
        raise OSError(f"injected {kind}")

    def list_pods(self, label_selector: str = "", **_):
        self._fault("GET", "/api/v1/pods")
        return {"items": [dict(p) for p in self.pods.values()]}

    def get_pod(self, ns: str, name: str) -> dict:
        return dict(self.pods[(ns, name)])

    def evict_pod(self, ns: str, name: str):
        self._fault("POST", f"/api/v1/namespaces/{ns}/pods/{name}/eviction")
        self.evictions.append((self._clock.now(), ns, name))
        self.pods.pop((ns, name), None)
        return {}

    def delete_pod(self, ns: str, name: str):
        self.pods.pop((ns, name), None)
        return {}

    def remove_pod_scheduling_gate(self, ns, name, gate, gates):
        self._fault("PATCH", f"/api/v1/namespaces/{ns}/pods/{name}")
        pod = self.pods[(ns, name)]
        pod["spec"]["schedulingGates"] = [g for g in gates if g.get("name") != gate]

    def patch_pod_annotations(self, ns, name, ann):
        pod = self.pods.get((ns, name))
        if pod is not None:
            pod.setdefault("metadata", {}).setdefault("annotations", {}).update(
                {k: v for k, v in ann.items() if v is not None})

    def create_event(self, *a, **kw):
        pass


@dataclasses.dataclass
class _SimGang:
    name: str
    pods: int
    chips: int
    priority: int
    duration_ticks: Optional[int]
    duty_cycle: Optional[float]
    checkpoint_age_s: Optional[float]
    warmup: bool
    arrival_t: float = 0.0
    admit_t: Optional[float] = None
    depart_tick: Optional[int] = None
    generation: int = 0
    evicted_count: int = 0
    # Virtual time of the card failure that degraded this gang: cleared, and
    # scored as its time to rescue, once it runs again.
    degraded_t: Optional[float] = None
    # pod name -> (host, card ids) of its bound pods.
    bindings: Dict[str, Tuple[str, List[str]]] = dataclasses.field(default_factory=dict)

    @property
    def tier(self) -> str:
        return tier_label(self.priority)


# -- the run -----------------------------------------------------------------


class SimRun:
    """One deterministic replay of one trace through the real stack."""

    NS = "sim"

    def __init__(self, trace: Trace, seed: Optional[int] = None,
                 policy_overrides: Optional[dict] = None):
        from .gang import GangAdmission
        from .reservations import ReservationTable

        self.trace = trace
        self.seed = trace.seed if seed is None else int(seed)
        self.clock = VirtualClock()
        self.rng = random.Random(self.seed)
        self.policy = dict(trace.policy)
        self.policy.update(policy_overrides or {})
        self.nodes: Dict[str, _SimNode] = {
            f"sim-{i}": _SimNode(f"sim-{i}", trace.chips_per_host)
            for i in range(trace.node_count)
        }
        self.gangs: Dict[GangKey, _SimGang] = {}
        self.arrivals = _expand_workload(trace, self.rng)
        self._restarts: Dict[int, List[GangKey]] = {}
        self.client = SimClient(self.clock, plan=self._fault_plan(trace.faults))
        # Per-run event counters live on a LOCAL registry: a replay must not
        # inflate the production families a live extender in the same
        # process exports (TPL011's boundary). The default uptime_name
        # stands: this registry is never rendered, and a custom name here
        # would read as a phantom family to the uptime scanner.
        self._reg = metrics.Registry()
        self._events = self._reg.counter(
            "tpu_sim_run_events_total",
            "simulated cluster events inside one replay, by event",
        )

        table = ReservationTable(clock=self.clock.now)
        self.adm = GangAdmission(self.client, reservations=table,
                                 topo_source=self._topo_source, pending_event_threshold_s=0)
        self.table = table
        resolver = PriorityResolver(clock=self.clock.now)
        self.adm.priority_resolver = resolver
        self.preemption = None
        if self.policy.get("preemption", True):
            planner = PreemptionPlanner(resolver, duty_source=self._duty_source,
                                        clock=self.clock.now)
            self.preemption = PreemptionEngine(
                self.adm, resolver, planner=planner,
                min_preemptor_priority=int(self.policy.get("min_preemptor_priority", 1)))
            self.adm.preemption = self.preemption
        self.defrag = None
        if self.policy.get("defrag", True):
            from .defrag import DefragPlanner

            dplanner = DefragPlanner(resolver, duty_source=self._duty_source,
                                     clock=self.clock.now)
            self.defrag = _RecordingDefragEngine(
                self.adm, resolver, planner=dplanner,
                stranded_ticks=int(self.policy.get("stranded_ticks", 2)),
                max_evictions_per_hour=int(self.policy.get("max_evictions_per_hour", 12)),
                checkpoint_wait_ticks=int(self.policy.get("checkpoint_wait_ticks", 0)),
                clock=self.clock.now)
            self.adm.defrag = self.defrag
        self.rescue = None
        if self.policy.get("rescue", True):
            rplanner = PreemptionPlanner(resolver, duty_source=self._duty_source,
                                         clock=self.clock.now)
            self.rescue = _RecordingRescueEngine(
                self.adm, resolver, planner=rplanner,
                grace_ticks=int(self.policy.get("rescue_grace_ticks", 1)),
                max_evictions_per_hour=int(self.policy.get("max_evictions_per_hour", 12)),
                clock=self.clock.now)
            self.adm.rescue = self.rescue
        # Scoring accumulators.
        self.tick_errors = 0
        self.frag_sum = 0.0
        self.frag_max = 0.0
        self.frag_samples = 0
        self.used_chip_s = 0.0
        self.cap_chip_s = 0.0
        self.preempt_cost = 0.0
        self.preempt_gangs = 0
        self.preempt_pods = 0
        self.defrag_cost = 0.0
        self.defrag_recovered = 0
        self.readmissions = 0
        self.chips_failed = 0
        self.fail_restarts = 0
        self.rescued_gangs = 0
        self.rescue_victim_cost = 0.0
        self.rescue_times: List[float] = []
        self.rescue_pending_ticks = 0
        self.hw_lost_cost = 0.0
        self._rescue_rounds_seen = 0

    # -- wiring ------------------------------------------------------------

    @staticmethod
    def _fault_plan(faults: Optional[dict]) -> Optional[FaultPlan]:
        if not faults:
            return None
        # The package's one plan reader, strict about fault keys as the fake
        # API server's loader is: the replay takes exactly the plans the
        # chaos suites use.
        plan = FaultPlan()
        plan.load(faults)
        return plan

    def _topo_source(self) -> List[NodeTopology]:
        return [self.nodes[n].topology() for n in sorted(self.nodes)]

    def _duty_source(self) -> Dict[str, float]:
        return {g.name: g.duty_cycle for g in self.gangs.values() if g.duty_cycle is not None}

    # -- cluster mutation --------------------------------------------------

    def _pod_names(self, g: _SimGang) -> List[str]:
        return [f"{g.name}-g{g.generation}-w{i}" for i in range(g.pods)]

    def _create_pods(self, g: _SimGang) -> None:
        from .gang import GANG_SIZE_LABEL, GATE_NAME

        ckpt_ts = None
        if g.checkpoint_age_s is not None:
            ckpt_ts = self.clock.now() - g.checkpoint_age_s
        for name in self._pod_names(g):
            pod = {
                "metadata": {
                    "name": name,
                    "namespace": self.NS,
                    "uid": f"uid-{name}",
                    "labels": {constants.GANG_NAME_LABEL: g.name, GANG_SIZE_LABEL: str(g.pods)},
                    "annotations": {},
                },
                "spec": {
                    "schedulingGates": [{"name": GATE_NAME}],
                    "priority": g.priority,
                    "containers": [{"name": "c", "resources": {
                        "requests": {constants.RESOURCE_NAME: str(g.chips)}}}],
                },
                "status": {},
            }
            if ckpt_ts is not None:
                pod["metadata"]["annotations"][constants.CHECKPOINT_TS_ANNOTATION] = str(ckpt_ts)
            self.client.pods[(self.NS, name)] = pod

    def _arrive(self, tick: int) -> None:
        for a in self.arrivals:
            if a.at_tick != tick:
                continue
            g = _SimGang(name=a.gang, pods=a.pods, chips=a.chips, priority=a.priority,
                         duration_ticks=a.duration_ticks, duty_cycle=a.duty_cycle,
                         checkpoint_age_s=a.checkpoint_age_s, warmup=a.warmup,
                         arrival_t=self.clock.now())
            self.gangs[(self.NS, g.name)] = g
            self._create_pods(g)
            self._events.inc(event="arrival")
        for key in self._restarts.pop(tick, []):
            g = self.gangs.get(key)
            if g is None:
                continue
            g.generation += 1
            g.bindings = {}
            # The first admission stands; the churn is scored.
            self._create_pods(g)
            self._events.inc(event="restart_arrival")

    def _depart(self, tick: int) -> None:
        for key in sorted(self.gangs):
            g = self.gangs[key]
            if g.depart_tick is None or g.depart_tick != tick:
                continue
            for pod_name, (host, ids) in sorted(g.bindings.items()):
                self.client.delete_pod(self.NS, pod_name)
                self.nodes[host].give(ids)
            g.bindings = {}
            g.depart_tick = None
            g.duration_ticks = 0  # done; never restarts
            self._events.inc(event="departure")

    def _fail_chips(self, tick: int) -> None:
        for spec in self.trace.chip_failures:
            if int(spec.get("at_tick", -1)) != tick:
                continue
            node = self.nodes.get(str(spec.get("node", "")))
            want = int(spec.get("chips", 1))
            if node is None or want <= 0:
                continue
            got, _ids = node.fail(want)
            self.chips_failed += got
            short = want - got
            if short <= 0:
                continue
            if self.rescue is not None:
                # The rescue plane is wired: withdraw the cards under the
                # bound pods and leave them running degraded. The engine's
                # count join (bound above healthy on the published topology)
                # detects it and evacuates through the eviction door, as in
                # production.
                self._fail_bound_rescued(node, short)
                continue
            # No rescue plane: the bound pods on that node die with their
            # cards, and their whole gang restarts gated.
            for key in sorted(self.gangs):
                if short <= 0:
                    break
                g = self.gangs[key]
                on_node = sorted(p for p, (h, _c) in g.bindings.items() if h == node.name)
                if not on_node:
                    continue
                for pod_name in on_node:
                    _h, ids = g.bindings.pop(pod_name)
                    self.client.delete_pod(self.NS, pod_name)
                    lost = min(short, len(ids))
                    node.fail_bound(ids[:lost])
                    short -= lost
                    self.chips_failed += lost
                    if len(ids) > lost:
                        node.give(ids[lost:])
                    if short <= 0:
                        break
                # The rest of the gang restarts: its cards freed, gated again
                # next tick.
                for pod_name in sorted(g.bindings):
                    host, ids = g.bindings.pop(pod_name)
                    self.client.delete_pod(self.NS, pod_name)
                    self.nodes[host].give(ids)
                g.depart_tick = None
                self.fail_restarts += 1
                self.hw_lost_cost += Victim(
                    key=key, priority=g.priority, hosts={}, pods=[], duty_cycle=g.duty_cycle,
                    checkpoint_age_s=g.checkpoint_age_s).restart_cost()
                self._events.inc(event="chip_failure_restart")
                self._restarts.setdefault(tick + RESTART_DELAY_TICKS, []).append(key)

    def _fail_bound_rescued(self, node: _SimNode, short: int) -> None:
        """Withdraw ``short`` cards from bound pods on ``node`` without
        killing anything: the rescue plane owns the evacuation from here.
        The gangs touched are stamped degraded_t for the time-to-rescue
        score."""
        for key in sorted(self.gangs):
            if short <= 0:
                return
            g = self.gangs[key]
            for pod_name in sorted(g.bindings):
                host, ids = g.bindings[pod_name]
                if host != node.name or short <= 0:
                    continue
                lost = min(short, len(ids))
                node.fail_bound(ids[:lost])
                short -= lost
                self.chips_failed += lost
                if g.degraded_t is None:
                    g.degraded_t = self.clock.now()
                    self._events.inc(event="gang_degraded")

    def _bind(self, released: List[GangKey], tick: int) -> None:
        for key in released:
            g = self.gangs.get(key)
            if g is None:
                continue
            hold = self.table.active().get(key)
            alloc: Dict[str, int] = (
                {h: n for h, n in sorted(hold.hosts.items())} if hold is not None else {})
            for pod_name in self._pod_names(g):
                if pod_name in g.bindings:
                    continue
                host = next((h for h, n in alloc.items() if n >= g.chips), None)
                if host is None:
                    host = next((n for n in sorted(self.nodes)
                                 if len(self.nodes[n].avail) >= g.chips), None)
                if host is None:
                    continue  # the hold drifted; the pod stays pending
                if host in alloc:
                    alloc[host] -= g.chips
                ids = self.nodes[host].take(g.chips)
                pod = self.client.pods.get((self.NS, pod_name))
                if pod is not None:
                    pod["spec"]["nodeName"] = host
                g.bindings[pod_name] = (host, ids)
            if g.admit_t is None:
                g.admit_t = self.clock.now()
                self._events.inc(event="admit")
                if g.duration_ticks:
                    g.depart_tick = tick + g.duration_ticks
            else:
                self.readmissions += 1
                self._events.inc(event="readmit")
                if g.duration_ticks:
                    g.depart_tick = tick + g.duration_ticks
            if g.degraded_t is not None and len(g.bindings) == g.pods:
                # Running again on healthy cards: the episode's time to
                # rescue is failure to full re-bind.
                self.rescue_times.append(self.clock.now() - g.degraded_t)
                g.degraded_t = None
                self._events.inc(event="rescued_running")

    def _drain_evictions(self, mark: int, tick: int) -> None:
        new = self.client.evictions[mark:]
        if not new:
            return
        defrag_pods = {
            (p.get("ns", ""), p.get("name", ""))
            for plan in (self.defrag.executed_plans if self.defrag else [])
            for v in plan.victims
            for p in v.pods
        }
        # Only the rounds executed since the last drain classify this
        # window's evictions: a gang rescued earlier in the run can still be
        # a plain preemption victim later.
        new_rounds: List[dict] = []
        if self.rescue is not None:
            new_rounds = self.rescue.executed_rounds[self._rescue_rounds_seen:]
            self._rescue_rounds_seen = len(self.rescue.executed_rounds)
        rescue_victim_pods = {
            (p.get("ns", ""), p.get("name", ""))
            for rnd in new_rounds
            for v in rnd["victims"]
            for p in v.pods
        }
        rescued_keys = {rnd["key"] for rnd in new_rounds}
        by_gang: Dict[GangKey, List[str]] = {}
        for _t, ns, name in new:
            gang_name = name.rsplit("-g", 1)[0]
            by_gang.setdefault((self.NS, gang_name), []).append(name)
            self._events.inc(event="eviction")
        for key in sorted(by_gang):
            g = self.gangs.get(key)
            if g is None:
                continue
            cost = Victim(key=key, priority=g.priority, hosts={}, pods=[],
                          duty_cycle=g.duty_cycle,
                          checkpoint_age_s=g.checkpoint_age_s).restart_cost()
            pods = by_gang[key]
            is_defrag = any((self.NS, p) in defrag_pods for p in pods)
            is_rescue_victim = any((self.NS, p) in rescue_victim_pods for p in pods)
            if key in rescued_keys:
                # The degraded gang's own evacuation: the restart it pays is
                # work the hardware cost it, and it re-admits against the
                # standing rescue fence.
                self.rescued_gangs += 1
                self.hw_lost_cost += cost
                self._events.inc(event="rescue_evacuation")
            elif is_rescue_victim:
                self.rescue_victim_cost += cost
                self._events.inc(event="rescue_victim")
            elif is_defrag:
                self.defrag_cost += cost
            else:
                self.preempt_cost += cost
                self.preempt_gangs += 1
                self.preempt_pods += len(pods)
            g.evicted_count += 1
            # Free the evicted pods' cards and drop any survivors of the same
            # gang (an evicted gang restarts whole).
            for pod_name in pods:
                bound = g.bindings.pop(pod_name, None)
                if bound is not None:
                    host, ids = bound
                    self.nodes[host].give(ids)
            for pod_name in sorted(g.bindings):
                host, ids = g.bindings.pop(pod_name)
                self.client.delete_pod(self.NS, pod_name)
                self.nodes[host].give(ids)
            g.depart_tick = None
            self._restarts.setdefault(tick + RESTART_DELAY_TICKS, []).append(key)

    def _score_defrag(self, plan_mark: int) -> None:
        if self.defrag is None:
            return
        for plan in self.defrag.executed_plans[plan_mark:]:
            self.defrag_recovered += plan.size

    def _sample(self) -> None:
        per_node: List[float] = []
        bound = 0
        cap = 0
        for name in sorted(self.nodes):
            node = self.nodes[name]
            cap += node.capacity
            free = len(node.avail)
            bound += node.capacity - free
            if free <= 0:
                continue
            # The JAX formula through the one entry point: a GPU node places
            # every size up to its free count, so each term reads 0.
            sizes = placeable_sizes(node.links, node.avail)
            largest = max(sizes) if sizes else 0
            per_node.append(1.0 - largest / free)
        self.used_chip_s += bound * self.trace.tick_s
        self.cap_chip_s += cap * self.trace.tick_s
        if per_node:
            frag = sum(per_node) / len(per_node)
            self.frag_sum += frag
            self.frag_max = max(self.frag_max, frag)
            self.frag_samples += 1

    # -- the loop ----------------------------------------------------------

    def run(self) -> dict:
        try:
            for tick in range(self.trace.ticks):
                self.clock.t = SIM_EPOCH + tick * self.trace.tick_s
                self._fail_chips(tick)
                self._depart(tick)
                self._arrive(tick)
                evict_mark = len(self.client.evictions)
                plan_mark = len(self.defrag.executed_plans) if self.defrag else 0
                try:
                    released = self.adm.tick()
                except Exception:  # noqa: BLE001 - a fault-plan hit mid-tick is
                    # the production loop's survive-and-retry shape, scored
                    # rather than fatal
                    self.tick_errors += 1
                    self._events.inc(event="tick_error")
                    released = []
                self._drain_evictions(evict_mark, tick)
                self._bind(released, tick)
                self._score_defrag(plan_mark)
                if self.rescue is not None:
                    # Gang-ticks parked RESCUE_PENDING: the stranded-demand
                    # exposure hardware failures cost.
                    self.rescue_pending_ticks += len(self.rescue.pending_state())
                self._sample()
            return self._scorecard()
        finally:
            if self.defrag is not None:
                self.defrag.close()
            if self.rescue is not None:
                self.rescue.close()

    # -- scoring -----------------------------------------------------------

    def _scorecard(self) -> dict:
        scored = [g for g in self.gangs.values() if not g.warmup]
        admitted = [g for g in scored if g.admit_t is not None]
        waits = {g.name: g.admit_t - g.arrival_t for g in admitted}
        tiers: Dict[str, dict] = {}
        for tier in ("critical", "high", "standard", "batch"):
            arrived = [g for g in scored if g.tier == tier]
            if not arrived:
                continue
            tier_waits = [waits[g.name] for g in arrived if g.name in waits]
            tiers[tier] = dict(_pctls(tier_waits), arrived=len(arrived),
                               admitted=len(tier_waits))
        d_evictions = len(self.defrag.spend_window()) if self.defrag else 0
        efficiency = self.defrag_recovered / d_evictions if d_evictions else 0.0
        overall = _pctls(list(waits.values()))
        events = {
            labels.get("event", ""): int(v)
            for labels, v in sorted(self._events.series(), key=lambda s: sorted(s[0].items()))
        }
        card = {
            "schema": SCORECARD_SCHEMA,
            "trace": self.trace.name,
            "seed": self.seed,
            "ticks": self.trace.ticks,
            "tick_s": self.trace.tick_s,
            "virtual_seconds": self.trace.ticks * self.trace.tick_s,
            "policy": {
                "preemption": self.preemption is not None,
                "defrag": self.defrag is not None,
                "rescue": self.rescue is not None,
                **{k: self.policy[k] for k in sorted(self.policy)
                   if k not in ("preemption", "defrag", "rescue")},
            },
            "arrivals": {
                "scored": len(scored),
                "warmup": len(self.gangs) - len(scored),
                "admitted": len(admitted),
                "readmissions": self.readmissions,
            },
            "time_to_admit_s": tiers,
            "utilization": {
                "chip_seconds_used": self.used_chip_s,
                "chip_seconds_capacity": self.cap_chip_s,
                "ratio": self.used_chip_s / self.cap_chip_s if self.cap_chip_s else 0.0,
            },
            "fragmentation": {
                "avg": self.frag_sum / self.frag_samples if self.frag_samples else 0.0,
                "max": self.frag_max,
                "samples": self.frag_samples,
            },
            "preemption": {
                "gangs_evicted": self.preempt_gangs,
                "pods_evicted": self.preempt_pods,
                "restart_cost_paid": self.preempt_cost,
            },
            "defrag": {
                "rounds_executed": len(self.defrag.executed_plans) if self.defrag else 0,
                "evictions_spent": d_evictions,
                "placeability_recovered_chips": self.defrag_recovered,
                "efficiency_chips_per_eviction": efficiency,
                "restart_cost_paid": self.defrag_cost,
            },
            "rescue": {
                "enabled": self.rescue is not None,
                "rounds_executed": len(self.rescue.executed_rounds) if self.rescue else 0,
                "gangs_rescued": self.rescued_gangs,
                "time_to_rescue_s": _pctls(self.rescue_times),
                "pending_gang_ticks": self.rescue_pending_ticks,
                "victim_restart_cost_paid": self.rescue_victim_cost,
            },
            "failures": {
                "chips_failed": self.chips_failed,
                "gangs_restarted": self.fail_restarts,
                "tick_errors": self.tick_errors,
                "work_lost_to_hardware_cost": self.hw_lost_cost,
            },
            "events": events,
        }
        card["score"] = {
            "admitted_ratio": len(admitted) / len(scored) if scored else 1.0,
            "time_to_admit_p50_s": overall["p50_s"],
            "time_to_admit_p99_s": overall["p99_s"],
            "utilization": card["utilization"]["ratio"],
            "fragmentation_avg": card["fragmentation"]["avg"],
            "preemption_churn_cost": self.preempt_cost,
            "defrag_efficiency_chips_per_eviction": efficiency,
            "evictions_total": self.preempt_pods + d_evictions,
            "time_to_rescue_p50_s": card["rescue"]["time_to_rescue_s"]["p50_s"],
            "work_lost_to_hardware_cost": self.hw_lost_cost,
        }
        return _rounded(card)


class _RecordingDefragEngine:
    """DefragEngine plus a per-run record of its executed plans (the defrag
    efficiency join needs each plan's freed size and victims; process-wide
    counters would leak across runs in one process). Composed lazily so
    importing the simulator never pays the defrag import."""

    def __new__(cls, *args, **kwargs):
        from .defrag import DefragEngine

        class _Impl(DefragEngine):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.executed_plans = []

            def _execute(self, key, gang_key, plan):
                out = super()._execute(key, gang_key, plan)
                if out is not None:
                    self.executed_plans.append(plan)
                return out

        return _Impl(*args, **kwargs)


class _RecordingRescueEngine:
    """RescueEngine plus a per-run record of its executed rounds ((key,
    victims) per rescue: the eviction classifier and the rescue scores need
    the join). Composed lazily like the defrag twin."""

    def __new__(cls, *args, **kwargs):
        from .rescue import RescueEngine

        class _Impl(RescueEngine):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.executed_rounds = []

            def _execute(self, key, gang_key, gv, priority, demands, consumed, victims,
                         degraded, bound, since):
                out = super()._execute(key, gang_key, gv, priority, demands, consumed,
                                       victims, degraded, bound, since)
                if out is not None:
                    self.executed_rounds.append({"key": key, "victims": list(victims)})
                return out

        return _Impl(*args, **kwargs)


def run_trace(trace, seed: Optional[int] = None,
              policy_overrides: Optional[dict] = None) -> dict:
    """Run one trace (a Trace, a trace dict, or a path) and return its
    scorecard."""
    if isinstance(trace, str):
        trace = load_trace(trace)
    elif isinstance(trace, dict):
        trace = Trace.from_dict(trace)
    return SimRun(trace, seed=seed, policy_overrides=policy_overrides).run()


# -- golden baseline & metrics ----------------------------------------------


def load_golden(path: Optional[str] = None) -> Optional[dict]:
    path = path or golden_path()
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("schema") != GOLDEN_SCHEMA:
        return None
    return doc


def score_deltas(scorecard: dict, golden: Optional[dict]) -> dict:
    """Current minus golden, per flat score metric (the CLI's and the
    /debug/simreport payload's regression view)."""
    if golden is None:
        return {}
    base = ((golden.get("traces") or {}).get(scorecard.get("trace")) or {}).get("score") or {}
    out = {}
    for k, v in (scorecard.get("score") or {}).items():
        if k in base and isinstance(v, (int, float)):
            out[k] = round(float(v) - float(base[k]), 6)
    return out


def publish_metrics(scorecard: dict, deltas: Optional[dict] = None) -> None:
    """Export one completed run onto the extender registry (the tpu_sim_*
    families, labelled by trace): a replay leaves its scores scrapeable and
    its drift from the baseline alertable."""
    trace = scorecard.get("trace", "")
    metrics.SIM_RUNS.inc(trace=trace, outcome="ok")
    for tier, st in (scorecard.get("time_to_admit_s") or {}).items():
        for q in ("p50_s", "p99_s"):
            metrics.SIM_TIME_TO_ADMIT.set(st[q], trace=trace, tier=tier, quantile=q[:-2])
    score = scorecard.get("score") or {}
    metrics.SIM_UTILIZATION.set(score.get("utilization", 0.0), trace=trace)
    metrics.SIM_FRAGMENTATION.set(score.get("fragmentation_avg", 0.0), trace=trace)
    metrics.SIM_PREEMPTION_CHURN.set(score.get("preemption_churn_cost", 0.0), trace=trace)
    metrics.SIM_DEFRAG_EFFICIENCY.set(score.get("defrag_efficiency_chips_per_eviction", 0.0),
                                      trace=trace)
    for k, v in (deltas or {}).items():
        metrics.SIM_BASELINE_DELTA.set(v, trace=trace, metric=k)


def prune_metrics() -> None:
    """Drop every tpu_sim_* series: they describe a run, not the process,
    and must not outlive their reader."""
    for fam in (metrics.SIM_RUNS, metrics.SIM_TIME_TO_ADMIT, metrics.SIM_UTILIZATION,
                metrics.SIM_FRAGMENTATION, metrics.SIM_PREEMPTION_CHURN,
                metrics.SIM_DEFRAG_EFFICIENCY, metrics.SIM_BASELINE_DELTA):
        for labels, _v in fam.series():
            fam.remove(**labels)


# -- /debug/simreport --------------------------------------------------------

# trace name -> {"scorecard", "deltas", "sha256"} of the runs completed in
# THIS process. The endpoint serves this at once and never runs a replay
# inline (a bare GET from tpu-doctor must answer in milliseconds, and an
# inline replay would stomp production counters).
_LAST: Dict[str, dict] = {}


def note_run(scorecard: dict, deltas: Optional[dict] = None) -> None:
    _LAST[scorecard.get("trace", "")] = {
        "scorecard": scorecard,
        "deltas": dict(deltas or {}),
        "sha256": hashlib.sha256(canonical_json(scorecard).encode()).hexdigest(),
    }


def debug_snapshot() -> dict:
    if not _LAST:
        return {
            "enabled": False,
            "note": "no simulator run has completed in this process "
            "(bench.py's scheduling_quality probe and tpu-simreport "
            "run populate it)",
        }
    return {
        "enabled": True,
        "golden": golden_path(),
        "runs": {k: _LAST[k] for k in sorted(_LAST)},
    }


# -- the probe ---------------------------------------------------------------


def scheduling_quality(traces_dir: Optional[str] = None,
                       golden: Optional[dict] = None) -> dict:
    """The scheduling-quality probe: replay every canned trace, publish the
    tpu_sim_* families, record the /debug/simreport state, and prove
    determinism by replaying the first trace twice (byte-identical
    scorecards, or the probe says they were not)."""
    import time as _time

    t0 = _time.monotonic()
    d = traces_dir or trace_dir()
    if golden is None:
        golden = load_golden()
    out: dict = {"traces": {}, "deltas": {}, "golden_found": golden is not None}
    first_sha = None
    for name in CANNED_TRACES:
        trace = load_trace(os.path.join(d, f"{name}.json"))
        card = run_trace(trace)
        deltas = score_deltas(card, golden)
        publish_metrics(card, deltas)
        note_run(card, deltas)
        out["traces"][name] = card
        out["deltas"][name] = deltas
        if first_sha is None:
            replay = run_trace(trace)
            a = canonical_json(card)
            b = canonical_json(replay)
            first_sha = hashlib.sha256(a.encode()).hexdigest()
            out["deterministic"] = a == b
            out["determinism_sha256"] = first_sha
    out["wall_s"] = round(_time.monotonic() - t0, 2)
    return out


# -- CLI ---------------------------------------------------------------------


def _render_scorecard(card: dict, deltas: dict) -> List[str]:
    out = [f"trace {card['trace']} (seed {card['seed']}, "
           f"{card['ticks']} ticks x {card['tick_s']}s virtual)"]
    arr = card["arrivals"]
    out.append(f"  admitted {arr['admitted']}/{arr['scored']} scored gangs"
               f" (+{arr['warmup']} warmup, {arr['readmissions']} readmissions)")
    for tier, st in card.get("time_to_admit_s", {}).items():
        out.append(f"  {tier:>8}: time-to-admit p50 {st['p50_s']}s "
                   f"p99 {st['p99_s']}s ({st['admitted']}/{st['arrived']} admitted)")
    score = card.get("score", {})
    for key in sorted(score):
        line = f"  {key} = {score[key]}"
        if key in deltas:
            d = deltas[key]
            line += f"  ({'+' if d >= 0 else ''}{d} vs golden)"
        out.append(line)
    return out


def self_test() -> int:
    """End-to-end smoke: a tiny 2-node trace (an instantly placeable gang, a
    preemption-pressure burst, and a replay determinism check) through the
    real admission stack, with the report renderer exercised on the result.
    Prints a one-line JSON verdict."""
    trace = {
        "schema": TRACE_SCHEMA,
        "name": "self_test",
        "seed": 7,
        "tick_s": 10.0,
        "ticks": 12,
        "nodes": {"count": 2, "chips_per_host": 4},
        "policy": {"stranded_ticks": 2},
        "arrivals": [
            {"at_tick": 0, "gang": "filler-a", "pods": 1, "chips": 4,
             "priority": -10, "duration_ticks": 10, "duty_cycle": 10,
             "checkpoint_age_s": 30, "warmup": True},
            {"at_tick": 0, "gang": "filler-b", "pods": 1, "chips": 4,
             "priority": -10, "duration_ticks": 10, "duty_cycle": 10,
             "checkpoint_age_s": 30, "warmup": True},
            {"at_tick": 2, "gang": "crit", "pods": 1, "chips": 4,
             "priority": 2000000, "duration_ticks": 4},
            {"at_tick": 2, "gang": "std", "pods": 1, "chips": 2,
             "priority": 0, "duration_ticks": 4},
        ],
    }
    card = run_trace(trace)
    again = run_trace(trace)
    deterministic = canonical_json(card) == canonical_json(again)
    assert deterministic, "replay was not byte-identical"
    assert card["arrivals"]["admitted"] >= 1, card["arrivals"]
    tiers = card["time_to_admit_s"]
    assert "critical" in tiers and tiers["critical"]["admitted"] == 1, tiers
    assert card["preemption"]["pods_evicted"] >= 1, card["preemption"]
    rendered = _render_scorecard(card, {})
    assert rendered and rendered[0].startswith("trace self_test")
    publish_metrics(card)
    assert metrics.SIM_UTILIZATION.get(trace="self_test") > 0
    prune_metrics()
    assert not metrics.SIM_UTILIZATION.series()
    print(json.dumps({
        "simulator_self_test": "ok",
        "deterministic": deterministic,
        "admitted": card["arrivals"]["admitted"],
        "preempted_pods": card["preemption"]["pods_evicted"],
        "utilization": card["score"]["utilization"],
    }))
    return 0


def _fetch_report(url: str) -> dict:
    import urllib.request

    base = url.rstrip("/")
    with urllib.request.urlopen(f"{base}/debug/simreport", timeout=10) as resp:
        return json.loads(resp.read())


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="tpu-simreport",
        description="Scheduling-quality simulator: replay arrival traces through the real "
        "admission/preemption/defrag stack and score the decisions against the checked-in "
        "golden baseline.")
    p.add_argument("command", nargs="?", choices=("run", "report"),
                   help="run: replay --trace (or every canned trace) and render scores + "
                   "golden deltas; report: render a live extender's /debug/simreport")
    p.add_argument("--trace", default="", help="trace JSON path")
    p.add_argument("--seed", type=int, default=None, help="override the trace's seed")
    p.add_argument("--golden", default="", help=f"golden baseline path (default {golden_path()})")
    p.add_argument("--update-golden", action="store_true",
                   help="rewrite the golden baseline from a fresh run of every canned trace "
                   "(do this deliberately, in the change that moves the policy)")
    p.add_argument("--json", action="store_true", help="raw JSON out")
    p.add_argument("--url", default="", help="extender base URL for `report`")
    p.add_argument("--self-test", action="store_true",
                   help="run the 2-node end-to-end smoke and print a one-line JSON verdict")
    a = p.parse_args(argv)
    if a.self_test:
        return self_test()
    gpath = a.golden or golden_path()
    if a.update_golden:
        doc = {"schema": GOLDEN_SCHEMA, "traces": {}}
        for name in CANNED_TRACES:
            card = run_trace(os.path.join(trace_dir(), f"{name}.json"), seed=a.seed)
            doc["traces"][name] = {
                "score": card["score"],
                "sha256": hashlib.sha256(canonical_json(card).encode()).hexdigest(),
            }
        with open(gpath, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"golden baseline written: {gpath}")
        return 0
    if a.command == "report":
        if not a.url:
            p.error("--url is required for report")
        try:
            doc = _fetch_report(a.url)
        except (OSError, ValueError) as e:
            print(f"tpu-simreport: {e}", file=sys.stderr)
            return 1
        if a.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
            return 0
        if not doc.get("enabled"):
            print(f"simreport: {doc.get('note', 'no runs')}")
            return 0
        for _name, entry in sorted((doc.get("runs") or {}).items()):
            for line in _render_scorecard(entry.get("scorecard") or {}, entry.get("deltas") or {}):
                print(line)
        return 0
    if a.command != "run":
        p.print_help()
        return 2
    golden = load_golden(gpath)
    paths = ([a.trace] if a.trace
             else [os.path.join(trace_dir(), f"{n}.json") for n in CANNED_TRACES])
    for path in paths:
        card = run_trace(path, seed=a.seed)
        deltas = score_deltas(card, golden)
        note_run(card, deltas)
        if a.json:
            print(canonical_json({"scorecard": card, "deltas": deltas}))
        else:
            for line in _render_scorecard(card, deltas):
                print(line)
            if golden is None:
                print("  (no golden baseline found — --update-golden writes one)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
