"""Priority tiers and cost-aware preemption for GPU gangs: the JAX package's
``extender/preemption.py``, the multi-tenant half of gang admission.

Without it every gang is equal: a batch gang holding a node's last free
cards blocks a production gang until it ends on its own. This module adds
the ordering and the verb that enforces it:

* **Priority tiers.** A gang's priority comes from its pods' PriorityClass:
  ``spec.priority`` when the admission chain already resolved it, else the
  class name resolved against ``scheduling.k8s.io/v1`` through
  :class:`PriorityResolver`. The numeric priority orders the pending queue
  (gang.py evaluates higher-priority gangs first) and rides every
  reservation hold and journal record, so the order survives the extender's
  death; the coarse :func:`tier_label` (``critical``/``high``/``standard``/
  ``batch``) keeps the metric labels bounded.

* **Preemption.** When a waiting gang outranks running gangs and no node
  fits it, :class:`PreemptionPlanner` computes a minimal victim set whose
  eviction frees room for every member (feasibility is proven with the very
  ``_CapacityPool`` admission uses, never guessed), and
  :class:`PreemptionEngine` executes it in two journaled phases:
  ``preempt_intent``, the victims evicted through the Eviction subresource
  (plain delete only where the subresource is unsupported),
  ``preempt_evicted``, the freed cards reserved for the preemptor,
  ``preempt_done``. A SIGKILL anywhere rehydrates to a safe state (gang.py
  ``recover``: an open ``evicted`` phase re-fences the freed cards before
  /filter serves, an open ``intent`` aborts and the next tick plans again
  from the cluster's truth). The reserve rides the ordinary gate/fence
  flow of the tick.

* **Cost-aware victims.** Victims rank by (priority, restart cost):
  strictly lower priority only, cheapest first, where the restart cost adds
  work in flight (the gang's mean card duty cycle from the telemetry
  sampler's attribution join) and checkpoint staleness (the
  ``tpu.google.com/last-checkpoint`` annotation ``workload/beacon.py``'s
  beacon stamps). The greedy build and its prune pass never evict more
  gangs than one fit needs.

The eviction door, the what-if credit, the planner's ranking and the victim
Event are shared parts: the JAX defrag and rescue planes reuse them, and so
will the port's.

Every decision goes to the decision ledger (``preemption`` and
``preempt_victim`` records, the JAX kinds and fields), so ``tools/explain.py
--evicted`` answers "why was I evicted"; the scheduler-extender
``/preemption`` verb (server.py) serves the planner's dry run.

Sharded, an engine lives inside each shard's ``GangAdmission`` and sees only
the gangs and nodes that shard owns (``gang_filter``/``topo_filter`` scope
discovery and the capacity view), so it never evicts across a shard.

On a GPU node the credit of :func:`credited_topos` names the first card ids
not available, in card order, as JAX does: they may be a failed card, or
not the cards the victims hold. Admission counts cards, so the verdict is
right; a set score computed after the credit may be optimistic.

``python -m k8s_device_plugin_tpu_torch.extender.preemption --self-test``
drives one round over two synthetic HGX nodes and prints a one-line verdict.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import constants
from ..kube.client import KubeError
from ..utils import metrics, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from ..utils.podresources import gpu_request
from ..workload.beacon import CheckpointBeacon

log = get_logger(__name__)

GangKey = Tuple[str, str]

# The victim's kube Event: the port's names, as gang.py's GPUGangPending.
VICTIM_EVENT_REASON = "GPUGangPreempted"
EVENT_COMPONENT = "gpu-gang-admission"

# -- priority tiers ----------------------------------------------------------

TIER_CRITICAL = "critical"
TIER_HIGH = "high"
TIER_STANDARD = "standard"
TIER_BATCH = "batch"

TIERS = (TIER_CRITICAL, TIER_HIGH, TIER_STANDARD, TIER_BATCH)


# Only gangs at or above this priority may evict (anything above the 0
# default): the floor that keeps two batch gangs from churning each other.
MIN_PREEMPTOR_PRIORITY = 1

# The PriorityClass listing's refresh cadence, and the sooner refresh an
# unknown-class miss may take (a new class takes effect in seconds),
# rate-limited so a pod naming a class that never exists cannot make every
# tick a LIST.
REFRESH_S = 300.0
MISS_REFRESH_S = 30.0


def tier_label(priority: int) -> str:
    """The tier of a numeric priority, the k8s convention's thresholds:
    system classes sit near 2e9, user production classes at 1e6 or more,
    anything negative is preemptible batch, and the unset default (0) is
    standard. The numeric priority orders queues; the tier only keeps the
    label's cardinality at four."""
    if priority >= 1_000_000:
        return TIER_CRITICAL
    if priority >= 1_000:
        return TIER_HIGH
    if priority >= 0:
        return TIER_STANDARD
    return TIER_BATCH


class PriorityResolver:
    """pod -> numeric scheduling priority, PriorityClass-aware.

    ``spec.priority`` wins when present (the admission chain resolved it,
    the normal case on a real cluster); otherwise ``spec.priorityClassName``
    resolves against a cached ``scheduling.k8s.io/v1`` listing (refreshed on
    an unknown-class miss, at most once per ``MISS_REFRESH_S``); otherwise
    the cluster's globalDefault class, else 0. A resolver without a client
    (tests, clusters without the scheduling API) reads ``spec.priority`` or
    0. It never raises."""

    def __init__(self, client=None, clock: Callable[[], float] = time.monotonic):
        self.client = client
        self._clock = clock
        self._lock = threading.Lock()
        self._classes: Dict[str, int] = {}
        self._default = 0
        self._loaded_at: Optional[float] = None

    def _ensure_classes(self, force: bool = False) -> None:
        if self.client is None:
            return
        with self._lock:
            now = self._clock()
            if self._loaded_at is not None and now - self._loaded_at < (
                    MISS_REFRESH_S if force else REFRESH_S):
                return
        try:
            listing = self.client.list_priority_classes()
        except Exception as e:  # noqa: BLE001 - an ordering hint: an API
            # blip degrades to the cached (or empty) vocabulary, never
            # blocks admission
            log.debug("priority class list failed: %s", e)
            with self._lock:
                if self._loaded_at is None:
                    self._loaded_at = self._clock()
            return
        classes: Dict[str, int] = {}
        default = 0
        for pc in listing.get("items", []):
            name = (pc.get("metadata") or {}).get("name", "")
            try:
                value = int(pc.get("value", 0))
            except (TypeError, ValueError):
                continue
            if name:
                classes[name] = value
                if pc.get("globalDefault"):
                    default = value
        with self._lock:
            self._classes = classes
            self._default = default
            self._loaded_at = self._clock()

    def class_value(self, name: str) -> Optional[int]:
        self._ensure_classes()
        with self._lock:
            v = self._classes.get(name)
        if v is None:
            self._ensure_classes(force=True)
            with self._lock:
                v = self._classes.get(name)
        return v

    def pod_priority(self, pod: dict) -> int:
        spec = pod.get("spec") or {}
        p = spec.get("priority")
        if p is not None:
            try:
                return int(p)
            except (TypeError, ValueError):
                pass
        name = spec.get("priorityClassName")
        if name:
            v = self.class_value(str(name))
            if v is not None:
                return v
        self._ensure_classes()
        with self._lock:
            return self._default

    def gang_priority(self, pods: List[dict]) -> int:
        """A gang is as important as its most important member (a gang of
        mixed priorities is a workload bug this stays safe against)."""
        return max((self.pod_priority(p) for p in pods), default=0)


def evict_gang_pod(client, ns: str, name: str) -> bool:
    """The one gang-eviction door: the Eviction subresource first
    (PodDisruptionBudget-honouring); a plain delete only when the
    subresource itself is unsupported (405, an API server without the
    policy group). Every other refusal returns False and the caller aborts
    its round: a 429 is a disruption budget doing its job, and a 403, 422
    or 5xx must never escalate into a forced delete. Every plane that
    evicts goes through here, so how it evicts cannot drift between them."""
    try:
        client.evict_pod(ns, name)
        return True
    except KubeError as e:
        if e.status_code == 429:
            log.warning("eviction of %s/%s blocked by disruption budget", ns, name)
            return False
        if e.status_code != 405:
            log.warning("eviction of %s/%s refused (%s); aborting the round", ns, name, e)
            return False
        log.warning("eviction subresource unsupported for %s/%s (%s); falling back to "
                    "plain delete", ns, name, e)
    except OSError as e:
        log.warning("eviction of %s/%s unreachable: %s", ns, name, e)
        return False
    try:
        client.delete_pod(ns, name)
        return True
    except (KubeError, OSError) as e:
        log.warning("plain-delete fallback failed for %s/%s: %s", ns, name, e)
        return False


def credited_topos(topos, freed: Dict[str, int]) -> list:
    """Clones of ``topos`` with ``freed`` cards credited back per node: the
    one optimistic what-if availability every eviction plane proves its
    plans on. Which cards free is a guess (the first ids not available, in
    card order, a failed card among them), which can overstate a set's
    links but never the count admission tests."""
    aug = []
    for t in topos:
        extra = freed.get(t.hostname, 0)
        if extra > 0:
            have = set(t.available)
            credit = [c.id for c in t.chips if c.id not in have][:extra]
            aug.append(dataclasses.replace(t, available=list(t.available) + credit))
        else:
            aug.append(t)
    return aug


# -- victims and cost --------------------------------------------------------

# Checkpoint staleness saturates here: past an hour of unsaved work every
# victim is equally expensive on this axis.
CHECKPOINT_COST_CAP_S = 3600.0


def telemetry_duty_source() -> Dict[str, float]:
    """gang label -> mean duty cycle (%) from this process's telemetry
    sampler (``telemetry.gang_duty_cycles``). Empty where no sampler runs,
    the extender's normal case: every victim's duty then reads as unknown."""
    from .. import telemetry

    return telemetry.gang_duty_cycles()


@dataclasses.dataclass
class Victim:
    """One running gang as a preemption candidate, with the cost facts
    frozen at decision time (the ledger keeps them verbatim: the ranking
    ``explain --evicted`` renders)."""

    key: GangKey
    priority: int
    # node -> cards this gang's scheduled pods hold there.
    hosts: Dict[str, int]
    # [{"ns", "name", "uid", "host", "chips"}]: the eviction targets.
    pods: List[dict]
    duty_cycle: Optional[float] = None
    checkpoint_age_s: Optional[float] = None

    @property
    def tier(self) -> str:
        return tier_label(self.priority)

    @property
    def total_chips(self) -> int:
        return sum(self.hosts.values())

    def restart_cost(self) -> float:
        """Work lost if evicted, on a 0-200 scale: the duty cycle (work in
        flight, 0-100, unknown reads as the 50 midpoint) plus checkpoint
        staleness (seconds since the last save against the cap, 0-100,
        unknown is the midpoint too). Lower is cheaper to evict: an idle
        gang that saved a minute ago goes first, a gang at 95% an hour past
        its save last."""
        duty = (50.0 if self.duty_cycle is None
                else min(max(float(self.duty_cycle), 0.0), 100.0))
        ckpt = (50.0 if self.checkpoint_age_s is None
                else min(max(float(self.checkpoint_age_s), 0.0), CHECKPOINT_COST_CAP_S)
                / CHECKPOINT_COST_CAP_S * 100.0)
        return duty + ckpt


@dataclasses.dataclass
class PreemptionPlan:
    preemptor: GangKey
    priority: int
    demands: List[int]
    # Cheapest first: exactly the set whose eviction frees room.
    victims: List[Victim]
    # node -> cards the victims free.
    freed: Dict[str, int]
    # node -> cards the preemptor's fit after the evictions consumed: what
    # the engine reserves (the fence) once the victims are gone.
    consumed: Dict[str, int]

    def victim_keys(self) -> List[List[str]]:
        return [[v.key[0], v.key[1]] for v in self.victims]

    def node_to_meta_victims(self) -> Dict[str, dict]:
        """The ``/preemption`` verb's answer
        (ExtenderPreemptionResult.nodeNameToMetaVictims)."""
        out: Dict[str, dict] = {}
        for v in self.victims:
            for p in v.pods:
                node = out.setdefault(p.get("host", ""), {"pods": [], "numPDBViolations": 0})
                node["pods"].append({"uid": p.get("uid", "")})
        return out


class PreemptionPlanner:
    """Planning alone: victims in, a minimal victim set and its proven fit
    out. No API call, no journal write: the engine executes, the
    ``/preemption`` verb serves this dry run."""

    def __init__(
        self,
        resolver: PriorityResolver,
        resource_name: str = constants.RESOURCE_NAME,
        duty_source: Optional[Callable[[], Dict[str, float]]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.resolver = resolver
        self.resource_name = resource_name
        # () -> {gang label or "ns/name" -> mean duty %}; by default this
        # process's telemetry sampler (empty off the node).
        self.duty_source = duty_source or telemetry_duty_source
        # The checkpoint ages' "now": the wall clock, or a replay's virtual
        # one (extender/simulator.py).
        self._clock = clock

    # -- victim discovery --------------------------------------------------

    def collect_victims(self, gangs: Dict[GangKey, object], exclude: GangKey,
                        below_priority: int) -> List[Victim]:
        """Running gangs (live pods with a nodeName) of strictly lower
        priority than ``below_priority``. ``gangs`` is the admitter's
        GangView map, already shard-scoped by ``gang_filter``, so a sharded
        engine only ever sees (and evicts) its own shard's gangs."""
        try:
            duty = self.duty_source() or {}
        except Exception:  # noqa: BLE001 - cost telemetry is advisory
            log.exception("preemption duty source failed")
            duty = {}
        now = self._clock()
        out: List[Victim] = []
        for key, gv in gangs.items():
            if key == exclude:
                continue
            live = getattr(gv, "live", None) or []
            priority = self.resolver.gang_priority(live)
            if priority >= below_priority:
                continue
            hosts: Dict[str, int] = {}
            pods: List[dict] = []
            ckpt_age: Optional[float] = None
            for p in live:
                node = (p.get("spec") or {}).get("nodeName")
                if not node:
                    continue
                meta = p.get("metadata") or {}
                cards = gpu_request(p, self.resource_name)
                if cards <= 0:
                    continue
                hosts[node] = hosts.get(node, 0) + cards
                pods.append({"ns": meta.get("namespace", "default"),
                             "name": meta.get("name", ""), "uid": meta.get("uid", ""),
                             "host": node, "chips": cards})
                # The beacon's one parser; the gang's age is its most recent
                # member save.
                age = CheckpointBeacon.age_from(meta.get("annotations"), now=now)
                if age is not None:
                    ckpt_age = age if ckpt_age is None else min(ckpt_age, age)
            if not hosts:
                continue  # nothing placed: evicting it frees no card
            out.append(Victim(key=key, priority=priority, hosts=hosts, pods=pods,
                              duty_cycle=duty.get(f"{key[0]}/{key[1]}", duty.get(key[1])),
                              checkpoint_age_s=ckpt_age))
        return out

    # -- feasibility -------------------------------------------------------

    def _fits_with(self, topos, freed: Dict[str, int],
                   demands: List[int]) -> Optional[Dict[str, int]]:
        """The whole gang's fit over the current (shielded) availability
        plus ``freed`` credited back per node, on the ``_CapacityPool``
        admission itself uses: a plan that reads feasible here is one the
        tick can admit."""
        from .gang import _CapacityPool  # deferred: gang imports this module

        return _CapacityPool(credited_topos(topos, freed)).fits(demands)

    @staticmethod
    def _sum_hosts(victims: List[Victim]) -> Dict[str, int]:
        freed: Dict[str, int] = {}
        for v in victims:
            for h, n in v.hosts.items():
                freed[h] = freed.get(h, 0) + n
        return freed

    def plan(self, preemptor: GangKey, demands: List[int], priority: int, topos,
             victims: List[Victim]) -> Optional[PreemptionPlan]:
        """The minimal victim set that makes ``demands`` fit, or None when no
        eviction of lower priority suffices.

        Greedy cheapest first (priority ascending, then restart cost) until
        the fit proves, then a prune pass dropping victims most expensive
        first while the fit still holds: no gang whose cards the fit does
        not need is evicted."""
        if not victims or not demands:
            return None
        ordered = sorted(victims, key=lambda v: (v.priority, v.restart_cost(), v.key))
        chosen: List[Victim] = []
        fit: Optional[Dict[str, int]] = None
        for v in ordered:
            chosen.append(v)
            fit = self._fits_with(topos, self._sum_hosts(chosen), demands)
            if fit is not None:
                break
        if fit is None:
            return None
        # Most expensive first: a cheap early pick the final fit does not
        # need goes here, which is what makes "never more gangs than needed"
        # hold beyond the greedy order.
        for v in sorted(chosen, key=lambda v: (-v.priority, -v.restart_cost(), v.key)):
            if len(chosen) == 1:
                break
            trial = [c for c in chosen if c is not v]
            trial_fit = self._fits_with(topos, self._sum_hosts(trial), demands)
            if trial_fit is not None:
                chosen = trial
                fit = trial_fit
        chosen.sort(key=lambda v: (v.priority, v.restart_cost(), v.key))
        return PreemptionPlan(preemptor=preemptor, priority=priority, demands=list(demands),
                              victims=chosen, freed=self._sum_hosts(chosen), consumed=fit)


class PreemptionEngine:
    """Execution: plan, two-phase journal, evict, fence.

    Attached to a GangAdmission (``adm.preemption = engine``): the tick calls
    :meth:`maybe_preempt` for a capacity-waiting gang after the ordinary fit
    failed; a round that succeeds returns the consumed node -> cards map,
    which goes through the tick's ordinary reserve, admit and release (the
    tick calls :meth:`finish` right after the reserve lands, closing the
    journaled round). Budgeted per tick, so one starved high-tier gang
    cannot evict the cluster in one pass."""

    def __init__(self, admission, resolver: PriorityResolver, rounds_per_tick: int = 1, *,
                 planner: Optional[PreemptionPlanner] = None,
                 min_preemptor_priority: int = MIN_PREEMPTOR_PRIORITY):
        self.admission = admission
        self.resolver = resolver
        self.planner = planner or PreemptionPlanner(resolver,
                                                    resource_name=admission.resource_name)
        self.rounds_per_tick = rounds_per_tick
        # The extender's entry point passes neither: only the simulator
        # (extender/simulator.py) replays another floor or its own planner on
        # the virtual clock.
        self.min_preemptor_priority = min_preemptor_priority
        self._rounds_left = rounds_per_tick
        # Open two-phase rounds, preemptor -> plan payload: what the
        # compaction snapshot carries (gang._journal_state reads it through
        # open_intents()).
        self._open: Dict[GangKey, dict] = {}
        # Waiting gangs whose "no_plan" outcome is already in the ledger this
        # waiting episode (reset when the gang admits or vanishes).
        self._noplan_reported: Set[GangKey] = set()

    # -- tick plumbing -----------------------------------------------------

    def begin_tick(self) -> None:
        self._rounds_left = self.rounds_per_tick

    def open_intents(self) -> Dict[GangKey, dict]:
        return dict(self._open)

    def note_admitted(self, key: GangKey) -> None:
        self._noplan_reported.discard(key)

    # -- the verb's dry run ------------------------------------------------

    def dry_run(self, pod: dict) -> dict:
        """The ``/preemption`` verb: plan, never execute, for the pod's gang
        or the bare pod, and answer the node -> victims map. A request that
        cannot fit or may not preempt answers an empty map (the scheduler
        reads it as "the extender found no preemption")."""
        from .gang import pod_gang  # deferred: gang imports this module

        info = pod_gang(pod)
        gangs = self.admission._collect_gangs()
        resource = self.admission.resource_name
        if info is not None:
            key = (info[0], info[1])
            gv = gangs.get(key)
            demands = gv.demands(resource) if gv is not None else [gpu_request(pod, resource)]
            priority = self.resolver.gang_priority(gv.live if gv is not None else [pod])
        else:
            meta = pod.get("metadata") or {}
            key = (meta.get("namespace", "default"), meta.get("name", ""))
            demands = [gpu_request(pod, resource)]
            priority = self.resolver.pod_priority(pod)
        demands = [d for d in demands if d > 0]
        if not demands or priority < self.min_preemptor_priority:
            return {"nodeNameToMetaVictims": {}}
        topos = self.admission._node_topologies()
        self.admission.reservations.apply(topos)
        victims = self.planner.collect_victims(gangs, key, priority)
        plan = self.planner.plan(key, demands, priority, topos, victims)
        if plan is None:
            return {"nodeNameToMetaVictims": {}}
        return {"nodeNameToMetaVictims": plan.node_to_meta_victims()}

    # -- execution ---------------------------------------------------------

    def maybe_preempt(self, key: GangKey, gv, demands: List[int], topos, priority: int,
                      gangs: Optional[Dict[GangKey, object]] = None
                      ) -> Optional[Dict[str, int]]:
        """One preemption round for a capacity-waiting gang. Returns the
        consumed node -> cards map for the tick to reserve (the gang then
        admits through the ordinary path), or None (not entitled, no plan,
        budget spent, eviction blocked: the gang keeps waiting). ``gangs``
        is the caller's complete gang map when it has one (a full sweep), so
        victim discovery costs no further LIST; None (a dirty tick) collects
        it here, only after the cheap entitlement checks passed."""
        if priority < self.min_preemptor_priority:
            return None
        if self._rounds_left <= 0:
            return None
        if key in self._open:
            # A round is still open (recovery closed its journal side but
            # the tick has not reserved yet): never stack a second wave.
            return None
        if gangs is None:
            gangs = self.admission._collect_gangs()
        victims = self.planner.collect_victims(gangs, key, priority)
        plan = self.planner.plan(key, demands, priority, topos, victims)
        gang_key = f"{key[0]}/{key[1]}"
        if plan is None:
            if key not in self._noplan_reported:
                self._noplan_reported.add(key)
                LEDGER.record("preemption", "no_plan",
                              f"no lower-priority victim set frees a placeable box for "
                              f"{demands}", gang=gang_key, tier=tier_label(priority),
                              priority=priority)
            return None
        self._rounds_left -= 1
        if not tracing.enabled():
            return self._execute(key, gang_key, plan)
        with tracing.span("gang.preempt", service="extender", namespace=key[0], gang=key[1],
                          victims=len(plan.victims)):
            return self._execute(key, gang_key, plan)

    def _execute(self, key: GangKey, gang_key: str,
                 plan: PreemptionPlan) -> Optional[Dict[str, int]]:
        journal = self.admission.journal
        tier = tier_label(plan.priority)
        payload = {"phase": "intent", "victims": plan.victim_keys(),
                   "consumed": dict(plan.consumed), "demands": list(plan.demands),
                   "priority": plan.priority, "ts": time.time()}
        # Phase 1: the intent is durable before anything irreversible.
        self._open[key] = payload
        if journal is not None:
            journal.record("preempt_intent", key, victims=plan.victim_keys(),
                           consumed=dict(plan.consumed), demands=list(plan.demands),
                           priority=plan.priority)
        for rank, v in enumerate(plan.victims):
            LEDGER.record(
                "preempt_victim", "selected",
                f"victim {rank + 1}/{len(plan.victims)} for {gang_key}: priority "
                f"{v.priority}, restart cost {v.restart_cost():.1f}",
                gang=f"{v.key[0]}/{v.key[1]}",
                evictor=gang_key,
                rank=rank + 1,
                victim_tier=v.tier,
                victim_priority=v.priority,
                chips=v.total_chips,
                duty_cycle="" if v.duty_cycle is None else round(v.duty_cycle, 1),
                checkpoint_age_s=("" if v.checkpoint_age_s is None
                                  else round(v.checkpoint_age_s, 1)),
            )
        # Phase 2: evict every victim pod. A refused eviction aborts the round
        # (retried next tick; the evictions that landed already freed their
        # cards, so the next plan is cheaper).
        blocked = False
        for v in plan.victims:
            for p in v.pods:
                if not evict_gang_pod(self.admission.client, p.get("ns", "default"),
                                      p.get("name", "")):
                    blocked = True
                    break
            if blocked:
                break
            metrics.PREEMPTION_VICTIMS.inc(victim_tier=v.tier)
            self._post_victim_event(v, gang_key)
        if blocked:
            self._open.pop(key, None)
            if journal is not None:
                journal.record("preempt_abort", key, reason="eviction_blocked")
            metrics.PREEMPTIONS.inc(tier=tier, outcome="blocked")
            LEDGER.record("preemption", "blocked",
                          "eviction blocked (PodDisruptionBudget or apiserver refusal); round "
                          "aborted, retried next tick", gang=gang_key, tier=tier)
            return None
        payload = dict(payload, phase="evicted", ts=time.time())
        self._open[key] = payload
        if journal is not None:
            journal.record("preempt_evicted", key, victims=plan.victim_keys(),
                           consumed=dict(plan.consumed), demands=list(plan.demands),
                           priority=plan.priority)
        metrics.PREEMPTIONS.inc(tier=tier, outcome="executed")
        victims_s = ",".join(f"{v.key[0]}/{v.key[1]}" for v in plan.victims)
        freed = sum(plan.freed.values())
        RECORDER.record("preemption",
                        f"gang {gang_key} preempted {len(plan.victims)} gang(s) to free a "
                        f"placeable box", namespace=key[0], gang=key[1], tier=tier,
                        victims=victims_s, freed_chips=freed)
        LEDGER.record("preemption", "executed",
                      f"evicted {len(plan.victims)} lower-priority gang(s) ({victims_s}) "
                      f"freeing {freed} chip(s) for {plan.demands}",
                      gang=gang_key, tier=tier, priority=plan.priority, victims=victims_s,
                      victim_count=len(plan.victims), freed_chips=freed)
        log.warning("preemption: gang %s (priority %d) evicted %d gang(s) [%s]; reserving %s",
                    gang_key, plan.priority, len(plan.victims), victims_s, plan.consumed)
        self._noplan_reported.discard(key)
        return dict(plan.consumed)

    def finish(self, key: GangKey) -> None:
        """Phase 3: the tick reserved the freed cards (the fence is
        journaled through the table's observer); close the round."""
        if self._open.pop(key, None) is None:
            return
        if self.admission.journal is not None:
            self.admission.journal.record("preempt_done", key)

    # -- helpers -----------------------------------------------------------

    def _post_victim_event(self, victim: Victim, evictor: str) -> None:
        post_victim_event(
            self.admission.client, victim, reason=VICTIM_EVENT_REASON,
            message=(f"gang {victim.key[0]}/{victim.key[1]} preempted by higher-priority "
                     f"gang {evictor}"))


def post_victim_event(client, victim: Victim, reason: str, message: str) -> None:
    """A best-effort Warning Event on a victim gang's first pod, so
    ``kubectl describe`` shows who evicted it and why: the one poster of
    every eviction plane, so their Events cannot drift apart."""
    create = getattr(client, "create_event", None)
    if create is None or not victim.pods:
        return
    p = victim.pods[0]
    try:
        create(p.get("ns", "default"),
               {"kind": "Pod", "name": p.get("name", ""), "namespace": p.get("ns", "default"),
                "uid": p.get("uid", "")},
               reason=reason, message=message, event_type="Warning",
               component=EVENT_COMPONENT)
    except (KubeError, OSError) as e:
        log.debug("victim event post failed (%s): %s", reason, e)


# -- self-test ---------------------------------------------------------------


def self_test() -> int:
    """One round end to end: two 4-card HGX nodes held by two batch gangs,
    a critical gang arrives gated; one tick plans, evicts the cheaper
    victim, fences the freed cards and releases the preemptor's gates,
    through the real GangAdmission, planner and journal against a client
    defined here (no API server). Prints a one-line JSON verdict."""
    import json
    import shutil
    import tempfile

    from ..topology.schema import hgx_topology
    from ..utils import statestore
    from .gang import GANG_SIZE_LABEL, GATE_NAME, GangAdmission
    from .journal import AdmissionJournal
    from .reservations import ReservationTable

    class FakeClient:
        """The subset of KubeClient the admitter and the engine call."""

        def __init__(self):
            self.pods: Dict[Tuple[str, str], dict] = {}
            self.evicted: List[Tuple[str, str]] = []
            self.events: List[dict] = []

        def list_pods(self, label_selector: str = "", **_):
            return {"items": [dict(p) for p in self.pods.values()]}

        def get_pod(self, ns, name):
            return dict(self.pods[(ns, name)])

        def evict_pod(self, ns, name):
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
            self.events.append(kw)

        def list_priority_classes(self):
            return {"items": [{"metadata": {"name": "prod"}, "value": 1_000_000}]}

    def pod(ns, gang, name, cards, size, gated, node="", priority=None, ckpt=None,
            class_name=""):
        p = {
            "metadata": {"name": name, "namespace": ns, "uid": f"uid-{name}",
                         "labels": {constants.GANG_NAME_LABEL: gang,
                                    GANG_SIZE_LABEL: str(size)},
                         "annotations": {}},
            "spec": {"schedulingGates": [{"name": GATE_NAME}] if gated else [],
                     "containers": [{"name": "c", "resources": {
                         "requests": {constants.RESOURCE_NAME: str(cards)}}}]},
            "status": {},
        }
        if node:
            p["spec"]["nodeName"] = node
        if priority is not None:
            p["spec"]["priority"] = priority
        if class_name:
            p["spec"]["priorityClassName"] = class_name
        if ckpt is not None:
            p["metadata"]["annotations"][constants.CHECKPOINT_TS_ANNOTATION] = str(ckpt)
        return p

    d = tempfile.mkdtemp(prefix="gpu-preempt-selftest-")
    try:
        client = FakeClient()
        # Two 4-card HGX nodes, every card held by two batch gangs.
        topos = [hgx_topology(n, 4, available=[]) for n in ("n1", "n2")]
        now = time.time()
        for gang, node, ckpt in (("batch-a", "n1", now - 5),       # saved 5 s ago
                                 ("batch-b", "n2", now - 3000)):   # 50 min unsaved
            for w in range(2):
                p = pod("default", gang, f"{gang}-w{w}", 2, 2, gated=False, node=node,
                        priority=-10, ckpt=ckpt)
                client.pods[("default", p["metadata"]["name"])] = p
        # The critical gang: one 4-card pod, gated, its class resolved
        # through the listing.
        client.pods[("default", "prod-w0")] = pod("default", "prod", "prod-w0", 4, 1,
                                                  gated=True, class_name="prod")
        table = ReservationTable()
        adm = GangAdmission(client, reservations=table, journal=AdmissionJournal(d),
                            topo_source=lambda: [dataclasses.replace(
                                t, available=list(t.available)) for t in topos])
        resolver = PriorityResolver(client)
        adm.priority_resolver = resolver
        adm.preemption = PreemptionEngine(adm, resolver)
        released = adm.tick()
        assert released == [("default", "prod")], released
        # The cheaper victim (the recent save) paid, and only it: batch-a's
        # 4 cards on n1 fit the preemptor.
        assert client.evicted, "no evictions recorded"
        evicted_gangs = {n.rsplit("-w", 1)[0] for _, n in client.evicted}
        assert evicted_gangs == {"batch-a"}, evicted_gangs
        assert table.active()[("default", "prod")].hosts == {"n1": 4}
        assert table.active()[("default", "prod")].priority == 1_000_000
        gates = client.pods[("default", "prod-w0")]["spec"]["schedulingGates"]
        assert gates == [], gates
        assert [e["reason"] for e in client.events] == [VICTIM_EVENT_REASON]
        assert not adm.preemption.open_intents()
        adm.journal.close()
        store = adm.journal.store
        ops = [r["op"] for r in statestore.read_state(store.journal_path,
                                                      store.snapshot_path).records
               if r["op"].startswith("preempt_")]
        assert ops == ["preempt_intent", "preempt_evicted", "preempt_done"], ops
        print(json.dumps({"preemption_self_test": "ok", "evicted": sorted(evicted_gangs),
                          "journal": ops}))
        return 0
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m k8s_device_plugin_tpu_torch.extender.preemption",
        description="priority tiers and cost-aware preemption of GPU gangs")
    p.add_argument("--self-test", action="store_true",
                   help="drive one preemption round over two synthetic HGX nodes and print "
                   "a one-line JSON verdict")
    a = p.parse_args(argv)
    if a.self_test:
        return self_test()
    p.print_help()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
