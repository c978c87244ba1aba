"""Active defragmentation of GPU gangs: the JAX package's
``extender/defrag.py``, which detects stranded demand and repacks the
cluster within an eviction budget.

A cluster can strand a gang of 8-card members forever while enough cards
sit free, scattered over nodes no member fits on: admission only reacts to
the fragmentation scheduling already made. This module closes that loop in
three layers.

* **Detection.** :class:`StrandedDemandDetector` rides the admission tick
  and recognizes the stranded shape: a waiting gang's largest member asks n
  cards, the free cards of the tick's shielded capacity view hold the
  gang's whole demand, n is at most the largest node's card count, and no
  node places n. Hysteresis (``--defrag-stranded-ticks`` consecutive
  stranded ticks) keeps a transient release race from ever triggering a
  repack. Stranded demand is always exported
  (``tpu_extender_stranded_demand{size,shard}``), whether or not a plan
  follows.

* **Planning.** :class:`DefragPlanner` searches for a minimal migration
  set: running gangs of strictly lower priority whose move to other
  capacity frees room for n on one node. Victims rank by the preemption
  plane's restart cost (duty cycle and checkpoint recency), target nodes by
  the total cost of the victims that would move; a greedy cheapest-first
  build and a most-expensive-first prune keep the set minimal. A plan holds
  only when both fits prove on the pool admission uses: the stranded gang's
  whole demand onto the freed node, and every victim's relocation onto what
  remains. A gang that cannot land elsewhere is never "migrated": that
  would be preemption under another name. Every plan is a document (victims
  with their cost facts, the target, the placeable sizes before and after)
  before it is an action.

* **Execution.** :class:`DefragEngine` coordinates with the checkpoint
  beacon (``workload/beacon.py``: a plan whose victims lack a fresh save is
  held ``checkpoint_wait_ticks``, one by default, so a save in flight can
  land),
  evicts through the preemption plane's one door (``evict_gang_pod``), and
  journals the round in two phases: ``defrag_intent``, the evictions,
  ``defrag_evicted``, the freed cards fenced under the stranded gang's key,
  ``defrag_done``. A SIGKILL anywhere rehydrates to a safe state (gang.py
  ``recover``). The fence goes to the gang the migration was for, never a
  scavenger; the rounds spend a rolling-hour eviction budget
  (``--defrag-max-evictions-per-hour``, ``--defrag-max-concurrent`` victims
  a plan). A refused eviction aborts the round (``defrag_abort``) and the
  next tick plans again.

A GPU node has no contiguous box: the per-node test is
``n in placeable_sizes(topology, free cards)``, the one entry point of that
tuple (``topology/placement.py``), called only for nodes with at least n
free cards (a node with fewer cannot place n). The JAX ``hosts_box_fits``,
``pool_mask`` and the batching by grid geometry have no counterpart. When a
migration leaves the target node wholly free the test is ``n <=
chip_count``; otherwise the freed cards are credited as ``credited_topos``
credits them (the first cards not available, in card order), which may be
optimistic about which cards free but never about the count admission
tests.

``/debug/defrag`` serves the stranded demand, the last plan, the budget and
the last outcome; ``python -m k8s_device_plugin_tpu_torch.tools.defrag
status|plan --url`` renders it. The ledger kinds ``defrag`` and
``defrag_victim`` let ``tools/explain.py --migrated`` answer "why was I
migrated". The victim's Event is ``GPUGangMigrated``.

Sharded, one engine runs per shard admitter and sees only its shard's gangs
and nodes (``gang_filter``/``topo_filter``), so a migration never crosses a
shard.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import constants
from ..topology.placement import placeable_sizes
from ..utils import metrics, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from .preemption import (
    PreemptionPlanner,
    PriorityResolver,
    Victim,
    credited_topos,
    evict_gang_pod,
    post_victim_event,
    tier_label,
)

log = get_logger(__name__)

GangKey = Tuple[str, str]

VICTIM_EVENT_REASON = "GPUGangMigrated"

# Consecutive stranded ticks before the planner is consulted: one resync's
# transient (a release racing the relist, a victim being rescheduled) must
# never trigger a repack.
DEFAULT_STRANDED_TICKS = 3
# The rolling-hour ceiling of victim-pod evictions: the operator's blast
# radius, conservative on purpose.
DEFAULT_MAX_EVICTIONS_PER_HOUR = 12
# Victim gangs one plan may migrate.
DEFAULT_MAX_CONCURRENT = 2
# A victim that saved within this window is "fresh": its eviction loses
# little. A plan with a victim past it is held this many ticks an episode for
# a save in flight.
CHECKPOINT_FRESH_S = 300.0
CHECKPOINT_WAIT_TICKS = 1

BUDGET_WINDOW_S = 3600.0


# -- detection ---------------------------------------------------------------


def _places(t, n: int, free: Optional[List[str]] = None) -> bool:
    """Does node ``t`` place ``n`` cards over ``free`` (its available cards
    by default)? The count first: a node with fewer than n free cards
    cannot, and the set search runs only for the rest."""
    free = t.available if free is None else free
    if len(free) < n:
        return False
    return n in placeable_sizes(t.to_topology(), free)


def stranded_size(topos, demands: List[int]) -> Optional[int]:
    """The member size stranded on ``topos`` (the tick's shielded,
    post-consumption capacity view), or None.

    Stranded means all of: the gang's largest member asks n cards, at most
    the largest node's card count (a bigger request is no node's); the free
    cards hold the gang's whole demand (a real shortage cannot be repacked
    away: migration conserves cards); and no node places n. The caller is in
    the capacity-waiting branch, so the count test of admission failed too:
    free cards that place nothing are exactly the gap this plane repacks."""
    wanted = [d for d in demands if d > 0]
    if not wanted:
        return None
    n = max(wanted)
    if n > max((t.chip_count for t in topos), default=0):
        return None
    if sum(len(t.available) for t in topos) < sum(wanted):
        return None
    if any(_places(t, n) for t in topos if t.chip_count >= n):
        return None
    return n


class StrandedDemandDetector:
    """Per-gang stranded episodes with hysteresis, feeding the
    ``tpu_extender_stranded_demand{size,shard}`` gauge. Mutated only from
    the admission tick's thread; the lock is for the /debug/defrag snapshot,
    which an HTTP handler thread reads."""

    def __init__(self, stranded_ticks: int = DEFAULT_STRANDED_TICKS,
                 shard: Optional[int] = None, *, clock: Callable[[], float] = time.time):
        self.stranded_ticks = max(1, stranded_ticks)
        self._clock = clock
        self._lock = threading.Lock()
        # The gauge is process-wide and one detector runs per admitter: its
        # series carry the shard ("" unsharded), so a detector prunes only
        # its own shard's series and never a peer's.
        self._shard = "" if shard is None else str(shard)
        # gang -> {"size", "ticks", "since"} of the gangs stranded now;
        # pruned when a gang stops being stranded, admits or vanishes.
        self._state: Dict[GangKey, dict] = {}

    def observe(self, key: GangKey, size: int) -> int:
        """One stranded observation; returns the consecutive count. A new
        size (the gang recreated with another shape) restarts the count:
        hysteresis is per (gang, size)."""
        with self._lock:
            st = self._state.get(key)
            if st is None or st["size"] != size:
                st = {"size": size, "ticks": 0, "since": self._clock()}
                self._state[key] = st
            st["ticks"] += 1
            return st["ticks"]

    def clear(self, key: GangKey) -> None:
        with self._lock:
            self._state.pop(key, None)

    def ready(self, key: GangKey) -> bool:
        with self._lock:
            st = self._state.get(key)
            return st is not None and st["ticks"] >= self.stranded_ticks

    def publish(self) -> None:
        """Export the gauge; an emptied size prunes its series (absent means
        no stranded demand of that size)."""
        with self._lock:
            counts: Dict[str, int] = {}
            for st in self._state.values():
                size = str(st["size"])
                counts[size] = counts.get(size, 0) + 1
        for labels, _ in metrics.STRANDED_DEMAND.series():
            if labels.get("shard", "") == self._shard and labels.get("size") not in counts:
                metrics.STRANDED_DEMAND.remove(**labels)
        for size, count in counts.items():
            metrics.STRANDED_DEMAND.set(count, size=size, shard=self._shard)

    def snapshot(self) -> List[dict]:
        now = self._clock()
        with self._lock:
            items = sorted((k, dict(st)) for k, st in self._state.items())
        return [{"namespace": k[0], "gang": k[1], "size": st["size"], "ticks": st["ticks"],
                 "threshold": self.stranded_ticks,
                 "stranded_for_s": round(max(0.0, now - st["since"]), 1)}
                for k, st in items]


# -- planning ----------------------------------------------------------------


@dataclasses.dataclass
class DefragPlan:
    """One executable migration plan: the document the engine and
    /debug/defrag render before anything moves."""

    requestor: GangKey
    priority: int
    demands: List[int]
    size: int  # the stranded member size the plan frees room for
    target_host: str
    # Cheapest first: exactly the set whose migration frees the room.
    victims: List[Victim]
    # node -> cards the victims vacate.
    freed: Dict[str, int]
    # node -> cards the requestor's fit after the migration consumed: what
    # the engine fences for the stranded gang.
    consumed: Dict[str, int]
    # node -> cards the victims' relocation fit consumed (their proven
    # landing capacity; the victims come back through ordinary admission).
    relocation: Dict[str, int]
    # The target node's placeable sizes before and after the migration.
    placeable_before: List[int]
    placeable_after: List[int]
    created_ts: float = 0.0

    def victim_keys(self) -> List[List[str]]:
        return [[v.key[0], v.key[1]] for v in self.victims]

    def victim_pods(self) -> int:
        return sum(len(v.pods) for v in self.victims)

    def total_cost(self) -> float:
        return round(sum(v.restart_cost() for v in self.victims), 1)

    def to_doc(self) -> dict:
        return {
            "requestor": f"{self.requestor[0]}/{self.requestor[1]}",
            "priority": self.priority,
            "tier": tier_label(self.priority),
            "demands": list(self.demands),
            "size": self.size,
            "target_host": self.target_host,
            "consumed": dict(self.consumed),
            "freed": dict(self.freed),
            "relocation": dict(self.relocation),
            "placeable_before": list(self.placeable_before),
            "placeable_after": list(self.placeable_after),
            "total_restart_cost": self.total_cost(),
            "victims": [{
                "gang": f"{v.key[0]}/{v.key[1]}",
                "tier": v.tier,
                "priority": v.priority,
                "hosts": dict(v.hosts),
                "pods": len(v.pods),
                "chips": v.total_chips,
                "duty_cycle": v.duty_cycle,
                "checkpoint_age_s": (None if v.checkpoint_age_s is None
                                     else round(v.checkpoint_age_s, 1)),
                "restart_cost": round(v.restart_cost(), 1),
            } for v in self.victims],
            "created_ts": round(self.created_ts, 3),
        }


class DefragPlanner(PreemptionPlanner):
    """Planning alone: stranded demand and victims in, a minimal migration
    set with a proven relocation out. No API call, no journal write: the
    engine executes, /debug/defrag renders the dry run. Victim discovery,
    the victims' cost facts and the node -> cards sum are the preemption
    planner's, so the two planes' "cheapest" agree."""

    @staticmethod
    def _frees_box(t, freed: int, n: int) -> bool:
        """Would vacating ``freed`` cards on node ``t`` let it place n?
        Exact when the node ends up wholly free (the usual repack: every
        resident hold was a victim's); otherwise the freed cards are
        credited as ``credited_topos`` credits them, optimistic about which
        cards free but never about the count admission tests."""
        if freed <= 0:
            return False
        ids = {c.id for c in t.chips}
        avail = [i for i in t.available if i in ids]
        if len(avail) + freed >= t.chip_count:
            return n <= t.chip_count
        have = set(avail)
        credit = [c.id for c in t.chips if c.id not in have][:freed]
        return _places(t, n, avail + credit)

    # -- the search --------------------------------------------------------

    def plan(self, requestor: GangKey, demands: List[int], priority: int, topos,
             victims: List[Victim], max_victims: int = 0) -> Optional[DefragPlan]:
        """The minimal migration set freeing room for the stranded demand,
        or None. ``victims`` are already of strictly lower priority
        (collect_victims makes them so); this checks feasibility only."""
        from .gang import _CapacityPool  # deferred: gang imports preemption

        wanted = [d for d in demands if d > 0]
        if not wanted or not victims:
            return None
        n = max(wanted)
        by_host: Dict[str, List[Victim]] = {}
        for v in victims:
            for h in v.hosts:
                by_host.setdefault(h, []).append(v)
        # Per candidate node: the greedy cheapest-first set whose vacated
        # cards let it place n, pruned most expensive first. Cheap count and
        # set tests only; the pool proofs below run in cost order.
        candidates: List[Tuple[float, int, str, List[Victim]]] = []
        for t in topos:
            residents = by_host.get(t.hostname)
            if not residents or t.chip_count < n:
                continue
            ordered = sorted(residents, key=lambda v: (v.priority, v.restart_cost(), v.key))
            chosen: List[Victim] = []
            feasible = False
            for v in ordered:
                chosen.append(v)
                if self._frees_box(t, sum(c.hosts[t.hostname] for c in chosen), n):
                    feasible = True
                    break
            if not feasible:
                continue
            for v in sorted(chosen, key=lambda v: (-v.priority, -v.restart_cost(), v.key)):
                if len(chosen) == 1:
                    break
                trial = [c for c in chosen if c is not v]
                if self._frees_box(t, sum(c.hosts[t.hostname] for c in trial), n):
                    chosen = trial
            if max_victims > 0 and len(chosen) > max_victims:
                continue
            candidates.append((sum(v.restart_cost() for v in chosen), len(chosen),
                               t.hostname, chosen))
        candidates.sort(key=lambda c: (c[0], c[1], c[2]))
        for _cost, _count, host, chosen in candidates:
            freed = self._sum_hosts(chosen)
            aug = credited_topos(topos, freed)
            pool = _CapacityPool(aug)
            # The stranded gang places first (it outranks every victim), and
            # its largest member must land on the freed node: landing
            # anywhere else would mean a node placed n already.
            consumed = pool.fits(wanted)
            if consumed is None or consumed.get(host, 0) < n:
                continue
            relocation = pool.fits(sorted((p["chips"] for v in chosen for p in v.pods),
                                          reverse=True))
            if relocation is None:
                continue
            target = next(t for t in topos if t.hostname == host)
            after = next(a for a in aug if a.hostname == host)
            topology = target.to_topology()
            return DefragPlan(
                requestor=requestor, priority=priority, demands=list(wanted), size=n,
                target_host=host, victims=list(chosen), freed=freed,
                consumed=dict(consumed), relocation=dict(relocation),
                placeable_before=list(placeable_sizes(topology, target.available)),
                placeable_after=list(placeable_sizes(topology, after.available)),
                created_ts=self._clock())
        return None


# -- execution ---------------------------------------------------------------


class DefragEngine:
    """Detection, plan, two-phase journal, migration, fence.

    Attached to a GangAdmission (``adm.defrag = engine``): the tick calls
    :meth:`maybe_defrag` for a capacity-waiting gang after the ordinary fit
    failed and preemption (when wired) declined (defragmentation remedies
    fragmentation, not entitlement); a round that succeeds returns the
    consumed node -> cards map, which goes through the tick's ordinary
    reserve, admit and release, and the tick calls :meth:`finish` right
    after the reserve lands, closing the journaled round."""

    def __init__(
        self,
        admission,
        resolver: PriorityResolver,
        stranded_ticks: int = DEFAULT_STRANDED_TICKS,
        max_evictions_per_hour: int = DEFAULT_MAX_EVICTIONS_PER_HOUR,
        max_concurrent: int = DEFAULT_MAX_CONCURRENT,
        *,
        planner: Optional[DefragPlanner] = None,
        checkpoint_wait_ticks: int = CHECKPOINT_WAIT_TICKS,
        clock: Callable[[], float] = time.time,
    ):
        self.admission = admission
        self.planner = planner or DefragPlanner(resolver, resource_name=admission.resource_name)
        shard = getattr(admission, "shard_id", None)
        # "" is the unsharded singleton; per-shard series keep several
        # engines on one registry from overwriting each other.
        self._shard_label = "" if shard is None else str(shard)
        self.detector = StrandedDemandDetector(stranded_ticks, shard=shard, clock=clock)
        self.max_evictions_per_hour = max(0, max_evictions_per_hour)
        self.max_concurrent = max(1, max_concurrent)
        # The extender's entry point passes none of the three keyword options:
        # only the simulator (extender/simulator.py) replays a trace's wait,
        # its own planner and its virtual clock.
        self.checkpoint_wait_ticks = max(0, checkpoint_wait_ticks)
        self._clock = clock
        # Guards _evictions and _open: the tick thread mutates them, the
        # /debug/defrag snapshot reads them from an HTTP thread (an unlocked
        # prune racing a spend could drop a stamp and overrun the budget).
        self._lock = threading.Lock()
        # Wall clocks of the executed victim-pod evictions in the window.
        self._evictions: List[float] = []
        # Open two-phase rounds, requestor -> payload: what the compaction
        # snapshot carries (gang._journal_state reads open_intents()).
        self._open: Dict[GangKey, dict] = {}
        # Per-episode state, reset when the episode ends: the deferred ticks
        # spent waiting for a save, and the ledger dedup of no_plan and
        # blocked_budget.
        self._ckpt_waits: Dict[GangKey, int] = {}
        self._noplan_reported: Set[GangKey] = set()
        self._budget_reported: Set[GangKey] = set()
        # The /debug/defrag what-if state.
        self.last_plan: Optional[dict] = None
        self.last_outcome: str = ""
        self.last_outcome_ts: float = 0.0

    # -- tick plumbing -----------------------------------------------------

    def begin_tick(self) -> None:
        metrics.DEFRAG_BUDGET.set(self.budget_remaining(), shard=self._shard_label)

    def open_intents(self) -> Dict[GangKey, dict]:
        with self._lock:
            return dict(self._open)

    def note_admitted(self, key: GangKey) -> None:
        """The gang's waiting episode ended (admitted, vanished, reshaped):
        its stranded state and per-episode marks go."""
        self.detector.clear(key)
        self.detector.publish()
        self._ckpt_waits.pop(key, None)
        self._noplan_reported.discard(key)
        self._budget_reported.discard(key)

    def budget_remaining(self) -> int:
        now = self._clock()
        with self._lock:
            self._evictions = [t for t in self._evictions if now - t < BUDGET_WINDOW_S]
            return max(0, self.max_evictions_per_hour - len(self._evictions))

    def spend_window(self) -> List[float]:
        """The budget window, for the compaction snapshot (gang.py
        ``_journal_state``)."""
        now = self._clock()
        with self._lock:
            return [t for t in self._evictions if now - t < BUDGET_WINDOW_S]

    def spend(self, stamp: float) -> None:
        """Count one executed eviction against the window. The rescue plane
        spends through here too: rescue and defragmentation share one blast
        radius (two planes with the full cap each would double it)."""
        with self._lock:
            self._evictions.append(float(stamp))

    def seed_spend(self, stamps) -> None:
        """Rehydrate the window on recovery (gang.recover, once, on a fresh
        engine): a crash-looping extender must not grant itself a fresh
        budget each restart. A plain merge, not a set union: two evictions at
        one clock reading are two stamps."""
        now = self._clock()
        with self._lock:
            self._evictions = sorted(
                self._evictions + [float(t) for t in stamps if now - float(t) < BUDGET_WINDOW_S])

    def _outcome(self, outcome: str) -> None:
        self.last_outcome = outcome
        self.last_outcome_ts = self._clock()

    # -- the round ---------------------------------------------------------

    def maybe_defrag(self, key: GangKey, gv, demands: List[int], topos, priority: int,
                     gangs: Optional[Dict[GangKey, object]] = None
                     ) -> Optional[Dict[str, int]]:
        """One defragmentation evaluation for a capacity-waiting gang.
        Returns the consumed node -> cards map for the tick to reserve (the
        stranded gang then admits through the ordinary path), or None (not
        stranded, hysteresis counting, no plan, budget spent, held for a
        checkpoint, eviction refused). ``gangs`` follows maybe_preempt's
        contract: a full sweep passes its map, a dirty tick None, and the
        engine lists only once a plan is due."""
        if key in self._open:
            return None
        n = stranded_size(topos, demands)
        if n is None:
            # No longer stranded ends the episode: a later stranding of the
            # same gang is a fresh episode, recorded and held anew.
            self.note_admitted(key)
            return None
        ticks = self.detector.observe(key, n)
        self.detector.publish()
        gang_key = f"{key[0]}/{key[1]}"
        if ticks < self.detector.stranded_ticks:
            # Count at tick cadence: a waiting gang is otherwise evaluated
            # again only on a node event or the full-sweep backstop, which
            # would stretch K ticks into K sweeps.
            self.admission.mark_dirty(key, source="defrag")
            return None
        if self.budget_remaining() <= 0:
            if key not in self._budget_reported:
                self._budget_reported.add(key)
                metrics.DEFRAG_PLANS.inc(outcome="blocked_budget")
                LEDGER.record("defrag", "blocked_budget",
                              f"stranded size-{n} demand cannot plan a repack: the eviction "
                              f"budget is spent ({self.max_evictions_per_hour}/h)",
                              gang=gang_key, size=n)
                self._outcome("blocked_budget")
            # Evaluated again every resync, so the repack runs as soon as the
            # window refills.
            self.admission.mark_dirty(key, source="defrag")
            return None
        if gangs is None:
            gangs = self.admission._collect_gangs()
        victims = self.planner.collect_victims(gangs, key, priority)
        plan = self.planner.plan(key, demands, priority, topos, victims,
                                 max_victims=self.max_concurrent)
        if plan is None:
            if key not in self._noplan_reported:
                self._noplan_reported.add(key)
                metrics.DEFRAG_PLANS.inc(outcome="no_plan")
                LEDGER.record("defrag", "no_plan",
                              f"size-{n} demand is stranded but no strictly-lower-priority "
                              f"victim set with a proven relocation frees a box",
                              gang=gang_key, size=n, tier=tier_label(priority),
                              priority=priority)
                self._outcome("no_plan")
            return None
        self.last_plan = plan.to_doc()
        if plan.victim_pods() > self.budget_remaining():
            if key not in self._budget_reported:
                self._budget_reported.add(key)
                metrics.DEFRAG_PLANS.inc(outcome="blocked_budget")
                LEDGER.record("defrag", "blocked_budget",
                              f"plan needs {plan.victim_pods()} eviction(s) but only "
                              f"{self.budget_remaining()} remain in the rolling hour",
                              gang=gang_key, size=n, evictions=plan.victim_pods(),
                              budget_remaining=self.budget_remaining())
                self._outcome("blocked_budget")
            self.admission.mark_dirty(key, source="defrag")
            return None
        # Checkpoint coordination: with a victim past its fresh save, hold
        # the plan (up to checkpoint_wait_ticks an episode) so a save in
        # flight can land; each plan again reads the newer recency.
        stale = [v for v in plan.victims
                 if v.checkpoint_age_s is None or v.checkpoint_age_s > CHECKPOINT_FRESH_S]
        waited = self._ckpt_waits.get(key, 0)
        if stale and waited < self.checkpoint_wait_ticks:
            self._ckpt_waits[key] = waited + 1
            self.admission.mark_dirty(key, source="defrag")  # one resync, not one sweep
            metrics.DEFRAG_PLANS.inc(outcome="deferred")
            LEDGER.record("defrag", "deferred",
                          f"{len(stale)} victim(s) lack a fresh checkpoint "
                          f"(> {CHECKPOINT_FRESH_S:.0f}s); holding the migration one "
                          f"tick for an in-flight save",
                          gang=gang_key, size=n, stale_victims=len(stale))
            self._outcome("deferred")
            return None
        if not tracing.enabled():
            return self._execute(key, gang_key, plan)
        with tracing.span("gang.defrag", service="extender", namespace=key[0], gang=key[1],
                          victims=len(plan.victims), target=plan.target_host):
            return self._execute(key, gang_key, plan)

    def _execute(self, key: GangKey, gang_key: str,
                 plan: DefragPlan) -> Optional[Dict[str, int]]:
        journal = self.admission.journal
        payload = {"phase": "intent", "victims": plan.victim_keys(),
                   "consumed": dict(plan.consumed), "demands": list(plan.demands),
                   "priority": plan.priority, "ts": self._clock()}
        # Phase 1: the intent is durable before anything irreversible.
        with self._lock:
            self._open[key] = payload
        if journal is not None:
            journal.record("defrag_intent", key, victims=plan.victim_keys(),
                           consumed=dict(plan.consumed), demands=list(plan.demands),
                           priority=plan.priority)
        # Phase 2: every victim pod through the one door. A refusal aborts
        # the round (the evictions that landed freed their cards, so the next
        # plan is cheaper). A victim's "migrated" record lands only once its
        # pods left: explain --migrated never claims an aborted move.
        blocked = False
        spent: List[float] = []
        for rank, v in enumerate(plan.victims):
            for p in v.pods:
                if not evict_gang_pod(self.admission.client, p.get("ns", "default"),
                                      p.get("name", "")):
                    blocked = True
                    break
                # Every executed eviction spends, a blocked round's partial
                # victim's too: those pods are gone.
                spent.append(self._clock())
                with self._lock:
                    self._evictions.append(spent[-1])
            if blocked:
                break
            metrics.DEFRAG_MIGRATIONS.inc(victim_tier=v.tier)
            LEDGER.record(
                "defrag_victim", "migrated",
                f"victim {rank + 1}/{len(plan.victims)} migrated off {plan.target_host} for "
                f"{gang_key}: priority {v.priority}, restart cost {v.restart_cost():.1f}",
                gang=f"{v.key[0]}/{v.key[1]}",
                requestor=gang_key,
                rank=rank + 1,
                victim_tier=v.tier,
                victim_priority=v.priority,
                chips=v.total_chips,
                target_host=plan.target_host,
                duty_cycle="" if v.duty_cycle is None else round(v.duty_cycle, 1),
                checkpoint_age_s=("" if v.checkpoint_age_s is None
                                  else round(v.checkpoint_age_s, 1)),
            )
            self._post_victim_event(v, gang_key, plan.target_host)
        if spent and journal is not None:
            # The spend survives a restart (the replay and the compaction
            # snapshot seed the window). Not critical: the evictions already
            # happened and the tick's flush covers it. Full precision: two
            # pods evicted in one millisecond are two stamps.
            journal.record("defrag_spend", key, stamps=list(spent))
        if blocked:
            with self._lock:
                self._open.pop(key, None)
            if journal is not None:
                journal.record("defrag_abort", key, reason="eviction_blocked")
            metrics.DEFRAG_ABORTED.inc(reason="eviction_blocked")
            LEDGER.record("defrag", "blocked",
                          "a victim eviction was refused (PodDisruptionBudget, drift, or "
                          "apiserver); round aborted, re-planned next tick", gang=gang_key)
            self._outcome("aborted")
            return None
        payload = dict(payload, phase="evicted", ts=self._clock())
        with self._lock:
            self._open[key] = payload
        if journal is not None:
            journal.record("defrag_evicted", key, victims=plan.victim_keys(),
                           consumed=dict(plan.consumed), demands=list(plan.demands),
                           priority=plan.priority)
        metrics.DEFRAG_PLANS.inc(outcome="executed")
        metrics.DEFRAG_BUDGET.set(self.budget_remaining(), shard=self._shard_label)
        victims_s = ",".join(f"{v.key[0]}/{v.key[1]}" for v in plan.victims)
        freed = sum(plan.freed.values())
        RECORDER.record("defrag",
                        f"defrag migrated {len(plan.victims)} gang(s) off {plan.target_host} "
                        f"to free a size-{plan.size} box for {gang_key}",
                        namespace=key[0], gang=key[1], target=plan.target_host,
                        size=plan.size, victims=victims_s, freed_chips=freed)
        LEDGER.record("defrag", "executed",
                      f"migrated {len(plan.victims)} gang(s) ({victims_s}) off "
                      f"{plan.target_host}, freeing a size-{plan.size} box (placeable "
                      f"{plan.placeable_before} -> {plan.placeable_after}) for {plan.demands}",
                      gang=gang_key, size=plan.size, target_host=plan.target_host,
                      victims=victims_s, victim_count=len(plan.victims), freed_chips=freed,
                      total_restart_cost=plan.total_cost())
        log.warning("defrag: stranded gang %s (size %d) migrating %d gang(s) [%s] off %s; "
                    "reserving %s", gang_key, plan.size, len(plan.victims), victims_s,
                    plan.target_host, plan.consumed)
        self._outcome("executed")
        self.detector.clear(key)
        self.detector.publish()
        self._noplan_reported.discard(key)
        self._ckpt_waits.pop(key, None)
        return dict(plan.consumed)

    def finish(self, key: GangKey) -> None:
        """Phase 3: the tick reserved the freed cards (the fence is journaled
        through the table's observer); close the round."""
        with self._lock:
            if self._open.pop(key, None) is None:
                return
        if self.admission.journal is not None:
            self.admission.journal.record("defrag_done", key)

    def close(self) -> None:
        """Leave /debug/defrag and prune this engine's series: the owning
        admitter's stop() calls it, so a shard handed back leaves no stale
        engine, frozen budget or duplicate behind."""
        uninstall(self)
        metrics.DEFRAG_BUDGET.remove(shard=self._shard_label)
        for labels, _ in metrics.STRANDED_DEMAND.series():
            if labels.get("shard", "") == self._shard_label:
                metrics.STRANDED_DEMAND.remove(**labels)

    # -- helpers -----------------------------------------------------------

    def _post_victim_event(self, victim: Victim, requestor: str, target: str) -> None:
        post_victim_event(
            self.admission.client, victim, reason=VICTIM_EVENT_REASON,
            message=(f"gang {victim.key[0]}/{victim.key[1]} migrated off {target} by "
                     f"defragmentation to free room for stranded gang {requestor}"))

    def snapshot(self) -> dict:
        """This engine's /debug/defrag payload."""
        return {
            "shard": getattr(self.admission, "shard_id", None),
            "stranded": self.detector.snapshot(),
            "stranded_ticks": self.detector.stranded_ticks,
            "budget": {"max_evictions_per_hour": self.max_evictions_per_hour,
                       "remaining": self.budget_remaining(),
                       "max_concurrent": self.max_concurrent,
                       "window_s": BUDGET_WINDOW_S},
            "checkpoint": {"fresh_s": CHECKPOINT_FRESH_S,
                           "wait_ticks": self.checkpoint_wait_ticks},
            "open_rounds": [{"requestor": f"{k[0]}/{k[1]}", "phase": p.get("phase"),
                             "consumed": dict(p.get("consumed") or {})}
                            for k, p in sorted(self.open_intents().items())],
            "last_plan": self.last_plan,
            "last_outcome": self.last_outcome,
            "last_outcome_ts": round(self.last_outcome_ts, 3),
        }


# -- /debug/defrag -----------------------------------------------------------

# The engines the entry point installed, one per admitter (the singleton or
# each shard's): metrics.debug_payload serves /debug/defrag from here, and
# tpu-doctor's bundle collects it through DEBUG_ENDPOINTS.
_ENGINES: List[DefragEngine] = []


def install(engine: DefragEngine) -> None:
    if engine not in _ENGINES:
        _ENGINES.append(engine)


def uninstall(engine: DefragEngine) -> None:
    if engine in _ENGINES:
        _ENGINES.remove(engine)


def debug_snapshot() -> dict:
    if not _ENGINES:
        return {"enabled": False,
                "note": "defragmentation not wired in this process (extender "
                        "--gang-admission without --no-defrag installs it)"}
    return {"enabled": True, "engines": [e.snapshot() for e in _ENGINES]}


# -- CLI ---------------------------------------------------------------------


def _fetch(url: str) -> dict:
    import json
    import urllib.request

    with urllib.request.urlopen(f"{url.rstrip('/')}/debug/defrag", timeout=10) as resp:
        return json.loads(resp.read())


def _render_status(doc: dict) -> List[str]:
    if not doc.get("enabled"):
        return [f"defrag: not wired ({doc.get('note', '')})"]
    out = []
    for eng in doc.get("engines", []):
        shard = eng.get("shard")
        head = "defrag" + (f" [shard {shard}]" if shard is not None else "")
        budget = eng.get("budget") or {}
        out.append(f"{head}: budget {budget.get('remaining', '?')}/"
                   f"{budget.get('max_evictions_per_hour', '?')} evictions this hour, last "
                   f"outcome {eng.get('last_outcome') or '(none)'}")
        stranded = eng.get("stranded") or []
        if not stranded:
            out.append("  no stranded demand")
        for s in stranded:
            out.append(f"  stranded: {s['namespace']}/{s['gang']} size {s['size']} "
                       f"({s['ticks']}/{s['threshold']} ticks, {s['stranded_for_s']}s)")
        for r in eng.get("open_rounds") or []:
            out.append(f"  open round: {r['requestor']} phase {r['phase']}")
    return out


def _render_plan(doc: dict) -> List[str]:
    if not doc.get("enabled"):
        return [f"defrag: not wired ({doc.get('note', '')})"]
    out = []
    for eng in doc.get("engines", []):
        plan = eng.get("last_plan")
        if not plan:
            out.append("no plan computed yet (no stranded demand has cleared hysteresis, "
                       "or none was plannable)")
            continue
        out.append(f"plan for {plan['requestor']} (tier {plan['tier']}): free a "
                   f"size-{plan['size']} box on {plan['target_host']} — placeable "
                   f"{plan['placeable_before']} -> {plan['placeable_after']}")
        out.append(f"  total restart cost {plan['total_restart_cost']}, fence "
                   f"{plan['consumed']}, relocation {plan['relocation']}")
        for v in plan.get("victims", []):
            age = v.get("checkpoint_age_s")
            duty = v.get("duty_cycle")
            out.append(f"  migrate {v['gang']} (tier {v['tier']}, {v['chips']} chip(s), duty "
                       f"{duty if duty is not None else '?'}, checkpoint "
                       f"{str(age) + 's ago' if age is not None else 'never'}, cost "
                       f"{v['restart_cost']})")
    return out


def self_test() -> int:
    """A fragmented two-node cluster end to end: two 4-card HGX nodes with
    two free cards each (free cards everywhere, room for 4 nowhere), a batch
    gang that saved recently on the other two cards of n1, a 4-card gang
    arriving gated. The detector counts it stranded through hysteresis, the
    planner picks the batch gang (whose pods land on n2's free cards), the
    engine evicts it two-phase journaled and the stranded gang admits onto
    the freed, fenced n1, through the real GangAdmission and journal
    against a client defined here. Prints a one-line JSON verdict."""
    import json
    import shutil
    import tempfile

    from ..topology.schema import hgx_topology
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

    def pod(gang, name, cards, size, gated, node="", priority=None, ckpt=None):
        p = {
            "metadata": {"name": name, "namespace": "default", "uid": f"uid-{name}",
                         "labels": {constants.GANG_NAME_LABEL: gang, GANG_SIZE_LABEL: str(size)},
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
        if ckpt is not None:
            p["metadata"]["annotations"][constants.CHECKPOINT_TS_ANNOTATION] = str(ckpt)
        return p

    d = tempfile.mkdtemp(prefix="gpu-defrag-selftest-")
    try:
        client = FakeClient()
        topos = []
        for name in ("n1", "n2"):
            t = hgx_topology(name, 4)
            topos.append(dataclasses.replace(t, available=[t.chips[0].id, t.chips[2].id]))
        now = time.time()
        # The victim: a batch gang that saved 5 s ago, on n1's other two
        # cards (its migration frees n1 whole).
        for w in range(2):
            p = pod("frag", f"frag-w{w}", 1, 2, gated=False, node="n1", priority=-10,
                    ckpt=now - 5)
            client.pods[("default", p["metadata"]["name"])] = p
        # The stranded gang: one 4-card pod of standard priority.
        client.pods[("default", "train-w0")] = pod("train", "train-w0", 4, 1, gated=True,
                                                   priority=0)
        table = ReservationTable()
        adm = GangAdmission(client, reservations=table, journal=AdmissionJournal(d),
                            topo_source=lambda: [dataclasses.replace(
                                t, available=list(t.available)) for t in topos])
        resolver = PriorityResolver()
        adm.priority_resolver = resolver
        engine = DefragEngine(adm, resolver, stranded_ticks=2)
        adm.defrag = engine
        released: List[GangKey] = []
        for _ in range(engine.detector.stranded_ticks):
            released = adm.tick()
        assert released == [("default", "train")], released
        evicted_gangs = {n.rsplit("-w", 1)[0] for _, n in client.evicted}
        assert evicted_gangs == {"frag"}, evicted_gangs
        assert table.active()[("default", "train")].hosts == {"n1": 4}
        gates = client.pods[("default", "train-w0")]["spec"]["schedulingGates"]
        assert gates == [], gates
        assert [e["reason"] for e in client.events] == [VICTIM_EVENT_REASON]
        assert not engine.open_intents()
        assert engine.last_outcome == "executed", engine.last_outcome
        assert engine.last_plan["target_host"] == "n1"
        assert engine.last_plan["relocation"] == {"n2": 2}, engine.last_plan
        assert 4 not in engine.last_plan["placeable_before"]
        assert 4 in engine.last_plan["placeable_after"]
        adm.journal.close()
        print(json.dumps({"defrag_self_test": "ok", "migrated": sorted(evicted_gangs),
                          "target": engine.last_plan["target_host"],
                          "budget_remaining": engine.budget_remaining()}))
        return 0
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="tpu-defrag",
        description="Active defragmentation: stranded demand, the plan the planner would "
        "execute, and budget state, read from a live extender's /debug/defrag surface.")
    p.add_argument("command", nargs="?", choices=("plan", "status"),
                   help="plan: render the last computed migration plan (dry-run view); "
                   "status: stranded demand + budget + last outcome")
    p.add_argument("--url", default="", help="extender base URL, e.g. http://extender:12346")
    p.add_argument("--self-test", action="store_true",
                   help="run the fragmented two-node migration smoke and print a one-line "
                   "JSON verdict")
    a = p.parse_args(argv)
    if a.self_test:
        return self_test()
    if not a.command:
        p.print_help()
        return 2
    if not a.url:
        p.error("--url is required for plan/status")
    try:
        doc = _fetch(a.url)
    except (OSError, ValueError) as e:
        print(f"tpu-defrag: {e}", file=sys.stderr)
        return 1
    print("\n".join(_render_plan(doc) if a.command == "plan" else _render_status(doc)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
