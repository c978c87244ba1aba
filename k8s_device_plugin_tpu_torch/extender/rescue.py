"""Hardware-failure rescue of GPU gangs and the node drain: the JAX
package's ``extender/rescue.py``.

The daemon's health path withdraws a failed card from the kubelet within
seconds, but the gang that was running on it stays where it died: its pods
are bound, its cards allocated, and the admission plane never looks at a
running gang again. This module closes that loop, in three layers.

* **Detection.** The admission tick hands every fully released gang to
  :meth:`RescueEngine.maybe_rescue`, which joins two signals: the topology
  annotation's ``failed`` card list (the health withdrawals the daemon
  publishes) and the node lifecycle :class:`NodeStateTracker` follows
  (NotReady, ``spec.unschedulable``, the ``tpu.google.com/maintenance``
  taint). A gang is degraded when a pod of it is bound to a node being
  evacuated (NotReady, or tainted ``maintenance=drain``), or to a node whose
  bound card demand exceeds its healthy card count: the count proof that
  some pod there sits on a dead card. A grace window (``grace_ticks``
  consecutive degraded ticks) keeps a health-check flap from evacuating a
  live job.

* **Rescue.** A journaled two-phase evacuation on the preemption and
  defragmentation planes' machinery: prove a target on healthy placeable
  capacity (the admission ``_CapacityPool``, with the gang's own cards on
  healthy nodes credited back: they free the moment it moves), else the
  preemption planner's minimal set of strictly lower-priority victims under
  the shared rolling eviction budget (defrag's window: two planes never
  double the operator's blast radius); then ``rescue_intent``, the victims
  and the degraded gang's own pods evicted through the one door,
  ``rescue_evicted``, the target fenced under the rescued gang's key,
  ``rescue_done``. The fence is the gang's re-admission at the head of its
  tier: its replacements arrive gated, match the standing hold and release
  without queueing behind newcomers. A SIGKILL anywhere rehydrates exactly
  once through gang.recover(): an open ``evicted`` phase fences the
  journaled target again even though the gang's pods are gone; an open
  ``intent`` aborts and the next tick plans again.

* **RESCUE_PENDING.** With no target (no fit, no affordable victim set) the
  gang parks: its demand goes to the defrag plane as stranded demand
  (``maybe_defrag``: a repack that frees room completes the rescue through
  the same round), the episode is recorded once, and the audit invariant
  ``rescue_vs_health`` fires if a degraded gang is ever neither rescued,
  parked nor inside an open round past the grace window.

The node lifecycle rides the same tracker: ``GangAdmission._node_topologies``
drops the nodes it excludes, so admission and both eviction planes refuse
cordoned, tainted and NotReady capacity through one filter, and
:class:`DrainCoordinator` serves the ``/drain`` verb (``tpu-doctor
drain``): the cordon and the ``maintenance=drain`` taint (kept in the
cluster, so a restarted extender resumes the evacuation from the node's
state with no drain journal), the rescue plane's evacuation of every
resident gang, and the ``drain-complete`` stamp once no resident gang pod
and no reserved card remain.

Observability: ``tpu_extender_rescues_total{outcome,tier}``,
``tpu_extender_rescue_latency_seconds``, ``tpu_node_cordoned{node}``, the
``/debug/rescue`` surface, the ledger kinds ``rescue``, ``rescue_victim`` and
``drain`` (``tools/explain.py --rescued``) and the flight kinds ``rescue``
and ``drain``. A victim's Event is ``GPUGangRescueEvicted``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import constants
from ..utils import metrics, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from ..utils.podresources import gpu_request
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

VICTIM_EVENT_REASON = "GPUGangRescueEvicted"

# Consecutive degraded ticks before a rescue runs: one transient (a
# health-check flap, a node condition racing the relist) must never evacuate
# a live job. The audit's rescue_vs_health fires only past it.
DEFAULT_GRACE_TICKS = 2
# The rolling-hour victim-pod ceiling when no defrag engine is wired to share
# a budget with (defrag's default); with defrag wired both planes spend from
# its one window.
DEFAULT_MAX_EVICTIONS_PER_HOUR = 12
BUDGET_WINDOW_S = 3600.0
# How long a completed rescue keeps its head-of-tier order: long enough for
# the replacements to be recreated and released, short enough never to
# outlive the episode it makes up for.
BOOST_WINDOW_S = 900.0


# -- node lifecycle ----------------------------------------------------------


class NodeStateTracker:
    """Each node's lifecycle from its watched object: the Ready condition,
    ``spec.unschedulable`` (a cordon) and the ``tpu.google.com/maintenance``
    taint (any value takes the node out of placement; ``drain`` also
    evacuates its residents). Fed by the node cache's tap (__main__.py) and
    by DrainCoordinator right after its own patches; a node it has not seen
    is placeable, so a cold cache never takes capacity away. Publishes
    ``tpu_node_cordoned{node}`` (1 per excluded node, pruned once it is
    placeable again). Thread-safe: the watch thread writes it, the tick and
    the HTTP threads read it."""

    _STATE_KEYS = ("ready", "unschedulable", "maintenance", "draining")

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.Lock()
        # name -> {"ready", "unschedulable", "maintenance", "draining", "since"}
        self._nodes: Dict[str, dict] = {}

    @staticmethod
    def _parse(node: dict) -> dict:
        spec = node.get("spec") or {}
        status = node.get("status") or {}
        ready = True
        for cond in status.get("conditions") or []:
            if cond.get("type") == "Ready":
                ready = cond.get("status") == "True"
        maintenance = draining = False
        for t in spec.get("taints") or []:
            if t.get("key") == constants.MAINTENANCE_TAINT:
                maintenance = True
                draining = t.get("value") == constants.DRAIN_TAINT_VALUE
        return {"ready": ready, "unschedulable": bool(spec.get("unschedulable")),
                "maintenance": maintenance, "draining": draining}

    def update_node(self, node: dict) -> None:
        name = (node.get("metadata") or {}).get("name")
        if not name:
            return
        st = self._parse(node)
        with self._lock:
            prev = self._nodes.get(name)
            same = prev is not None and all(prev[k] == st[k] for k in self._STATE_KEYS)
            st["since"] = prev["since"] if same else self._clock()
            self._nodes[name] = st
        self._publish(name, st)

    def remove_node(self, name: str) -> None:
        with self._lock:
            self._nodes.pop(name, None)
        metrics.NODE_CORDONED.remove(node=name)

    @staticmethod
    def _excluded(st: dict) -> bool:
        return st["unschedulable"] or st["maintenance"] or not st["ready"]

    def _publish(self, name: str, st: dict) -> None:
        if self._excluded(st):
            metrics.NODE_CORDONED.set(1, node=name)
        else:
            metrics.NODE_CORDONED.remove(node=name)

    def placeable(self, host: str) -> bool:
        with self._lock:
            st = self._nodes.get(host)
            return st is None or not self._excluded(st)

    def evacuate(self, host: str) -> bool:
        """Must the resident gangs move off this node? NotReady or an
        explicit drain: a plain cordon only stops new placement (kubectl
        cordon's meaning), it never evicts."""
        with self._lock:
            st = self._nodes.get(host)
            return st is not None and (not st["ready"] or st["draining"])

    def draining(self, host: str) -> bool:
        with self._lock:
            st = self._nodes.get(host)
            return st is not None and st["draining"]

    def snapshot(self) -> List[dict]:
        now = self._clock()
        with self._lock:
            items = sorted((n, dict(st)) for n, st in self._nodes.items())
        return [{"node": n, "ready": st["ready"], "unschedulable": st["unschedulable"],
                 "maintenance": st["maintenance"], "draining": st["draining"],
                 "placeable": not self._excluded(st),
                 "state_for_s": round(max(0.0, now - st.get("since", now)), 1)}
                for n, st in items]


# -- the rescue engine -------------------------------------------------------


class RescueEngine:
    """Detection, target proof, two-phase journal, evacuation, fence.
    Attached to a GangAdmission (``adm.rescue = engine``): the tick calls
    :meth:`maybe_rescue` for every fully released gang (the running ones;
    gated gangs are the admission queue's), and a round that succeeds
    returns its consumed map so the tick debits its shared pool."""

    def __init__(
        self,
        admission,
        resolver: PriorityResolver,
        tracker: Optional[NodeStateTracker] = None,
        grace_ticks: int = DEFAULT_GRACE_TICKS,
        max_evictions_per_hour: int = DEFAULT_MAX_EVICTIONS_PER_HOUR,
        *,
        planner: Optional[PreemptionPlanner] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.admission = admission
        # The target proof and the victims are the preemption planner's (the
        # same Victim, cost ranking and minimal-set search): the three
        # eviction planes' "cheapest" must agree.
        self.planner = planner or PreemptionPlanner(resolver,
                                                    resource_name=admission.resource_name)
        self.tracker = tracker
        self.grace_ticks = max(1, grace_ticks)
        self.max_evictions_per_hour = max(0, max_evictions_per_hour)
        # The extender's entry point passes neither keyword option: only the
        # simulator (extender/simulator.py) replays with its own planner and
        # its virtual clock.
        self._clock = clock
        # Guards _open, _evictions, _degraded, _pending and _rescued_at: the
        # tick thread writes them, /debug/rescue and the auditor read them.
        self._lock = threading.Lock()
        # Open two-phase rounds, rescued gang -> payload (the compaction
        # snapshot carries it through open_intents()).
        self._open: Dict[GangKey, dict] = {}
        # The own rolling window, used only when no defrag engine shares one.
        self._evictions: List[float] = []
        # Degraded episodes: key -> {"hosts": {host: reason}, "ticks", "since"}.
        self._degraded: Dict[GangKey, dict] = {}
        # Parked RESCUE_PENDING episodes: key -> {"since", "reason"}.
        self._pending: Dict[GangKey, dict] = {}
        self._pending_reported: Set[GangKey] = set()
        # Completed rescues inside the boost window.
        self._rescued_at: Dict[GangKey, float] = {}
        # host -> cards whose evacuation this tick already planned: two gangs
        # on one overcommitted node must not both read its dead cards as
        # theirs and both leave.
        self._tick_evacuated: Dict[str, int] = {}
        self.last_outcome: str = ""
        self.last_outcome_ts: float = 0.0
        # The DrainCoordinator serving this admitter's /drain, attached by
        # the entry point (None where only detection and rescue run).
        self.drain_coordinator = None

    # -- tick plumbing -----------------------------------------------------

    def begin_tick(self) -> None:
        self._tick_evacuated = {}

    def open_intents(self) -> Dict[GangKey, dict]:
        with self._lock:
            return dict(self._open)

    def note_refenced(self, key: GangKey) -> None:
        """Crash recovery restored (or found) this gang's rescue fence with
        its pods already evicted: the boost and shield window opens, so the
        upkeep keeps the pod-less hold until the replacements release
        against it, and the gang keeps its place across the crash."""
        with self._lock:
            self._rescued_at[key] = self._clock()

    def note_admitted(self, key: GangKey) -> None:
        """The gang's episode ended (rescued, healed, vanished, reshaped):
        its degraded and parked state and its dedup mark go."""
        with self._lock:
            self._degraded.pop(key, None)
            self._pending.pop(key, None)
        self._pending_reported.discard(key)

    def prune(self, live_keys: Set[GangKey]) -> None:
        """The full sweep's GC (the tick passes every gang it saw): the
        episodes of vanished gangs go. A just-rescued gang has no pods until
        its controller recreates them and its entry is the shield of its
        fence, so _rescued_at is pruned only by the boost window's end."""
        now = self._clock()
        with self._lock:
            for k in list(self._degraded):
                if k not in live_keys:
                    self._degraded.pop(k, None)
            for k in list(self._pending):
                if k not in live_keys:
                    self._pending.pop(k, None)
            for k, ts in list(self._rescued_at.items()):
                if now - ts > BOOST_WINDOW_S:
                    self._rescued_at.pop(k, None)
        self._pending_reported &= set(live_keys)

    def shield(self, key: GangKey) -> bool:
        """Should a pod-less gang's hold survive the upkeep? While a rescue
        round is open for it, or its rescue is inside the boost window: no
        pods then means "evicted by us, replacements coming"."""
        with self._lock:
            if key in self._open:
                return True
            ts = self._rescued_at.get(key)
            return ts is not None and self._clock() - ts <= BOOST_WINDOW_S

    def admit_boost(self, key: GangKey) -> int:
        """The tick's order within a tier: 0 (first) for a gang rescued
        inside the boost window, else 1."""
        with self._lock:
            ts = self._rescued_at.get(key)
            if ts is None:
                return 1
            if self._clock() - ts > BOOST_WINDOW_S:
                self._rescued_at.pop(key, None)
                return 1
            return 0

    def placeable(self, host: str) -> bool:
        return self.tracker is None or self.tracker.placeable(host)

    # -- the budget (defrag's when wired) ----------------------------------

    def budget_remaining(self) -> int:
        defrag = getattr(self.admission, "defrag", None)
        if defrag is not None:
            return defrag.budget_remaining()
        now = self._clock()
        with self._lock:
            self._evictions = [t for t in self._evictions if now - t < BUDGET_WINDOW_S]
            return max(0, self.max_evictions_per_hour - len(self._evictions))

    def _spend(self, stamp: float) -> None:
        defrag = getattr(self.admission, "defrag", None)
        if defrag is not None:
            defrag.spend(stamp)
        else:
            with self._lock:
                self._evictions.append(stamp)

    def seed_spend(self, stamps) -> None:
        """Rehydrate the window on recovery when this engine owns it (no
        defrag engine wired; otherwise gang.recover seeds defrag's, which
        budget_remaining reads). The same plain merge as defrag's."""
        now = self._clock()
        with self._lock:
            self._evictions = sorted(
                self._evictions + [float(t) for t in stamps if now - float(t) < BUDGET_WINDOW_S])

    def _outcome(self, outcome: str) -> None:
        self.last_outcome = outcome
        self.last_outcome_ts = self._clock()

    # -- detection ---------------------------------------------------------

    def _bound_chips(self, gv) -> Dict[str, int]:
        bound: Dict[str, int] = {}
        for p in getattr(gv, "live", None) or []:
            node = (p.get("spec") or {}).get("nodeName")
            if node:
                bound[node] = bound.get(node, 0) + gpu_request(p, self.admission.resource_name)
        return bound

    def _degraded_hosts(self, bound: Dict[str, int], by_host: Dict[str, object],
                        gangs: Optional[Dict[GangKey, object]]
                        ) -> Tuple[Dict[str, str], Optional[Dict[GangKey, object]]]:
        """host -> reason for every degraded node this gang is bound to, and
        the gangs map (listed here when the count proof needs it), so the
        victim search never lists twice in one call."""
        out: Dict[str, str] = {}
        card_hosts: List[str] = []
        for h in sorted(bound):
            if self.tracker is not None and self.tracker.evacuate(h):
                out[h] = "draining" if self.tracker.draining(h) else "node_lost"
                continue
            t = by_host.get(h)
            if t is not None and getattr(t, "failed", None):
                card_hosts.append(h)
        if card_hosts and gangs is None:
            # A dirty tick's map is narrowed, and the count proof needs every
            # pod bound to the suspect node: listed only once a bound pod
            # shares a node with a withdrawn card.
            gangs = self.admission._collect_gangs()
        for h in card_hosts:
            t = by_host[h]
            healthy = t.chip_count - len(t.failed)
            bound_all = 0
            for ogv in (gangs or {}).values():
                for p in getattr(ogv, "live", None) or []:
                    if (p.get("spec") or {}).get("nodeName") == h:
                        bound_all += gpu_request(p, self.admission.resource_name)
            bound_all -= self._tick_evacuated.get(h, 0)
            if bound_all > healthy:
                # More cards bound than healthy cards exist: a bound pod
                # holds a dead card. The kubelet's device assignment is not
                # visible here; rescuing the resident gangs in cost order
                # until the overcommit clears is the safe over-approximation.
                out[h] = "chip_failed"
        return out, gangs

    def degraded_state(self) -> Dict[GangKey, dict]:
        """The degraded episodes observed now (rescue_vs_health's input: a
        key here past the grace window must be open, parked or rescued)."""
        with self._lock:
            return {k: dict(st) for k, st in self._degraded.items()}

    def pending_state(self) -> Dict[GangKey, dict]:
        with self._lock:
            return {k: dict(st) for k, st in self._pending.items()}

    def tracked(self, key: GangKey) -> bool:
        """Is this degraded gang accounted for: an open round, a parked
        episode or a just-completed rescue?"""
        with self._lock:
            return key in self._open or key in self._pending or key in self._rescued_at

    # -- the round ---------------------------------------------------------

    def maybe_rescue(self, key: GangKey, gv, priority: int, topos_fn: Callable[[], list],
                     gangs: Optional[Dict[GangKey, object]] = None
                     ) -> Optional[Dict[str, int]]:
        """One rescue evaluation of a fully released gang. Returns the
        consumed node -> cards map the round fenced (the tick debits its
        pool), or None (healthy, grace counting, parked, eviction refused).
        ``gangs`` follows maybe_preempt's contract: a full sweep passes its
        map, a dirty tick None, and the engine lists only once detection
        needs the cluster's view."""
        if key in self._open:
            return None
        bound = self._bound_chips(gv)
        if not bound:
            # Nothing placed is nothing on dead hardware; a stale episode
            # (the pods evicted or gone) ends.
            if key in self._degraded or key in self._pending:
                self.note_admitted(key)
            return None
        topos = topos_fn()
        by_host = {t.hostname: t for t in topos}
        degraded, gangs = self._degraded_hosts(bound, by_host, gangs)
        if not degraded:
            if key in self._degraded or key in self._pending:
                # Healed (card restored, node Ready, drain undone): the
                # episode ends without a rescue.
                self.note_admitted(key)
            return None
        gang_key = f"{key[0]}/{key[1]}"
        with self._lock:
            st = self._degraded.get(key)
            if st is None or set(st["hosts"]) != set(degraded):
                st = {"hosts": dict(degraded), "ticks": 0, "since": self._clock()}
                self._degraded[key] = st
            st["ticks"] += 1
            ticks, since = st["ticks"], st["since"]
        if ticks == 1:
            reasons = ", ".join(f"{h} ({r})" for h, r in sorted(degraded.items()))
            LEDGER.record("rescue", "degraded",
                          f"running gang {gang_key} is on degraded capacity: {reasons}; rescue "
                          f"after {self.grace_ticks} consecutive tick(s)",
                          gang=gang_key, hosts=sorted(degraded), tier=tier_label(priority))
            log.warning("rescue: gang %s degraded on %s (grace %d tick(s))", gang_key, reasons,
                        self.grace_ticks)
        if ticks < self.grace_ticks:
            # Count at resync cadence: a running gang waits on no capacity,
            # so nothing else would evaluate it sooner.
            self.admission.mark_dirty(key, source="rescue")
            return None
        if key in self.admission.reservations.active():
            # A fence already stands under this key (a recovered round, or a
            # rescue racing replacement churn): the release path finishes it.
            return None
        demands = gv.demands(self.admission.resource_name)
        if not [d for d in demands if d > 0]:
            return None
        # The target view: healthy placeable nodes only (not the degraded
        # ones, none with withdrawn cards), with the gang's own cards on
        # surviving nodes credited back.
        target = [t for t in topos
                  if t.hostname not in degraded and not getattr(t, "failed", None)
                  and self.placeable(t.hostname)]
        target_hosts = {t.hostname for t in target}
        own = {h: n for h, n in bound.items() if h in target_hosts}
        if own:
            target = credited_topos(target, own)
        from .gang import _CapacityPool  # deferred: gang imports preemption

        consumed = _CapacityPool(target).fits(demands)
        victims: List[Victim] = []
        if consumed is None:
            if gangs is None:
                gangs = self.admission._collect_gangs()
            cand = [v for v in self.planner.collect_victims(gangs, key, priority)
                    if any(h in target_hosts for h in v.hosts)]
            plan = self.planner.plan(key, demands, priority, target, cand)
            if plan is not None:
                pods = sum(len(v.pods) for v in plan.victims)
                if pods <= self.budget_remaining():
                    victims = plan.victims
                    consumed = plan.consumed
                else:
                    self._park(key, gang_key, priority, reason="budget_exhausted",
                               detail=(f"a victim plan exists but needs {pods} eviction(s) and "
                                       f"only {self.budget_remaining()} remain in the rolling "
                                       f"hour"))
            else:
                self._park(key, gang_key, priority, reason="no_target",
                           detail="no healthy fit and no strictly-lower-priority victim set "
                                  "frees one")
        if consumed is None:
            # RESCUE_PENDING: the demand goes to the defrag plane as stranded
            # demand; a repack that frees room completes this rescue.
            defrag = getattr(self.admission, "defrag", None)
            if defrag is not None:
                freed = defrag.maybe_defrag(key, gv, demands, target, priority, gangs=gangs)
                if freed is not None:
                    consumed = dict(freed)
            if consumed is None:
                self.admission.mark_dirty(key, source="rescue")
                return None
        if not tracing.enabled():
            out = self._execute(key, gang_key, gv, priority, demands, consumed, victims,
                                degraded, bound, since)
        else:
            with tracing.span("gang.rescue", service="extender", namespace=key[0],
                              gang=key[1], victims=len(victims),
                              hosts=",".join(sorted(degraded))):
                out = self._execute(key, gang_key, gv, priority, demands, consumed, victims,
                                    degraded, bound, since)
        defrag = getattr(self.admission, "defrag", None)
        if out is not None and defrag is not None:
            # Close a defrag round this rescue rode on (a no-op after a plain
            # fit or a victim plan).
            defrag.finish(key)
        return out

    def _park(self, key: GangKey, gang_key: str, priority: int, reason: str,
              detail: str) -> None:
        with self._lock:
            st = self._pending.get(key)
            if st is None:
                st = self._pending[key] = {"since": self._clock(), "reason": reason}
            st["reason"] = reason
        if key not in self._pending_reported:
            self._pending_reported.add(key)
            metrics.RESCUES.inc(outcome="pending", tier=tier_label(priority))
            LEDGER.record("rescue", "pending",
                          f"gang {gang_key} is degraded but unrescuable: {detail}; parked "
                          f"RESCUE_PENDING (its demand feeds the defrag plane, retried every "
                          f"resync)", gang=gang_key, cause=reason, tier=tier_label(priority))
            RECORDER.record("rescue", f"gang {gang_key} parked RESCUE_PENDING ({reason})",
                            namespace=key[0], gang=key[1], reason=reason)
            log.warning("rescue: gang %s parked RESCUE_PENDING (%s)", gang_key, detail)
            self._outcome("pending")

    def _execute(self, key: GangKey, gang_key: str, gv, priority: int, demands: List[int],
                 consumed: Dict[str, int], victims: List[Victim], degraded: Dict[str, str],
                 bound: Dict[str, int], since: float) -> Optional[Dict[str, int]]:
        journal = self.admission.journal
        payload = {"phase": "intent", "victims": [[v.key[0], v.key[1]] for v in victims],
                   "consumed": dict(consumed), "demands": sorted(int(d) for d in demands),
                   "priority": priority, "ts": self._clock()}
        # Phase 1: the intent is durable before anything irreversible.
        with self._lock:
            self._open[key] = payload
        if journal is not None:
            journal.record("rescue_intent", key, victims=payload["victims"],
                           consumed=dict(consumed), demands=payload["demands"],
                           priority=priority)
        # Phase 2a: the victims through the one door. Each executed eviction
        # spends the shared budget (a blocked round's partial victim too);
        # the degraded gang's own pods below spend nothing: evacuating the
        # casualty is the rescue, not blast radius.
        blocked = False
        spent: List[float] = []
        for rank, v in enumerate(victims):
            for p in v.pods:
                if not evict_gang_pod(self.admission.client, p.get("ns", "default"),
                                      p.get("name", "")):
                    blocked = True
                    break
                spent.append(self._clock())
                self._spend(spent[-1])
            if blocked:
                break
            LEDGER.record("rescue_victim", "evicted",
                          f"victim {rank + 1}/{len(victims)} evicted for the hardware rescue "
                          f"of {gang_key}: priority {v.priority}, restart cost "
                          f"{v.restart_cost():.1f}",
                          gang=f"{v.key[0]}/{v.key[1]}", requestor=gang_key, rank=rank + 1,
                          victim_tier=v.tier, victim_priority=v.priority, chips=v.total_chips)
            post_victim_event(
                self.admission.client, v, reason=VICTIM_EVENT_REASON,
                message=(f"gang {v.key[0]}/{v.key[1]} evicted to free a relocation target "
                         f"for gang {gang_key}, whose GPU hardware failed"))
        if spent and journal is not None:
            # The shared budget's spend survives a restart through the op
            # defrag uses: the replay folds both planes' stamps into one
            # window.
            journal.record("defrag_spend", key, stamps=list(spent))
        # Phase 2b: the degraded gang's own pods, every live member: its
        # controller recreates them gated, to release against the fence.
        if not blocked:
            for p in getattr(gv, "live", None) or []:
                meta = p.get("metadata") or {}
                if not evict_gang_pod(self.admission.client, meta.get("namespace", key[0]),
                                      meta.get("name", "")):
                    blocked = True
                    break
        if blocked:
            with self._lock:
                self._open.pop(key, None)
            if journal is not None:
                journal.record("rescue_abort", key, reason="eviction_blocked")
            metrics.RESCUES.inc(outcome="eviction_blocked", tier=tier_label(priority))
            LEDGER.record("rescue", "eviction_blocked",
                          "an eviction was refused (PodDisruptionBudget, drift, or apiserver); "
                          "rescue aborted, re-planned next tick", gang=gang_key)
            self._outcome("eviction_blocked")
            return None
        payload = dict(payload, phase="evicted", ts=self._clock())
        with self._lock:
            self._open[key] = payload
        if journal is not None:
            journal.record("rescue_evicted", key, victims=payload["victims"],
                           consumed=dict(consumed), demands=payload["demands"],
                           priority=priority)
        # Phase 3: the healthy target fenced under the rescued gang's key
        # before any replacement exists. The reserve is journaled through the
        # table's observer, so a crash after this line restores the fence
        # from either record.
        self.admission.reservations.reserve(key, dict(consumed),
                                            demands=tuple(sorted(int(d) for d in demands)),
                                            priority=priority)
        with self._lock:
            self._open.pop(key, None)
            for h in degraded:
                self._tick_evacuated[h] = self._tick_evacuated.get(h, 0) + bound.get(h, 0)
            self._rescued_at[key] = self._clock()
        if journal is not None:
            journal.record("rescue_done", key)
        self.note_admitted(key)
        latency = max(0.0, self._clock() - since)
        metrics.RESCUES.inc(outcome="executed", tier=tier_label(priority))
        metrics.RESCUE_LATENCY.observe(latency)
        reasons = ",".join(f"{h}:{r}" for h, r in sorted(degraded.items()))
        victims_s = ",".join(f"{v.key[0]}/{v.key[1]}" for v in victims)
        RECORDER.record("rescue",
                        f"gang {gang_key} evacuated off degraded capacity ({reasons}) and "
                        f"re-fenced on {sorted(consumed)}",
                        namespace=key[0], gang=key[1], hosts=reasons, victims=victims_s,
                        fenced_chips=sum(consumed.values()), latency_s=round(latency, 3))
        LEDGER.record("rescue", "executed",
                      f"evacuated gang {gang_key} off {sorted(degraded)} ({reasons}) and fenced "
                      f"{dict(consumed)} for its re-admission"
                      + (f"; evicted {victims_s} to make room" if victims else ""),
                      gang=gang_key, hosts=sorted(degraded), consumed=dict(consumed),
                      victims=victims_s, victim_count=len(victims), tier=tier_label(priority),
                      latency_s=round(latency, 3))
        log.warning("rescue: gang %s evacuated off %s; fenced %s (victims: %s; %.1fs after "
                    "detection)", gang_key, reasons, dict(consumed), victims_s or "none",
                    latency)
        self._outcome("executed")
        # Wake the gang as soon as its replacements appear (pod events do
        # this too; the mark covers a controller recreating them between
        # watch windows).
        self.admission.mark_dirty(key, source="rescue")
        return dict(consumed)

    def close(self) -> None:
        """Leave /debug/rescue: the owning admitter's stop() calls it. The
        node tracker is shared by the process's admitters, so its series
        outlive any one engine."""
        uninstall(self)

    def snapshot(self) -> dict:
        """This engine's /debug/rescue payload."""
        now = self._clock()
        with self._lock:
            degraded = [{"gang": f"{k[0]}/{k[1]}", "hosts": dict(st["hosts"]),
                         "ticks": st["ticks"], "grace_ticks": self.grace_ticks,
                         "degraded_for_s": round(max(0.0, now - st["since"]), 1)}
                        for k, st in sorted(self._degraded.items())]
            pending = [{"gang": f"{k[0]}/{k[1]}", "reason": st["reason"],
                        "pending_for_s": round(max(0.0, now - st["since"]), 1)}
                       for k, st in sorted(self._pending.items())]
            open_rounds = [{"gang": f"{k[0]}/{k[1]}", "phase": p.get("phase"),
                            "consumed": dict(p.get("consumed") or {})}
                           for k, p in sorted(self._open.items())]
        return {
            "shard": getattr(self.admission, "shard_id", None),
            "grace_ticks": self.grace_ticks,
            "budget": {"shared_with_defrag": getattr(self.admission, "defrag", None) is not None,
                       "remaining": self.budget_remaining(), "window_s": BUDGET_WINDOW_S},
            "nodes": self.tracker.snapshot() if self.tracker is not None else [],
            "degraded": degraded,
            "rescue_pending": pending,
            "open_rounds": open_rounds,
            "last_outcome": self.last_outcome,
            "last_outcome_ts": round(self.last_outcome_ts, 3),
        }


# -- drain -------------------------------------------------------------------


class DrainCoordinator:
    """The server half of the drain verb (POST /drain, driven by
    ``tpu-doctor drain``): the cordon and the ``maintenance=drain`` taint,
    kept in the API server so a restarted extender resumes the evacuation
    from the cluster's state with no drain journal; then the rescue plane
    evacuates every resident gang through its ordinary rounds, and the node
    is stamped drain-complete once no resident gang pod and no reserved card
    remain. Every call is idempotent: the doctor polls by POSTing again."""

    def __init__(self, client, admission, tracker: NodeStateTracker):
        self.client = client
        self.admission = admission
        self.tracker = tracker
        # Nodes whose drain-complete stamp this process already wrote (once
        # a drain, not once a poll).
        self._completed: Set[str] = set()

    def drain(self, node: str) -> dict:
        if not self.tracker.draining(node):
            self.client.set_node_unschedulable(node, True)
            self.client.set_node_taint(node, constants.MAINTENANCE_TAINT,
                                       value=constants.DRAIN_TAINT_VALUE, effect="NoSchedule")
            # Feed the tracker now: the watch confirms later, but the very
            # next tick must already refuse placement and evacuate.
            self.tracker.update_node(self.client.get_node(node))
            self.admission.mark_all_dirty()
            self._completed.discard(node)
            LEDGER.record("drain", "started",
                          f"node {node} cordoned and tainted {constants.MAINTENANCE_TAINT}="
                          f"{constants.DRAIN_TAINT_VALUE}; resident gangs will be rescued off "
                          f"it", node=node)
            RECORDER.record("drain", f"drain started for node {node}", node=node)
            log.warning("drain: node %s cordoned for evacuation", node)
        return self.status(node)

    def uncordon(self, node: str) -> dict:
        self.client.set_node_unschedulable(node, False)
        self.client.set_node_taint(node, constants.MAINTENANCE_TAINT, remove=True)
        self.client.patch_node_annotations(node, {constants.DRAIN_COMPLETE_ANNOTATION: None})
        self.tracker.update_node(self.client.get_node(node))
        self.admission.mark_all_dirty()
        self._completed.discard(node)
        LEDGER.record("drain", "uncordoned",
                      f"node {node} uncordoned: taint and cordon removed, placement may use it "
                      f"again", node=node)
        log.warning("drain: node %s uncordoned", node)
        return self.status(node)

    def status(self, node: str) -> dict:
        from .gang import pod_gang  # deferred: gang imports preemption

        residents: Set[GangKey] = set()
        pods = 0
        for p in self.client.list_pods(label_selector=constants.GANG_NAME_LABEL).get("items", []):
            if (p.get("metadata") or {}).get("deletionTimestamp"):
                continue
            if (p.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
                continue
            if (p.get("spec") or {}).get("nodeName") != node:
                continue
            info = pod_gang(p)
            if info is None:
                continue
            residents.add((info[0], info[1]))
            pods += 1
        held = sum(r.hosts.get(node, 0) for r in self.admission.reservations.active().values())
        draining = self.tracker.draining(node)
        done = draining and not residents and held == 0
        if done and node not in self._completed:
            self._completed.add(node)
            self.client.patch_node_annotations(
                node, {constants.DRAIN_COMPLETE_ANNOTATION: str(int(time.time()))})
            LEDGER.record("drain", "complete",
                          f"node {node} drained: zero resident gang pods, zero reserved chips; "
                          f"annotated {constants.DRAIN_COMPLETE_ANNOTATION}", node=node)
            RECORDER.record("drain", f"drain complete for node {node}", node=node)
            log.warning("drain: node %s is clear", node)
        return {"node": node, "draining": draining,
                "resident_gangs": sorted(f"{ns}/{name}" for ns, name in residents),
                "resident_pods": pods, "held_chips": held, "done": done}


# -- /debug/rescue -----------------------------------------------------------

# The engines the entry point installed, one per admitter (the singleton or
# each shard's): metrics.debug_payload serves /debug/rescue from here, and
# tpu-doctor's bundle collects it through DEBUG_ENDPOINTS.
_ENGINES: List[RescueEngine] = []


def install(engine: RescueEngine) -> None:
    if engine not in _ENGINES:
        _ENGINES.append(engine)


def uninstall(engine: RescueEngine) -> None:
    if engine in _ENGINES:
        _ENGINES.remove(engine)


def debug_snapshot() -> dict:
    if not _ENGINES:
        return {"enabled": False,
                "note": "hardware rescue not wired in this process (extender "
                        "--gang-admission without --no-rescue installs it)"}
    return {"enabled": True, "engines": [e.snapshot() for e in _ENGINES]}


# -- self-test and CLI -------------------------------------------------------


def self_test() -> int:
    """The rescue end to end on two full 4-card HGX nodes: gang ``train``
    running on every card of n1, a batch gang that saved recently filling
    n2, a same-tier gang gated with nowhere to go; then a card of n1 is
    withdrawn under train. One round evacuates train, evicts the strictly
    lower batch gang off n2 and fences n2 under train's key, and train's
    recreated gated members release against that fence on the next tick
    while the same-tier gang keeps waiting (re-admission at the head of the
    tier), through the real GangAdmission and journal against a client
    defined here. Prints a one-line JSON verdict."""
    import dataclasses
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
            pass

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

    d = tempfile.mkdtemp(prefix="gpu-rescue-selftest-")
    try:
        client = FakeClient()
        base = {n: hgx_topology(n, 4, available=[]) for n in ("n1", "n2")}
        # A full cluster; the cells let the withdrawal below reach every
        # later tick.
        failed: Dict[str, List[str]] = {"n1": [], "n2": []}
        full = {"n1": True, "n2": True}

        def topos():
            return [dataclasses.replace(
                base[n], failed=list(failed[n]),
                available=[] if full[n] else [c.id for c in base[n].chips
                                              if c.id not in failed[n]])
                for n in ("n1", "n2")]

        now = time.time()
        for w in range(2):
            p = pod("train", f"train-w{w}", 2, 2, gated=False, node="n1", priority=0)
            client.pods[("default", p["metadata"]["name"])] = p
        for w in range(2):
            p = pod("batch", f"batch-w{w}", 2, 2, gated=False, node="n2", priority=-10,
                    ckpt=now - 5)
            client.pods[("default", p["metadata"]["name"])] = p
        # The same-tier waiter: "queued" sorts before "train" by key, so its
        # staying gated shows the fence outranks the queue.
        client.pods[("default", "queued-w0")] = pod("queued", "queued-w0", 4, 1, gated=True,
                                                    priority=0)
        table = ReservationTable()
        adm = GangAdmission(client, reservations=table, journal=AdmissionJournal(d),
                            topo_source=topos)
        resolver = PriorityResolver()
        adm.priority_resolver = resolver
        engine = RescueEngine(adm, resolver, grace_ticks=1)
        adm.rescue = engine

        # A healthy tick moves nothing (the cluster is full but fine).
        assert adm.tick() == []
        assert not client.evicted, client.evicted

        # The failure: a card of n1 withdrawn under train.
        failed["n1"] = [base["n1"].chips[0].id]
        released = adm.tick()
        assert released == [], released  # the evacuation tick releases none
        evicted_gangs = {n.rsplit("-w", 1)[0] for _, n in client.evicted}
        assert evicted_gangs == {"train", "batch"}, evicted_gangs
        hold = table.active()[("default", "train")]
        assert hold.hosts == {"n2": 4}, hold.hosts
        assert not engine.open_intents()
        assert engine.last_outcome == "executed", engine.last_outcome
        # n2's cards freed (batch gone); n1 keeps its dead card listed.
        full["n1"] = full["n2"] = False

        # The controller recreates train's members, gated.
        for w in range(2):
            p = pod("train", f"train-r{w}", 2, 2, gated=True, priority=0)
            client.pods[("default", p["metadata"]["name"])] = p
        released = adm.tick()
        # Head of tier: train releases against its fence; the waiter stays
        # gated (n2 is fenced, n1's healthy three cards cannot hold 4).
        assert released == [("default", "train")], released
        assert client.pods[("default", "queued-w0")]["spec"]["schedulingGates"], \
            "the waiter must stay gated"
        for w in range(2):
            gates = client.pods[("default", f"train-r{w}")]["spec"]["schedulingGates"]
            assert gates == [], gates
        adm.journal.close()
        print(json.dumps({"rescue_self_test": "ok", "evacuated": sorted(evicted_gangs),
                          "fenced": dict(hold.hosts), "waiter_still_gated": True,
                          "budget_remaining": engine.budget_remaining()}))
        return 0
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _fetch(url: str) -> dict:
    import json
    import urllib.request

    with urllib.request.urlopen(f"{url.rstrip('/')}/debug/rescue", timeout=10) as resp:
        return json.loads(resp.read())


def _render_status(doc: dict) -> List[str]:
    if not doc.get("enabled"):
        return [f"rescue: not wired ({doc.get('note', '')})"]
    out = []
    for eng in doc.get("engines", []):
        shard = eng.get("shard")
        head = "rescue" + (f" [shard {shard}]" if shard is not None else "")
        budget = eng.get("budget") or {}
        out.append(f"{head}: budget {budget.get('remaining', '?')} eviction(s) left this hour"
                   + (" (shared with defrag)" if budget.get("shared_with_defrag") else "")
                   + f", last outcome {eng.get('last_outcome') or '(none)'}")
        for n in eng.get("nodes") or []:
            if not n.get("placeable"):
                out.append(f"  node {n['node']}: excluded ("
                           + ", ".join(k for k in ("unschedulable", "maintenance", "draining")
                                       if n.get(k))
                           + ("" if n.get("ready") else ", NotReady")
                           + f") for {n['state_for_s']}s")
        for g in eng.get("degraded") or []:
            out.append(f"  degraded: {g['gang']} on {sorted(g['hosts'])} "
                       f"({g['ticks']}/{g['grace_ticks']} ticks, {g['degraded_for_s']}s)")
        for g in eng.get("rescue_pending") or []:
            out.append(f"  RESCUE_PENDING: {g['gang']} ({g['reason']}, {g['pending_for_s']}s)")
        for r in eng.get("open_rounds") or []:
            out.append(f"  open round: {r['gang']} phase {r['phase']}")
        if not (eng.get("degraded") or eng.get("rescue_pending") or eng.get("open_rounds")):
            out.append("  no degraded gangs")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="tpu-rescue",
        description="Hardware-failure rescue plane: node lifecycle state, degraded gangs, "
        "RESCUE_PENDING parkings, and budget state, read from a live extender's "
        "/debug/rescue surface.")
    p.add_argument("command", nargs="?", choices=("status",),
                   help="status: node lifecycle + degraded gangs + open rounds")
    p.add_argument("--url", default="", help="extender base URL, e.g. http://extender:12346")
    p.add_argument("--self-test", "--rescue-self-test", dest="self_test", action="store_true",
                   help="run the card-failure-under-a-running-gang evacuation smoke on a full "
                   "two-node cluster and print a one-line JSON verdict")
    a = p.parse_args(argv)
    if a.self_test:
        return self_test()
    if not a.command:
        p.print_help()
        return 2
    if not a.url:
        p.error("--url is required for status")
    try:
        doc = _fetch(a.url)
    except (OSError, ValueError) as e:
        print(f"tpu-rescue: {e}", file=sys.stderr)
        return 1
    print("\n".join(_render_status(doc)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
