"""Gang admission: the JAX package's ``extender/gang.py``, the all-or-nothing
release of GPU pod gangs through scheduling gates.

The extender (``server.py``) filters and scores nodes one scheduling cycle at
a time, which cannot make N pods admit together. This controller does, on
the kube primitive for it:

* A GPU pod asks for at most one node's cards; a job over several nodes is a
  gang of per-node pods. Workloads create every pod of a gang with the
  scheduling gate ``tpu.google.com/gang`` and the labels
  ``tpu.google.com/gang-name`` (the shared identity) and
  ``tpu.google.com/gang-size`` (the pod count), the JAX extender's keys.
  Gated pods are invisible to the scheduler: nothing is partially placed.
* The controller watches gang-labeled pods. Once all ``size`` members exist
  it tests the gang's demand against the ``nvidia.com/gpu-topology``
  annotations the node daemons publish: each member must fit on some node's
  free cards (a GPU node has no multi-host slice, so there is no host
  sub-box to find).
* Only when the whole gang fits are the gates removed, gang-wide, in one
  pass; the default scheduler and the extender then place the pods. A gang
  that does not fit stays gated and is evaluated again on the next tick, or
  sooner when a node's annotation changes (the index's ``on_change``).

Before any gate comes off, the node -> card counts the test consumed are
recorded in the ``ReservationTable`` this process shares with the
``TopologyExtender``, whose /filter withholds them from every other pod
until the gang's members bind (``reservations.py``): the fence that makes
the release stick. With ``--journal-dir`` every transition goes to the
write-ahead journal (``journal.py``) first, and ``recover`` rebuilds the
state after a crash.

The capacity test is the JAX count test: best-fit over nodes bucketed by
free-card count. On the chosen node the pool debits the very cards
``GpuPlacementState.select`` picks, the set the extender's score and the
plugin's ``Allocate`` would take, so later gangs of the same tick see the
cards that will really be gone.

The priority, preemption, defrag and rescue planes of the JAX admitter hook
in through ``priority_resolver``, ``preemption``, ``defrag`` and ``rescue``
(``preemption.py``, ``defrag.py``, ``rescue.py``); the entry point wires all
four, and a None keeps its plane off. Sharded admission
(``sharding.py``) builds one admitter per owned shard with ``shard_id``,
``gang_filter`` and ``topo_filter``: it then sees only its shard's gangs and
places them only on its shard's nodes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import constants
from ..kube.client import KubeClient, KubeError
from ..topology.placement import GpuPlacementState
from ..topology.schema import NodeTopology, parse_topology_cached
from ..utils import metrics, profiling, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from ..utils.podresources import gpu_request
from .journal import AdmissionJournal, Hold
from .preemption import TIER_STANDARD, tier_label
from .reservations import DEFAULT_TABLE, ReservationTable

log = get_logger(__name__)

GATE_NAME = "tpu.google.com/gang"
GANG_NAME_LABEL = constants.GANG_NAME_LABEL
GANG_SIZE_LABEL = "tpu.google.com/gang-size"

GangKey = Tuple[str, str]


def is_gated(pod: dict) -> bool:
    gates = (pod.get("spec") or {}).get("schedulingGates") or []
    return any(g.get("name") == GATE_NAME for g in gates)


def pod_gang(pod: dict) -> Optional[Tuple[str, str, int]]:
    """(namespace, gang_name, size) when the pod carries the gang labels,
    gated or not: released members keep counting toward the gang's
    completeness, or a release that failed halfway could never be finished.
    A malformed size disqualifies the pod (logged)."""
    meta = pod.get("metadata") or {}
    labels = meta.get("labels") or {}
    name = labels.get(GANG_NAME_LABEL)
    raw_size = labels.get(GANG_SIZE_LABEL)
    if not name or raw_size is None:
        return None
    try:
        size = int(raw_size)
    except ValueError:
        log.warning(
            "pod %s/%s: bad %s=%r",
            meta.get("namespace", "default"), meta.get("name"),
            GANG_SIZE_LABEL, raw_size,
        )
        return None
    if size <= 0:
        return None
    return (meta.get("namespace", "default"), name, size)


def multi_node_reason(n: int, topo: NodeTopology) -> Tuple[str, str]:
    """(token, message) for a request of more cards than the node has: the
    JAX ``_multi_host_reason`` chain without its slice steps. A GPU node has
    no multi-node NVLink domain, so a node that passes the first two checks
    has no peers. /filter and the gang shortfall both read it; the tokens
    are the decision ledger's bounded labels."""
    if n % topo.chip_count != 0:
        return ("not_chip_multiple",
                f"multi-node request of {n} not a multiple of node size {topo.chip_count}")
    if len(topo.available) < topo.chip_count:
        return ("host_not_whole_free", "a request over several nodes needs the full node free")
    return ("no_slice_peers",
            "node has no multi-node NVLink domain; a job over several nodes "
            "is a gang of per-node pods")


# The chain's order: the shortfall names the furthest step any node reached.
_MULTI_NODE_ORDER = ("not_chip_multiple", "host_not_whole_free", "no_slice_peers")


@dataclasses.dataclass
class GangView:
    """One gang's membership as one pass found it.

    ``live`` are pods the scheduler can still act on; ``standins`` are
    finished (Succeeded/Failed) pods topping the membership up to the
    declared size until replacements exist. A stand-in's stale nodeName
    holds no cards, so stand-ins never count as placed."""

    size: int
    live: List[dict]
    standins: List[dict]

    @property
    def members(self) -> List[dict]:
        return self.live + self.standins

    @property
    def gated(self) -> List[dict]:
        return [p for p in self.live if is_gated(p)]

    @property
    def ungated_live(self) -> List[dict]:
        return [p for p in self.live if not is_gated(p)]

    def demands(self, resource_name: str) -> List[int]:
        """Card demands of the whole-gang test: live members plus Failed
        stand-ins (their replacements are coming). A Succeeded stand-in's
        work is done and no replacement comes, so it asks nothing."""
        out = [gpu_request(p, resource_name) for p in self.live]
        out += [
            gpu_request(p, resource_name)
            for p in self.standins
            if (p.get("status") or {}).get("phase") == "Failed"
        ]
        return out


class _CapacityPool:
    """One tick's consumable capacity over the published topologies.

    Built once a tick, it keeps nodes bucketed by free-card count, so a
    placement is a bucket probe, not a scan. Placements are transactional:
    ``fits`` rolls back a gang that cannot wholly place, which lets one pool
    carry the consumption across every gang of a tick. The input topologies
    are never mutated: consumption lives in ``avail``, whose lists are
    replaced."""

    def __init__(self, topos: List[NodeTopology]):
        self.topos = list(topos)
        self.by_host: Dict[str, NodeTopology] = {t.hostname: t for t in self.topos}
        self.avail: Dict[str, List[str]] = {t.hostname: t.available for t in self.topos}
        self.chip_count: Dict[str, int] = {t.hostname: t.chip_count for t in self.topos}
        self.max_chip_count = max((t.chip_count for t in self.topos), default=0)
        # free-card count -> hosts, in topos order (the order the JAX
        # first-minimal scan picked in).
        self._by_len: Dict[int, Dict[str, None]] = {}
        for t in self.topos:
            self._by_len.setdefault(len(t.available), {})[t.hostname] = None
        self._max_len = max(self._by_len, default=0)
        # A node's placement state, built on its first placement this tick.
        self._states: Dict[str, GpuPlacementState] = {}
        self._undo: Optional[List[Tuple[str, List[str]]]] = None
        # Why the last failed fits() failed: the gang_waiting record's
        # shortfall. None after a success.
        self.last_reject: Optional[Dict] = None

    def current_topos(self) -> List[NodeTopology]:
        """Clones carrying the pool's current (post-consumption)
        availability: what a later plane's what-if fits run over."""
        return [
            t if self.avail[t.hostname] is t.available
            else dataclasses.replace(t, available=list(self.avail[t.hostname]))
            for t in self.topos
        ]

    def debit(self, host_chips: Dict[str, int]) -> None:
        """Consume ``host_chips`` from the pool (what it can still see of
        them), so later gangs of the tick do not use cards another plane's
        fresh reservation claimed."""
        for h, n in host_chips.items():
            cur = self.avail.get(h)
            if cur is None or n <= 0:
                continue
            self._take(h, min(n, len(cur)))

    def _take(self, host: str, n: int) -> None:
        """Debit the n cards ``select`` picks among the node's free cards:
        the set the extender's score and the plugin's Allocate would take."""
        cur = self.avail[host]
        state = self._states.get(host)
        if state is None:
            state = self._states[host] = GpuPlacementState(self.by_host[host].to_topology())
        picked = set(state.select(n, available=cur))
        if len(picked) != n:
            # An annotation whose free ids the topology does not list: the
            # count still debits.
            picked = set(cur[:n])
        self._set_avail(host, [i for i in cur if i not in picked])

    def _set_avail(self, host: str, new: List[str]) -> None:
        old = self.avail[host]
        if self._undo is not None:
            self._undo.append((host, old))
        self._move_bucket(host, len(old), len(new))
        self.avail[host] = new

    def _move_bucket(self, host: str, old_len: int, new_len: int) -> None:
        bucket = self._by_len.get(old_len)
        if bucket is not None:
            bucket.pop(host, None)
            if not bucket:
                del self._by_len[old_len]
        self._by_len.setdefault(new_len, {})[host] = None

    def _place_single(self, n: int) -> Optional[str]:
        """Best fit: the tightest node whose free cards and card count both
        cover n, which keeps roomier nodes for bigger members."""
        for length in range(n, self._max_len + 1):
            host = next((h for h in self._by_len.get(length, ()) if self.chip_count[h] >= n),
                        None)
            if host is not None:
                self._take(host, n)
                return host
        return None

    def fits(self, demands: List[int]) -> Optional[Dict[str, int]]:
        """Whole-gang feasibility: each member on some node's free cards.
        On success the consumption stays in the pool (later gangs of the
        tick see it) and node -> cards is returned for the reservation; on
        failure every placement of this call is rolled back. Conservative:
        a gang not placed here cannot fit."""
        self._undo = []
        self.last_reject = None
        consumed: Dict[str, int] = {}
        for n in sorted((d for d in demands if d > 0), reverse=True):
            host = self._place_single(n)
            if host is None:
                # Diagnose the current state (this gang's earlier
                # placements are part of why n is blocked), then roll back.
                self.last_reject = self._diagnose(n)
                for h, old in reversed(self._undo):
                    self._move_bucket(h, len(self.avail[h]), len(old))
                    self.avail[h] = old
                self._undo = None
                return None
            consumed[host] = consumed.get(host, 0) + n
        self._undo = None
        return consumed

    def _diagnose(self, n: int) -> Dict:
        """Why demand ``n`` could not place, for the decision ledger and the
        pending-gang Event: the best node's free cards when some node is big
        enough, else the furthest step of /filter's multi-node chain any
        node reaches, with its token and message."""
        if n <= self.max_chip_count:
            best_free = max((len(self.avail[h]) for h in self.avail if self.chip_count[h] >= n),
                            default=0)
            return {
                "demand": n,
                "blocking": "single_host",
                "best_free_chips": best_free,
                "shortfall_chips": n - best_free,
            }
        best: Optional[Tuple[str, str]] = None
        for t in self.topos:
            if t.chip_count <= 0:
                continue
            cur = self.avail[t.hostname]
            view = t if cur is t.available else dataclasses.replace(t, available=cur)
            reason = multi_node_reason(n, view)
            if best is None or _MULTI_NODE_ORDER.index(reason[0]) > _MULTI_NODE_ORDER.index(
                    best[0]):
                best = reason
        if best is None:
            return {"demand": n, "blocking": "no_matching_slice"}
        return {"demand": n, "blocking": best[0], "detail": best[1],
                "max_node_cards": self.max_chip_count}


class GangAdmission:
    """The scheduling-gate lifter for GPU pod gangs."""

    def __init__(
        self,
        client: KubeClient,
        resource_name: str = constants.RESOURCE_NAME,
        resync_interval_s: float = 5.0,
        reservations: Optional[ReservationTable] = None,
        full_sweep_interval_s: float = 60.0,
        topo_source: Optional[Callable[[], List[NodeTopology]]] = None,
        watch: bool = False,
        pending_event_threshold_s: float = 300.0,
        pending_event_repost_s: float = 600.0,
        pending_event_budget: int = 10,
        journal: Optional[AdmissionJournal] = None,
        gang_filter: Optional[Callable[[GangKey], bool]] = None,
        topo_filter: Optional[Callable[[NodeTopology], bool]] = None,
        shard_id: Optional[int] = None,
    ):
        self.client = client
        self.resource_name = resource_name
        self.resync_interval_s = resync_interval_s
        # Sharded admission (sharding.py): this admitter owns one shard of
        # the consistent-hash ring. ``gang_filter`` keeps every pass (ticks,
        # the recovery's reconcile, explain, the audit) to the shard's
        # gangs; ``topo_filter`` keeps the capacity view to the shard's
        # nodes, so no two shards ever reserve cards of one node. None (the
        # default) is the unsharded admitter.
        self.gang_filter = gang_filter
        self.topo_filter = topo_filter
        self.shard_id = shard_id
        # The level-triggered backstop: the loop sweeps every gang at least
        # this often; the ticks in between are dirty ticks over the gangs
        # events marked plus the gangs holding reservations.
        self.full_sweep_interval_s = max(full_sweep_interval_s, resync_interval_s)
        # The capacity view's source: a node relist by default; the entry
        # point wires the node cache's index (parsed clones, no HTTP).
        self.topo_source = topo_source
        # Watch gang-labeled pods and mark only their gangs dirty.
        self.watch = watch
        # Shared with the TopologyExtender of this process: what tick()
        # reserves here, /filter enforces.
        self.reservations = DEFAULT_TABLE if reservations is None else reservations
        # The write-ahead journal: every reservation transition (through the
        # table's observer) and the admit and wait records written here.
        # None keeps the state in memory only.
        self.journal = journal
        if journal is not None:
            self.reservations.observer = journal.observe
        # Holds are renewed once a tick, so they must outlive several ticks,
        # and the age cap scales with the TTL.
        self.reservations.ttl_s = max(self.reservations.ttl_s, 4 * resync_interval_s)
        self.reservations.max_age_s = max(self.reservations.max_age_s,
                                          2 * self.reservations.ttl_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch_thread: Optional[threading.Thread] = None
        # The last listed topologies, served when a relist fails: a gang
        # released against a slightly stale view just Pends (its hold still
        # fences it); it can never double-admit.
        self._last_topos: List[NodeTopology] = []
        # Gang -> the demands last reported as capacity-waiting: one record
        # per waiting-state change, pruned when the wait ends.
        self._waiting_reported: Dict[GangKey, tuple] = {}
        # The first capacity evaluation of each complete, fully gated gang
        # (monotonic): the tpu_gang_time_to_admit_seconds origin.
        self._first_complete: Dict[GangKey, float] = {}
        # Wall-clock start of each gang's capacity wait, and when its last
        # pending-gang Event was posted.
        self._waiting_since: Dict[GangKey, float] = {}
        self._pending_evented: Dict[GangKey, float] = {}
        # Gangs whose waiting episode already has its slo_breach records:
        # the Event post retries every tick on failure, the records not.
        self._breach_recorded: Set[GangKey] = set()
        # Past this many seconds capacity-waiting, a Warning Event on each
        # gated member, re-posted every repost interval, budgeted per tick.
        # 0 disables.
        self.pending_event_threshold_s = pending_event_threshold_s
        self.pending_event_repost_s = pending_event_repost_s
        self.pending_event_budget = pending_event_budget
        self._event_budget_left = pending_event_budget
        self._lapsed_reported = 0  # the table's lapses already counted
        # Gangs whose hold hit the age cap: never re-fenced (a re-fence
        # would reset the age and make the cap no cap).
        self._lapsed_gangs: Set[GangKey] = set()
        # -- dirty-gang state, under _dirty_lock --------------------------
        self._dirty_lock = threading.Lock()
        self._dirty: Set[GangKey] = set()
        # Complete gangs gated for lack of capacity: the tpu_gang_waiting
        # gauge's truth, and the gangs a node event wakes. A GPU gang's
        # members each fit on one node, so any node's change may unblock
        # any waiting gang (the JAX index's ANY_NODE dependency).
        self._waiting_gangs: Set[GangKey] = set()
        # With the rescue plane wired: node -> the released gangs with a pod
        # bound there, as the last ticks saw them (a full sweep rebuilds it),
        # so a node's changed annotation (a card withdrawn) wakes the running
        # gangs on it at the next resync, not at the full-sweep backstop.
        self._bound_on: Dict[str, Set[GangKey]] = {}
        self._last_full_sweep = float("-inf")  # the loop's first tick is full
        # The extender's AuditEngine, wired by the entry point and driven
        # from _loop after each tick: this thread is the journal's one
        # writer, so the replay check never races an append.
        self.auditor = None
        # The planes on the admitter, wired by the entry point: a priority
        # resolver (priority-ordered queue), preemption (preemption.py),
        # defragmentation (defrag.py) and rescue (rescue.py). None keeps the
        # FIFO admitter, bit for bit.
        self.priority_resolver = None
        self.preemption = None
        self.defrag = None
        self.rescue = None
        # Optional utils/resilience.DegradedMode: while paused (breaker open
        # past the staleness cap) the loop skips whole ticks.
        self.degraded = None
        # Gang -> (numeric priority, tier), refreshed per evaluation.
        self._gang_priority: Dict[GangKey, int] = {}
        self._gang_tier: Dict[GangKey, str] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        # Supervised: an exception out of either loop is counted, flight-
        # recorded and trips the thread_liveness audit invariant.
        self._thread = threading.Thread(target=profiling.supervised("gang_tick", self._loop),
                                        name="gang-admission", daemon=True)
        self._thread.start()
        if self.watch:
            self._watch_thread = threading.Thread(
                target=profiling.supervised("gang_pod_watch", self._watch_loop),
                name="gang-pod-watch", daemon=True)
            self._watch_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watch_thread is not None:
            try:
                self.client.interrupt_watches()
            except Exception:  # noqa: BLE001 - best-effort unblock
                pass
            self._watch_thread.join(timeout=5)
            self._watch_thread = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for plane in (self.defrag, self.rescue):
            # After the tick thread joined, so no tick re-publishes what the
            # plane's close prunes.
            close = getattr(plane, "close", None)
            if close is not None:
                close()
        if self.journal is not None:
            # One clean snapshot, so the successor's replay is O(holds). The
            # callable captures the covered seq before the build.
            self.journal.compact(self._journal_state)
            self.journal.close()

    # -- crash recovery ----------------------------------------------------

    def _journal_state(self) -> dict:
        """The compaction snapshot: the live table's holds with their true
        ages, the lapse bars and the wait origins."""
        now = time.time()
        holds = {
            k: Hold(
                hosts=st["hosts"],
                demands=tuple(st["demands"]),
                counted_pods=set(st["counted"]),
                created_ts=now - st["age_s"],
                priority=int(st.get("priority", 0)),
            )
            for k, st in self.reservations.export_state().items()
        }

        def rounds(plane, method):
            return getattr(plane, method)() if plane is not None else None

        return AdmissionJournal.state_data(
            holds, set(self._lapsed_gangs), dict(self._waiting_since),
            preempting=rounds(self.preemption, "open_intents"),
            defragging=rounds(self.defrag, "open_intents"),
            defrag_spend=rounds(self.defrag, "spend_window"),
            rescuing=rounds(self.rescue, "open_intents"),
        )

    def _recover_rounds(
        self,
        rounds: Dict[GangKey, dict],
        gangs: Dict[GangKey, GangView],
        truth: bool,
        now: float,
        done_op: str,
        abort_op: str,
        evicted_survives_vanish: bool = False,
    ) -> Tuple[int, int]:
        """Close the open two-phase rounds of one eviction protocol
        (preempt_*, defrag_* or rescue_*, one record shape). Returns
        (refenced, aborted). An ``evicted`` phase whose reserve never landed
        re-installs its planned fence (``restore`` journals the reserve); an
        ``intent`` phase, or a fence that cannot be restored, aborts and the
        next tick plans again from the cluster's truth. A rescue's evicted
        phase has no live pods by design and still restores."""
        refenced = aborted = 0
        active_now = self.reservations.active() if rounds else {}
        for key, rec in sorted(rounds.items()):
            if truth and key not in gangs and not (
                    evicted_survives_vanish and rec.get("phase") == "evicted"):
                self.journal.record(abort_op, key, reason="gang_vanished")
                aborted += 1
                continue
            if key in active_now:
                # The reserve landed before the crash: the round is done and
                # the standing-hold release finishes the gates.
                self.journal.record(done_op, key)
                continue
            if rec.get("phase") == "evicted":
                hosts = {str(h): int(n) for h, n in (rec.get("consumed") or {}).items()}
                if hosts and self.reservations.restore(
                        key, hosts, age_s=max(0.0, now - float(rec.get("ts", now))),
                        demands=tuple(sorted(int(d) for d in rec.get("demands") or ())),
                        priority=int(rec.get("priority", 0))):
                    self.journal.record(done_op, key)
                    refenced += 1
                    self.mark_dirty(key, source="recovery")
                    continue
            self.journal.record(abort_op, key, reason="recovered")
            aborted += 1
            self.mark_dirty(key, source="recovery")
        return refenced, aborted

    def recover(self) -> dict:
        """The cold start's rehydration: replay the journal, reconcile it
        with the cluster's truth and install what survives, before start()
        and behind the /readyz ``replaying`` phase. Restored holds keep their
        original age (the cap survives the crash), lapse bars are restored
        so _maybe_refence never brings a lapsed hold back, and a gang killed
        between its reserve and its gate patches finishes through the first
        tick's release_retry and finish_partial_release paths. Never raises:
        without a journal, or with an unreadable one, it falls back to the
        rebuild from the cluster's truth."""
        if self.journal is None:
            return {"status": "disabled"}
        t0 = time.monotonic()
        state = self.journal.replay()
        now = time.time()
        # The cluster's truth, best-effort: an API-server outage at start
        # must not block recovery, and holds restore from the journal alone
        # (they fence cards the upkeep reconciles once the API answers).
        gangs: Dict[GangKey, GangView] = {}
        truth = False
        keys = (set(state.holds) | state.lapsed | set(state.waiting_since)
                | set(state.preempting) | set(state.defragging) | set(state.rescuing))
        try:
            if keys:
                gangs = self._collect_gangs(set(keys))
            truth = True
        except Exception as e:  # noqa: BLE001 - degrade, do not block
            log.warning("recovery could not list gang pods (%s); restoring the journal's "
                        "state without reconciling it with the cluster", e)
        restored = dropped = lapsed_now = 0
        for key, hold in sorted(state.holds.items()):
            if truth and key not in gangs:
                # The gang vanished while the extender was down.
                self.journal.record("drop", key)
                dropped += 1
                continue
            if not hold.hosts:
                # Fully consumed but not pruned when the snapshot was cut: a
                # plain drop, not a lapse (a bar would block the gang's
                # rightful re-fence).
                self.journal.record("drop", key)
                dropped += 1
                continue
            if not self.reservations.restore(key, hold.hosts, age_s=hold.age_s(now),
                                             demands=tuple(hold.demands),
                                             counted_pods=hold.counted_pods,
                                             priority=hold.priority):
                # Aged past the cap while the extender was down: it lapses
                # now, and stays lapsed.
                self._lapsed_gangs.add(key)
                self.journal.record("lapse", key)
                lapsed_now += 1
                continue
            restored += 1
            self.mark_dirty(key, source="recovery")
        # Lapse bars survive the crash as they were, less vanished gangs.
        self._lapsed_gangs |= {k for k in state.lapsed if not truth or k in gangs}
        preempt_refenced, preempt_aborted = self._recover_rounds(
            state.preempting, gangs, truth, now, "preempt_done", "preempt_abort")
        defrag_refenced, defrag_aborted = self._recover_rounds(
            state.defragging, gangs, truth, now, "defrag_done", "defrag_abort")
        rescue_refenced, rescue_aborted = self._recover_rounds(
            state.rescuing, gangs, truth, now, "rescue_done", "rescue_abort",
            evicted_survives_vanish=True)
        if self.rescue is not None and state.rescuing:
            # A restored rescue fence belongs to a gang whose pods were
            # evicted: the rescue plane shields it until replacements come.
            active_after = self.reservations.active()
            for key in state.rescuing:
                if key in active_after:
                    self.rescue.note_refenced(key)
        if state.defrag_spend:
            # The eviction budget's rolling window survives the crash.
            for plane in (self.defrag, self.rescue):
                if plane is not None:
                    plane.seed_spend(state.defrag_spend)
                    break
        # The SLO clock and the pending-Event threshold count from the wait's
        # true start.
        for key, since in state.waiting_since.items():
            if truth and key not in gangs:
                continue
            self._waiting_since.setdefault(key, since)
            self._first_complete.setdefault(key, time.monotonic() - max(0.0, now - since))
        # The first tick sweeps fully: what the journal missed, the
        # cluster's truth catches.
        self.mark_all_dirty()
        # A fresh snapshot of the reconciled state bounds the replay across
        # a crash loop.
        self.journal.compact(self._journal_state)
        took = round(time.monotonic() - t0, 3)
        summary = {
            "status": state.status,
            "records": state.records,
            "journal_dropped": state.dropped,
            "holds_restored": restored,
            "holds_dropped": dropped,
            "holds_lapsed_on_restore": lapsed_now,
            "lapse_bars": len(self._lapsed_gangs),
            "waits_restored": len(state.waiting_since),
            "preempt_refenced": preempt_refenced,
            "preempt_aborted": preempt_aborted,
            "defrag_refenced": defrag_refenced,
            "defrag_aborted": defrag_aborted,
            "rescue_refenced": rescue_refenced,
            "rescue_aborted": rescue_aborted,
            "cluster_truth": truth,
            "took_s": took,
        }
        RECORDER.record(
            "journal_replay",
            f"admission journal replayed: {state.records} record(s), {state.status}",
            **{k: v for k, v in summary.items() if k != "took_s"})
        RECORDER.record(
            "rehydrate",
            f"admission state rehydrated: {restored} hold(s) restored, {lapsed_now} lapsed "
            f"on restore, {len(self._lapsed_gangs)} lapse bar(s)",
            holds=restored, lapsed=lapsed_now, cluster_truth=truth)
        LEDGER.record("journal_replay", state.status,
                      f"replayed {state.records} journal record(s) in {took}s "
                      f"({state.dropped} dropped)",
                      records=state.records, dropped=state.dropped)
        LEDGER.record(
            "rehydrate", "ok" if truth else "no_cluster_truth",
            f"restored {restored} hold(s), {dropped} dropped for vanished gangs, "
            f"{lapsed_now} lapsed at the cap, {len(self._lapsed_gangs)} lapse bar(s) standing",
            **{k: v for k, v in summary.items() if k not in ("status", "took_s")})
        log.info("admission state recovered: %s", summary)
        return summary

    def _loop(self) -> None:
        # A loop frozen inside one tick stops beating, and gates stop coming
        # off: this heartbeat's silence is the outage.
        hb = profiling.HEARTBEATS.register("gang_tick", interval_s=self.resync_interval_s)
        while not self._stop.is_set():
            hb.beat()
            try:
                if self.degraded is not None and self.degraded.paused:
                    # Past the staleness cap: admission pauses, as the HTTP
                    # plane answers 503; the sweep after recovery is full.
                    log.warning("gang tick skipped: degraded serving paused (last-known-good "
                                "state %.0fs old, cap %.0fs)", self.degraded.staleness_s(),
                                self.degraded.staleness_cap_s)
                    self._stop.wait(self.resync_interval_s)
                    continue
                full = (time.monotonic() - self._last_full_sweep >= self.full_sweep_interval_s)
                self.tick(full=full)
            except Exception as e:  # noqa: BLE001 - admission must survive
                if self._stop.is_set():
                    return
                log.warning("gang admission tick failed: %s", e)
            auditor = self.auditor
            if auditor is not None:
                # Cadenced by the engine; runs after a failed tick too, when
                # drift matters most. Never raises.
                auditor.maybe_sweep()
            self._stop.wait(self.resync_interval_s)

    # -- the event plane (dirty marking) -----------------------------------

    def mark_dirty(self, key: GangKey, source: str = "manual") -> None:
        with self._dirty_lock:
            self._dirty.add(key)
        metrics.GANG_DIRTY_MARKS.inc(source=source)

    def mark_all_dirty(self) -> None:
        """Make the next tick a full sweep (after a watch gap, a recovery)."""
        self._last_full_sweep = float("-inf")

    def note_pod_event(self, pod: dict) -> None:
        """A gang-labeled pod appeared, changed or vanished: only its gang
        needs another evaluation."""
        info = pod_gang(pod)
        if info is None:
            return
        if self.gang_filter is not None and not self.gang_filter((info[0], info[1])):
            return  # another shard's gang: not this admitter's to wake
        with self._dirty_lock:
            self._dirty.add((info[0], info[1]))
        metrics.GANG_DIRTY_MARKS.inc(source="pod")

    def note_node_event(self, slice_keys: Tuple[Tuple[str, ...], ...] = (),
                        node: str = "") -> int:
        """A node's published availability changed: wake every capacity-
        waiting gang, since any node may now fit any of their members (GPU
        nodes have no slices, so ``slice_keys`` narrows nothing), and, with
        the rescue plane wired, the running gangs bound to ``node`` (its
        withdrawn cards are theirs to leave). Returns how many gangs were
        marked."""
        with self._dirty_lock:
            keys = set(self._waiting_gangs)
            if node and self.rescue is not None:
                keys |= self._bound_on.get(node, set())
            self._dirty |= keys
        if keys:
            metrics.GANG_DIRTY_MARKS.inc(len(keys), source="node")
        return len(keys)

    def _set_waiting(self, key: GangKey) -> None:
        with self._dirty_lock:
            self._waiting_gangs.add(key)

    def _clear_waiting(self, key: GangKey) -> None:
        with self._dirty_lock:
            self._waiting_gangs.discard(key)

    def _clear_wait_state(self, key: GangKey) -> None:
        """Drop every waiting and SLO marker of the gang (reported demands,
        wait origin, Event and breach dedup, time-to-admit origin) in one
        place: an exit path that forgot one would leak a stale SLO origin
        into a same-named successor."""
        self._waiting_reported.pop(key, None)
        if self._waiting_since.pop(key, None) is not None and self.journal is not None:
            self.journal.record("wait_clear", key)
        self._pending_evented.pop(key, None)
        self._breach_recorded.discard(key)
        self._first_complete.pop(key, None)
        for plane in (self.preemption, self.defrag):
            # The waiting episode ended: the plane's per-episode state goes.
            # Not the rescue plane's, which tracks running gangs.
            if plane is not None:
                plane.note_admitted(key)

    def _priority_of(self, key: GangKey, gv: GangView) -> int:
        """The gang's numeric priority: 0 without a resolver. Cached per
        gang for the metric labels; a resolver failure keeps the cached
        value."""
        if self.priority_resolver is None:
            return 0
        try:
            prio = self.priority_resolver.gang_priority(gv.live)
        except Exception:  # noqa: BLE001 - an ordering hint never blocks a tick
            prio = self._gang_priority.get(key, 0)
        self._gang_priority[key] = prio
        self._gang_tier[key] = tier_label(prio)
        return prio

    def _prune_priority(self, key: GangKey) -> None:
        self._gang_priority.pop(key, None)
        self._gang_tier.pop(key, None)

    def _publish_waiting(self) -> None:
        """The per-tier tpu_gang_waiting gauge: one series per tier with
        waiting gangs, emptied tiers pruned (absent, not frozen)."""
        with self._dirty_lock:
            waiting = list(self._waiting_gangs)
        counts: Dict[str, int] = {}
        for key in waiting:
            tier = self._gang_tier.get(key, TIER_STANDARD)
            counts[tier] = counts.get(tier, 0) + 1
        for labels, _ in metrics.GANG_WAITING.series():
            if labels.get("tier") not in counts:
                metrics.GANG_WAITING.remove(**labels)
        for tier, n in counts.items():
            metrics.GANG_WAITING.set(n, tier=tier)

    @staticmethod
    def _shortfall_text(diag: Dict) -> str:
        """One sentence for a pool diagnosis, shared by the log line, the
        gang_waiting record and the pending-gang Event."""
        if not diag:
            return "capacity shortfall unknown"
        if diag.get("blocking") == "single_host":
            return (f"blocking demand {diag['demand']}: best node has "
                    f"{diag['best_free_chips']} free card(s), short {diag['shortfall_chips']}")
        if "detail" in diag:
            return f"blocking demand {diag['demand']}: {diag['detail']}"
        return f"blocking demand {diag.get('demand')}: no node publishes GPU capacity"

    def _maybe_post_pending_event(self, key: GangKey, gv: GangView, demands: List[int],
                                  diag: Dict) -> None:
        """A long capacity wait in ``kubectl describe pod``: a Warning Event
        on each gated member once the gang has waited past
        ``pending_event_threshold_s``, through the client's resilience layer,
        once per waiting episode and again every ``pending_event_repost_s``,
        within a per-tick budget."""
        if self.pending_event_threshold_s <= 0:
            return
        now = time.time()
        since = self._waiting_since.get(key)
        if since is None or now - since < self.pending_event_threshold_s:
            return
        if now - self._pending_evented.get(key, 0.0) < self.pending_event_repost_s:
            return
        create = getattr(self.client, "create_event", None)
        if create is None:
            return
        if self._event_budget_left <= 0:
            metrics.GANG_PENDING_EVENTS.inc(outcome="suppressed")
            return
        waited = int(now - since)
        message = (f"gang {key[0]}/{key[1]} waiting for GPU capacity for {waited}s: demand "
                   f"{demands}; {self._shortfall_text(diag)}")
        if key not in self._breach_recorded:
            # Once per waiting episode, whatever the post's fate: re-emitting
            # on every retry would flood both rings during the very
            # API-server incident they describe.
            self._breach_recorded.add(key)
            RECORDER.record(
                "slo_breach",
                f"gang {key[0]}/{key[1]} capacity-waiting past "
                f"{self.pending_event_threshold_s:.0f}s",
                namespace=key[0], gang=key[1], waited_s=waited)
            LEDGER.record("slo_breach", "gang_pending", message, gang=f"{key[0]}/{key[1]}",
                          waited_s=waited)
        posted = 0
        for pod in gv.gated:
            if self._event_budget_left <= 0:
                metrics.GANG_PENDING_EVENTS.inc(outcome="suppressed")
                break
            self._event_budget_left -= 1
            meta = pod.get("metadata") or {}
            try:
                create(
                    key[0],
                    {"kind": "Pod", "name": meta.get("name", ""), "namespace": key[0],
                     "uid": meta.get("uid", "")},
                    reason="GPUGangPending",
                    message=message,
                    event_type="Warning",
                    component="gpu-gang-admission",
                )
                metrics.GANG_PENDING_EVENTS.inc(outcome="posted")
                posted += 1
            except (KubeError, OSError) as e:
                metrics.GANG_PENDING_EVENTS.inc(outcome="error")
                log.warning("pending-gang event for %s/%s failed: %s", key[0],
                            meta.get("name", ""), e)
        if posted:
            # Only once an Event landed: a wholesale failure retries next
            # tick, not after the repost interval.
            self._pending_evented[key] = now

    def _watch_loop(self) -> None:
        """The pod-event plane: gang-labeled pod events become dirty marks.
        A stream failure falls back to the full sweep: events are an
        optimization, never a correctness dependency."""
        rv = ""
        # A healthy watch blocks its whole 60 s window with no event.
        hb = profiling.HEARTBEATS.register("gang_pod_watch", interval_s=60.0, max_silence_s=180.0)
        while not self._stop.is_set():
            hb.beat()
            try:
                for etype, pod in self.client.watch_pods(label_selector=GANG_NAME_LABEL,
                                                         resource_version=rv,
                                                         timeout_seconds=60):
                    if self._stop.is_set():
                        return
                    hb.beat()
                    rv = (pod.get("metadata") or {}).get("resourceVersion", "") or rv
                    if etype != "BOOKMARK":
                        self.note_pod_event(pod)
            except Exception as e:  # noqa: BLE001 - 410, drop, partition
                if self._stop.is_set():
                    return
                log.debug("gang pod watch window ended: %s", e)
                rv = ""
                self.mark_all_dirty()  # the watch may have missed events
                self._stop.wait(min(5.0, self.resync_interval_s))

    # -- one evaluation pass -----------------------------------------------

    def _collect_gangs(self, keys: Optional[Set[GangKey]] = None) -> Dict[GangKey, GangView]:
        """Gang-labeled pods grouped by (namespace, gang) into GangViews: the
        one discovery path of tick(), explain(), recover() and the auditor.
        The API server filters: only gang-labeled pods come back, and a
        dirty tick asks for its marked gangs' names (``in (...)``) when they
        are few. Terminating pods are left out. Finished pods top the live
        membership up to the declared size only, so a Failed member beside
        its replacement does not read as an oversized gang, and a size-2
        gang whose released member finished still reads complete."""
        selector = GANG_NAME_LABEL
        if keys is not None:
            if not keys:
                return {}
            names = sorted({name for _, name in keys})
            # A huge set selector would outgrow URL norms; past ~40 names the
            # existence selector and local filtering are cheaper anyway.
            if len(names) <= 40:
                selector = f"{GANG_NAME_LABEL} in ({','.join(names)})"
        pods = self.client.list_pods(label_selector=selector).get("items", [])
        live: Dict[GangKey, List[dict]] = {}
        finished: Dict[GangKey, List[dict]] = {}
        sizes: Dict[GangKey, int] = {}
        for pod in pods:
            if (pod.get("metadata") or {}).get("deletionTimestamp"):
                continue  # a member on its way out completes no gang
            info = pod_gang(pod)
            if info is None:
                continue
            ns, name, size = info
            key = (ns, name)
            if (pod.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
                finished.setdefault(key, []).append(pod)
            else:
                live.setdefault(key, []).append(pod)
            sizes[key] = size
        views: Dict[GangKey, GangView] = {}
        for key, size in sizes.items():
            alive = live.get(key, [])
            # Succeeded before Failed: a Failed stand-in adds its demand,
            # which its live replacement already carries.
            done = sorted(finished.get(key, []), key=lambda p: (
                (p.get("status") or {}).get("phase") != "Succeeded",
                (p.get("metadata") or {}).get("name", "")))
            views[key] = GangView(size=size, live=alive, standins=done[:max(0, size - len(alive))])
        if keys is not None:
            views = {k: v for k, v in views.items() if k in keys}
        if self.gang_filter is not None:
            # Sharded: another shard's gangs are invisible everywhere this
            # discovery feeds, so this admitter can neither admit nor drop
            # what it does not own.
            views = {k: v for k, v in views.items() if self.gang_filter(k)}
        return views

    def tick(self, full: bool = True) -> List[GangKey]:
        """Evaluate gangs once; returns the gangs released this pass.

        ``full`` (the default, what direct callers get) rescans every gang.
        ``full=False`` is the loop's dirty tick between sweeps: only gangs
        events marked, plus gangs holding reservations (their upkeep is per
        tick), are listed and evaluated; with nothing marked and nothing
        held it touches neither the pod nor the node API."""
        with self._dirty_lock:
            dirty = set(self._dirty)
            self._dirty.clear()
        metrics.GANG_TICKS.inc(mode="full" if full else "dirty")
        try:
            return self._tick_inner(full, dirty)
        except Exception:
            # The consumed marks survive a failed tick; re-marking a gang the
            # pass did evaluate costs one redundant evaluation.
            with self._dirty_lock:
                self._dirty |= dirty
            raise
        finally:
            if self.journal is not None:
                # Once a tick, on every exit: the tick's buffered records go
                # to the OS, and the journal folds into a snapshot once
                # enough piled up.
                self.journal.flush()
                self.journal.maybe_compact(self._journal_state)

    def _tick_inner(self, full: bool, dirty: Set[GangKey]) -> List[GangKey]:
        requested: Optional[Set[GangKey]] = None
        if full:
            gangs = self._collect_gangs()
            # Only after the listing succeeded: a failed sweep is retried.
            self._last_full_sweep = time.monotonic()
        else:
            requested = dirty | set(self.reservations.active())
            if not requested:
                self._publish_waiting()
                return []
            gangs = self._collect_gangs(requested)
        self._event_budget_left = self.pending_event_budget
        for plane in (self.preemption, self.defrag, self.rescue):
            if plane is not None:
                plane.begin_tick()
        if self.rescue is not None and full:
            self.rescue.prune(set(gangs))
        self._reservation_upkeep(gangs, full)
        # Prune the markers of vanished gangs. A dirty tick saw only
        # ``requested``, so it prunes only those.
        if full:
            for key in list(self._waiting_reported):
                if key not in gangs:
                    self._clear_wait_state(key)
            for key in list(self._first_complete):
                if key not in gangs:
                    self._first_complete.pop(key, None)
            for key in list(self._gang_priority):
                if key not in gangs:
                    self._prune_priority(key)
            with self._dirty_lock:
                stale = self._waiting_gangs - set(gangs)
            for key in stale:
                self._clear_waiting(key)
        else:
            for key in requested - set(gangs):
                self._clear_wait_state(key)
                self._clear_waiting(key)
                self._prune_priority(key)
                # A vanished gang's lapse bar is moot; dropping it here, for
                # the gangs this tick saw absent, keeps upkeep's
                # intersection for full sweeps only.
                self._lapsed_gangs.discard(key)
        if not gangs:
            self._publish_waiting()
            return []

        # One consumable capacity view for the whole tick: a gang released
        # earlier in the pass shrinks what later gangs see. Active holds of
        # released-but-unscheduled gangs are subtracted first (the daemons'
        # availability lags scheduling). Built lazily: a tick with nothing
        # to test never lists nodes.
        pool_cell: List[Optional[_CapacityPool]] = [None]

        def pool() -> _CapacityPool:
            if pool_cell[0] is None:
                topos = self._node_topologies()
                self.reservations.apply(topos)
                pool_cell[0] = _CapacityPool(topos)
            return pool_cell[0]

        standing = self.reservations.active()
        released: List[GangKey] = []
        prios = {key: self._priority_of(key, gv) for key, gv in gangs.items()}
        if self.rescue is not None:
            self._note_bound(gangs, full)
        # Within a tier a just-rescued gang goes first; with no rescue plane
        # every gang is equal and the order is the key's.
        boost = self.rescue.admit_boost if self.rescue is not None else (lambda _key: 1)
        for key, gv in sorted(gangs.items(), key=lambda kv: (-prios[kv[0]], boost(kv[0]), kv[0])):
            gated = gv.gated
            if not gated:
                # Fully released. A restart loses holds that were never
                # journaled; while members are unscheduled, re-fence their
                # remaining demand, never a lapsed hold's.
                self._clear_waiting(key)
                self._clear_wait_state(key)
                self._maybe_refence(key, gv, standing, pool)
                if self.rescue is not None:
                    consumed = self.rescue.maybe_rescue(
                        key, gv, prios[key], lambda: pool().current_topos(),
                        gangs=gangs if full else None)
                    if consumed:
                        pool().debit(consumed)
                        standing = self.reservations.active()
                continue
            members = gv.members
            if len(members) < gv.size:
                log.debug("gang %s/%s: %d/%d pods present; waiting", key[0], key[1],
                          len(members), gv.size)
                # An incomplete gang waits on pod events, not capacity.
                self._clear_waiting(key)
                self._clear_wait_state(key)
                continue
            if len(members) > gv.size:
                log.warning("gang %s/%s: %d pods exceed declared size %d; refusing to release "
                            "(misconfigured gang)", key[0], key[1], len(members), gv.size)
                self._clear_waiting(key)
                self._clear_wait_state(key)
                continue
            if gv.ungated_live:
                # Two shapes end here, and both want the gates gone without a
                # fresh test: (a) replacements joining a placed gang (a live
                # ungated member is scheduled; a whole-gang test would
                # deadlock against the gang's own cards), and (b) a release
                # pass that failed mid-gang: the decision is made, and a
                # gated remainder is the worst outcome. Stand-ins never reach
                # here: a finished pod's nodeName holds no cards.
                placed = any((p.get("spec") or {}).get("nodeName") for p in gv.ungated_live)
                if placed:
                    log.info("gang %s/%s: releasing %d replacement pod(s) joining a placed "
                             "gang", key[0], key[1], len(gated))
                else:
                    log.warning("gang %s/%s: finishing partial release (%d of %d still gated)",
                                key[0], key[1], len(gated), gv.size)
                self._traced_release(
                    key, gated, reason="replacement_join" if placed else "finish_partial_release",
                    wait_started=self._waiting_since.get(key))
                released.append(key)
                self._clear_waiting(key)
                self._clear_wait_state(key)
                continue
            hold = standing.get(key)
            demands = gv.demands(self.resource_name)
            # The SLO origin: the first capacity evaluation of this complete,
            # fully gated gang.
            self._first_complete.setdefault(key, time.monotonic())
            if hold is not None:
                if tuple(sorted(demands)) == hold.demands:
                    # An earlier pass reserved and then every gate patch
                    # failed: the decision is made and the gang's own hold
                    # fences its cards (the pool already subtracted it, so a
                    # test would read no capacity). Finish the release.
                    log.warning("gang %s/%s: finishing release against its standing "
                                "reservation (previous release pass failed wholesale)",
                                key[0], key[1])
                    self._traced_release(key, gated, reason="release_retry",
                                         wait_started=self._waiting_since.get(key))
                    released.append(key)
                    self._clear_waiting(key)
                    self._clear_wait_state(key)
                    continue
                # A same-named gang of another shape: the hold was sized for
                # its predecessor. Drop it; the next tick tests the new gang
                # on honest availability.
                log.warning("gang %s/%s: demands changed under a standing reservation (%s -> "
                            "%s); dropping the stale hold and re-evaluating next resync",
                            key[0], key[1], list(hold.demands), sorted(demands))
                self.reservations.drop(key)
                continue
            consumed_hosts = pool().fits(demands)
            preempted = defragged = False
            if consumed_hosts is None and self.preemption is not None:
                consumed_hosts = self.preemption.maybe_preempt(
                    key, gv, demands, pool().current_topos(), prios[key],
                    gangs=gangs if full else None)
                if consumed_hosts is not None:
                    preempted = True
                    pool().debit(consumed_hosts)
            if consumed_hosts is None and self.defrag is not None:
                consumed_hosts = self.defrag.maybe_defrag(
                    key, gv, demands, pool().current_topos(), prios[key],
                    gangs=gangs if full else None)
                if consumed_hosts is not None:
                    defragged = True
                    pool().debit(consumed_hosts)
            if consumed_hosts is None:
                diag = pool().last_reject or {}
                # A node event wakes this gang; the sweep stays the backstop.
                self._set_waiting(key)
                dtuple = tuple(sorted(demands))
                if self._waiting_reported.get(key) != dtuple:
                    # A waiting-state change (a fresh wait, or demands edited
                    # in place): one record, flight event and log line.
                    self._waiting_reported[key] = dtuple
                    if key not in self._waiting_since:
                        self._waiting_since[key] = time.time()
                        if self.journal is not None:
                            self.journal.record("wait", key, since=self._waiting_since[key])
                    LEDGER.record("gang_waiting", "capacity",
                                  f"insufficient GPU capacity for {demands}: "
                                  + self._shortfall_text(diag),
                                  gang=f"{key[0]}/{key[1]}", demands=demands, **diag)
                    RECORDER.record("gang_waiting",
                                    f"gang {key[0]}/{key[1]} blocked on capacity",
                                    namespace=key[0], gang=key[1], demands=demands)
                    log.info("gang %s/%s: insufficient GPU capacity for %s (%s); stays gated "
                             "(re-evaluated every %.0fs)", key[0], key[1], demands,
                             self._shortfall_text(diag), self.resync_interval_s)
                self._maybe_post_pending_event(key, gv, demands, diag)
                continue
            self._clear_waiting(key)
            waited_s = max(0.0, time.monotonic() - self._first_complete.pop(key,
                                                                            time.monotonic()))
            wait_started = self._waiting_since.get(key)
            self._clear_wait_state(key)
            # Reserve before the first gate comes off: from the moment a
            # competitor can be scheduled, /filter subtracts this gang's
            # hold. The demands tell a later tick a same-named gang of
            # another shape apart.
            self.reservations.reserve(key, consumed_hosts, demands=tuple(sorted(demands)),
                                      priority=prios[key])
            if preempted:
                self.preemption.finish(key)
            if defragged:
                self.defrag.finish(key)
            # A fresh release clears a predecessor's lapse bar.
            self._lapsed_gangs.discard(key)
            if self.journal is not None:
                # On the OS before the first gate patch: a crash anywhere in
                # the release below rehydrates the hold and this marker, and
                # the next tick's release_retry finishes the gates.
                self.journal.record("admit", key, hosts=consumed_hosts, demands=sorted(demands))
            self._traced_release(key, gated, reason="admitted", demands=demands,
                                 consumed=consumed_hosts, waited_s=waited_s,
                                 wait_started=wait_started)
            released.append(key)
        self._publish_waiting()
        for key in released:
            metrics.GANG_RELEASED.inc(tier=self._gang_tier.get(key, TIER_STANDARD))
        if released and self.shard_id is not None:
            # Each shard's admission throughput (rate() is gangs/s).
            metrics.SHARD_ADMITTED.inc(len(released), shard=str(self.shard_id))
        active = self.reservations.active()
        metrics.GANG_RESERVED.set(len(active))
        metrics.GANG_RESERVED_CHIPS.set(sum(r.total_chips for r in active.values()))
        # Lapses are counted in the table (a hold can expire between ticks).
        lapsed = self.reservations.lapsed_total
        if lapsed > self._lapsed_reported:
            metrics.GANG_RESERVATIONS_LAPSED.inc(lapsed - self._lapsed_reported)
            self._lapsed_reported = lapsed
        return released

    def _note_bound(self, gangs: Dict[GangKey, GangView], full: bool) -> None:
        """Refresh the node -> bound released gangs map note_node_event
        reads: rebuilt on a full sweep, extended on a dirty tick (a stale
        entry costs one more evaluation of its gang, never a missed one)."""
        bound: Dict[str, Set[GangKey]] = {}
        for key, gv in gangs.items():
            if gv.gated:
                continue
            for p in gv.live:
                node = (p.get("spec") or {}).get("nodeName")
                if node:
                    bound.setdefault(node, set()).add(key)
        with self._dirty_lock:
            if full:
                self._bound_on = bound
            else:
                for node, keys in bound.items():
                    self._bound_on.setdefault(node, set()).update(keys)

    # -- reservations ------------------------------------------------------

    def _maybe_refence(self, key: GangKey, gv: GangView, standing: Dict,
                       pool: Callable[[], _CapacityPool]) -> None:
        """Reserve a fully released gang's unscheduled demand again when it
        has no hold (a hold dies with the process unless journaled). The
        consumption lands in the tick's shared pool."""
        # Drain again at the decision point: a hold can lapse in any prune
        # between the upkeep and here.
        self._lapsed_gangs |= self.reservations.drain_lapsed()
        if key in standing or key in self._lapsed_gangs:
            return
        pending = [p for p in gv.ungated_live if not (p.get("spec") or {}).get("nodeName")]
        demands = [d for p in pending if (d := gpu_request(p, self.resource_name)) > 0]
        if not demands:
            return  # nothing to fence
        consumed = pool().fits(demands)
        if consumed is None:
            return  # the capacity is gone; the gang Pends
        # Members already scheduled are outside this hold: pre-count them,
        # or the upkeep would drain the fresh hold by their cards.
        scheduled = {(p.get("metadata") or {}).get("name", "")
                     for p in gv.live if (p.get("spec") or {}).get("nodeName")}
        self.reservations.reserve(key, consumed,
                                  demands=tuple(sorted(gv.demands(self.resource_name))),
                                  counted_pods=scheduled,
                                  priority=self._gang_priority.get(key, 0))
        log.info("gang %s/%s: re-fenced %d card(s) for %d unscheduled pod(s) (hold was lost, "
                 "e.g. process restart)", key[0], key[1], sum(consumed.values()), len(pending))

    def _reservation_upkeep(self, gangs: Dict[GangKey, GangView], full: bool = True) -> None:
        """Shrink, renew or drop the active holds against the live pods: a
        scheduled member's cards leave its gang's hold, a fully scheduled or
        vanished gang drops it, a gang still Pending renews it up to the age
        cap, where it lapses (gates cannot be re-added; past it the gang
        Pends like any unschedulable pod)."""
        for key, _res in self.reservations.active().items():
            gv = gangs.get(key)
            if gv is None:
                if self.rescue is not None and self.rescue.shield(key):
                    continue  # a rescued gang's pods are coming back
                self.reservations.drop(key)
                continue
            unscheduled = 0
            for p in gv.live:
                node = (p.get("spec") or {}).get("nodeName")
                if node:
                    self.reservations.note_scheduled(key, (p.get("metadata") or {}).get("name", ""),
                                                     node, gpu_request(p, self.resource_name))
                else:
                    unscheduled += 1
            if unscheduled == 0 and len(gv.live) >= gv.size:
                self.reservations.drop(key)
                self._lapsed_gangs.discard(key)
            elif not self.reservations.renew(
                    # No record while the expiry has several ticks of runway.
                    key, skip_if_remaining_s=3.0 * self.resync_interval_s):
                self.reservations.lapse(key)
                log.warning("gang %s/%s: reservation lapsed at the age cap with %d pod(s) still "
                            "unscheduled; its cards are no longer fenced (gates cannot be "
                            "re-added)", key[0], key[1], unscheduled)
        # Drain last: a hold can age out inside any prune, this active()
        # included.
        self._lapsed_gangs |= self.reservations.drain_lapsed()
        if full:
            # Only a full sweep saw every gang: intersecting with a dirty
            # tick's subset would erase the bars of the gangs outside it.
            self._lapsed_gangs &= set(gangs)

    def explain(self) -> List[dict]:
        """The operator's diagnosis (the gang tool of a later slice): per
        gang its membership against its declared size, gate state, demands
        and whether it fits the published capacity now. A pure read. The fit
        verdicts thread the consumed capacity across gangs in tick()'s
        order, so two gangs competing for one node read "fits" and
        "blocked", as the controller will act."""
        gangs = self._collect_gangs()
        topos = self._node_topologies()
        self.reservations.apply(topos)
        pool = _CapacityPool(topos)
        standing = self.reservations.active()
        reports = []
        for key, gv in sorted(gangs.items()):
            members = gv.members
            gated = gv.gated
            demands = gv.demands(self.resource_name)
            if len(members) < gv.size:
                status = f"waiting: {len(members)}/{gv.size} pods exist"
            elif len(members) > gv.size:
                status = f"misconfigured: {len(members)} pods exceed declared size {gv.size}"
            elif not gated:
                status = "released"
            elif gv.ungated_live:
                if any((p.get("spec") or {}).get("nodeName") for p in gv.ungated_live):
                    status = "replacement joining placed gang: release due next resync"
                else:
                    status = "partial release in progress"
            elif key in standing and tuple(sorted(demands)) == standing[key].demands:
                status = ("release retry due next resync (standing reservation from a failed "
                          "release pass)")
            elif key in standing:
                status = ("stale hold from a differently-shaped predecessor: re-evaluated next "
                          "resync")
            elif pool.fits(demands) is not None:
                status = "fits: release due next resync"
            else:
                status = (f"blocked: insufficient GPU capacity for {demands} on published "
                          "topology")
            reports.append({"namespace": key[0], "gang": key[1], "size": gv.size,
                            "pods": len(members), "gated": len(gated), "demands": demands,
                            "status": status})
        return reports

    def _node_topologies(self) -> List[NodeTopology]:
        if self.topo_source is not None:
            # The extender's index: parsed per-call clones, no HTTP.
            try:
                topos = list(self.topo_source())
            except Exception as e:  # noqa: BLE001 - as a failed relist
                if self._last_topos:
                    log.warning("topology source failed (%s); serving last-known topology "
                                "(%d nodes)", e, len(self._last_topos))
                    return list(self._last_topos)
                raise
        else:
            try:
                items = self.client.list_nodes().get("items", [])
            except (KubeError, OSError) as e:
                # The resilience layer has retried: serve the last-known view
                # rather than abort, as the node cache does.
                if self._last_topos:
                    log.warning("node list failed (%s); serving last-known topology (%d nodes)",
                                e, len(self._last_topos))
                    return list(self._last_topos)
                raise
            topos = []
            for node in items:
                raw = ((node.get("metadata") or {}).get("annotations") or {}).get(
                    constants.TOPOLOGY_ANNOTATION)
                if not raw:
                    continue
                try:
                    topos.append(parse_topology_cached(raw))
                except ValueError as e:  # every malformed shape, normalized
                    log.warning("bad topology annotation on %s: %s",
                                (node.get("metadata") or {}).get("name"), e)
        if self.topo_filter is not None:
            # Sharded: only the nodes this shard owns, on either source (the
            # peer shards filter the complement).
            topos = [t for t in topos if self.topo_filter(t)]
        if self.rescue is not None:
            # The rescue plane's node lifecycle filter: cordoned, tainted and
            # NotReady nodes leave the capacity view.
            topos = [t for t in topos if self.rescue.placeable(t.hostname)]
        self._last_topos = list(topos)
        return topos

    # -- release -----------------------------------------------------------

    def _traced_release(
        self,
        key: GangKey,
        members: List[dict],
        reason: str,
        demands: Optional[List[int]] = None,
        consumed: Optional[Dict[str, int]] = None,
        waited_s: Optional[float] = None,
        wait_started: Optional[float] = None,
    ) -> None:
        """The release inside the allocation trace's root span.

        Gang admission is the first to touch a gang pod, so ``gang.admit``
        opens the trace; its context is stamped onto every member as the
        carrier annotation before the gates come off, and the extender's
        /filter and the daemon's controller join it. With tracing and the
        ledger both off this adds nothing: not even the admitted-at stamp's
        patch."""
        def note_released() -> None:
            # Inside the span when one is open, so the log line, the flight
            # event and the record carry the trace id.
            RECORDER.record("gang_released", f"gang {key[0]}/{key[1]} gates removed ({reason})",
                            namespace=key[0], gang=key[1], pods=len(members), reason=reason)
            gang_key = f"{key[0]}/{key[1]}"
            ctx = tracing.current()
            if ctx is not None and wait_started is not None:
                # The gang's wait records predate this span: join this
                # waiting episode's records to the trace.
                LEDGER.tag_gang(gang_key, ctx.trace_id, ctx.span_id,
                                since_ts=wait_started - 0.001)
            if reason == "admitted":
                if waited_s is not None:
                    metrics.GANG_TIME_TO_ADMIT.observe(waited_s)
                attrs = {"demands": demands,
                         "hosts": ",".join(f"{h}={c}" for h, c in sorted((consumed or {}).items()))}
                if waited_s is not None:
                    attrs["waited_s"] = round(waited_s, 3)
                LEDGER.record("gang_admitted", "admitted",
                              f"whole gang fits; gates removed for {len(members)} pod(s)",
                              gang=gang_key, **attrs)
            else:
                LEDGER.record("gang_released", reason,
                              f"gates removed ({reason}) for {len(members)} pod(s)",
                              gang=gang_key)
            log.info("gang %s/%s released (%s): %d pods, demand %s", key[0], key[1], reason,
                     len(members), demands if demands is not None else "unchanged")

        if not tracing.enabled():
            if LEDGER.enabled:
                self._stamp_release(members, None)
            self._release(members)
            note_released()
            return
        with tracing.span("gang.admit", service="extender", namespace=key[0], gang=key[1],
                          pods=len(members), reason=reason) as sp:
            self._stamp_release(members, sp.context)
            self._release(members)
            note_released()

    def _stamp_release(self, members: List[dict], ctx) -> None:
        """The release-time annotations, one patch per member before its
        gate comes off: the admitted-at stamp (the controller's
        tpu_pod_time_to_allocate_seconds origin) and, with a span open, the
        trace carrier."""
        ann = {constants.ADMIT_TS_ANNOTATION: str(round(time.time(), 3))}
        if ctx is not None:
            tracing.inject(ann, ctx)
        for pod in members:
            meta = pod.setdefault("metadata", {})
            ns = meta.get("namespace", "default")
            name = meta.get("name", "")
            # An explicit "annotations": null must not abort the release.
            local = meta.get("annotations")
            if not isinstance(local, dict):
                local = meta["annotations"] = {}
            local.update(ann)
            try:
                self.client.patch_pod_annotations(ns, name, dict(ann))
            except Exception as e:  # noqa: BLE001 - an overlay: losing the
                # carrier costs the trace's join, never the release
                log.debug("trace carrier stamp for %s/%s failed: %s", ns, name, e)

    def _release(self, members: List[dict]) -> None:
        """Remove the gang gate from every member, best-effort per pod: a
        failed patch is retried on the next tick (released pods keep their
        labels; tick()'s is_gated filter is what skips them). The removal is
        the client's guarded JSON Patch, so a gate another controller added
        since the list survives."""
        for pod in members:
            meta = pod.get("metadata") or {}
            ns = meta.get("namespace", "default")
            name = meta.get("name", "")
            gates = (pod.get("spec") or {}).get("schedulingGates") or []
            try:
                self._remove_gate(ns, name, gates)
            except Exception as e:  # noqa: BLE001 - retried next resync
                log.warning("gate removal for %s/%s failed (retrying next resync): %s",
                            ns, name, e)

    def _remove_gate(self, ns: str, name: str, gates: List[dict]) -> None:
        try:
            self.client.remove_pod_scheduling_gate(ns, name, GATE_NAME, gates)
            return
        except ValueError:
            return  # the snapshot holds no gang gate: nothing to do
        except Exception:  # noqa: BLE001 - the gate list changed meanwhile
            live = self.client.get_pod(ns, name)
        live_gates = (live.get("spec") or {}).get("schedulingGates") or []
        if not any(g.get("name") == GATE_NAME for g in live_gates):
            return  # removed by someone else: released either way
        self.client.remove_pod_scheduling_gate(ns, name, GATE_NAME, live_gates)
