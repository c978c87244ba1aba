"""Post-release gang reservations: the JAX package's
``extender/reservations.py``, the whole table.

Gang admission's capacity check runs on published availability, and gate
removal is not a placement: any pod could take the cards between a gang's
release and its scheduling, stranding the gang Pending with its gates gone.
Scheduling gates cannot be re-added to a live pod, so the reservation comes
first:

* the admission tick records the exact host -> card counts its feasibility
  check consumed, before removing any gate, in this table;
* the extender's /filter and /prioritize subtract the reservations other
  gangs hold from every candidate node's availability (a gang's own pods
  are exempt from its own hold);
* the admission tick subtracts every active reservation from its own
  capacity view.

A reservation shrinks as gang members schedule, is dropped when every
member is scheduled or the gang vanishes, is renewed each tick while
members are Pending, and lapses at a hard age cap. One table is shared in
the extender's process between gang admission and the ``TopologyExtender``.
The ``observer`` hook is the admission journal's tap. Gang admission and
its journal come with the extender's next slice; until then the table is
filled by the tests and read by /filter, /prioritize and /reservations.
Cards within a host are fungible for counting, so a hold fences a count,
not identities, exactly as the JAX table's does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Set, Tuple

from ..utils import metrics, profiling

GangKey = Tuple[str, str]  # (namespace, gang name)

DEFAULT_TTL_S = 60.0
DEFAULT_MAX_AGE_S = 300.0


def apply_held(topos, held_by_host: Dict[str, int]) -> Dict[str, int]:
    """Subtract held card counts from published NodeTopology
    availability, in place. The one place the holds -> availability
    truncation lives (ReservationTable.apply, and the sharded facade of a
    later slice), so the /filter shields cannot drift. Returns
    hostname -> cards withheld (for the failure-reason diagnostics)."""
    withheld: Dict[str, int] = {}
    for t in topos:
        held = held_by_host.get(t.hostname, 0)
        if held > 0:
            t.available = t.available[
                : max(0, len(t.available) - held)
            ]
            withheld[t.hostname] = held
    return withheld


@dataclasses.dataclass
class Reservation:
    gang: GangKey
    # host → chips still reserved there (shrinks as members schedule).
    hosts: Dict[str, int]
    created_at: float
    expires_at: float
    # The sorted per-pod demands the hold was reserved FOR: lets the
    # admitter detect that a same-named gang was deleted and recreated
    # with a different shape while the hold lived (the hold then fences
    # the wrong chips and must not excuse a fresh capacity check).
    demands: Tuple[int, ...] = ()
    # Pod names whose placement was already subtracted from ``hosts``.
    counted_pods: Set[str] = dataclasses.field(default_factory=set)
    # The gang's scheduling priority at reserve time (PriorityClass-
    # derived, by the preemption plane of a later slice): holds order by
    # it in snapshots. 0 = the cluster default.
    priority: int = 0

    @property
    def total_chips(self) -> int:
        return sum(self.hosts.values())


class ReservationTable:
    """Thread-safe gang→reservation map with TTL + hard age cap."""

    def __init__(
        self,
        ttl_s: float = DEFAULT_TTL_S,
        max_age_s: float = DEFAULT_MAX_AGE_S,
        clock=time.monotonic,
    ):
        self.ttl_s = ttl_s
        self.max_age_s = max_age_s
        self._clock = clock
        # Instrumented lock (utils/profiling.TimedLock): every /filter
        # thread and the gang tick serialize here, so convoy on this
        # lock is scheduler-visible latency — contended waits land in
        # tpu_lock_wait_seconds{lock="reservations"}.
        self._lock = profiling.TimedLock(
            "reservations", metrics.EXT_LOCK_WAIT
        )
        self._by_gang: Dict[GangKey, Reservation] = {}
        # State-transition observer: callable(op, gang_key, payload)
        # invoked under the table lock (ordering must match mutation
        # order) for reserve/renew/drop/lapse/shrink, the admission
        # journal's tap. Hooked here, not at the call sites, so a lapse
        # inside a routine prune on the /filter hot path is captured too.
        # None = no journaling (the default: one None check when off).
        self.observer = None
        self.lapsed_total = 0  # reservations that hit the hard age cap
        # Keys that lapsed since the last drain_lapsed() — a hold can
        # age out inside a routine prune (any active()/apply() call),
        # so the admitter can't observe every lapse in its own upkeep;
        # it drains this set instead (and must never re-fence those).
        self._lapsed_keys: set = set()

    # -- mutation ----------------------------------------------------------

    def _observe_reserve_locked(self, gang: GangKey, age_s: float) -> None:
        """The ONE builder of the observer's 'reserve' payload — fresh
        reserves and age-preserving restores must journal the same
        record shape or replay diverges between them."""
        if self.observer is None:
            return
        r = self._by_gang[gang]
        self.observer("reserve", gang, {
            "hosts": dict(r.hosts),
            "demands": list(r.demands),
            "counted": sorted(r.counted_pods),
            "age_s": round(age_s, 3),
            "priority": r.priority,
        })

    def reserve(
        self,
        gang: GangKey,
        host_chips: Dict[str, int],
        demands: Tuple[int, ...] = (),
        counted_pods: Optional[Set[str]] = None,
        priority: int = 0,
    ) -> None:
        """``counted_pods`` pre-marks members whose chips are already
        OUTSIDE this hold (e.g. a restart re-fence covering only the
        still-pending members): note_scheduled must not subtract their
        chips a second time."""
        now = self._clock()
        with self._lock:
            self._by_gang[gang] = Reservation(
                gang=gang,
                hosts={h: int(n) for h, n in host_chips.items() if n > 0},
                created_at=now,
                # The hard age cap bounds even the FIRST expiry: ttl_s
                # can be auto-raised past max_age_s (long resyncs), and
                # an unclamped first window would outlive the documented
                # cap whenever renewals stop (e.g. admission thread dies
                # while the extender keeps serving /filter).
                expires_at=now + min(self.ttl_s, self.max_age_s),
                demands=tuple(sorted(demands)),
                counted_pods=set(counted_pods or ()),
                priority=int(priority),
            )
            self._observe_reserve_locked(gang, 0.0)

    def restore(
        self,
        gang: GangKey,
        host_chips: Dict[str, int],
        age_s: float,
        demands: Tuple[int, ...] = (),
        counted_pods: Optional[Set[str]] = None,
        priority: int = 0,
    ) -> bool:
        """Re-install a journal-rehydrated hold with its pre-crash age
        preserved: ``created_at`` is backdated by ``age_s`` so the hard
        age cap keeps counting from the ORIGINAL reserve — a restart
        must never reset a hold's age (that would void the cap, the
        lapsed-hold amnesia bug). False (not installed) when the age
        already exceeds the cap; the caller records the lapse
        instead."""
        if age_s >= self.max_age_s:
            return False
        now = self._clock()
        hosts = {h: int(n) for h, n in host_chips.items() if n > 0}
        if not hosts:
            return False
        with self._lock:
            self._by_gang[gang] = Reservation(
                gang=gang,
                hosts=hosts,
                created_at=now - age_s,
                # Fresh TTL window, still clamped so expiry can never
                # outlive the cap's remainder.
                expires_at=now + min(self.ttl_s, self.max_age_s - age_s),
                demands=tuple(sorted(demands)),
                counted_pods=set(counted_pods or ()),
                priority=int(priority),
            )
            self._observe_reserve_locked(gang, age_s)
        return True

    def renew(self, gang: GangKey, skip_if_remaining_s: float = 0.0) -> bool:
        """Extend the reservation's expiry; False when absent or past the
        hard age cap (the caller logs the lapse; expiry then prunes).
        ``skip_if_remaining_s``: when the current expiry still has at
        least this much runway, report healthy WITHOUT extending — the
        admission tick renews every hold every resync, and re-stamping
        an expiry that is nowhere near due is pure lock churn plus one
        journal record per hold per tick (the upkeep passes a few
        resync intervals of slack, so a hold still can never expire
        between ticks)."""
        now = self._clock()
        with self._lock:
            r = self._by_gang.get(gang)
            if r is None:
                return False
            if now - r.created_at >= self.max_age_s:
                return False
            if (
                skip_if_remaining_s > 0.0
                and r.expires_at - now >= skip_if_remaining_s
            ):
                return True
            r.expires_at = min(
                now + self.ttl_s, r.created_at + self.max_age_s
            )
            if self.observer is not None:
                self.observer("renew", gang, {})
            return True

    def drop(self, gang: GangKey) -> None:
        with self._lock:
            if (
                self._by_gang.pop(gang, None) is not None
                and self.observer is not None
            ):
                self.observer("drop", gang, {})

    def lapse(self, gang: GangKey) -> None:
        """Drop a reservation that aged out with work still unscheduled
        (counted; ordinary drops are not)."""
        with self._lock:
            r = self._by_gang.pop(gang, None)
            if r is not None and r.hosts:
                self.lapsed_total += 1
                self._lapsed_keys.add(gang)
                if self.observer is not None:
                    self.observer("lapse", gang, {})

    def drain_lapsed(self) -> set:
        """Gang keys whose holds lapsed since the last drain (consumed:
        the internal set is emptied, keeping it bounded)."""
        with self._lock:
            out = self._lapsed_keys
            self._lapsed_keys = set()
            return out

    def peek_lapsed(self) -> set:
        """The undrained lapse set, without consuming it: the
        consistency auditor's view, which must not steal the admitter's
        own signal."""
        with self._lock:
            return set(self._lapsed_keys)

    def clear(self) -> None:
        """Drop every reservation (test isolation for DEFAULT_TABLE)."""
        with self._lock:
            self._by_gang.clear()
            self.lapsed_total = 0
            self._lapsed_keys = set()

    def note_scheduled(
        self, gang: GangKey, pod_name: str, hostname: str, chips: int
    ) -> None:
        """A gang member landed: release its chips from the reservation
        (the daemon's republished availability now accounts for them).
        Idempotent per pod name."""
        with self._lock:
            r = self._by_gang.get(gang)
            if r is None or pod_name in r.counted_pods:
                return
            r.counted_pods.add(pod_name)
            if hostname in r.hosts:
                r.hosts[hostname] = max(0, r.hosts[hostname] - chips)
                if r.hosts[hostname] == 0:
                    del r.hosts[hostname]
            if self.observer is not None:
                self.observer("shrink", gang, {
                    "pod": pod_name,
                    "host": hostname,
                    "chips": int(chips),
                })

    # -- queries -----------------------------------------------------------

    def _prune_locked(self) -> None:
        now = self._clock()
        for key in [
            k for k, r in self._by_gang.items()
            if r.expires_at <= now or not r.hosts
        ]:
            r = self._by_gang.pop(key)
            lapsed = r.hosts and now - r.created_at >= self.max_age_s
            if lapsed:
                self.lapsed_total += 1
                self._lapsed_keys.add(key)
            if self.observer is not None:
                # Even prune-path exits are journaled: a TTL expiry is
                # a drop, an age-cap expiry a lapse — otherwise replay
                # would resurrect a hold the live table already shed.
                self.observer("lapse" if lapsed else "drop", key, {})

    def active(self) -> Dict[GangKey, Reservation]:
        """Snapshot of live reservations (expired ones pruned)."""
        with self._lock:
            self._prune_locked()
            return {
                k: dataclasses.replace(r, hosts=dict(r.hosts))
                for k, r in self._by_gang.items()
            }

    def reserved_chips(
        self, hostname: str, exclude: Optional[GangKey] = None
    ) -> int:
        """Chips reserved on ``hostname`` by gangs other than
        ``exclude`` (a pod is never blocked by its own gang's hold)."""
        with self._lock:
            self._prune_locked()
            return sum(
                r.hosts.get(hostname, 0)
                for k, r in self._by_gang.items()
                if k != exclude
            )

    def held_by_host(
        self, exclude: Optional[GangKey] = None
    ) -> Dict[str, int]:
        """hostname → chips held by gangs other than ``exclude``, as a
        plain dict — the read-only form of ``apply`` for consumers that
        must not mutate shared topology objects (the extender's indexed
        fast path compares counts instead of truncating lists).

        One lock acquisition and one prune for the whole call — a
        per-node reserved_chips() would put O(nodes × holds) lock/prune
        cycles on the scheduler's /filter hot path."""
        with self._lock:
            self._prune_locked()
            held: Dict[str, int] = {}
            for k, r in self._by_gang.items():
                if k == exclude:
                    continue
                for h, n in r.hosts.items():
                    held[h] = held.get(h, 0) + n
        return held

    def apply(self, topos, exclude: Optional[GangKey] = None) -> Dict[str, int]:
        """Subtract active holds from published NodeTopology
        availability, in place, via the shared :func:`apply_held`
        core: both the extender's /filter shield and the admission
        tick's capacity view go through here (the indexed fast path
        uses the same ``held_by_host`` counts), so they cannot drift.
        Returns hostname→chips withheld (for failure-reason
        diagnostics)."""
        return apply_held(topos, self.held_by_host(exclude))

    def snapshot(self) -> list:
        """JSON-ready view of active holds (the extender's /reservations
        endpoint). Ordered by priority, highest first, then key."""
        now = self._clock()
        return [
            {
                "namespace": k[0],
                "gang": k[1],
                "hosts": dict(r.hosts),
                "age_s": round(now - r.created_at, 1),
                "expires_in_s": round(r.expires_at - now, 1),
                "priority": r.priority,
            }
            for k, r in sorted(
                self.active().items(),
                key=lambda kv: (-kv[1].priority, kv[0]),
            )
        ]

    def export_state(self) -> Dict[GangKey, dict]:
        """Full JSON-ready hold state: hosts, demands, counted pods, and
        each hold's age (not its monotonic timestamps, which mean nothing
        across processes), the table's half of the admission journal's
        compaction snapshot. No prune: compaction must reflect exactly
        what the journal's records said."""
        now = self._clock()
        with self._lock:
            return {
                k: {
                    "hosts": dict(r.hosts),
                    "demands": list(r.demands),
                    "counted": sorted(r.counted_pods),
                    "age_s": round(max(0.0, now - r.created_at), 3),
                    "priority": r.priority,
                }
                for k, r in self._by_gang.items()
            }

    def load_snapshot(self, entries) -> None:
        """Rebuild holds from a snapshot() payload (fresh TTLs — the
        consumer is a short-lived diagnosis pass, not the owner)."""
        for e in entries:
            self.reserve((e["namespace"], e["gang"]), dict(e["hosts"]))


# The in-process table gang admission and the TopologyExtender share by
# default (they run in one process, extender/__main__.py).
DEFAULT_TABLE = ReservationTable()
