"""Sharded active-active gang admission: the JAX package's
``extender/sharding.py``, N extender replicas and no single admitter.

``leader.py``'s singleton makes one process both the availability
bottleneck (its death stalls every gang until the lease is taken over and
the journal replayed) and the throughput ceiling. This module turns the
fence from one admitter per cluster into one admitter per **shard**:

* **Consistent-hash ring** (:class:`ShardRing`): capacity keys hash onto N
  shards through a ring of virtual points, so adding or removing a shard
  remaps about 1/N of the keys and one key never maps to two shards under
  one shard count. A GPU node forms no multi-host slice (the gang model of
  ``gang.py``), so a node's capacity key is its hostname. Gang keys ride
  the same ring: each gang belongs to exactly one shard and is admitted
  onto exactly that shard's nodes, so no card is booked by two shards, by
  construction rather than by coordination. The hash (blake2b, 64 bits) and
  the point names are the JAX ring's, so both map a key to the same shard.
* **A Lease per shard** (the ``leader.py`` fence, once per shard): a
  replica that does not hold shard k's lease does not admit shard k's
  gangs. The home shard keeps the singleton's fail-fast contract (a second
  replica of the same home exits nonzero); other shards' stale leases are
  taken over by the scan loop (:class:`ShardManager`).
* **A journal per shard** (``<journal-dir>/shard-<k>``): a takeover replays
  exactly the dead shard's journal, so its holds come back with their
  original ages and only that shard's gangs ever stalled.
* **Active-active serving**: /filter and /prioritize run on every replica
  from its own node index. Each shard publishes its holds as an annotation
  on the very Lease it renews (``leader.py``'s ``annotations_fn``, in the
  binary form of ``holdscodec.py``); every replica reads its peers' on the
  scan cadence, and :class:`ShardedReservations` unions the local tables
  and the peer overlays behind the one ``apply``/``held_by_host`` surface
  the extender's /filter shield consumes.

SIGKILL one of N replicas and only its shard's gangs stall, and only until
a survivor takes its lease over; a restarted home replica parks a standby
lease and the interim owner hands the shard back. Changing ``--shards`` is
an operator action: roll every replica together.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..utils import metrics, profiling
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from . import holdscodec
from .leader import LEASE_NAME, LeaderLease, SecondReplica

log = get_logger(__name__)

GangKey = Tuple[str, str]

# The Lease annotation carrying one shard's holds, the JAX key (as the gang
# labels keep theirs). A fresh reserve pushes it at once (the reserve
# observer wakes the publisher); peers read it on their next scan
# (lease/3). Until then a pod racing through a peer's /filter can still see
# the fenced cards: one scheduling race, bounded by the scan interval.
# Releases and shrinks ride the renew cadence: that stale direction only
# fences a beat longer.
HOLDS_ANNOTATION = "tpu.google.com/shard-holds"

# The holder's own home shard, published beside the holds: how a restarted
# replica tells "my home is held by an interim takeover owner" (stand by,
# ask for it back) from "another replica is configured with my home" (fail
# fast, the singleton's contract per shard).
HOME_ANNOTATION = "tpu.google.com/home-shard"

# The serialised overlay's ceiling: the API server caps an object's
# annotations at 256 KiB together, and a renew that starts failing on size
# would trip the renew deadline and crash-loop the shard. Past it the
# payload degrades to one aggregated host -> cards record (it still fences
# every card, but a gang's own pods then read as blocked on the peers'
# /filter until they go through the owner: over-fencing), and past it again
# to nothing (peers lose sight; the capacity partition still keeps two
# shards off one node).
MAX_HOLDS_ANNOTATION_BYTES = 192 * 1024

# Virtual points per shard: a split within a few percent of even, and a
# ring built in microseconds.
DEFAULT_VNODES = 64


def _hash64(key: str) -> int:
    """A key's place on the ring: the first 8 bytes of blake2b, big-endian."""
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class ShardRing:
    """Consistent-hash ring: key -> shard in [0, shards).

    Deterministic (replicas configured with one shard count always agree)
    and stable: shard k's points depend on k alone, so growing N to N+1
    adds points without moving any, and only the keys nearest a new point
    move (about 1/(N+1) of them)."""

    def __init__(self, shards: int):
        self.shards = max(1, int(shards))
        # The point count is fixed: another would move keys off the JAX
        # ring's shards.
        points = sorted((_hash64(f"tpu-shard-{s}#{v}"), s)
                        for s in range(self.shards) for v in range(DEFAULT_VNODES))
        self._points = points
        self._hashes = [h for h, _ in points]

    def shard_of(self, key: str) -> int:
        if self.shards == 1:
            return 0
        i = bisect.bisect_right(self._hashes, _hash64(key)) % len(self._points)
        return self._points[i][1]

    def gang_shard(self, key: GangKey) -> int:
        return self.shard_of(f"{key[0]}/{key[1]}")

    def topo_shard(self, topo) -> int:
        """The shard owning a node's cards."""
        return self.shard_of(slice_shard_key(topo))


def slice_shard_key(topo) -> str:
    """The capacity key of one published topology: the node's hostname. The
    JAX key is a multi-host slice's member list, so that a slice's hosts
    land on one shard; a GPU node forms no slice (a gang over several nodes
    is a gang of per-node pods), so every node is its own capacity domain.
    The name stays the JAX one."""
    return getattr(topo, "hostname", "") or ""


def shard_lease_name(shard: int, shards: int) -> str:
    """A shard's lease. One shard keeps the singleton's name, so an upgrade
    from the unsharded manifest contends on the same lease."""
    if shards <= 1:
        return LEASE_NAME
    return f"{LEASE_NAME}-shard-{shard}"


def standby_lease_name(shard: int, shards: int) -> str:
    """The handback request: a replica whose home shard is held by an
    interim (takeover) owner parks a live lease here, and the owner's scan
    releases the shard back. Only shard k's home replica touches it, so a
    live foreign holder here means two replicas claim one home."""
    return f"{shard_lease_name(shard, shards)}-standby"


class ShardedReservations:
    """Read-only union of the owned shards' tables and the peers' overlays.

    The extender's /filter shield uses three verbs: ``apply``,
    ``held_by_host`` and ``snapshot`` (/reservations). This facade serves
    them over the local ``ReservationTable``s plus the peer-published hold
    records, so /filter on every replica withholds every shard's fenced
    cards. Mutations stay with each shard's own table and journal."""

    def __init__(self, tables_fn: Callable[[], List],
                 peers_fn: Optional[Callable[[], List[dict]]] = None):
        # () -> the owned tables now (ownership changes under takeover, so
        # the list is read per call, never captured).
        self._tables_fn = tables_fn
        # () -> the peers' records [{"namespace", "gang", "hosts"}].
        self._peers_fn = peers_fn

    def held_by_host(self, exclude: Optional[GangKey] = None) -> Dict[str, int]:
        held: Dict[str, int] = {}
        # Peers before tables: the takeover's swap (a local table in, the
        # peer overlay out) can land between the two reads, and this order
        # makes the race read both (a double fence) instead of neither (a
        # steal window on the shard mid-swap).
        if self._peers_fn is not None:
            for rec in self._peers_fn():
                if exclude is not None and (rec.get("namespace"), rec.get("gang")) == exclude:
                    # A pod is never blocked by its own gang's hold, even
                    # when that hold lives on another shard.
                    continue
                for h, n in (rec.get("hosts") or {}).items():
                    held[h] = held.get(h, 0) + int(n)
        for table in self._tables_fn():
            for h, n in table.held_by_host(exclude).items():
                held[h] = held.get(h, 0) + n
        return held

    def apply(self, topos, exclude: Optional[GangKey] = None) -> Dict[str, int]:
        """``ReservationTable.apply``'s contract, through the same
        ``reservations.apply_held``, so the sharded and the single-table
        shields cannot drift."""
        from .reservations import apply_held

        return apply_held(topos, self.held_by_host(exclude))

    def snapshot(self) -> list:
        """The locally owned holds (with ages: the tools' schema); the
        peers' overlays are at /debug/shards, where their staleness shows."""
        out: list = []
        for table in self._tables_fn():
            out.extend(table.snapshot())
        return sorted(out, key=lambda e: (e["namespace"], e["gang"]))


class _OwnedShard:
    """One shard this replica admits now."""

    def __init__(self, shard_id: int, lease: LeaderLease):
        self.shard_id = shard_id
        self.lease = lease
        self.admission = None  # set once the factory built it
        self.phase = "acquiring"  # acquiring|replaying|ready
        self.acquired_mono = time.monotonic()


class ShardManager:
    """This replica's shards: the home shard's adoption, the peer scan (the
    overlays and the takeover of dead shards) and each shard's admitter.

    ``admitter_factory(shard_id, gang_filter, topo_filter)`` builds one
    shard's admitter (a ``GangAdmission`` over its own ``ReservationTable``
    and journal); the manager drives its ``recover()``, ``start()`` and
    ``stop()`` around the lease. ``on_shard_lost(shard_id)`` fires when an
    owned shard's lease is lost: the entry point exits at once (the
    ``leader.py`` rationale: an admission write in flight must die with the
    process), tests pass a soft handler."""

    def __init__(self, client, shards: int, home_shard: int,
                 admitter_factory: Callable[[int, Callable, Callable], object],
                 lease_namespace: str = "kube-system", lease_seconds: float = 30.0,
                 identity: str = "", takeover: bool = True,
                 on_shard_lost: Optional[Callable[[int], None]] = None,
                 auto_start: bool = True):
        if not 0 <= home_shard < shards:
            raise ValueError(f"home shard {home_shard} out of range for {shards} shard(s)")
        self.client = client
        self.ring = ShardRing(shards)
        self.shards = self.ring.shards
        self.home_shard = home_shard
        self.admitter_factory = admitter_factory
        self.lease_namespace = lease_namespace
        self.lease_seconds = lease_seconds
        self.identity = identity
        # One GET per foreign shard a pass; a third of the lease keeps the
        # overlay's staleness well under the takeover horizon.
        self.scan_interval_s = max(1.0, lease_seconds / 3.0)
        self.takeover = takeover
        self.on_shard_lost = on_shard_lost
        # False: adopted admitters are recovered but not started (tests and
        # the self-test drive tick() themselves).
        self.auto_start = auto_start
        # A TimedLock, so lockdep sees its order against the tables' locks.
        self._lock = profiling.TimedLock("shard_manager", metrics.EXT_LOCK_WAIT)
        self._owned: Dict[int, _OwnedShard] = {}
        # Foreign shards: shard -> the peer's hold records, and shard -> the
        # observer lease (never started) whose liveness history makes the
        # takeover decision immune to clock skew, as the singleton's.
        self._peer_holds: Dict[int, List[dict]] = {}
        self._observers: Dict[int, LeaderLease] = {}
        # shard -> when its lease was first seen without a holder (absent or
        # released): the scan waits one lease duration before taking such a
        # shard, so a first rollout's slower replicas are not scavenged. A
        # named but stale holder needs no grace: its decay took a lease.
        self._unheld_since: Dict[int, float] = {}
        # The handback request, held only while an interim owner has our
        # home shard.
        self._standby: Optional[LeaderLease] = None
        # Observers of the other replicas' standby leases.
        self._standby_observers: Dict[int, LeaderLease] = {}
        # Set by the reserve observer of any owned shard: the scan thread
        # pushes the overlay now instead of at the next renew.
        self._publish_wake = threading.Event()
        self.takeovers = 0
        # Fired with the home admitter whenever the home shard is adopted,
        # a late adoption after a standby wait included: the entry point
        # builds the auditor through it.
        self.on_home_adopted: Optional[Callable[[object], None]] = None
        self._stop = threading.Event()
        self._scan_thread: Optional[threading.Thread] = None

    # -- ownership predicates (each shard's admission filters) -------------

    def gang_filter_for(self, shard_id: int) -> Callable[[GangKey], bool]:
        ring = self.ring
        return lambda key: ring.gang_shard(key) == shard_id

    def topo_filter_for(self, shard_id: int) -> Callable[[object], bool]:
        ring = self.ring
        return lambda topo: ring.topo_shard(topo) == shard_id

    def owned_shards(self) -> Set[int]:
        with self._lock:
            return set(self._owned)

    def shard_tables(self) -> List[Tuple[int, object]]:
        """(shard, ReservationTable) of each owned shard: what the audit's
        ownership invariant walks."""
        with self._lock:
            return [(s.shard_id, s.admission.reservations)
                    for s in self._owned.values() if s.admission is not None]

    def reservations_view(self) -> ShardedReservations:
        """The facade /filter and /prioritize are shielded with."""
        def tables() -> List:
            with self._lock:
                return [s.admission.reservations
                        for s in self._owned.values() if s.admission is not None]

        return ShardedReservations(tables, self.peer_hold_records)

    def peer_hold_records(self) -> List[dict]:
        """The foreign shards' records, as the last scan read them. A shard
        counts as ours only once its admitter finished the replay: during a
        takeover the dead shard's published overlay keeps shielding /filter
        until the local table holds the replayed holds (one atomic swap in
        ``_adopt_shard``)."""
        with self._lock:
            out: List[dict] = []
            for shard, recs in self._peer_holds.items():
                s = self._owned.get(shard)
                if s is None or s.admission is None:
                    out.extend(recs)
            return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ShardManager":
        """Adopt the home shard, or stand by when an interim owner holds it
        (the scan keeps retrying and the owner hands it back), and start the
        peer scan. A genuine second replica of this home (a live holder
        whose published home is this shard) raises SecondReplica."""
        self._try_adopt_home(fail_fast=True)
        self._stop.clear()
        self._scan_thread = threading.Thread(
            target=profiling.supervised("shard_scan", self._scan_loop), name="shard-scan",
            daemon=True)
        self._scan_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._publish_wake.set()
        if self._scan_thread is not None:
            self._scan_thread.join(timeout=5)
            self._scan_thread = None
        self._drop_standby()
        with self._lock:
            owned = list(self._owned.values())
            self._owned.clear()
        for s in owned:
            if s.admission is not None:
                s.admission.stop()
            s.lease.stop()  # released: a successor acquires at once
            metrics.SHARD_OWNED.remove(shard=str(s.shard_id))
            metrics.SHARD_LEASE_AGE.remove(shard=str(s.shard_id))

    def abandon(self) -> None:
        """A SIGKILL's aftermath, for the chaos tests and the self-test: the
        renew threads stop without releasing a lease or flushing a journal,
        so the leases age into takeover and the journals' durable prefix is
        all that survives."""
        self._stop.set()
        self._publish_wake.set()
        if self._scan_thread is not None:
            self._scan_thread.join(timeout=5)
            self._scan_thread = None
        with self._lock:
            owned = list(self._owned.values())
            self._owned.clear()
        leases = [s.lease for s in owned]
        if self._standby is not None:
            leases.append(self._standby)
            self._standby = None
        for lease in leases:
            lease.abandon()
        # No admission.stop(): its compaction must not run.

    # -- home adoption and the handback -----------------------------------

    def _try_adopt_home(self, fail_fast: bool = False) -> bool:
        """Adopt the home shard if possible, else park a standby lease so
        the interim owner hands it back. True once the home shard is owned.
        SecondReplica only for a genuine duplicate: a live holder whose
        published home is this shard (``fail_fast``), or a live foreign
        holder of our own standby lease."""
        if self.home_shard in self.owned_shards():
            return True
        try:
            self._adopt_shard(self.home_shard, reason="home")
        except SecondReplica:
            if fail_fast and self._holder_home(self.home_shard) == self.home_shard:
                raise
            self._ensure_standby()
            return False
        self._drop_standby()
        if self.on_home_adopted is not None:
            try:
                self.on_home_adopted(self.home_admission())
            except Exception:  # noqa: BLE001 - a hook's bug must not cost the adoption
                log.exception("on_home_adopted hook failed")
        return True

    def _holder_home(self, shard_id: int) -> Optional[int]:
        """The holder's published home shard, or None when unreadable:
        unknown reads as interim, which degrades to a visible standby, never
        to a second admitter (the lease itself still fences)."""
        try:
            lease = self.client.get(f"/apis/coordination.k8s.io/v1/namespaces/"
                                    f"{self.lease_namespace}/leases/"
                                    f"{shard_lease_name(shard_id, self.shards)}")
        except Exception:  # noqa: BLE001 - unreadable is unknown
            return None
        ann = (lease.get("metadata") or {}).get("annotations") or {}
        try:
            return int(ann.get(HOME_ANNOTATION, ""))
        except ValueError:
            return None

    def _ensure_standby(self) -> None:
        if self._standby is not None:
            return
        sb = LeaderLease(self.client, namespace=self.lease_namespace,
                         name=standby_lease_name(self.home_shard, self.shards),
                         identity=self.identity, lease_seconds=self.lease_seconds)
        # SecondReplica here: another live replica claims this home too.
        sb.start()
        self._standby = sb
        log.warning("home shard %d is held by an interim owner; standing by on %s until it "
                    "hands the shard back", self.home_shard, sb.name)

    def _drop_standby(self) -> None:
        if self._standby is not None:
            self._standby.stop()
            self._standby = None

    def _standby_claimant_live(self, shard_id: int) -> bool:
        """True while the shard's home replica stands by, asking for it."""
        obs = self._standby_observers.get(shard_id)
        if obs is None:
            obs = LeaderLease(self.client, namespace=self.lease_namespace,
                              name=standby_lease_name(shard_id, self.shards),
                              identity=self.identity, lease_seconds=self.lease_seconds)
            self._standby_observers[shard_id] = obs
        try:
            lease = self.client.get(obs._path)
        except Exception:  # noqa: BLE001 - absent or unreachable: no claim
            return False
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        return bool(holder) and holder != self.identity and obs._holder_is_live(spec)

    def _handback(self, shard_id: int) -> None:
        """Return a taken-over shard to its home replica: stop the admitter
        (its final compaction leaves the successor an O(holds) replay) and
        release the lease, so the claimant's next retry acquires at once."""
        with self._lock:
            s = self._owned.pop(shard_id, None)
            if s is not None and s.admission is not None:
                # The peer overlay is seeded from the last local snapshot in
                # the step that drops the table from reservations_view(), so
                # this replica's /filter keeps fencing the shard's cards
                # through the new owner's replay.
                self._peer_holds[shard_id] = [
                    {"namespace": e["namespace"], "gang": e["gang"], "hosts": e["hosts"]}
                    for e in s.admission.reservations.snapshot()]
        if s is None:
            return
        log.warning("shard %d: home replica is back; handing the shard over", shard_id)
        RECORDER.record("shard_handback",
                        f"released taken-over shard {shard_id} to its returning home replica",
                        shard=shard_id, identity=self.identity)
        if s.admission is not None:
            s.admission.stop()
        s.lease.stop()
        metrics.SHARD_OWNED.remove(shard=str(shard_id))
        metrics.SHARD_LEASE_AGE.remove(shard=str(shard_id))

    # -- adoption ----------------------------------------------------------

    def _holds_payload_fn(self, shard_id: int) -> Callable[[], Dict[str, str]]:
        def payload() -> Dict[str, str]:
            # The home rides from the first renew on, admitter or not: a
            # returning replica must tell an interim owner from a duplicate.
            out = {HOME_ANNOTATION: str(self.home_shard)}
            with self._lock:
                s = self._owned.get(shard_id)
            if s is None or s.admission is None:
                return out
            recs = [{"namespace": e["namespace"], "gang": e["gang"], "hosts": e["hosts"]}
                    for e in s.admission.reservations.snapshot()]
            raw = holdscodec.encode_holds(recs)
            if len(raw) > MAX_HOLDS_ANNOTATION_BYTES:
                # Past the ceiling: one aggregated record, which still
                # fences every card and loses only the own-gang exclusion.
                merged: Dict[str, int] = {}
                for r in recs:
                    for h, n in r["hosts"].items():
                        merged[h] = merged.get(h, 0) + int(n)
                raw = holdscodec.encode_holds([{"namespace": "", "gang": "", "hosts": merged}])
                if len(raw) > MAX_HOLDS_ANNOTATION_BYTES:
                    log.warning("shard %d holds overlay exceeds the annotation ceiling even "
                                "aggregated (%d hosts); publishing empty: the peers' /filter "
                                "loses sight of it for the scan window", shard_id, len(merged))
                    # Empty, not omitted: the lease's merge never deletes a
                    # key, so an omission would leave the last overlay
                    # fencing long-released cards.
                    raw = "[]"
            out[HOLDS_ANNOTATION] = raw
            return out

        return payload

    def _adopt_shard(self, shard_id: int, reason: str) -> None:
        """Take shard_id's lease and bring its admitter up. SecondReplica
        when a live holder exists (the caller decides: fail fast for the
        home shard, skip for a lost takeover race)."""
        lease = LeaderLease(self.client, namespace=self.lease_namespace,
                            name=shard_lease_name(shard_id, self.shards),
                            identity=self.identity, lease_seconds=self.lease_seconds,
                            on_lost=lambda: self._shard_lost(shard_id),
                            annotations_fn=self._holds_payload_fn(shard_id))
        # The observer's locally witnessed renewals decide liveness (the
        # clock-skew-safe takeover of leader.py).
        obs = self._observers.get(shard_id)
        if obs is not None:
            lease._observed = obs._observed
            lease._observed_at = obs._observed_at
        lease.start()
        owned = _OwnedShard(shard_id, lease)
        owned.phase = "replaying"
        with self._lock:
            self._owned[shard_id] = owned
            # _peer_holds[shard_id] stays: the dead shard's overlay shields
            # /filter until recover() below installs the replayed holds.
            self._unheld_since.pop(shard_id, None)
        metrics.SHARD_OWNED.set(1, shard=str(shard_id))
        metrics.SHARD_LEASE_AGE.set(0.0, shard=str(shard_id))
        if reason == "takeover":
            self.takeovers += 1
            metrics.SHARD_TAKEOVERS.inc(shard=str(shard_id))
            RECORDER.record("shard_takeover", f"took over shard {shard_id}'s admission lease",
                            shard=shard_id, identity=self.identity)
            log.warning("shard %d: lease taken over; replaying its journal", shard_id)
        try:
            admission = self.admitter_factory(shard_id, self.gang_filter_for(shard_id),
                                              self.topo_filter_for(shard_id))
            # The reserve observer's tap: a fresh fence reaches the lease's
            # annotation now (the publisher wakes), so the peers' staleness
            # is their scan interval alone. Chained in front of the
            # factory's observer (the journal's).
            prev_obs = admission.reservations.observer

            def tap(op, gang, payload, _prev=prev_obs):
                if _prev is not None:
                    _prev(op, gang, payload)
                if op == "reserve":
                    self._publish_wake.set()

            admission.reservations.observer = tap
            admission.recover()
            if self.auto_start:
                admission.start()
        except Exception:
            # A failed bring-up must not hold the lease hostage: the shard
            # would read owned but dead for a whole lease duration.
            with self._lock:
                self._owned.pop(shard_id, None)
            metrics.SHARD_OWNED.remove(shard=str(shard_id))
            metrics.SHARD_LEASE_AGE.remove(shard=str(shard_id))
            lease.stop()
            raise
        with self._lock:
            # One atomic step: the local table takes over the shielding as
            # the published overlay stops being read.
            owned.admission = admission
            owned.phase = "ready"
            self._peer_holds.pop(shard_id, None)

    def _shard_lost(self, shard_id: int) -> None:
        log.error("shard %d: admission lease lost", shard_id)
        with self._lock:
            s = self._owned.pop(shard_id, None)
        metrics.SHARD_OWNED.remove(shard=str(shard_id))
        metrics.SHARD_LEASE_AGE.remove(shard=str(shard_id))
        if self.on_shard_lost is not None:
            # The entry point's: an immediate exit.
            self.on_shard_lost(shard_id)
            return
        # The library's default: at least stop minting admissions.
        if s is not None and s.admission is not None:
            try:
                s.admission.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                log.exception("shard %d admission stop failed", shard_id)

    # -- the peer scan ------------------------------------------------------

    def _scan_loop(self) -> None:
        hb = profiling.HEARTBEATS.register("shard_scan", interval_s=self.scan_interval_s)
        last_scan = float("-inf")
        while not self._stop.is_set():
            remaining = self.scan_interval_s - (time.monotonic() - last_scan)
            woke = self._publish_wake.wait(max(0.05, remaining))
            if self._stop.is_set():
                return
            hb.beat()
            if woke:
                # A fresh reserve on an owned shard: publish its overlay now.
                self._publish_wake.clear()
                self.publish_holds()
            if time.monotonic() - last_scan >= self.scan_interval_s:
                last_scan = time.monotonic()
                try:
                    self.scan_once()
                except Exception as e:  # noqa: BLE001 - API-server noise: the
                    # takeover waits a beat
                    log.warning("shard scan failed: %s", e)

    def publish_holds(self) -> None:
        """Renew every owned shard's lease now, with the current overlay
        (the reserve observer's path). Racing the lease's own renew is
        benign: both writes carry fresh state."""
        with self._lock:
            leases = [s.lease for s in self._owned.values()]
        for lease in leases:
            try:
                lease._renew_once()
            except Exception as e:  # noqa: BLE001 - the renew loop retries
                log.debug("immediate hold publish failed: %s", e)

    def scan_once(self) -> None:
        """One pass over the shards: the owned shards' gauges, the foreign
        shards' overlays, the takeover of a shard whose lease is stale (a
        dead holder) or holder-less past the rollout grace, the handback of
        taken-over shards to their returning home replicas, and the retry
        of our own home while an interim owner holds it."""
        now = time.monotonic()
        with self._lock:
            owned_ids = set(self._owned)
            for s in self._owned.values():
                metrics.SHARD_LEASE_AGE.set(round(now - s.acquired_mono, 3),
                                            shard=str(s.shard_id))
        if self.home_shard not in owned_ids:
            # A genuine duplicate was screened at start(): SecondReplica
            # here only means "not yet".
            try:
                if self._try_adopt_home():
                    owned_ids.add(self.home_shard)
            except SecondReplica:
                pass
            except Exception as e:  # noqa: BLE001 - an API-server outage mid-
                # adoption: the rest of the scan must still run
                log.warning("home shard re-adoption failed: %s", e)
        for shard_id in sorted(owned_ids):
            if shard_id != self.home_shard and self._standby_claimant_live(shard_id):
                self._handback(shard_id)
                owned_ids.discard(shard_id)
        peer_chips = 0
        for shard_id in range(self.shards):
            if shard_id in owned_ids:
                continue
            obs = self._observers.get(shard_id)
            if obs is None:
                obs = LeaderLease(self.client, namespace=self.lease_namespace,
                                  name=shard_lease_name(shard_id, self.shards),
                                  identity=self.identity, lease_seconds=self.lease_seconds)
                self._observers[shard_id] = obs
            try:
                lease = self.client.get(obs._path)
            except Exception as e:  # noqa: BLE001 - a 404 and an outage differ:
                if getattr(e, "status_code", 0) == 404:
                    lease = None  # never created: no holds; the grace may take it
                else:
                    # A brownout: the last-known overlay keeps fencing, and
                    # no liveness can be judged from a failed read, so no
                    # takeover is decided for this shard either.
                    with self._lock:
                        stale = self._peer_holds.get(shard_id, [])
                    peer_chips += sum(int(n) for r in stale
                                      for n in (r.get("hosts") or {}).values())
                    continue
            spec = (lease or {}).get("spec") or {}
            holder = spec.get("holderIdentity", "")
            live = bool(holder) and obs._holder_is_live(spec)
            # The overlay is read whatever the holder's liveness: a dead
            # shard's fenced cards stay fenced until its successor replays.
            recs = self._parse_holds(lease)
            with self._lock:
                self._peer_holds[shard_id] = recs
            peer_chips += sum(int(n) for r in recs for n in (r.get("hosts") or {}).values())
            if live:
                self._unheld_since.pop(shard_id, None)
            if self.takeover and not live:
                if not holder:
                    # Holder-less: one lease of grace before scavenging, so
                    # a first rollout's own replica is not beaten to it.
                    first = self._unheld_since.setdefault(shard_id, time.monotonic())
                    if time.monotonic() - first < self.lease_seconds:
                        continue
                try:
                    self._adopt_shard(shard_id, reason="takeover")
                except SecondReplica:
                    continue  # a peer won the race: the designed outcome
                except Exception as e:  # noqa: BLE001 - the bring-up released
                    # the lease; retry next pass
                    log.warning("shard %d takeover failed: %s", shard_id, e)
        metrics.SHARD_PEER_HELD_CHIPS.set(peer_chips)

    @staticmethod
    def _parse_holds(lease: Optional[dict]) -> List[dict]:
        if not lease:
            return []
        ann = (lease.get("metadata") or {}).get("annotations") or {}
        # Either form, memoised by content digest (holdscodec); a corrupt
        # payload is the empty overlay.
        return holdscodec.decode_holds(ann.get(HOLDS_ANNOTATION, ""))

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """The /readyz ``shard`` payload and the /debug/shards body: the
        owned shards and each one's phase, and the peers' overlay ("up but
        owns nothing yet" and "ready" must read differently)."""
        with self._lock:
            owned = {str(s.shard_id): {"phase": s.phase,
                                       "lease_age_s": round(time.monotonic() - s.acquired_mono,
                                                            3)}
                     for s in self._owned.values()}
            peers = {str(shard): recs for shard, recs in self._peer_holds.items()
                     if shard not in self._owned or self._owned[shard].admission is None}
        return {
            "shards": self.shards,
            "home": self.home_shard,
            "owned": sorted(int(k) for k in owned),
            "shard_phases": owned,
            "takeovers": self.takeovers,
            # True while an interim owner holds our home and we stand by.
            "standby": self._standby is not None,
            "peer_holds": peers,
        }

    def home_admission(self):
        """The home shard's admitter (the auditor rides its loop, the one
        writer of its journal)."""
        with self._lock:
            s = self._owned.get(self.home_shard)
            return s.admission if s is not None else None

    def ticked_admissions(self) -> List[object]:
        """Every owned shard's admitter."""
        with self._lock:
            return [s.admission for s in self._owned.values() if s.admission is not None]

    def note_node_event(self, slice_keys, node: str = "") -> None:
        """Fan a node's change out to every owned shard's dirty marking (the
        index's on_change in the sharded entry point)."""
        for adm in self.ticked_admissions():
            adm.note_node_event(slice_keys, node=node)


# -- the self-test: two in-process shards, disjoint admission, one SIGKILLed
# and its gang admitted by the other's takeover.


class _Killed(BaseException):
    """A SIGKILL's stand-in: a BaseException tears through every best-effort
    handler as the process's death does."""


class _FakeKube:
    """The verbs GangAdmission and LeaderLease call, over dicts: nodes, gang
    pods and leases (``tests/fake_apiserver.py`` is the full one)."""

    def __init__(self):
        self.nodes: Dict[str, dict] = {}
        self.pods: Dict[Tuple[str, str], dict] = {}
        self.leases: Dict[str, dict] = {}
        self.kill_gate_patch_for: Set[str] = set()

    def list_nodes(self, **kw) -> dict:
        return {"items": list(self.nodes.values())}

    def list_pods(self, label_selector: str = "", **kw) -> dict:
        return {"items": [dict(p) for p in self.pods.values()]}

    def get_pod(self, ns: str, name: str) -> dict:
        return dict(self.pods[(ns, name)])

    def remove_pod_scheduling_gate(self, ns, name, gate, gates) -> None:
        from .gang import GANG_NAME_LABEL

        pod = self.pods[(ns, name)]
        if pod["metadata"]["labels"].get(GANG_NAME_LABEL, "") in self.kill_gate_patch_for:
            raise _Killed(f"SIGKILL before releasing {ns}/{name}")
        pod["spec"]["schedulingGates"] = [
            x for x in (pod["spec"].get("schedulingGates") or []) if x.get("name") != gate]

    def patch_pod_annotations(self, ns, name, ann) -> None:
        self.pods[(ns, name)].setdefault("metadata", {}).setdefault(
            "annotations", {}).update(ann)

    def get(self, path: str, **kw) -> dict:
        from ..kube.client import KubeError

        if path not in self.leases:
            raise KubeError(404, "lease not found")
        return json.loads(json.dumps(self.leases[path]))

    def create(self, collection: str, body: dict, **kw) -> dict:
        from ..kube.client import KubeError

        path = f"{collection}/{body['metadata']['name']}"
        if path in self.leases:
            raise KubeError(409, "already exists")
        self.leases[path] = json.loads(json.dumps(body))
        return body

    def replace(self, path: str, body: dict, **kw) -> dict:
        self.leases[path] = json.loads(json.dumps(body))
        return body


def pick_key(ring: ShardRing, shard: int, template: str) -> str:
    """The first instantiation of ``template`` (``str.format`` of 0, 1, ...)
    that ``ring`` puts on ``shard``: names a node or a gang so that it lands
    on a chosen shard, as the self-test and a drive of two replicas need."""
    for i in range(10000):
        key = template.format(i)
        if ring.shard_of(key) == shard:
            return key
    raise RuntimeError("keyspace search failed")


def self_test() -> int:
    """Two in-process shards over a fake API server: each admits only its
    own gang onto its own node; one is SIGKILLed mid-release, and the
    other's takeover replays its journal, re-fences with the original hold
    and admits its gang. Lockdep records the whole drive and must find no
    cycle."""
    import shutil
    import tempfile

    from ..api import constants
    from ..topology.schema import hgx_topology
    from .gang import GANG_NAME_LABEL, GANG_SIZE_LABEL, GATE_NAME, GangAdmission
    from .journal import AdmissionJournal
    from .reservations import ReservationTable

    base = tempfile.mkdtemp(prefix="shard-selftest-")
    profiling.LOCKDEP.enable()
    kube = _FakeKube()
    ring = ShardRing(2)
    # A node and a gang per shard, named where the ring puts them.
    hosts = [pick_key(ring, s, "host-{0:04d}-" + str(s)) for s in (0, 1)]
    gangs = [pick_key(ring, s, "default/gang-{0:04d}-" + str(s)).split("/", 1)[1]
             for s in (0, 1)]
    for host in hosts:
        kube.nodes[host] = {"metadata": {"name": host, "annotations": {
            constants.TOPOLOGY_ANNOTATION: hgx_topology(host, 4).to_json()}}}

    def add_gang(gang: str) -> None:
        for i in range(2):
            kube.pods[("default", f"{gang}-w{i}")] = {
                "metadata": {"name": f"{gang}-w{i}", "namespace": "default",
                             "labels": {GANG_NAME_LABEL: gang, GANG_SIZE_LABEL: "2"}},
                "spec": {"schedulingGates": [{"name": GATE_NAME}],
                         "containers": [{"name": "w", "resources": {
                             "limits": {constants.RESOURCE_NAME: "2"}}}]},
                "status": {"phase": "Pending"},
            }

    def gates_on(gang: str) -> int:
        return sum(1 for (_, name), p in kube.pods.items() if name.startswith(gang)
                   and any(g.get("name") == GATE_NAME
                           for g in (p["spec"].get("schedulingGates") or [])))

    try:
        add_gang(gangs[0])
        add_gang(gangs[1])

        def factory(shard_id, gang_filter, topo_filter):
            return GangAdmission(kube, reservations=ReservationTable(),
                                 journal=AdmissionJournal(f"{base}/shard-{shard_id}"),
                                 gang_filter=gang_filter, topo_filter=topo_filter,
                                 shard_id=shard_id)

        managers = []
        for s in (0, 1):
            m = ShardManager(kube, shards=2, home_shard=s, admitter_factory=factory,
                             identity=f"rep-{s}", lease_seconds=0.8, takeover=(s == 0),
                             auto_start=False)
            m._adopt_shard(s, reason="home")  # by hand: no scan thread
            managers.append(m)

        # Disjoint admission: each shard releases exactly its own gang.
        kube.kill_gate_patch_for.add(gangs[1])
        rel0 = managers[0].ticked_admissions()[0].tick()
        assert rel0 == [("default", gangs[0])], rel0
        assert gates_on(gangs[0]) == 0
        try:
            managers[1].ticked_admissions()[0].tick()
            raise AssertionError("kill point never fired")
        except _Killed:
            pass
        assert gates_on(gangs[1]) == 2  # died before any gate patch
        managers[1].abandon()  # the SIGKILL: a stale lease, the journal
        kube.kill_gate_patch_for.clear()

        # The takeover replays shard 1's journal (reserve and admit are
        # durable), re-fences and finishes the release.
        time.sleep(1.0)  # the 0.8 s lease ages out
        managers[0].scan_once()
        assert managers[0].owned_shards() == {0, 1}
        assert managers[0].takeovers == 1
        adopted = [a for a in managers[0].ticked_admissions() if a.shard_id == 1][0]
        held = adopted.reservations.held_by_host()
        assert sum(held.values()) == 4, held
        rel1 = adopted.tick()
        assert rel1 == [("default", gangs[1])], rel1
        assert gates_on(gangs[1]) == 0
        managers[0].stop()
        cycles = profiling.LOCKDEP.cycles()
        assert not cycles, f"lock-order inversions: {[c['nodes'] for c in cycles]}"
        print(json.dumps({"shard_self_test": "ok", "takeovers": 1, "lockdep_cycles": 0}))
        return 0
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m k8s_device_plugin_tpu_torch.extender.sharding",
        description="sharded gang admission's self-test")
    p.add_argument("--shard-self-test", action="store_true",
                   help="run the two-shard takeover drive in process and print its result")
    a = p.parse_args(argv)
    if a.shard_self_test:
        return self_test()
    p.print_help()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
