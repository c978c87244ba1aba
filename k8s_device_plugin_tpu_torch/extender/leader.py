"""The single-admitter fence: the JAX package's ``extender/leader.py``, a
coordination.k8s.io Lease the extender holds before it runs gang admission.

Gang admission keeps its reservation table in process memory. Two extender
replicas would each run an admitter over its own table, and the fence
between a gang's release and its scheduling would silently stop holding.
The Deployment pins ``replicas: 1``, but a manifest is a suggestion, so the
extender enforces it with kube's singleton primitive:

- On start it takes the Lease, or **exits nonzero** when another live holder
  exists: a second replica crash-loops loudly while the first is untouched.
- A holder whose ``renewTime`` is staler than the lease's duration is
  presumed dead and taken over (``leaseTransitions`` bumped); the journal's
  replay rebuilds the state, so a takeover needs no handoff.
- The holder renews on a background thread. A different live holder seen
  there fires ``on_lost``, which the entry point wires to a hard exit.
- The renew deadline (client-go's RenewDeadline, 2/3 of the lease by
  default): a holder that cannot renew within it demotes itself without
  waiting to see a competitor, so a partitioned holder stops admitting
  strictly before its lease can be taken over.
- ``stop()`` clears ``holderIdentity``, so a successor (the Deployment's
  Recreate rollout, a drain) acquires at once.
- Acquisition and takeover are create-or-replace with optimistic
  concurrency (resourceVersion): of two replicas racing one stale lease,
  the loser's PUT conflicts.

Holder liveness follows client-go's locally-observed model: once this
process has seen a holder's record, the holder is live exactly while its
``renewTime`` keeps changing within the lease's own
``spec.leaseDurationSeconds``, so clock skew between nodes cannot make a
renewing holder read as dead. Only the first sight of a holder compares its
``renewTime`` with the local clock.

The Lease is ``kube-system/nvidia-scheduler-extender``, the name the port's
manifest gives the extender, so a cluster that runs the JAX extender for its
TPU nodes and the port's for its GPU nodes has one admitter of each.
"""

from __future__ import annotations

import calendar
import os
import random
import socket
import threading
import time
from typing import Callable, Dict, Optional

from ..kube.client import KubeError, rfc3339_now
from ..utils import metrics, profiling
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger

log = get_logger(__name__)

LEASE_NAME = "nvidia-scheduler-extender"


class SecondReplica(RuntimeError):
    """Another live extender admitter already holds the lease."""


def default_identity() -> str:
    """The pod's name in kube (HOSTNAME), else host and pid, so two local
    processes still fence each other."""
    return os.environ.get("HOSTNAME") or f"{socket.gethostname()}-{os.getpid()}"


def _parse_rfc3339(s: str) -> float:
    """Epoch seconds of the API server's MicroTime or Time
    (``2026-07-31T12:00:00.123456Z``, ``...T12:00:00Z``); 0.0 when absent or
    malformed, which reads as infinitely stale: the safe direction, since a
    live holder renews within seconds."""
    if not s:
        return 0.0
    s = s.strip().rstrip("Z")
    frac = 0.0
    if "." in s:
        s, frac_s = s.split(".", 1)
        try:
            frac = float("0." + frac_s)
        except ValueError:
            frac = 0.0
    try:
        return calendar.timegm(time.strptime(s, "%Y-%m-%dT%H:%M:%S")) + frac
    except ValueError:
        return 0.0


class LeaderLease:
    """Acquire-or-die singleton lease with background renewal."""

    def __init__(
        self,
        client,
        namespace: str = "kube-system",
        name: str = LEASE_NAME,
        identity: str = "",
        lease_seconds: float = 30.0,
        renew_deadline_s: float = 0.0,
        on_lost: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.time,
        retry_jitter_s: float = 0.5,
        annotations_fn: Optional[Callable[[], Dict[str, str]]] = None,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.client = client
        self.namespace = namespace
        self.name = name
        self.identity = identity or default_identity()
        self.lease_seconds = lease_seconds
        # Bound of the jittered sleep after a lost optimistic-concurrency
        # race, so replicas racing one released lease do not conflict again
        # in lockstep; 0 retries at once. ``rng``/``sleep`` are for tests.
        self.retry_jitter_s = max(0.0, retry_jitter_s)
        self._rng = rng or random.Random()
        self._sleep = sleep
        # Optional publisher merged into the Lease's metadata.annotations on
        # every acquire and renew (the sharded plane of a later slice rides
        # its holds snapshot here); None costs nothing.
        self.annotations_fn = annotations_fn
        # client-go's convention: demote at 2/3 of the lease, strictly
        # before it can be taken over.
        self.renew_deadline_s = renew_deadline_s or lease_seconds * 2.0 / 3.0
        self.on_lost = on_lost
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_renew = 0.0
        # The holder record this process last saw, (holderIdentity,
        # renewTime), and when it saw it change.
        self._observed: Optional[tuple] = None
        self._observed_at = 0.0

    @property
    def _collection(self) -> str:
        return f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases"

    @property
    def _path(self) -> str:
        return f"{self._collection}/{self.name}"

    def _spec(self, transitions: int, acquire: bool) -> dict:
        now = rfc3339_now()
        spec = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_seconds),
            "renewTime": now,
            "leaseTransitions": transitions,
        }
        if acquire:
            spec["acquireTime"] = now
        return spec

    def _stamp_annotations(self, lease: dict) -> None:
        """Merge annotations_fn's payload into the lease's metadata.
        Best-effort: a raising publisher costs its overlay, never the
        renewal."""
        if self.annotations_fn is None:
            return
        try:
            extra = self.annotations_fn()
        except Exception as e:  # noqa: BLE001 - an overlay, not the fence
            log.warning("lease annotation publisher failed: %s", e)
            return
        if not extra:
            return
        meta = lease.setdefault("metadata", {})
        ann = meta.get("annotations")
        if not isinstance(ann, dict):
            ann = {}
            meta["annotations"] = ann
        ann.update(extra)

    def _race_lost(self, what: str) -> None:
        """One lost optimistic-concurrency round: count it and sleep a
        jittered beat before the re-read."""
        metrics.SHARD_ACQUIRE_CONFLICTS.inc()
        if self.retry_jitter_s > 0:
            delay = self._rng.uniform(0, self.retry_jitter_s)
            log.debug("lost %s race for %s/%s; retrying in %.3fs", what, self.namespace,
                      self.name, delay)
            self._sleep(delay)

    def _holder_is_live(self, spec: dict) -> bool:
        """A holder whose record this process saw change is live (a renewal
        observed locally, immune to clock skew); an unchanged record decays
        dead after the lease's own published duration. Only a first sight
        compares ``renewTime`` with the local clock."""
        duration = float(spec.get("leaseDurationSeconds") or self.lease_seconds)
        record = (spec.get("holderIdentity", ""), spec.get("renewTime", ""))
        now = self._clock()
        if record != self._observed:
            first_sight = self._observed is None or self._observed[0] != record[0]
            self._observed = record
            self._observed_at = now
            if not first_sight:
                return True  # the same holder, renewTime advanced: renewing
            live = (now - _parse_rfc3339(record[1])) < duration
            if not live:
                # Anchor the decay, so the next re-read of this unchanged
                # stale record does not bring it back.
                self._observed_at = now - duration
            return live
        return (now - self._observed_at) < duration

    # -- lifecycle ---------------------------------------------------------

    def acquire(self) -> None:
        """Take the lease or raise SecondReplica. One retry absorbs the
        create/replace race with a concurrent replica, whose freshly renewed
        lease then reads as live."""
        for attempt in (0, 1):
            try:
                lease = self.client.get(self._path)
            except KubeError as e:
                if e.status_code != 404:
                    raise
                body = {
                    "apiVersion": "coordination.k8s.io/v1",
                    "kind": "Lease",
                    "metadata": {"name": self.name, "namespace": self.namespace},
                    "spec": self._spec(transitions=0, acquire=True),
                }
                self._stamp_annotations(body)
                try:
                    self.client.create(self._collection, body)
                    return
                except KubeError as ce:
                    if ce.status_code == 409 and attempt == 0:
                        self._race_lost("create")
                        continue  # lost the create race: re-read
                    raise
            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity", "")
            if holder and holder != self.identity and self._holder_is_live(spec):
                age = self._clock() - _parse_rfc3339(spec.get("renewTime", ""))
                raise SecondReplica(f"lease {self.namespace}/{self.name} held by {holder!r} "
                                    f"(renewed {age:.0f}s ago)")
            taking_over = holder != self.identity
            if taking_over and holder:
                log.warning("taking over stale lease %s/%s from %r", self.namespace,
                            self.name, holder)
            lease["spec"] = self._spec(
                transitions=int(spec.get("leaseTransitions", 0)) + (1 if taking_over else 0),
                acquire=taking_over or not holder,
            )
            self._stamp_annotations(lease)
            try:
                self.client.replace(self._path, lease)
                return
            except KubeError as e:
                if e.status_code == 409 and attempt == 0:
                    self._race_lost("takeover")
                    continue  # lost the takeover race: re-read
                raise
        raise SecondReplica(f"lease {self.namespace}/{self.name}: lost two acquisition "
                            "races; another replica is live")

    def start(self) -> "LeaderLease":
        self.acquire()
        self._last_renew = self._clock()
        metrics.LEASE_HELD.set(1)
        # The journal's replay runs right after this: a flight dump from
        # the new holder shows when its leadership began.
        RECORDER.record("leader_acquired",
                        f"singleton lease {self.namespace}/{self.name} acquired",
                        identity=self.identity)
        self._thread = threading.Thread(
            target=profiling.supervised(f"lease_renew_{self.name}", self._renew_loop),
            name="extender-lease",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._release()

    def abandon(self) -> None:
        """Stop renewing without releasing, as a killed process does: the
        lease ages out and a successor takes it over after its decay."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _release(self) -> None:
        """Clear holderIdentity on a graceful stop, so the next pod acquires
        at once instead of crash-looping against this fresh renewTime.
        Best-effort and bounded tightly (a rollout waits on this exit): on
        failure the lease ages out."""
        try:
            lease = self.client.get(self._path, deadline_s=5.0, timeout=5.0)
            spec = lease.get("spec") or {}
            if spec.get("holderIdentity", "") != self.identity:
                return  # lost or taken over already: nothing of ours to free
            spec["holderIdentity"] = ""
            spec["renewTime"] = rfc3339_now()
            lease["spec"] = spec
            self.client.replace(self._path, lease, deadline_s=5.0, timeout=5.0)
            log.info("released lease %s/%s on shutdown", self.namespace, self.name)
        except Exception as e:  # noqa: BLE001 - teardown is best-effort
            log.warning("lease release on shutdown failed: %s", e)
        finally:
            metrics.LEASE_HELD.set(0)

    def _demote(self, reason: str, detail) -> None:
        log.error("lease lost (%s): %s", reason, detail)
        metrics.LEASE_HELD.set(0)
        metrics.LEASE_SELF_DEMOTIONS.inc(reason=reason)
        if self.on_lost is not None:
            self.on_lost()

    def _renew_wait_s(self, prev_wait: float, interval: float, failed: bool) -> float:
        """Decorrelated jitter for the renewal cadence (``next = min(cap,
        uniform(base, prev * 3))``), each instance on its own RNG, so
        replicas never renew, or retry a browned-out API server, in
        lockstep. A healthy renewal waits within [interval/2, interval]; a
        failed one within [interval/8, interval/2], so the demotion guard
        is evaluated more often. ``retry_jitter_s=0`` gives the fixed
        cadence."""
        if self.retry_jitter_s <= 0:
            return interval
        if failed:
            base = max(interval / 8.0, 0.05)
            cap = max(interval / 2.0, base)
        else:
            base = interval / 2.0
            cap = interval
        hi = max(min(prev_wait * 3.0, cap), base)
        return min(cap, self._rng.uniform(base, hi))

    def _renew_loop(self) -> None:
        # About three renewal attempts inside the renew deadline
        # (client-go's RetryPeriod).
        interval = max(min(self.lease_seconds / 3.0, self.renew_deadline_s / 3.0), 0.2)
        hb = profiling.HEARTBEATS.register(
            f"lease_renew_{self.name}", interval_s=interval,
            max_silence_s=profiling.default_max_silence(interval) + self.renew_deadline_s)
        # The first wake is jittered too.
        wait = self._renew_wait_s(interval, interval, failed=False)
        while not self._stop.wait(wait):
            hb.beat()
            # An attempt that blocked past the deadline must not buy another
            # attempt while the lease may already be takeover-able.
            unrenewed = self._clock() - self._last_renew
            if unrenewed > self.renew_deadline_s:
                self._demote("renew_deadline",
                             f"no successful renewal for {unrenewed:.1f}s "
                             f"(deadline {self.renew_deadline_s:.1f}s)")
                return
            try:
                self._renew_once()
                self._last_renew = self._clock()
                wait = self._renew_wait_s(wait, interval, failed=False)
            except SecondReplica as e:
                self._demote("lost_to_peer", e)
                return
            except Exception as e:  # noqa: BLE001 - transient API-server noise
                # must not kill the admitter; past the deadline, though, the
                # lease can no longer be proved ours.
                metrics.LEASE_RENEWAL_ERRORS.inc()
                unrenewed = self._clock() - self._last_renew
                if unrenewed > self.renew_deadline_s:
                    self._demote("renew_deadline",
                                 f"no successful renewal for {unrenewed:.1f}s "
                                 f"(deadline {self.renew_deadline_s:.1f}s): {e}")
                    return
                log.warning("lease renewal failed (will retry): %s", e)
                wait = self._renew_wait_s(wait, interval, failed=True)

    def _renew_once(self) -> None:
        # The retry envelope and the one request are both clamped to the
        # remaining renew budget: an attempt that outlived the deadline
        # could return only after the lease is already takeover-able.
        rem = max(0.5, self.renew_deadline_s - (self._clock() - self._last_renew))
        t_out = min(getattr(self.client, "timeout", rem) or rem, rem)
        lease = self.client.get(self._path, deadline_s=rem, timeout=t_out)
        if self._stop.is_set():
            # stop() may have released the lease after timing out on this
            # thread: a late renewal must not re-take what it freed.
            return
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        if holder != self.identity:
            # A released lease (empty holder) is re-taken; a live different
            # holder means it was lost.
            if holder and self._holder_is_live(spec):
                raise SecondReplica(f"now held by {holder!r}")
            log.warning("re-taking stale lease from %r", holder)
            lease["spec"] = self._spec(transitions=int(spec.get("leaseTransitions", 0)) + 1,
                                       acquire=True)
        else:
            spec["renewTime"] = rfc3339_now()
            lease["spec"] = spec
        self._stamp_annotations(lease)
        self.client.replace(self._path, lease, deadline_s=rem, timeout=t_out)
