"""The retry, backoff, deadline and circuit-breaker layer of the JAX
package's ``utils/resilience.py``, the plugin side: every REST call the
port's kube client makes (``kube/client.py``) flows through one
:class:`Resilience` instance per client, and through it the controller's
and the topology publisher's.

* **Jittered exponential backoff** between attempts, a **per-call
  deadline** across all of a call's attempts, **per-verb retry budgets**
  (token buckets), and a **circuit breaker** that fails fast after
  consecutive transport failures and lets one half-open probe through
  after its reset timeout.
* Retryable: transport errors (``OSError``, which covers every
  ``requests`` exception), HTTP 500/502/503/504, and truncated or garbled
  JSON bodies. Semantic answers (404/409/410/422/429) prove the API
  server alive: never retried, never counted by the breaker. A 429 or 503
  with ``Retry-After`` is retried no sooner than the server asked (capped)
  for idempotent calls; an Eviction (``idempotent=False``) gets exactly
  one attempt.
* Exhausted calls raise :class:`UnavailableError`, an ``OSError``, so the
  callers' ``except (KubeError, OSError)`` sites degrade without more.
* :class:`DegradedMode`, flipped by the breaker; :class:`PendingWrites`,
  the queue of state-publishing writes made while the API server is
  unreachable, delivered on reconnect.
* :data:`TRACKER`, the process-wide record of what the layer did: call
  outcomes, breaker windows, every successful mutation
  (``Resilience.call(mutating=True)``), watch resumes and relists, and the
  live ``DegradedMode`` of each daemon generation. ``/debug/resilience``
  serves it and the audit's ``degraded_consistency`` invariant reads it.

The metrics are the ``tpu_plugin_kube_*`` families of
``utils/metrics.py``. The extender's metric set and the hostile-apiserver
self-test come with the scheduler extender.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple
from .logging import get_logger

log = get_logger(__name__)

# HTTP statuses that indicate the apiserver (or a proxy in front of it)
# is unhealthy rather than answering: retryable, breaker-counted.
RETRYABLE_STATUS = frozenset({500, 502, 503, 504})

# Upper bound on how long a server-sent Retry-After may park one call:
# an apiserver (or an injected fault) asking for minutes must not eat a
# caller's whole deadline — past the cap our own backoff shape resumes.
RETRY_AFTER_CAP_S = 5.0

# Circuit states, as exported by the *_kube_circuit_state gauge.
CLOSED, OPEN, HALF_OPEN = 0, 1, 2

_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half-open"}


def retry_after_of(exc: BaseException) -> Optional[float]:
    """The server-requested retry delay carried by ``exc`` (KubeError
    parses the ``Retry-After`` header), or None."""
    v = getattr(exc, "retry_after_s", None)
    if v is None:
        return None
    try:
        return max(0.0, float(v))
    except (TypeError, ValueError):
        return None


class UnavailableError(OSError):
    """The API server could not be reached within the call's retry/
    deadline policy. Subclasses OSError on purpose: every existing
    ``except (KubeError, OSError)`` degradation site catches it."""


class CircuitOpenError(UnavailableError):
    """Failed fast: the circuit breaker is open (recent calls all died
    at the transport level) and the reset timeout has not elapsed."""


def retryable(exc: BaseException) -> bool:
    """Default failure classification (see module docstring)."""
    if isinstance(exc, UnavailableError):
        return False  # already a final verdict; never re-wrapped
    if isinstance(exc, OSError):  # covers all requests.* exceptions
        return True
    if isinstance(exc, json.JSONDecodeError):  # truncated/garbled body
        return True
    return getattr(exc, "status_code", None) in RETRYABLE_STATUS


def delay_for_attempt(
    attempt: int,
    base: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    rng: Callable[[], float] = random.random,
) -> float:
    """Jittered exponential delay for retry ``attempt`` (0-based): the
    deterministic bottom ``1 - jitter`` fraction plus a randomized top
    ``jitter`` fraction, capped at ``max_delay``. Shared by the
    Resilience loop, the controller workqueue, and wiring's conflict
    retry, so every backoff in the control plane has the same shape."""
    d = min(base * (2.0 ** attempt), max_delay)
    return d * (1.0 - jitter) + d * jitter * rng()


class Backoff:
    """Stateful escalating delay for long-lived retry loops (informer
    reconnect, node-cache relist, topology republish): ``next_delay()``
    escalates, ``reset()`` after any success."""

    def __init__(
        self,
        base: float = 0.5,
        max_delay: float = 30.0,
        jitter: float = 0.5,
        rng: Callable[[], float] = random.random,
    ):
        self.base = base
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = rng
        self._attempt = 0

    def next_delay(self) -> float:
        d = delay_for_attempt(
            self._attempt, self.base, self.max_delay, self.jitter, self._rng
        )
        self._attempt += 1
        return d

    def reset(self) -> None:
        self._attempt = 0


class RetryBudget:
    """Token bucket bounding retry amplification across a whole client:
    each RETRY (not first attempt) spends a token; refill is steady.
    When the bucket is dry the call fails over to UnavailableError
    immediately instead of multiplying load on a struggling apiserver."""

    def __init__(
        self,
        capacity: float = 20.0,
        refill_per_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.capacity = capacity
        self.refill_per_s = refill_per_s
        self._clock = clock
        self._tokens = capacity
        self._last = clock()
        self._lock = threading.Lock()

    def try_spend(self, amount: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.capacity,
                self._tokens + (now - self._last) * self.refill_per_s,
            )
            self._last = now
            if self._tokens >= amount:
                self._tokens -= amount
                return True
            return False


class CircuitBreaker:
    """Consecutive-transport-failure breaker with half-open probing.

    Semantic HTTP answers (any status the classifier calls
    non-retryable) count as SUCCESS here: a 404 proves the apiserver is
    alive, and the breaker only models reachability."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        on_state_change: Optional[Callable[[int], None]] = None,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._on_state_change = on_state_change
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _set_state(self, state: int) -> None:
        # Lock held by caller.
        if state != self._state:
            self._state = state
            if self._on_state_change is not None:
                self._on_state_change(state)

    def allow(self) -> bool:
        """True when a call may proceed. In the open state, exactly one
        probe is admitted once ``reset_timeout_s`` has elapsed."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if (
                self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s
            ):
                self._set_state(HALF_OPEN)
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                # The probe died: back to open, fresh reset window.
                self._probe_in_flight = False
                self._opened_at = self._clock()
                self._set_state(OPEN)
            elif (
                self._state == CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._set_state(OPEN)


# The most successful mutating calls the tracker remembers.
MAX_MUTATIONS = 4096


class ResilienceTracker:
    """Process-global record of what the resilience layer did: the source
    of ``/debug/resilience`` and of the ``degraded_consistency`` audit
    invariant (audit.py).

    Tracks, under one lock: per-(verb, outcome) call counts, breaker
    open/close windows (monotonic clock), every successful mutating call
    (timestamp and verb, bounded ring), watch stream outcomes (resumed vs.
    relist), and the attached :class:`DegradedMode` instances, one per live
    daemon generation (a generation's teardown detaches its own).
    ``mutations_while_open()`` is the invariant's evidence and must always
    be empty: a mutation landing while the breaker was open means some call
    site bypassed the wrapper."""

    def __init__(self):
        self._lock = threading.Lock()
        self._outcomes: Dict[Tuple[str, str], int] = {}
        self._mutations: "collections.deque" = collections.deque(maxlen=MAX_MUTATIONS)
        # [open_ts, close_ts or None]: the live window has close None.
        self._windows: List[List[Optional[float]]] = []
        self._watch = {"resumed": 0, "relist": 0}
        self._degraded: List["DegradedMode"] = []
        self._retries_honoring_retry_after = 0

    def reset(self) -> None:
        """Tests only: a fresh slate between scenarios."""
        with self._lock:
            self._outcomes.clear()
            self._mutations.clear()
            self._windows.clear()
            self._watch = {"resumed": 0, "relist": 0}
            self._degraded.clear()
            self._retries_honoring_retry_after = 0

    def record_outcome(self, verb: str, outcome: str) -> None:
        with self._lock:
            key = (verb or "call", outcome)
            self._outcomes[key] = self._outcomes.get(key, 0) + 1

    def record_retry_after(self) -> None:
        with self._lock:
            self._retries_honoring_retry_after += 1

    def record_mutation(self, verb: str) -> None:
        with self._lock:
            self._mutations.append((time.monotonic(), verb or "call"))

    def record_circuit(self, state: int) -> None:
        with self._lock:
            now = time.monotonic()
            live = self._windows and self._windows[-1][1] is None
            if state == OPEN and not live:
                self._windows.append([now, None])
            elif state == CLOSED and live:
                self._windows[-1][1] = now
            # HALF_OPEN keeps the current window: the probe phase is still
            # "open" for the no-mutations contract.

    def record_watch(self, outcome: str) -> None:
        with self._lock:
            if outcome in self._watch:
                self._watch[outcome] += 1

    def attach_degraded(self, dm: "DegradedMode") -> None:
        with self._lock:
            if dm not in self._degraded:
                self._degraded.append(dm)

    def detach_degraded(self, dm: "DegradedMode") -> None:
        """Forget a generation's mode once that generation is torn down, so
        that a daemon rebuilt on every SIGHUP keeps one entry, not one per
        rebuild."""
        with self._lock:
            if dm in self._degraded:
                self._degraded.remove(dm)

    def breaker_open(self) -> bool:
        with self._lock:
            return bool(self._windows) and self._windows[-1][1] is None

    def mutations_while_open(self) -> List[Tuple[float, str]]:
        """Mutations whose success timestamp falls inside any breaker open
        window: the degraded_consistency invariant's evidence (always
        expected empty)."""
        with self._lock:
            windows = [list(w) for w in self._windows]
            muts = list(self._mutations)
        now = time.monotonic()
        bad = []
        for ts, verb in muts:
            for opened, closed in windows:
                if opened <= ts <= (closed if closed is not None else now):
                    bad.append((ts, verb))
                    break
        return bad

    def snapshot(self) -> dict:
        """The /debug/resilience payload."""
        with self._lock:
            now = time.monotonic()
            outcomes: Dict[str, Dict[str, int]] = {}
            for (verb, outcome), n in sorted(self._outcomes.items()):
                outcomes.setdefault(verb, {})[outcome] = n
            windows = [
                {
                    "opened_s_ago": round(now - o, 3),
                    "closed_s_ago": round(now - c, 3) if c is not None else None,
                }
                for o, c in self._windows[-16:]
            ]
            degraded = list(self._degraded)
            mutations = len(self._mutations)
            watch = dict(self._watch)
            retry_after = self._retries_honoring_retry_after
        return {
            "call_outcomes": outcomes,
            "circuit_windows": windows,
            "breaker_open": bool(windows) and windows[-1]["closed_s_ago"] is None,
            "watch_streams": watch,
            "mutations_recorded": mutations,
            "mutations_while_open": len(self.mutations_while_open()),
            "retries_honoring_retry_after": retry_after,
            "degraded": [d.snapshot() for d in degraded],
        }


#: The one tracker every Resilience instance reports into (one daemon a
#: process).
TRACKER = ResilienceTracker()


class DegradedMode:
    """Explicit consumer-facing degraded state, flipped by the circuit
    breaker: while active, consumers serve their last-known-good view
    and ``staleness_s()`` (age of the last successful sync,
    ``mark_fresh()``) is exported. Beyond ``staleness_cap_s`` the mode
    turns ``paused``: acting on a view that stale is worse than not
    acting. In the node daemon the controller marks it fresh on every
    relist and skips its eviction sweep while it is active. It attaches
    itself to :data:`TRACKER`; the daemon detaches each generation's mode
    at teardown."""

    def __init__(
        self,
        staleness_cap_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
        gauge=None,
        staleness_gauge=None,
    ):
        self.staleness_cap_s = staleness_cap_s
        self.name = name or "kube"
        self._clock = clock
        self._gauge = gauge
        self._staleness_gauge = staleness_gauge
        self._lock = threading.Lock()
        self._active = False
        self._entered_at = 0.0
        self._last_good = clock()
        self._entries = 0
        TRACKER.attach_degraded(self)

    def on_circuit_state(self, state: int) -> None:
        """Breaker callback: OPEN enters degraded mode, CLOSED exits.
        HALF_OPEN stays degraded — the probe hasn't proven anything."""
        if state == OPEN:
            self.enter("circuit_open")
        elif state == CLOSED:
            self.exit("circuit_closed")

    def _transition(self, active: bool, reason: str) -> None:
        from .flightrecorder import RECORDER
        from .decisions import LEDGER

        if self._gauge is not None:
            self._gauge.set(1 if active else 0)
        word = "entered" if active else "exited"
        log.warning(
            "%s consumers %s degraded mode (%s)", self.name, word, reason
        )
        RECORDER.record(
            "degraded_mode",
            f"{self.name} consumers {word} degraded mode",
            state="degraded" if active else "normal",
            reason=reason,
        )
        LEDGER.record(
            "resilience",
            f"degraded_{'enter' if active else 'exit'}",
            f"{self.name} consumers {word} degraded mode ({reason})",
        )

    def enter(self, reason: str = "manual") -> None:
        with self._lock:
            if self._active:
                return
            self._active = True
            self._entered_at = self._clock()
            self._entries += 1
        self._transition(True, reason)

    def exit(self, reason: str = "manual") -> None:
        with self._lock:
            if not self._active:
                return
            self._active = False
        self._transition(False, reason)

    def mark_fresh(self) -> None:
        """A successful sync of the consumer's view of cluster state
        (relist, watch event applied) — resets the staleness clock."""
        with self._lock:
            self._last_good = self._clock()
        if self._staleness_gauge is not None:
            self._staleness_gauge.set(0.0)

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def staleness_s(self) -> float:
        with self._lock:
            age = self._clock() - self._last_good
        if self._staleness_gauge is not None:
            self._staleness_gauge.set(round(age, 3))
        return age

    @property
    def paused(self) -> bool:
        """True when degraded AND the last-known-good view is older
        than the cap: serving stops being better than not serving."""
        return self.active and self.staleness_s() > self.staleness_cap_s

    def snapshot(self) -> dict:
        with self._lock:
            active = self._active
            entered = self._entered_at
            entries = self._entries
            age = self._clock() - self._last_good
        return {
            "name": self.name,
            "active": active,
            "entries": entries,
            "active_for_s": (
                round(self._clock() - entered, 3) if active else 0.0
            ),
            "staleness_s": round(age, 3),
            "staleness_cap_s": self.staleness_cap_s,
            "paused": active and age > self.staleness_cap_s,
        }


@dataclasses.dataclass
class RetryPolicy:
    """Per-call attempt/backoff/deadline envelope."""

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 2.0
    jitter: float = 0.5
    # Wall-clock budget for ONE logical call across all its attempts
    # (sleeps included). Sized above a couple of request timeouts so a
    # hanging apiserver costs bounded time, not max_attempts * timeout.
    deadline_s: float = 20.0


@dataclasses.dataclass
class ResilienceMetrics:
    """The metric objects one Resilience instance feeds
    (``plugin_metrics`` is the node daemon's set)."""

    retries: object  # Metric counter, labeled by verb
    circuit_state: object  # Metric gauge
    latency: object  # Histogram, labeled by verb + outcome
    # Counter labeled verb + outcome (ok / retry / retry_after /
    # semantic / unavailable / circuit_open) — the Grafana "retry rate
    # by verb/outcome" panel. None tolerated (older hand-built sets).
    outcomes: object = None
    degraded: object = None  # gauge: 1 while consumers run degraded
    staleness: object = None  # gauge: degraded-serving staleness age
    watch_streams: object = None  # counter labeled outcome


def plugin_metrics() -> ResilienceMetrics:
    from . import metrics

    return ResilienceMetrics(
        retries=metrics.KUBE_RETRIES,
        circuit_state=metrics.KUBE_CIRCUIT_STATE,
        latency=metrics.KUBE_REQUEST_LATENCY,
        outcomes=metrics.KUBE_CALL_OUTCOMES,
        degraded=metrics.KUBE_DEGRADED_MODE,
        staleness=metrics.KUBE_DEGRADED_STALENESS,
        watch_streams=metrics.KUBE_WATCH_STREAMS,
    )


def extender_metrics() -> ResilienceMetrics:
    """The scheduler extender's set, on its own registry."""
    from . import metrics

    return ResilienceMetrics(
        retries=metrics.EXT_KUBE_RETRIES,
        circuit_state=metrics.EXT_KUBE_CIRCUIT_STATE,
        latency=metrics.EXT_KUBE_REQUEST_LATENCY,
        outcomes=metrics.EXT_KUBE_CALL_OUTCOMES,
        degraded=metrics.EXT_KUBE_DEGRADED_MODE,
        staleness=metrics.EXT_KUBE_DEGRADED_STALENESS,
        watch_streams=metrics.EXT_KUBE_WATCH_STREAMS,
    )


# Thread-local marker proving a frame is executing inside Resilience.call
# — tests/test_chaos.py wraps the HTTP session with it to assert that NO
# kube/client.py request site bypasses the resilience layer.
_ACTIVE = threading.local()


def in_resilient_call() -> bool:
    return getattr(_ACTIVE, "depth", 0) > 0


class Resilience:
    """One retry/backoff/deadline/circuit pipeline, shared by every
    call of one KubeClient (kube/client.py constructs a default)."""

    def __init__(
        self,
        policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        budget: Optional[RetryBudget] = None,
        metrics: Optional[ResilienceMetrics] = None,
        classify: Callable[[BaseException], bool] = retryable,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        degraded: Optional[DegradedMode] = None,
    ):
        self.policy = policy or RetryPolicy()
        self.metrics = metrics if metrics is not None else plugin_metrics()
        self.breaker = breaker or CircuitBreaker(
            on_state_change=self._on_circuit_change
        )
        if breaker is not None and breaker._on_state_change is None:
            breaker._on_state_change = self._on_circuit_change
        # Template bucket: per-verb buckets below clone its shape, so a
        # LIST retry storm can't starve lease-renew (PUT) of budget.
        self.budget = budget or RetryBudget()
        self._verb_budgets: Dict[str, RetryBudget] = {}
        self._budget_lock = threading.Lock()
        self.classify = classify
        self._clock = clock
        self._sleep = sleep
        # Consumer-facing degraded state driven by this breaker
        # (entrypoints wire one; None = nobody to flip).
        self.degraded = degraded

    def _budget_for(self, verb: str) -> RetryBudget:
        if not verb:
            return self.budget
        with self._budget_lock:
            b = self._verb_budgets.get(verb)
            if b is None:
                b = RetryBudget(
                    capacity=self.budget.capacity,
                    refill_per_s=self.budget.refill_per_s,
                    clock=self.budget._clock,
                )
                self._verb_budgets[verb] = b
            return b

    def _on_circuit_change(self, state: int) -> None:
        """Gauge update plus flight-recorder and ledger records of the
        transition, and on a move to OPEN the ring's dump to the flight
        dir (``circuit-break``)."""
        self.metrics.circuit_state.set(state)
        TRACKER.record_circuit(state)
        from .flightrecorder import RECORDER
        from .decisions import LEDGER

        RECORDER.record(
            "circuit_state",
            "kube API circuit breaker state changed",
            state=_STATE_NAMES[state],
        )
        if state in (OPEN, CLOSED):
            LEDGER.record(
                "resilience",
                "breaker_open" if state == OPEN else "breaker_close",
                f"kube API circuit breaker {_STATE_NAMES[state]}",
            )
        if self.degraded is not None:
            self.degraded.on_circuit_state(state)
        if state == OPEN and RECORDER.enabled and RECORDER.dump_dir:
            # This callback runs under the breaker's lock, which every kube
            # call takes: the disk write goes to its own thread, or a slow
            # volume would stall every kube-calling thread while the API
            # server is already down. A one-shot write, not a loop, so it is
            # not supervised.
            threading.Thread(target=RECORDER.dump_on, args=("circuit-break",),
                             name="flight-dump", daemon=True).start()

    def _outcome(self, verb: str, outcome: str) -> None:
        TRACKER.record_outcome(verb, outcome)
        if self.metrics.outcomes is not None:
            self.metrics.outcomes.inc(verb=verb or "call", outcome=outcome)

    def call(
        self,
        fn: Callable[[], object],
        verb: str = "",
        deadline_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
        idempotent: bool = True,
        mutating: bool = False,
    ):
        """Run ``fn`` under the policy. Semantic errors (non-retryable)
        propagate unchanged on the first attempt; transport-level
        failures are retried with jittered backoff until attempts,
        deadline, or the per-verb retry budget run out — then
        UnavailableError.

        ``idempotent=False`` marks a mutation that must NEVER blind-
        retry (Eviction): one attempt, breaker-gated, every failure
        surfaces to the caller. ``mutating=True`` records each SUCCESS in
        :data:`TRACKER`, so the ``degraded_consistency`` audit invariant
        can prove no mutation landed while the breaker was open. A 429/503
        carrying Retry-After is (for idempotent calls)
        retried no sooner than the server asked, capped at
        ``RETRY_AFTER_CAP_S`` and the call deadline.

        When tracing is enabled AND this call runs inside an open span,
        the whole logical call (attempts + backoff sleeps) becomes a
        ``kube.<verb>`` child span — every kube round-trip an
        allocation's journey makes is a child of that journey's trace.
        Root spans are deliberately NOT minted here: background relists
        and watches outside any trace stay span-free.
        """
        from . import tracing

        if tracing.enabled() and tracing.current() is not None:
            with tracing.span(f"kube.{verb or 'call'}") as sp:
                result = self._call_inner(
                    fn, verb, deadline_s, max_attempts, idempotent, mutating
                )
                if sp is not None:
                    sp.set(outcome="ok")
                return result
        return self._call_inner(fn, verb, deadline_s, max_attempts, idempotent, mutating)

    def _call_inner(
        self,
        fn: Callable[[], object],
        verb: str = "",
        deadline_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
        idempotent: bool = True,
        mutating: bool = False,
    ):
        if not self.breaker.allow():
            self._outcome(verb, "circuit_open")
            raise CircuitOpenError(
                "kube API circuit open (recent calls failed at the "
                "transport level); failing fast until the reset probe"
            )
        deadline = self._clock() + (
            self.policy.deadline_s if deadline_s is None else deadline_s
        )
        # Non-idempotent mutations get exactly ONE attempt: a transport
        # error leaves "did it land?" unknown, and re-sending (e.g. an
        # Eviction) could double-apply. The caller's level-triggered
        # reconcile owns the retry.
        attempts = (
            1 if not idempotent
            else (max_attempts or self.policy.max_attempts)
        )
        last: Optional[BaseException] = None
        _ACTIVE.depth = getattr(_ACTIVE, "depth", 0) + 1
        try:
            for attempt in range(attempts):
                t0 = self._clock()
                try:
                    result = fn()
                except Exception as e:  # noqa: BLE001 — classified below
                    self.metrics.latency.observe(
                        self._clock() - t0, verb=verb, outcome="error"
                    )
                    if not self.classify(e):
                        # Semantic answer: the apiserver is alive.
                        self.breaker.record_success()
                        ra = retry_after_of(e)
                        if (
                            ra is not None
                            and getattr(e, "status_code", None) == 429
                            and idempotent
                            and attempt + 1 < attempts
                        ):
                            # Server-directed retry: the apiserver is
                            # shedding load and told us when to come
                            # back. Still budget- and deadline-gated.
                            delay = min(ra, RETRY_AFTER_CAP_S)
                            if (
                                self._clock() + delay < deadline
                                and self._budget_for(verb).try_spend()
                            ):
                                last = e
                                self._retry_sleep(
                                    verb, delay, "retry_after"
                                )
                                continue
                        self._outcome(verb, "semantic")
                        raise
                    self.breaker.record_failure()
                    last = e
                    if not self.breaker.allow():
                        break  # tripped mid-call: stop hammering
                    if attempt + 1 >= attempts:
                        break
                    delay = delay_for_attempt(
                        attempt,
                        self.policy.base_delay_s,
                        self.policy.max_delay_s,
                        self.policy.jitter,
                    )
                    ra = retry_after_of(e)
                    if ra is not None:
                        # A 503 with Retry-After: wait at least what
                        # the server asked (capped), never less.
                        delay = max(delay, min(ra, RETRY_AFTER_CAP_S))
                    if self._clock() + delay >= deadline:
                        break
                    if not self._budget_for(verb).try_spend():
                        log.warning(
                            "kube retry budget exhausted; failing %s fast",
                            verb or "call",
                        )
                        from .decisions import LEDGER

                        LEDGER.record(
                            "resilience",
                            "retry_budget_exhausted",
                            f"retry budget dry for {verb or 'call'}; "
                            "failing fast",
                        )
                        break
                    self._retry_sleep(verb, delay, "retry")
                else:
                    self.metrics.latency.observe(
                        self._clock() - t0, verb=verb, outcome="ok"
                    )
                    self.breaker.record_success()
                    self._outcome(verb, "ok")
                    if mutating:
                        TRACKER.record_mutation(verb)
                    return result
        finally:
            _ACTIVE.depth -= 1
        self._outcome(verb, "unavailable")
        raise UnavailableError(
            f"kube API unavailable after {attempts} attempt(s) for "
            f"{verb or 'call'}: {last}"
        ) from last

    def _retry_sleep(self, verb: str, delay: float, reason: str) -> None:
        """One retry pause: counted (metrics and tracker), flight-
        recorded (the ring is exactly where a retry storm's shape
        matters post-mortem), then slept."""
        from .flightrecorder import RECORDER

        self.metrics.retries.inc(verb=verb)
        self._outcome(verb, reason)
        if reason == "retry_after":
            TRACKER.record_retry_after()
        RECORDER.record(
            "kube_retry",
            f"kube {verb or 'call'} retrying in {delay * 1000:.0f}ms",
            verb=verb or "call",
            reason=reason,
            delay_ms=round(delay * 1000, 1),
        )
        self._sleep(delay)


class PendingWrites:
    """Degradation queue for state-publishing writes: a patch that
    cannot reach the apiserver is parked here (deduped by key, newest
    wins — a newer annotation value for the same pod supersedes the
    queued one) and replayed by ``drain()`` once connectivity returns.

    Drain semantics: success or a SEMANTIC error (pod deleted → 404)
    removes the entry; another UnavailableError stops the drain and
    keeps the remainder for the next reconnect. Bounded: past
    ``max_items`` the oldest entry is dropped loudly — unbounded growth
    during a long partition would be its own outage."""

    def __init__(self, max_items: int = 1000, gauge=None):
        self.max_items = max_items
        self._gauge = gauge
        self._lock = threading.Lock()
        self._items: "Dict[object, Tuple[Callable[[], object], str]]" = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def _publish_depth(self) -> None:
        if self._gauge is not None:
            self._gauge.set(len(self._items))

    def put(self, key, fn: Callable[[], object], describe: str = "") -> None:
        with self._lock:
            self._items.pop(key, None)  # newest wins, moves to the end
            self._items[key] = (fn, describe or str(key))
            while len(self._items) > self.max_items:
                dropped_key = next(iter(self._items))
                _, desc = self._items.pop(dropped_key)
                log.error(
                    "pending-write queue full (%d); dropped oldest: %s",
                    self.max_items, desc,
                )
            self._publish_depth()

    def discard(self, key) -> None:
        with self._lock:
            self._items.pop(key, None)
            self._publish_depth()

    def _discard_entry(self, key, fn: Callable[[], object]) -> None:
        """Remove ``key`` only if it still holds the SAME queued fn:
        a writer may have put() a newer value for the key while drain()
        was delivering this one — unconditional discard would silently
        drop that newer write (lost update)."""
        with self._lock:
            cur = self._items.get(key)
            if cur is not None and cur[0] is fn:
                del self._items[key]
            self._publish_depth()

    def drain(self) -> Tuple[int, int]:
        """(delivered, kept). Runs the queued writes in FIFO order."""
        with self._lock:
            batch: List[Tuple[object, Callable[[], object], str]] = [
                (k, fn, desc) for k, (fn, desc) in self._items.items()
            ]
        delivered = 0
        for key, fn, desc in batch:
            try:
                fn()
            except UnavailableError as e:
                log.warning(
                    "pending-write drain stopped (apiserver still "
                    "unreachable at %s): %s", desc, e,
                )
                break
            except Exception as e:  # noqa: BLE001 — semantic failure:
                # the target is gone or the write is no longer valid;
                # keeping it would wedge the queue forever.
                log.warning("pending write %s dropped: %s", desc, e)
                self._discard_entry(key, fn)
            else:
                delivered += 1
                log.info("queued write delivered: %s", desc)
                self._discard_entry(key, fn)
        return delivered, len(self)
