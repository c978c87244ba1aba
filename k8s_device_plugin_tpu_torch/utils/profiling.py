"""The JAX package's ``utils/profiling.py`` for the port: the workload's
profiler trace of a block (``trace``) and named regions inside it
(``annotate``); and the node daemon's runtime-performance plane:

- handler timing (``timed``);
- loop liveness (``Heartbeat``, ``HEARTBEATS``) and the supervised thread
  target (``supervised``, ``run_supervised``) that makes a background
  loop's death loud, with the registry's snapshot that the audit's
  ``thread_liveness`` invariant reads;
- the :class:`StallWatchdog`, which exports every heartbeat's age as
  ``tpu_thread_heartbeat_age_seconds{loop}`` and turns a silent loop into
  ``tpu_loop_stall_total{loop,reason="stalled"}``, a ``loop_stall`` flight
  event and its ``on_stall`` hook;
- GC pauses (``gc.callbacks`` into ``tpu_gc_pause_seconds``);
- the runtime lock-order graph (:class:`LockdepGraph`, :data:`LOCKDEP`) fed
  by :class:`TimedLock`, whose cycles the audit's ``lock_order`` invariant
  pages on;
- the SLO capture (:class:`CaptureManager`, :data:`CAPTURE`): a windowed
  p99 per hot RPC (``Allocate``) and, on its crossing of
  ``--capture-p99-ms`` or on a heartbeat stall, one bundle on disk with the
  last minute of profile samples (``utils/stackprof.py``), the flight ring,
  the ledger tail, the heartbeat table and a metrics snapshot.

Everything is off by default behind one cheap check: no watchdog thread
without ``StallWatchdog.start()``, no capture evaluation without a capture
dir, no GC callback without :func:`enable_gc_monitor`, no lockdep
bookkeeping without ``LOCKDEP.enable()``.

The node daemon imports this module and never touches the card, so
``torch`` is imported only inside the workload's two functions.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import os
import threading
import time
from collections.abc import Callable, Iterator
from typing import Dict, List, Optional, Set

from .logging import get_logger

log = get_logger(__name__)

# The name this process reports under (the capture bundles' and the
# profiler's ``service``), set once by the entry point.
_SERVICE = "plugin"


def set_service(service: str) -> None:
    global _SERVICE
    _SERVICE = service


@contextlib.contextmanager
def timed(histogram, **labels) -> Iterator[None]:
    """Observe the block's wall time into ``histogram`` (required: each
    caller names its registry's histogram, e.g. ``metrics.RPC_LATENCY``)."""
    if histogram is None or not hasattr(histogram, "observe"):
        raise TypeError("timed() requires an explicit Histogram (e.g. metrics.RPC_LATENCY)")
    start = time.monotonic()
    try:
        yield
    finally:
        histogram.observe(time.monotonic() - start, **labels)


@contextlib.contextmanager
def trace(trace_dir: str | None) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (host, and the card's
    kernels when CUDA is up) and write the trace into ``trace_dir`` as a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin and Chrome's
    trace viewer load. No-op when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(trace_dir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler):
        yield


def annotate(name: str) -> "torch.profiler.record_function":
    """A named region inside an active trace (``record_function``); costs
    next to nothing outside one."""
    import torch

    return torch.profiler.record_function(name)


class Heartbeat:
    """One long-lived loop's liveness record. The loop calls :meth:`beat`
    once per iteration; everyone else reads :meth:`age_s`.
    ``max_silence_s`` is the loop's own stall threshold."""

    def __init__(self, name: str, interval_s: float, max_silence_s: float):
        self.name = name
        self.interval_s = interval_s
        self.max_silence_s = max_silence_s
        self.beats = 0
        self.dead = False
        self.dead_reason = ""
        self._last = time.monotonic()

    def beat(self) -> None:
        self._last = time.monotonic()
        self.beats += 1
        if self.dead:
            # The loop restarted: death clears on the first new beat.
            self.dead = False
            self.dead_reason = ""

    def age_s(self) -> float:
        return time.monotonic() - self._last

    def mark_dead(self, reason: str = "died") -> None:
        self.dead = True
        self.dead_reason = reason

    def stalled(self) -> bool:
        return self.dead or self.age_s() > self.max_silence_s

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "interval_s": round(self.interval_s, 3),
            "max_silence_s": round(self.max_silence_s, 3),
            "age_s": round(self.age_s(), 3),
            "beats": self.beats,
            "dead": self.dead,
            "dead_reason": self.dead_reason,
        }


def default_max_silence(interval_s: float) -> float:
    """Several missed intervals, floored generously: one slow tick must
    never read as a stall."""
    return max(4.0 * max(interval_s, 0.0), 15.0)


class HeartbeatRegistry:
    """Process-global loop registry (one daemon per process).
    Re-registering an existing name revives it: a restarted loop clears
    its own death."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beats: Dict[str, Heartbeat] = {}

    def register(self, name: str, interval_s: float = 1.0,
                 max_silence_s: Optional[float] = None) -> Heartbeat:
        silence = default_max_silence(interval_s) if max_silence_s is None else max_silence_s
        with self._lock:
            hb = self._beats.get(name)
            if hb is None:
                hb = Heartbeat(name, interval_s, silence)
                self._beats[name] = hb
            else:
                hb.interval_s = interval_s
                hb.max_silence_s = silence
                hb.beat()
            return hb

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def get(self, name: str) -> Optional[Heartbeat]:
        with self._lock:
            return self._beats.get(name)

    def snapshot(self) -> List[dict]:
        """Every registered loop's record (the ``thread_liveness`` audit
        invariant reads it)."""
        with self._lock:
            return [hb.to_dict() for hb in self._beats.values()]


HEARTBEATS = HeartbeatRegistry()


def run_supervised(name: str, fn: Callable[[], None]) -> None:
    """Thread-target wrapper: a loop that raises out of its body is logged
    with the traceback, counted as ``tpu_loop_stall_total{loop,
    reason="died"}``, flight-recorded, and its heartbeat marked dead. A
    clean return unregisters the heartbeat: a stopped loop is not a stalled
    one."""
    try:
        fn()
    except Exception:  # noqa: BLE001 - the whole point
        log.exception("supervised loop %r died", name)
        hb = HEARTBEATS.get(name) or HEARTBEATS.register(name)
        hb.mark_dead("died")
        try:
            from . import metrics
            from .flightrecorder import RECORDER

            metrics.family("LOOP_STALLS", _SERVICE).inc(loop=name, reason="died")
            RECORDER.record(
                "loop_stall",
                f"background loop {name} died from an unhandled "
                f"exception (see logs for the traceback)",
                loop=name,
                reason="died",
                state="detected",
            )
        except Exception:  # noqa: BLE001 - reporting must not re-raise
            pass
        return
    HEARTBEATS.unregister(name)


def supervised(name: str, fn: Callable[[], None]) -> Callable[[], None]:
    """``threading.Thread(target=supervised("x", self._loop))``."""
    return lambda: run_supervised(name, fn)


class StallWatchdog:
    """Exports every heartbeat's age and turns silence into signal.

    One thread at ``check_interval_s``: each check publishes
    ``tpu_thread_heartbeat_age_seconds{loop}`` for every registered loop
    (pruning the series of unregistered ones), and on each loop's stall
    crossing (age past its ``max_silence_s``, or marked dead) counts
    ``tpu_loop_stall_total{loop,reason="stalled"}`` (death is counted when
    it happens, by :func:`run_supervised`), flight-records a ``loop_stall``
    event and calls ``on_stall(loop)`` (the daemon wires
    :meth:`CaptureManager.heartbeat_stall`, so a wedged loop yields a
    capture bundle while it is still wedged). Recovery records the cleared
    transition; a persisting stall is silent in between."""

    def __init__(self, check_interval_s: float = 2.0, service: Optional[str] = None,
                 on_stall: Optional[Callable[[str], None]] = None):
        self.check_interval_s = check_interval_s
        self.service = service or _SERVICE
        self.on_stall = on_stall
        self._stalled: Set[str] = set()
        self._exported: Set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StallWatchdog":
        self._stop.clear()
        # Supervised and heartbeated itself: a dead watchdog would freeze
        # every age gauge at its last export; the audit sweep reads
        # HEARTBEATS directly, so a silent watchdog trips thread_liveness.
        self._thread = threading.Thread(
            target=supervised("stall_watchdog", self._run),
            name="stall-watchdog",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.check_interval_s + 2)
            self._thread = None

    def _run(self) -> None:
        hb = HEARTBEATS.register("stall_watchdog", interval_s=self.check_interval_s)
        while not self._stop.wait(self.check_interval_s):
            hb.beat()
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 - the watchdog survives
                log.exception("stall watchdog check failed")

    def check_once(self) -> List[str]:
        """One pass; returns the names of the loops stalled now (the tests
        drive this directly)."""
        from . import metrics
        from .flightrecorder import RECORDER

        flush_gc_pauses()  # drain the callback's lock-free buffer
        snap = HEARTBEATS.snapshot()
        names = {hb["name"] for hb in snap}
        stalled_now: List[str] = []
        for hb in snap:
            name = hb["name"]
            metrics.family("HEARTBEAT_AGE", self.service).set(hb["age_s"], loop=name)
            over = hb["dead"] or hb["age_s"] > hb["max_silence_s"]
            if over:
                stalled_now.append(name)
            if over and name not in self._stalled:
                self._stalled.add(name)
                reason = "died" if hb["dead"] else "stalled"
                if not hb["dead"]:
                    # A death was counted once already, by run_supervised.
                    metrics.family("LOOP_STALLS", self.service).inc(loop=name, reason="stalled")
                RECORDER.record(
                    "loop_stall",
                    f"loop {name} heartbeat silent for {hb['age_s']:.1f}s "
                    f"(threshold {hb['max_silence_s']:.1f}s)",
                    loop=name, reason=reason, state="detected", age_s=hb["age_s"],
                )
                log.warning("loop %s %s (heartbeat age %.1fs, threshold %.1fs)",
                            name, reason, hb["age_s"], hb["max_silence_s"])
                if self.on_stall is not None:
                    try:
                        self.on_stall(name)
                    except Exception:  # noqa: BLE001 - a failed capture
                        log.exception("stall capture for %s failed", name)
            elif not over and name in self._stalled:
                self._stalled.discard(name)
                RECORDER.record("loop_stall", f"loop {name} heartbeat recovered",
                                loop=name, state="cleared")
        for gone in self._exported - names:
            # A cleanly stopped loop's series must not scrape forever at
            # its last age.
            metrics.family("HEARTBEAT_AGE", self.service).remove(loop=gone)
            self._stalled.discard(gone)
        self._exported = names
        return stalled_now


# -- GC pause recording ------------------------------------------------------

_gc_start: Dict[int, float] = {}
# Pauses measured by the callback and not yet observed into the histogram.
# The callback must take no lock: a collection can start inside
# Histogram.observe (which allocates under the histogram's non-reentrant
# lock), and an observe from the callback on that thread would deadlock.
# deque.append is atomic, and allocating inside a gc callback cannot start
# another collection, so the callback only buffers; flush_gc_pauses()
# drains from safe places (the watchdog's tick, capture time, tests).
_gc_pending: "collections.deque" = collections.deque(maxlen=4096)


def _gc_callback(phase: str, info: dict) -> None:
    gen = info.get("generation", 0)
    if phase == "start":
        _gc_start[gen] = time.perf_counter()
    elif phase == "stop":
        t0 = _gc_start.pop(gen, None)
        if t0 is None:
            return
        _gc_pending.append((gen, time.perf_counter() - t0))


def flush_gc_pauses() -> int:
    """Drain the buffered GC pauses into ``tpu_gc_pause_seconds``; returns
    how many were flushed. Never called from the gc callback itself."""
    n = 0
    try:
        from . import metrics

        while True:
            try:
                gen, dt = _gc_pending.popleft()
            except IndexError:
                break
            metrics.family("GC_PAUSE", _SERVICE).observe(dt, generation=str(gen))
            n += 1
    except Exception:  # noqa: BLE001 - a metrics hiccup never propagates
        pass
    return n


def enable_gc_monitor() -> None:
    """Record every collector pass's stop-the-world time into
    ``tpu_gc_pause_seconds{generation}`` through ``gc.callbacks``.
    Idempotent: a second call adds no second callback."""
    if _gc_callback not in gc.callbacks:
        gc.callbacks.append(_gc_callback)


def disable_gc_monitor() -> None:
    if _gc_callback in gc.callbacks:
        gc.callbacks.remove(_gc_callback)
    flush_gc_pauses()
    _gc_start.clear()


# -- lock-order (lockdep) race detection -------------------------------------


class LockdepGraph:
    """Runtime lock-order graph: inversion cycles without a deadlock.

    Every :class:`TimedLock` acquire and release (when enabled) keeps a
    per-thread held-lock list; acquiring lock B while holding lock A
    records the edge A→B with a witness stack the first time the edge is
    seen. An edge that closes a cycle means two threads took the same locks
    in opposite orders: one unlucky interleaving from a deadlock, caught
    while both call sites are easy to find.

    Nodes are per instance (``name@serial``), never per name: two locks of
    one name held together must not read as a self-cycle. Edges are capped
    at ``MAX_EDGES`` and stored cycles at ``MAX_CYCLES``; past either cap
    the overflow is counted (``dropped_edges``, ``dropped_cycles``), and a
    new cycle past the cap is still counted, logged and flight-recorded.
    Exported as ``tpu_lockdep_edges`` and ``tpu_lockdep_cycles_total`` and
    swept by the ``lock_order`` audit invariant. Cycles never clear by
    themselves: an inversion is a property of the code; only :meth:`reset`
    or a restart clears it."""

    MAX_EDGES = 4096
    MAX_CYCLES = 64
    WITNESS_FRAMES = 16

    def __init__(self):
        self.enabled = False
        self._glock = threading.Lock()
        self._tls = threading.local()
        # node -> the per-thread held list it sits in, so that a lock
        # released by another thread than the one that acquired it (legal
        # for a Lock) still leaves that thread's held set: a phantom hold
        # would mint false edges and at last a false cycle. _hlock
        # serialises releases only; acquires are lock-free. Never held
        # together with _glock.
        self._hlock = threading.Lock()
        self._holders: Dict[str, List[str]] = {}
        self._edges: Dict[tuple, dict] = {}  # (a, b) -> stack, thread, count
        self._succ: Dict[str, Set[str]] = {}
        self._cycles: List[dict] = []
        self._cycle_keys: Set[frozenset] = set()
        self._dropped_edges = 0
        self._dropped_cycles = 0

    def enable(self) -> "LockdepGraph":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._hlock:
            self._holders.clear()
        with self._glock:
            self._edges.clear()
            self._succ.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
            self._dropped_edges = 0
            self._dropped_cycles = 0

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquire(self, name: str, obj_id: int) -> None:
        # Lock-free: the held list is this thread's own (a cross-thread
        # release deletes only earlier elements), list()/append/dict-set
        # are each atomic under the GIL, and one node's acquire and release
        # never overlap (the real lock orders them).
        node = f"{name}@{obj_id:x}"
        held = self._held()
        prevs = list(held)
        held.append(node)
        self._holders[node] = held
        if prevs:
            import traceback

            for prev in prevs:
                self._add_edge(prev, node, traceback)

    def note_release(self, name: str, obj_id: int) -> None:
        node = f"{name}@{obj_id:x}"
        with self._hlock:
            held = self._holders.pop(node, None)
            if held is None:
                held = self._held()  # a synthetic double acquire
            # The last occurrence: releases usually unwind LIFO, but an
            # out-of-order release is legal and must not corrupt the set.
            for i in range(len(held) - 1, -1, -1):
                if held[i] == node:
                    del held[i]
                    return

    def _add_edge(self, a: str, b: str, traceback_mod) -> None:
        # a == b (re-acquiring a held non-reentrant lock) is the deadlock
        # itself; it records as a one-edge cycle.
        info = self._edges.get((a, b))
        if info is not None:
            # A known edge takes no graph lock; a racy += may lose a count,
            # which is diagnostic colour only.
            info["count"] += 1
            return
        with self._glock:
            info = self._edges.get((a, b))
            if info is not None:
                info["count"] += 1
                return
            if len(self._edges) >= self.MAX_EDGES:
                self._dropped_edges += 1
                return
            self._edges[(a, b)] = {
                "stack": "".join(traceback_mod.format_stack(limit=self.WITNESS_FRAMES)),
                "thread": threading.current_thread().name,
                "count": 1,
            }
            self._succ.setdefault(a, set()).add(b)
            cycle_path = self._path_locked(b, a)
            self._export_edges()
            if cycle_path is not None:
                # cycle_path is b→…→a; the new edge a→b closes it.
                self._record_cycle_locked([a] + cycle_path)

    def _path_locked(self, src: str, dst: str) -> Optional[List[str]]:
        """Depth-first search src→dst through the recorded edges: the node
        path [src, ..., dst], or None."""
        stack: List[tuple] = [(src, [src])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._succ.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _record_cycle_locked(self, nodes: List[str]) -> None:
        from . import metrics
        from .flightrecorder import RECORDER

        edge_pairs = frozenset((nodes[i], nodes[i + 1]) for i in range(len(nodes) - 1))
        if edge_pairs in self._cycle_keys:
            return
        self._cycle_keys.add(edge_pairs)
        path = " -> ".join(nodes)
        metrics.family("LOCKDEP_CYCLES", _SERVICE).inc()
        if len(self._cycles) >= self.MAX_CYCLES:
            # Witness retention is bounded; the signal is not.
            self._dropped_cycles += 1
            log.error("lockdep: lock-order inversion %s (witness retention full at "
                      "%d cycles: counted but not stored)", path, self.MAX_CYCLES)
            RECORDER.record("lockdep_cycle", f"lock-order inversion (retention full): {path}",
                            nodes=path, stored=False)
            return
        witnesses = []
        for pair in sorted(edge_pairs):
            info = self._edges.get(tuple(pair))
            if info is not None:
                witnesses.append({"edge": f"{pair[0]} -> {pair[1]}",
                                  "thread": info["thread"], "stack": info["stack"]})
        self._cycles.append({
            "id": f"cycle-{len(self._cycles)}",
            "nodes": list(nodes),
            "ts": round(time.time(), 3),
            "witnesses": witnesses,
        })
        log.error("lockdep: lock-order inversion %s: two threads acquire these locks in "
                  "opposite orders; witness stacks kept (the lock_order audit invariant "
                  "pages)", path)
        RECORDER.record("lockdep_cycle", f"lock-order inversion: {path}",
                        nodes=path, witnesses=len(witnesses))

    def _export_edges(self) -> None:
        from . import metrics

        metrics.family("LOCKDEP_EDGES", _SERVICE).set(len(self._edges))

    def cycles(self) -> List[dict]:
        with self._glock:
            return [dict(c) for c in self._cycles]

    def snapshot(self) -> dict:
        """The /debug/lockdep payload: the whole graph and the cycles with
        their witness stacks."""
        with self._glock:
            return {
                "enabled": self.enabled,
                "edges": [
                    {"from": a, "to": b, "count": info["count"], "thread": info["thread"]}
                    for (a, b), info in sorted(self._edges.items())
                ],
                "dropped_edges": self._dropped_edges,
                "dropped_cycles": self._dropped_cycles,
                "cycles": [dict(c) for c in self._cycles],
            }


# One per process, like CAPTURE and HEARTBEATS.
LOCKDEP = LockdepGraph()

# TimedLock node serials: a monotonic count, not id(self), since a collected
# lock's id can be reused and two unrelated orderings stitched together.
_LOCK_SERIALS = itertools.count(1)


class TimedLock:
    """A ``threading.Lock`` whose contended acquires are measured.

    The uncontended path is one extra non-blocking acquire: no clock read,
    no histogram. Only when that fails does the caller pay two
    ``perf_counter`` reads and one observation into ``histogram{lock=name}``.
    With lockdep on, every acquire and release feeds the graph (``lockdep``,
    a private :class:`LockdepGraph` for tests, else :data:`LOCKDEP`)."""

    def __init__(self, name: str, histogram=None, lockdep=None):
        self.name = name
        self._histogram = histogram
        self._lockdep = lockdep
        self._serial = next(_LOCK_SERIALS)
        self._lock = threading.Lock()

    def _dep(self) -> "LockdepGraph":
        return self._lockdep if self._lockdep is not None else LOCKDEP

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            dep = self._dep()
            if dep.enabled:
                dep.note_acquire(self.name, self._serial)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        h = self._histogram
        if h is not None:
            try:
                h.observe(time.perf_counter() - t0, lock=self.name)
            except Exception:  # noqa: BLE001 - never fail an acquire
                pass
        if ok:
            dep = self._dep()
            if dep.enabled:
                dep.note_acquire(self.name, self._serial)
        return ok

    def release(self) -> None:
        dep = self._dep()
        if dep.enabled:
            dep.note_release(self.name, self._serial)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TimedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# -- SLO-triggered capture ---------------------------------------------------


class _LatencyWindow:
    """A sliding window of one op's latencies with its crossing state.
    ``obs`` is per window: with one counter for every op, a strictly
    alternating op mix could park one op's observations on counts the
    evaluation never lands on."""

    __slots__ = ("samples", "over", "last_p99_ms", "obs")

    def __init__(self, maxlen: int = 512):
        self.samples: "collections.deque" = collections.deque(maxlen=maxlen)
        self.over = False
        self.last_p99_ms = 0.0
        self.obs = 0

    def p99_ms(self, window_s: float) -> Optional[float]:
        cutoff = time.monotonic() - window_s
        vals = sorted(v for t, v in self.samples if t >= cutoff)
        if not vals:
            return None
        self.last_p99_ms = round(
            vals[min(len(vals) - 1, int(0.99 * (len(vals) - 1) + 0.5))] * 1000.0, 3)
        return self.last_p99_ms


class CaptureManager:
    """An SLO breach or a stall → one atomic capture bundle on disk.

    ``observe(op, seconds)`` is called from the hot RPC path (``Allocate``):
    one bool read when unconfigured. With a capture dir and a p99 threshold
    set, each op keeps a sliding window (``window_s``) and every
    ``_EVAL_EVERY``-th observation re-derives its p99; when it crosses the
    threshold (de-duplicated while it stays over) a bundle is written:

    * the last ``profile_window_s`` seconds of profile samples
      (``utils/stackprof.py``: collapsed and speedscope, or ``enabled:
      false`` without a profiler),
    * the flight ring, the decision-ledger tail, the heartbeat table and a
      full metrics snapshot,

    as one JSON file written atomically (tmp + ``os.replace``), limited to
    ``budget`` bundles per ``budget_window_s``, pruned to the newest
    ``keep`` in the directory, and recorded as ``profile_capture`` flight
    and ledger entries. The watchdog's ``on_stall`` hook routes heartbeat
    stalls here too (``reason="stall_<loop>"``)."""

    _EVAL_EVERY = 8

    def __init__(self):
        self.enabled = False
        self.capture_dir = ""
        self.p99_ms = 0.0
        self.service = "plugin"
        self.window_s = 60.0
        self.min_samples = 20
        self.budget = 8
        self.budget_window_s = 3600.0
        self.profile_window_s = 60.0
        self.keep = 40
        self._lock = threading.Lock()
        self._windows: Dict[str, _LatencyWindow] = {}
        self._captures: "collections.deque" = collections.deque()
        self._seq = 0  # file-name uniquifier within one second

    def configure(self, capture_dir: str = "", p99_ms: float = 0.0,
                  service: Optional[str] = None, window_s: float = 60.0,
                  min_samples: int = 20, budget: int = 8,
                  budget_window_s: float = 3600.0, profile_window_s: float = 60.0,
                  keep: int = 40) -> None:
        with self._lock:
            self.capture_dir = capture_dir
            self.p99_ms = float(p99_ms)
            if service is not None:
                self.service = service
            self.window_s = window_s
            self.min_samples = max(1, int(min_samples))
            self.budget = max(1, int(budget))
            self.budget_window_s = budget_window_s
            self.profile_window_s = profile_window_s
            # The budget bounds the rate, this the total: a flapping SLO
            # must not fill the capture volume one budget window at a time.
            self.keep = max(1, int(keep))
            self._windows = {}
            self._captures.clear()
            self.enabled = bool(capture_dir)

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self.capture_dir = ""
            self._windows = {}

    def observe(self, op: str, seconds: float) -> None:
        """First line is the enabled gate: one bool read when off."""
        if not self.enabled or self.p99_ms <= 0:
            return
        trigger = None
        with self._lock:
            w = self._windows.get(op)
            if w is None:
                w = self._windows[op] = _LatencyWindow()
            w.samples.append((time.monotonic(), seconds))
            w.obs += 1
            if w.obs % self._EVAL_EVERY or len(w.samples) < self.min_samples:
                return
            p99 = w.p99_ms(self.window_s)
            if p99 is None:
                return
            if p99 > self.p99_ms and not w.over:
                w.over = True  # the crossing: one capture per excursion
                trigger = p99
            elif p99 <= self.p99_ms and w.over:
                w.over = False  # re-armed for the next excursion
        if trigger is not None:
            self.capture(
                f"slo_{op}",
                f"windowed {op} p99 {trigger}ms crossed the --capture-p99-ms "
                f"threshold ({self.p99_ms}ms)",
                op=op, p99_ms=trigger, threshold_ms=self.p99_ms,
            )

    def heartbeat_stall(self, loop: str) -> None:
        """The watchdog's on_stall hook (de-duplicated upstream)."""
        self.capture(f"stall_{loop}", f"heartbeat stall on loop {loop}", loop=loop)

    def capture(self, reason: str, message: str = "", **attrs) -> Optional[str]:
        """Write one bundle now. Returns its path, or None (off, budget
        spent, write failed). Never raises: a capture runs at the worst
        moment by design."""
        from . import metrics

        if not self.enabled or not self.capture_dir:
            return None
        now = time.monotonic()
        with self._lock:
            while self._captures and now - self._captures[0] > self.budget_window_s:
                self._captures.popleft()
            if len(self._captures) >= self.budget:
                metrics.family("PROFILE_CAPTURES", self.service).inc(reason=reason, outcome="budget")
                log.warning("capture %s suppressed: budget of %d per %.0fs spent",
                            reason, self.budget, self.budget_window_s)
                return None
            self._captures.append(now)
            windows = {
                op: {"samples": len(w.samples), "p99_ms": w.last_p99_ms,
                     "threshold_ms": self.p99_ms, "over": w.over}
                for op, w in self._windows.items()
            }
        try:
            from . import stackprof
            from .decisions import LEDGER
            from .flightrecorder import RECORDER

            flush_gc_pauses()  # the metrics snapshot carries them
            bundle = {
                "v": 1,
                "service": self.service,
                "reason": reason,
                "message": message,
                "ts": round(time.time(), 3),
                "attrs": {k: str(v) for k, v in attrs.items()},
                "profile": stackprof.bundle_section(self.profile_window_s),
                # The one ring-drain seam (RECORDER.export).
                "flight": RECORDER.export("capture"),
                "decisions": LEDGER.snapshot(limit=256),
                "heartbeats": HEARTBEATS.snapshot(),
                "windows": windows,
                "metrics": metrics.registry_for(self.service).render(),
            }
            with self._lock:
                self._seq += 1
                seq = self._seq
            name = (f"capture-{self.service}-{time.strftime('%Y%m%dT%H%M%S')}-"
                    f"{os.getpid()}-{seq:03d}-{reason}.json")
            path = os.path.join(self.capture_dir, name)
            tmp = path + ".tmp"
            os.makedirs(self.capture_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic: never a torn bundle
            self._prune_old_bundles()
            RECORDER.record("profile_capture", message or f"capture bundle written ({reason})",
                            reason=reason, path=path, **attrs)
            LEDGER.record("profile_capture", reason, message or f"capture bundle written to {path}",
                          **{k: str(v) for k, v in attrs.items()})
            metrics.family("PROFILE_CAPTURES", self.service).inc(reason=reason, outcome="ok")
            log.warning("capture bundle written: %s (%s)", path, reason)
            return path
        except Exception:  # noqa: BLE001 - a capture never makes the incident worse
            log.exception("capture bundle for %s failed", reason)
            metrics.family("PROFILE_CAPTURES", self.service).inc(reason=reason, outcome="error")
            return None

    def _prune_old_bundles(self) -> int:
        """Keep only the newest ``keep`` bundles in the capture dir (this
        process's and its predecessors'). Returns how many were deleted;
        never raises."""
        removed = 0
        try:
            bundles = sorted(
                (os.path.join(self.capture_dir, f) for f in os.listdir(self.capture_dir)
                 if f.startswith("capture-") and f.endswith(".json")),
                key=os.path.getmtime,
            )
            for doomed in bundles[: -self.keep]:
                try:
                    os.unlink(doomed)
                    removed += 1
                except OSError:
                    pass
        except OSError:
            pass
        return removed

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capture_dir": self.capture_dir,
                "p99_ms": self.p99_ms,
                "window_s": self.window_s,
                "budget": self.budget,
                "captures_in_window": len(self._captures),
                "windows": {
                    op: {"samples": len(w.samples), "p99_ms": w.last_p99_ms, "over": w.over}
                    for op, w in self._windows.items()
                },
            }


# One per process, like RECORDER and LEDGER: a daemon is one process.
CAPTURE = CaptureManager()
