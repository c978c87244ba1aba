"""Two parts of the JAX package's ``utils/profiling.py``: the workload's
profiler trace of a block (``trace``) and named regions inside it
(``annotate``); and the node daemon's loop liveness (``Heartbeat``,
``HEARTBEATS``) and the supervised thread target (``supervised``,
``run_supervised``) that makes a background loop's death loud. The stall
watchdog, lockdep, GC and sampling profiler of that module come with the
plugin server.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections.abc import Callable, Iterator
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity

from .logging import get_logger

log = get_logger(__name__)


@contextlib.contextmanager
def trace(trace_dir: str | None) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (host, and the card's
    kernels when CUDA is up) and write the trace into ``trace_dir`` as a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin and Chrome's
    trace viewer load. No-op when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(trace_dir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler):
        yield


def annotate(name: str) -> torch.profiler.record_function:
    """A named region inside an active trace (``record_function``); costs
    next to nothing outside one."""
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

            metrics.LOOP_STALLS.inc(loop=name, reason="died")
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
