"""The flight recorder of the JAX package's ``utils/flightrecorder.py``, as
far as the health watcher and the supervised loops record into it: a
fixed-size ring of structured events (epoch timestamp, kind, message, flat
attrs, the active trace), gated on :meth:`enable` so that recording costs
one bool read when off; past ``capacity`` the oldest event drops and
``dropped`` counts it. The disk dumps and the black-box taps come with the
plugin server."""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from . import tracing


class FlightRecorder:
    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self.enabled = False
        self.service = ""
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque()
        self._counter = None  # *_flight_events_total, bound by enable()

    def enable(self, service: str = "plugin", capacity: Optional[int] = None) -> None:
        from . import metrics

        with self._lock:
            self.service = service
            if capacity is not None:
                self.capacity = capacity
            self._counter = metrics.FLIGHT_EVENTS
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._counter = None

    def record(self, kind: str, message: str = "", **attrs) -> None:
        """Append one event. First line is the enabled gate."""
        if not self.enabled:
            return
        ctx = tracing.current()
        ev = {
            "ts": round(time.time(), 3),
            "kind": kind,
            "message": message,
            "attrs": {k: str(v) for k, v in attrs.items()},
        }
        if ctx is not None:
            ev["trace_id"] = ctx.trace_id
            ev["span_id"] = ctx.span_id
        with self._lock:
            self._events.append(ev)
            while len(self._events) > self.capacity:
                self._events.popleft()
                self.dropped += 1
            counter = self._counter
        if counter is not None:
            counter.inc(kind=kind)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self, reason: str = "") -> dict:
        """A consistent snapshot of the ring (``reason`` stamped when
        given)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            dropped = self.dropped
        snap = {
            "service": self.service,
            "capacity": self.capacity,
            "dropped": dropped,
            "events": events,
        }
        if reason:
            snap["reason"] = reason
        return snap


# One per process, like the metrics registry: a daemon is one process.
RECORDER = FlightRecorder()
