"""The flight recorder of the JAX package's ``utils/flightrecorder.py``: a
fixed-size ring of structured events (epoch timestamp, kind, message, flat
attrs, the active trace), gated on :meth:`enable` so that recording costs
one bool read when off; past ``capacity`` the oldest event drops and
``dropped`` counts it.

The ring is served live at ``GET /debug/events``, streamed to subscribers
through :meth:`add_tap` (the black box), and dumped to ``dump_dir`` by
:meth:`dump_on` at the moments an operator most wants the preceding event
tail: the daemon's shutdown, the kube breaker's move to OPEN, and a new
critical audit finding. Every consumer reads the ring through
:meth:`export`."""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from . import tracing


class FlightRecorder:
    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self.enabled = False
        self.service = ""
        # Directory of the disk dumps; "" disables them (the ring and
        # /debug/events still work).
        self.dump_dir = ""
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque()
        self._counter = None  # *_flight_events_total, bound by enable()
        # Live subscribers (the black box), called with every appended event
        # outside the ring lock; the tuple is replaced on mutation, so
        # record() reads it without the lock.
        self._taps: tuple = ()

    def add_tap(self, fn) -> None:
        """Subscribe ``fn(event_dict)`` to every recorded event. A tap runs on
        the recording thread, so it must never block."""
        with self._lock:
            if fn not in self._taps:
                self._taps = self._taps + (fn,)

    def remove_tap(self, fn) -> None:
        with self._lock:
            self._taps = tuple(t for t in self._taps if t != fn)

    def enable(self, service: str = "plugin", dump_dir: str = "",
               capacity: Optional[int] = None) -> None:
        from . import metrics

        with self._lock:
            self.service = service
            self.dump_dir = dump_dir
            if capacity is not None:
                self.capacity = capacity
            self._counter = metrics.family("FLIGHT_EVENTS", service)
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
        for tap in self._taps:
            try:
                tap(ev)
            except Exception:  # noqa: BLE001 - a broken subscriber must
                pass  # never take the recording path down with it

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self, reason: str = "") -> dict:
        """The one ring-drain seam: ``/debug/events``, :meth:`dump_on` and
        the capture bundles read the ring through it (``reason`` stamped
        when given)."""
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

    def snapshot(self) -> dict:
        """The /debug/events payload: :meth:`export` without a reason."""
        return self.export()

    def dump_on(self, reason: str) -> Optional[str]:
        """Write the ring to ``dump_dir`` as one JSON file whose name carries
        the reason and the pid. Returns the path, or None when the recorder
        is off, no dump dir is set or the ring is empty. Never raises: a
        failed dump on the way down must not mask the original failure."""
        if not self.enabled or not self.dump_dir:
            return None
        snap = self.export(reason)
        if not snap["events"]:
            return None
        name = (f"flight-{self.service or 'daemon'}-"
                f"{time.strftime('%Y%m%dT%H%M%S')}-{os.getpid()}-{reason}.json")
        path = os.path.join(self.dump_dir, name)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            # Written aside and renamed: a reader that sees the name reads
            # the whole dump, never a half-written one.
            with open(path + ".tmp", "w") as f:
                json.dump(snap, f, indent=1)
            os.replace(path + ".tmp", path)
        except OSError:
            return None
        return path


# One per process, like the metrics registry: a daemon is one process.
RECORDER = FlightRecorder()
