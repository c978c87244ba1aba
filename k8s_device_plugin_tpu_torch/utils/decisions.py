"""The decision ledger of the JAX package's ``utils/decisions.py``, as far
as the health watcher records into it: a bounded, queryable ring of
structured decisions (kind, machine-readable reason token, message, the
pod/gang/node it concerns, the active trace), gated on :meth:`enable` so
that recording costs one bool read when off, and ``retrace``, the pod
controller's join of ``Allocate``'s records into the pod's trace, and the
``snapshot`` that ``/debug/decisions`` serves, and the tap seam the black
box subscribes through (``add_tap``). ``tag_gang`` comes with the gang
admitter."""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

from . import tracing


class DecisionLedger:
    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.enabled = False
        self.service = ""
        self.dropped = 0
        self._lock = threading.Lock()
        self._records: "collections.deque" = collections.deque()
        self._counter = None  # *_decisions_total, bound by enable()
        # Drop count at the last decision_overflow flight event: overflow is
        # flight-recorded on the first drop and then once per
        # _OVERFLOW_EVERY, not per record.
        self._overflow_reported = 0
        # Live subscribers (the black box), as on the flight recorder:
        # called with every appended record outside the ledger lock, the
        # tuple replaced on mutation so record() reads it lock-free.
        self._taps: tuple = ()

    _OVERFLOW_EVERY = 1024

    def add_tap(self, fn) -> None:
        """Subscribe ``fn(record_dict)`` to every recorded decision. A tap
        runs on the recording thread, so it must never block."""
        with self._lock:
            if fn not in self._taps:
                self._taps = self._taps + (fn,)

    def remove_tap(self, fn) -> None:
        with self._lock:
            self._taps = tuple(t for t in self._taps if t != fn)

    def enable(self, service: str = "plugin", capacity: Optional[int] = None) -> None:
        from . import metrics

        with self._lock:
            self.service = service
            if capacity is not None:
                self.capacity = capacity
            self._counter = metrics.family("DECISIONS", service)
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._counter = None

    def record(self, kind: str, reason: str, message: str = "", pod: str = "", gang: str = "",
               node: str = "", **attrs) -> None:
        """Append one decision. ``reason`` must be a stable machine token
        (it becomes the ``*_decisions_total`` reason label); the human
        detail goes in ``message``. First line is the enabled gate."""
        if not self.enabled:
            return
        ctx = tracing.current()
        rec = {
            "ts": round(time.time(), 3),
            "kind": kind,
            "reason": reason,
            "message": message,
            "pod": pod,
            "gang": gang,
            "node": node,
            "attrs": {k: str(v) for k, v in attrs.items()},
        }
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["span_id"] = ctx.span_id
        overflowed = False
        with self._lock:
            self._records.append(rec)
            while len(self._records) > self.capacity:
                self._records.popleft()
                self.dropped += 1
            if self.dropped and (
                self._overflow_reported == 0
                or self.dropped - self._overflow_reported >= self._OVERFLOW_EVERY
            ):
                self._overflow_reported = self.dropped
                overflowed = True
            counter = self._counter
        if counter is not None:
            counter.inc(kind=kind, reason=reason)
        # Each tap gets its own copy, attrs too: retrace() mutates the live
        # record under the ledger lock, which must not race a tap consumer
        # serialising its copy on another thread.
        for tap in self._taps:
            try:
                tap({**rec, "attrs": dict(rec["attrs"])})
            except Exception:  # noqa: BLE001 - a broken subscriber must
                pass  # never take the recording path down with it
        if overflowed:
            from .flightrecorder import RECORDER

            RECORDER.record(
                "decision_overflow",
                "decision ledger dropping oldest records",
                service=self.service,
                dropped=self.dropped,
                capacity=self.capacity,
            )

    def retrace(self, old_trace_id: str, new_trace_id: str) -> int:
        """Rewrite records stamped under ``old_trace_id`` into
        ``new_trace_id`` (keeping ``retraced_from``): the ledger side of
        the plugin-Allocate adoption (``tracing.adopt``). Returns how many
        records moved."""
        if not old_trace_id or old_trace_id == new_trace_id:
            return 0
        n = 0
        with self._lock:
            for rec in self._records:
                if rec.get("trace_id") == old_trace_id:
                    rec["attrs"]["retraced_from"] = old_trace_id
                    rec["trace_id"] = new_trace_id
                    n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0
            self._overflow_reported = 0

    def query(self, pod: str = "", gang: str = "", node: str = "", kind: str = "",
              trace_id: str = "", limit: int = 0) -> List[dict]:
        """Filtered records, oldest first. ``pod``/``gang`` match the full
        ``namespace/name`` key or the bare name; ``node``/``kind``/
        ``trace_id`` are exact. ``limit`` keeps the newest n matches."""

        def name_match(value: str, arg: str) -> bool:
            return value == arg or value.endswith("/" + arg)

        with self._lock:
            records = [{**r, "attrs": dict(r.get("attrs") or {})} for r in self._records]
        out = []
        for r in records:
            if pod and not name_match(r.get("pod", ""), pod):
                continue
            if gang and not name_match(r.get("gang", ""), gang):
                continue
            if node and r.get("node", "") != node:
                continue
            if kind and r.get("kind", "") != kind:
                continue
            if trace_id and r.get("trace_id", "") != trace_id:
                continue
            out.append(r)
        if limit > 0:
            out = out[-limit:]
        return out

    def snapshot(self, **filters) -> dict:
        """The /debug/decisions payload (``filters`` as :meth:`query`)."""
        return {
            "service": self.service,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "records": self.query(**filters),
        }


# One per process, like the flight recorder: a daemon is one process.
LEDGER = DecisionLedger()
