"""The span model of the JAX package's ``utils/tracing.py``, as far as the
device-plugin server's ``Allocate``, the pod controller and the decision
ledger, flight recorder and latency histograms need it: ``enabled``/
``enable``/``disable``, ``span`` (a thread-local stack, so ``current()``
names the innermost open span), a bounded in-memory collector of finished
spans, reading the trace carrier off a pod (``extract``) and adopting the
provisional ``Allocate`` span into the pod's trace (``adopt``), and the
collector's OTLP/JSON export that ``/debug/traces`` serves, and ``RECENT``,
through which the scheduler extender's /prioritize joins the trace its
/filter opened for the same pod. The daemon's and the extender's
``--trace`` turn tracing on. Writing carriers comes with the extender's gang
admission, the one writer. The training step (``workload/train.train_step``)
records its own spans too, of service ``workload``: ``train.step`` around
the call, and inside it ``train.forward``, ``train.backward`` and
``train.optimizer``, which the benchmark's readers place on the card's
trace.

**Exact no-op when disabled** (the default): every entry point checks one
module-level bool first, and ``span()`` then returns a shared no-op that
yields ``None``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_lock = threading.Lock()
_enabled = False
_service = ""
# The service's span counter (``metrics.family("TRACE_SPANS", service)``),
# set by enable(); None while tracing is off.
_span_counter = None
_tls = threading.local()


class SpanContext(collections.namedtuple("SpanContext", "trace_id span_id")):
    """The propagatable part of a span: (trace_id, span_id)."""

    __slots__ = ()


def _ids() -> Tuple[str, str]:
    return os.urandom(16).hex(), os.urandom(8).hex()


class SpanCollector:
    """The last ``max_spans`` finished spans of this process, oldest
    dropped first."""

    def __init__(self, max_spans: int = 4096):
        self._spans: "collections.deque" = collections.deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self.dropped = 0
        # Live subscribers (the black box), as on the flight recorder:
        # called with every finished span outside the collector lock.
        self._taps: tuple = ()

    def add_tap(self, fn) -> None:
        """Subscribe ``fn(span_dict)`` to every collected span. A tap runs
        on the finishing thread, so it must never block."""
        with self._lock:
            if fn not in self._taps:
                self._taps = self._taps + (fn,)

    def remove_tap(self, fn) -> None:
        with self._lock:
            self._taps = tuple(t for t in self._taps if t != fn)

    def add(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)
        # Each tap gets its own copy, attrs too: reparent() mutates the live
        # span under the collector lock.
        for tap in self._taps:
            try:
                tap({**span, "attrs": dict(span.get("attrs") or {})})
            except Exception:  # noqa: BLE001 - a broken subscriber must
                pass  # never take the finishing path down with it

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def trace(self, trace_id: str) -> List[dict]:
        return [s for s in self.spans() if s["trace_id"] == trace_id]

    def reparent(self, span_id: str, parent: SpanContext) -> bool:
        """Rewrite one collected span (and its collected descendants)
        into ``parent``'s trace; see :func:`adopt`."""
        with self._lock:
            target = next((s for s in self._spans if s["span_id"] == span_id), None)
            if target is None:
                return False
            old_trace = target["trace_id"]
            target.setdefault("attrs", {})["adopted_from"] = old_trace
            target["trace_id"] = parent.trace_id
            target["parent_span_id"] = parent.span_id
            # Children recorded under the provisional trace follow.
            descendants = {span_id}
            changed = True
            while changed:
                changed = False
                for s in self._spans:
                    if (s["trace_id"] == old_trace and s["parent_span_id"] in descendants
                            and s["span_id"] not in descendants):
                        s["trace_id"] = parent.trace_id
                        descendants.add(s["span_id"])
                        changed = True
            return True

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def otlp_json(self, trace_id: str = "") -> dict:
        """The OTLP/JSON ``resourceSpans`` shape, one resource per service
        (``trace_id`` narrows it to one trace)."""
        spans = self.trace(trace_id) if trace_id else self.spans()
        by_service: Dict[str, List[dict]] = {}
        for s in spans:
            by_service.setdefault(s.get("service", ""), []).append(s)
        resource_spans = []
        for service, members in sorted(by_service.items()):
            resource_spans.append({
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": service or "unknown"},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "k8s_device_plugin_tpu_torch"},
                    "spans": [{
                        "traceId": s["trace_id"],
                        "spanId": s["span_id"],
                        "parentSpanId": s["parent_span_id"],
                        "name": s["name"],
                        "startTimeUnixNano": str(s["start_ns"]),
                        "endTimeUnixNano": str(s["end_ns"]),
                        "attributes": [{"key": k, "value": {"stringValue": v}}
                                       for k, v in sorted((s.get("attrs") or {}).items())],
                        "status": ({"code": 2, "message": s["error"]} if s.get("error")
                                   else {"code": 0}),
                    } for s in members],
                }],
            })
        return {"resourceSpans": resource_spans, "dropped_spans": self.dropped}


COLLECTOR = SpanCollector()


class Span:
    """One in-flight span. Finished spans live on as plain dicts in the
    collector."""

    __slots__ = (
        "trace_id", "span_id", "parent_span_id", "name", "service",
        "start_ns", "end_ns", "attrs", "error",
    )

    def __init__(self, name: str, parent: Optional[SpanContext] = None,
                 service: str = "", **attrs):
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_span_id = parent.span_id
            self.span_id = os.urandom(8).hex()
        else:
            self.trace_id, self.span_id = _ids()
            self.parent_span_id = ""
        self.name = name
        self.service = service or _service
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attrs = {k: str(v) for k, v in attrs.items()}
        self.error = ""

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> None:
        self.attrs.update((k, str(v)) for k, v in attrs.items())

    def finish(self, error: str = "") -> dict:
        self.end_ns = time.time_ns()
        if error:
            self.error = error
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "service": self.service,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "attrs": self.attrs,
            "error": self.error,
        }
        COLLECTOR.add(d)
        counter = _span_counter
        if counter is not None:
            counter.inc()
        return d


class _SpanCM:
    """Context manager for one span; pushes and pops the thread-local
    current-span stack."""

    __slots__ = ("_span",)

    def __init__(self, s: Span):
        self._span = s

    def __enter__(self) -> Span:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self._span:
            stack.pop()
        self._span.finish(error=f"{exc_type.__name__}: {exc}" if exc_type else "")
        return False


class _NoopCM:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *a) -> bool:
        return False


_NOOP = _NoopCM()


def enabled() -> bool:
    return _enabled


def enable(service: str = "plugin") -> None:
    """Turn tracing on for this process. ``service`` names the daemon in
    the spans it records and picks the span counter of the registry that
    daemon serves (``tpu_plugin_trace_spans_total`` or
    ``tpu_extender_trace_spans_total``), as the flight recorder picks its
    own."""
    global _enabled, _service, _span_counter
    from . import metrics

    with _lock:
        _service = service
        _span_counter = metrics.family("TRACE_SPANS", service)
        _enabled = True


def disable() -> None:
    global _enabled, _span_counter
    with _lock:
        _enabled = False
        _span_counter = None


def current() -> Optional[SpanContext]:
    """The innermost open span's context on this thread, or None.
    Cheap when disabled (one bool read)."""
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    return stack[-1].context


def span(name: str, parent: Optional[SpanContext] = None, service: str = "", **attrs):
    """Context manager for one span. Disabled: a shared no-op that yields
    None. Otherwise the innermost open span on this thread (or ``parent``)
    is the new span's parent."""
    if not _enabled:
        return _NOOP
    if parent is None:
        stack = getattr(_tls, "stack", None)
        if stack:
            parent = stack[-1].context
    return _SpanCM(Span(name, parent=parent, service=service, **attrs))


def adopt(span_id: str, parent: SpanContext) -> bool:
    """Re-parent an already-collected span into ``parent``'s trace: the
    plugin-side join. Allocate runs before any pod identity is knowable
    (the kubelet's RPC carries device ids only), so its span is recorded
    under a provisional trace and adopted once the controller resolves the
    pod and reads its carrier annotation. The provisional trace id is kept
    as the ``adopted_from`` attribute. False when the ring has already
    dropped the span."""
    return COLLECTOR.reparent(span_id, parent)


def format_traceparent(ctx: SpanContext) -> str:
    """A W3C traceparent: version 00, the sampled flag set."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def inject(annotations: Dict[str, str], ctx: Optional[SpanContext] = None) -> None:
    """Write the carrier annotation of ``ctx`` (default: the current span)
    into a pod's annotations dict: gang admission stamps it on each member
    it releases. A no-op with nothing to propagate."""
    from ..api import constants

    ctx = ctx or current()
    if ctx is not None:
        annotations[constants.TRACE_ANNOTATION] = format_traceparent(ctx)


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """A W3C traceparent (``00-<trace>-<span>-<flags>``), or None."""
    parts = (value or "").strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id)


def extract(pod: Optional[dict]) -> Optional[SpanContext]:
    """Read the carrier annotation off a pod object (or a bare annotations
    dict). None when absent or malformed: a bad carrier must never fail the
    work it rode in on."""
    if not isinstance(pod, dict):
        return None
    from ..api import constants

    ann: Dict = pod
    meta = pod.get("metadata")
    if isinstance(meta, dict):
        ann = meta.get("annotations") or {}
    raw = ann.get(constants.TRACE_ANNOTATION) if isinstance(ann, dict) else None
    return parse_traceparent(raw) if raw else None


class _RecentTraces:
    """Bounded, TTL'd pod key -> SpanContext memo: /filter and /prioritize
    see the same pod in one scheduling cycle, but a pod that never went
    through gang admission carries no carrier annotation, so the extender
    remembers the trace /filter opened here and /prioritize joins it
    instead of opening a second root. The TTL bounds a trace to about one
    scheduling cycle: a Pending pod the scheduler retries every 10-30 s
    opens a fresh root each cycle."""

    def __init__(self, max_items: int = 1024, ttl_s: float = 5.0):
        self.max_items = max_items
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        # key -> (ctx, monotonic stamp)
        self._items: "collections.OrderedDict" = collections.OrderedDict()

    def remember(self, key: str, ctx: SpanContext) -> None:
        if not key:
            return
        with self._lock:
            self._items.pop(key, None)
            self._items[key] = (ctx, time.monotonic())
            while len(self._items) > self.max_items:
                self._items.popitem(last=False)

    def recall(self, key: str) -> Optional[SpanContext]:
        with self._lock:
            entry = self._items.get(key)
            if entry is None:
                return None
            ctx, stamp = entry
            if time.monotonic() - stamp > self.ttl_s:
                del self._items[key]
                return None
            return ctx

    def clear(self) -> None:
        with self._lock:
            self._items.clear()


RECENT = _RecentTraces()


def pod_key(pod: dict) -> str:
    """Stable correlation key for a pod object: uid when present, else
    namespace/name."""
    meta = (pod or {}).get("metadata") or {}
    return meta.get("uid") or f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
