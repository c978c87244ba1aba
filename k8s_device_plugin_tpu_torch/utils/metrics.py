"""The metric classes of the JAX package's ``utils/metrics.py`` (counter,
gauge, histogram with trace exemplars, registry) and the families the
port's device-plugin server, health watcher, decision ledger, flight
recorder, supervised loops, kube client (``utils/resilience.py``) and pod
controller write, under the JAX names and labels. The HTTP endpoint and
the other planes' families come with those planes."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from . import tracing


class Metric:
    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind  # "counter" | "gauge"
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted(labels.items()))

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def get(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def remove(self, **labels) -> bool:
        """Delete one labeled series, so that a state that empties reads
        as an absent series instead of lingering at its last value.
        Returns True when a series was actually dropped."""
        with self._lock:
            return self._values.pop(self._key(labels), None) is not None

    def render(self, openmetrics: bool = False) -> str:
        # OpenMetrics declares a counter family without the _total suffix
        # (samples keep it).
        family = self.name
        if openmetrics and self.kind == "counter" and family.endswith("_total"):
            family = family[: -len("_total")]
        lines = [
            f"# HELP {family} {self.help}",
            f"# TYPE {family} {self.kind}",
        ]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, value in sorted(self._values.items()):
                if key:
                    label_s = ",".join(f'{k}="{v}"' for k, v in key)
                    lines.append(f"{self.name}{{{label_s}}} {_fmt(value)}")
                else:
                    lines.append(f"{self.name} {_fmt(value)}")
        return "\n".join(lines)


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


# Request-latency bucket bounds (seconds): sub-ms gRPC handlers up through
# multi-second outliers (kube API round-trips under contention).
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Prometheus histogram (cumulative le buckets + _sum/_count).

    When tracing (utils/tracing.py) is enabled and an observation lands
    inside an open span, the span's context is kept as an **exemplar**
    for the smallest bucket the value falls in (latest wins, per
    labelset per bucket). An OpenMetrics scrape
    (``Accept: application/openmetrics-text``) renders them as
    ``# {trace_id="…",span_id="…"} value ts`` suffixes — the link from
    a p99 bucket to the trace that caused it."""

    def __init__(self, name: str, help_text: str,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[Tuple[str, str], ...], list] = {}
        self._sums: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._totals: Dict[Tuple[Tuple[str, str], ...], int] = {}
        # labelset key -> bucket index (len(buckets) = +Inf) ->
        # (trace_id, span_id, value, unix_ts)
        self._exemplars: Dict[Tuple[Tuple[str, str], ...], Dict[int, tuple]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        ctx = tracing.current()  # one bool read when tracing is off
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            bucket_idx = len(self.buckets)  # +Inf
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    bucket_idx = min(bucket_idx, i)
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if ctx is not None:
                self._exemplars.setdefault(key, {})[bucket_idx] = (
                    ctx.trace_id, ctx.span_id, value, round(time.time(), 3)
                )

    def count(self, **labels) -> int:
        with self._lock:
            return self._totals.get(tuple(sorted(labels.items())), 0)

    def exemplar(self, bucket_index: int, **labels) -> Optional[tuple]:
        """(trace_id, span_id, value, ts) kept for one bucket of one
        labelset, or None. ``bucket_index == len(buckets)`` is +Inf."""
        with self._lock:
            return self._exemplars.get(
                tuple(sorted(labels.items())), {}
            ).get(bucket_index)

    def _exemplar_suffix(self, key, idx: int, openmetrics: bool) -> str:
        if not openmetrics:
            return ""
        ex = self._exemplars.get(key, {}).get(idx)
        if ex is None:
            return ""
        trace_id, span_id, value, ts = ex
        return (
            f' # {{trace_id="{trace_id}",span_id="{span_id}"}} '
            f"{_fmt(value)} {ts}"
        )

    def render(self, openmetrics: bool = False) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            for key in sorted(self._totals):
                base = ",".join(f'{k}="{v}"' for k, v in key)
                sep = "," if base else ""
                for i, (bound, c) in enumerate(
                    zip(self.buckets, self._counts[key])
                ):
                    lines.append(
                        f'{self.name}_bucket{{{base}{sep}le="{_fmt(bound)}"}}'
                        f" {c}"
                        f"{self._exemplar_suffix(key, i, openmetrics)}"
                    )
                lines.append(
                    f'{self.name}_bucket{{{base}{sep}le="+Inf"}} '
                    f"{self._totals[key]}"
                    + self._exemplar_suffix(
                        key, len(self.buckets), openmetrics
                    )
                )
                label_s = f"{{{base}}}" if base else ""
                lines.append(
                    f"{self.name}_sum{label_s} {_fmt(self._sums[key])}"
                )
                lines.append(
                    f"{self.name}_count{label_s} {self._totals[key]}"
                )
        return "\n".join(lines)


class Registry:
    def __init__(self, uptime_name: str = "tpu_plugin_uptime_seconds"):
        self._metrics: Dict[str, Metric] = {}
        self._start = time.time()
        self._uptime_name = uptime_name

    def counter(self, name: str, help_text: str) -> Metric:
        return self._register(name, help_text, "counter")

    def gauge(self, name: str, help_text: str) -> Metric:
        return self._register(name, help_text, "gauge")

    def histogram(self, name: str, help_text: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        if name not in self._metrics:
            self._metrics[name] = Histogram(name, help_text, buckets)
        return self._metrics[name]

    def _register(self, name: str, help_text: str, kind: str) -> Metric:
        if name not in self._metrics:
            self._metrics[name] = Metric(name, help_text, kind)
        return self._metrics[name]

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text format (``openmetrics=True`` adds the closing
        ``# EOF``)."""
        parts = [m.render(openmetrics=openmetrics) for m in self._metrics.values()]
        parts.append(
            f"# HELP {self._uptime_name} Seconds since process start\n"
            f"# TYPE {self._uptime_name} gauge\n"
            f"{self._uptime_name} "
            f"{_fmt(round(time.time() - self._start, 1))}"
        )
        out = "\n".join(parts) + "\n"
        if openmetrics:
            out += "# EOF\n"
        return out


# The plugin's metrics (module-level: one daemon per process).
REGISTRY = Registry()
CHIPS = REGISTRY.gauge(
    "tpu_plugin_chips", "Chip counts by state (total/allocated/unhealthy)"
)
ALLOCATIONS = REGISTRY.counter(
    "tpu_plugin_allocations_total", "Container allocation requests served"
)
ALLOCATED_CHIPS = REGISTRY.counter(
    "tpu_plugin_allocated_chips_total", "Chips handed to containers"
)
HEALTH_TRANSITIONS = REGISTRY.counter(
    "tpu_plugin_health_transitions_total",
    "Chip health transitions by direction",
)
APP_FAULTS = REGISTRY.counter(
    "tpu_plugin_app_faults_total",
    "Application-level chip faults observed (not marked unhealthy), "
    "by reason",
)
LISTANDWATCH_SENDS = REGISTRY.counter(
    "tpu_plugin_listandwatch_sends_total",
    "Device-list advertisements streamed to the kubelet",
)
GRPC_ERRORS = REGISTRY.counter(
    "tpu_plugin_grpc_errors_total", "gRPC requests answered with an error"
)
PLUGIN_REREGISTRATIONS = REGISTRY.counter(
    "tpu_plugin_reregistrations_total",
    "Plugin re-serve + re-register cycles forced by a kubelet restart "
    "(server/plugin.py watch loop), by trigger: kubelet_restart (the "
    "kubelet's registration socket changed identity) or "
    "plugin_socket_vanished (the kubelet wiped the device-plugins "
    "dir, taking our serving socket with it)",
)
RPC_LATENCY = REGISTRY.histogram(
    "tpu_plugin_rpc_latency_seconds",
    "Wall latency of device-plugin gRPC handlers, by method",
)
FLIGHT_EVENTS = REGISTRY.counter(
    "tpu_plugin_flight_events_total",
    "Flight-recorder events captured, by kind (utils/flightrecorder.py)",
)
DECISIONS = REGISTRY.counter(
    "tpu_plugin_decisions_total",
    "Scheduling/health decisions recorded by this daemon's decision "
    "ledger (utils/decisions.py), by kind and machine-readable reason token",
)
LOOP_STALLS = REGISTRY.counter(
    "tpu_loop_stall_total",
    "Loop stall transitions by loop and reason: died (the thread exited "
    "on an unhandled exception; run_supervised counts it)",
)
EVICTIONS = REGISTRY.counter(
    "tpu_plugin_evictions_total",
    "Pods evicted because a chip they hold went Unhealthy, by outcome "
    "(evicted/failed)",
)
# The kube client's resilience layer (utils/resilience.py).
KUBE_RETRIES = REGISTRY.counter(
    "tpu_plugin_kube_retries_total",
    "Kube API attempts retried after a transport-level failure, by verb",
)
KUBE_CIRCUIT_STATE = REGISTRY.gauge(
    "tpu_plugin_kube_circuit_state",
    "Kube API circuit breaker: 0 closed, 1 open (failing fast), "
    "2 half-open (probing)",
)
KUBE_REQUEST_LATENCY = REGISTRY.histogram(
    "tpu_plugin_kube_request_latency_seconds",
    "Wall latency of individual kube API request attempts, by verb and "
    "outcome",
)
KUBE_QUEUED_WRITES = REGISTRY.gauge(
    "tpu_plugin_kube_queued_writes",
    "State-publishing writes queued while the apiserver is unreachable "
    "(drained on reconnect; >0 for long = degraded mode)",
)
KUBE_CALL_OUTCOMES = REGISTRY.counter(
    "tpu_plugin_kube_call_outcomes_total",
    "Kube API call outcomes by verb and outcome (ok / retry / "
    "retry_after / semantic / unavailable / circuit_open) — the "
    "resilience layer's per-verb success/retry rate",
)
KUBE_DEGRADED_MODE = REGISTRY.gauge(
    "tpu_plugin_kube_degraded_mode",
    "1 while consumers run in explicit degraded mode (circuit breaker "
    "open: serving last-known-good state, mutations failing fast)",
)
KUBE_DEGRADED_STALENESS = REGISTRY.gauge(
    "tpu_plugin_kube_degraded_staleness_seconds",
    "Age of the last successful cluster-state sync behind degraded "
    "serving; past the staleness cap admission pauses",
)
KUBE_WATCH_STREAMS = REGISTRY.counter(
    "tpu_plugin_kube_watch_streams_total",
    "Watch stream recoveries by outcome: resumed (from bookmarked "
    "resourceVersion after a drop) vs. relist (410 Gone forced a full "
    "relist)",
)
# Scheduling-SLO buckets (seconds): admission to reconcile spans seconds
# to an hour.
SLO_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
    600.0, 1800.0, 3600.0,
)
POD_TIME_TO_ALLOCATE = REGISTRY.histogram(
    "tpu_pod_time_to_allocate_seconds",
    "Admission-stamp to controller reconcile per pod: how long a "
    "released pod took to be scheduled, allocated, and reconciled to "
    "its real chips (exemplar-linked to the allocation trace)",
    buckets=SLO_BUCKETS,
)
