"""The metric classes of the JAX package's ``utils/metrics.py`` (counter,
gauge, histogram with trace exemplars, registry), the families the port's
node daemon writes, under the JAX names and labels, and the daemon's HTTP
endpoint (``MetricsServer``): ``/metrics`` (Prometheus text, or OpenMetrics
with exemplars when the scrape asks for it), ``/healthz`` backed by a
liveness check, and the ``/debug/*`` surfaces of the planes the port has.

The per-card families keep the JAX ``tpu_chip_*`` names, so a dashboard
reads either daemon: ``chip`` is the card's UUID, and the two
``tpu_chip_ici_link_*`` families carry the card's NVLinks, ``link`` being
NVML's link index. The scheduler extender's process serves its own registry
(``EXTENDER_REGISTRY``): the filter/score plane's families under the JAX
names, and the evidence planes' twins, which ``family(name, service)``
picks. ``/debug/profile`` is the one surface that may block: with
``?seconds=N`` it waits for N seconds of samples (at most 60)."""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Tuple

from . import tracing
from .httpserver import BackgroundHTTPServer


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

    def remove_matching(self, **labels) -> int:
        """Delete every series whose label set contains ``labels`` (a subset
        match; none matches all): one call drops every series of a card
        whatever attribution labels they carried. Returns the count."""
        want = set(labels.items())
        with self._lock:
            doomed = [k for k in self._values if want <= set(k)]
            for k in doomed:
                del self._values[k]
            return len(doomed)

    def series(self) -> "list[tuple[dict, float]]":
        """Live (labels, value) pairs."""
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

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
# Black-box recorder families (utils/blackbox.py; --blackbox-dir).
BLACKBOX_RECORDS = REGISTRY.counter(
    "tpu_blackbox_records_total",
    "Records persisted to the crash-durable black box, by kind "
    "(flight/decision/span/heartbeats/metrics/meta/stop - "
    "utils/blackbox.py; read with python -m "
    "k8s_device_plugin_tpu_torch.utils.blackbox <dir>)",
)
BLACKBOX_DROPPED = REGISTRY.counter(
    "tpu_blackbox_dropped_total",
    "Black-box records dropped instead of blocking a hot path, by "
    "reason (queue_full: the bounded queue was at capacity; "
    "write_error: the segment file could not be written)",
)
BLACKBOX_BYTES = REGISTRY.counter(
    "tpu_blackbox_bytes_total",
    "Bytes appended to black-box segment files (statestore-framed; "
    "bounded on disk by rotation and pruning)",
)
BLACKBOX_ROTATIONS = REGISTRY.counter(
    "tpu_blackbox_segment_rotations_total",
    "Black-box segment rotations (a segment reached segment_bytes "
    "and a new one was opened; oldest segments pruned past the "
    "directory byte budget)",
)
BLACKBOX_QUEUE = REGISTRY.gauge(
    "tpu_blackbox_queue_depth",
    "Black-box records waiting in the bounded producer queue at the "
    "last writer drain (sustained depth near queue_max precedes "
    "queue_full drops)",
)
LOOP_STALLS = REGISTRY.counter(
    "tpu_loop_stall_total",
    "Loop stall transitions by loop and reason: stalled (heartbeat "
    "silent past its threshold, counted once per excursion) or died "
    "(the thread exited on an unhandled exception; run_supervised "
    "counts it and trips the thread_liveness audit invariant)",
)
# The runtime-performance plane (utils/profiling.py, utils/stackprof.py):
# heartbeat ages and stall counts from the watchdog, GC pauses from
# gc.callbacks, the sampling profiler's samples and the SLO capture
# bundles, and the lockdep graph. GC pause bucket bounds (seconds): tens of
# microseconds up to 1 s stop-the-world tails.
PAUSE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0,
)
HEARTBEAT_AGE = REGISTRY.gauge(
    "tpu_thread_heartbeat_age_seconds",
    "Seconds since each registered long-lived loop last beat its "
    "heartbeat (utils/profiling.py; exported by the stall watchdog, "
    "pruned when a loop stops cleanly): a frozen age is a wedged or "
    "dead thread",
)
GC_PAUSE = REGISTRY.histogram(
    "tpu_gc_pause_seconds",
    "Stop-the-world duration of each Python GC pass, by generation "
    "(gc.callbacks; utils/profiling.enable_gc_monitor)",
    buckets=PAUSE_BUCKETS,
)
PROFILE_SAMPLES = REGISTRY.counter(
    "tpu_profile_samples_total",
    "Thread-stack samples captured by the sampling profiler "
    "(utils/stackprof.py; --profile-hz, served at /debug/profile)",
)
PROFILE_CAPTURES = REGISTRY.counter(
    "tpu_profile_captures_total",
    "SLO-triggered capture bundles, by reason (slo_<op> / "
    "stall_<loop>) and outcome (ok/budget/error), written by "
    "utils/profiling.CaptureManager to --capture-dir",
)
LOCKDEP_EDGES = REGISTRY.gauge(
    "tpu_lockdep_edges",
    "Distinct lock-order edges (lock A held while acquiring lock B) "
    "recorded by the runtime lockdep graph "
    "(utils/profiling.LockdepGraph; --lockdep): a growing edge set is "
    "normal, a cycle is not",
)
LOCKDEP_CYCLES = REGISTRY.counter(
    "tpu_lockdep_cycles_total",
    "Lock-order inversion cycles detected (two threads acquired the "
    "same locks in opposite orders, a deadlock one interleaving "
    "away); witness stacks are kept in the graph and the lock_order "
    "audit invariant pages CRITICAL while any cycle stands",
)
EVICTIONS = REGISTRY.counter(
    "tpu_plugin_evictions_total",
    "Pods evicted because a chip they hold went Unhealthy, by outcome "
    "(evicted/failed)",
)
# The DRA plane (dra/driver.py).
DRA_CLAIMS = REGISTRY.counter(
    "tpu_plugin_dra_claims_total",
    "DRA claim operations served, by op (prepare/unprepare) and outcome "
    "(ok/error)",
)
DRA_PREPARED = REGISTRY.gauge(
    "tpu_plugin_dra_prepared_claims",
    "DRA claims currently prepared (holding chips) on this node",
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
# Per-card runtime telemetry (telemetry.py's sampler over NVML): labeled by
# chip (the card's UUID) and, when the controller attributes the card, by
# pod/namespace/container/gang. A card's series are pruned when its holder
# changes or its read fails; constant 0 unless --telemetry-interval-s
# starts the sampler.
CHIP_DUTY_CYCLE = REGISTRY.gauge(
    "tpu_chip_duty_cycle",
    "Percent of the last sample window the chip spent executing, by "
    "chip and holding pod/namespace/container/gang",
)
CHIP_HBM_USED = REGISTRY.gauge(
    "tpu_chip_hbm_used_bytes",
    "HBM bytes in use on the chip, by chip and holding pod",
)
CHIP_HBM_RATIO = REGISTRY.gauge(
    "tpu_chip_hbm_used_ratio",
    "HBM in use as a 0-1 fraction of the card's memory total; absent "
    "(not 0) where the total is unknown",
)
CHIP_TEMP = REGISTRY.gauge(
    "tpu_chip_temperature_celsius",
    "Die temperature reported by the chip's telemetry surface",
)
CHIP_POWER = REGISTRY.gauge(
    "tpu_chip_power_watts", "Chip power draw"
)
CHIP_LINK_UP = REGISTRY.gauge(
    "tpu_chip_ici_link_up",
    "Per-link state (1 up, 0 down), by chip and link; on an NVIDIA card "
    "each NVLink, link being NVML's link index",
)
CHIP_LINK_ERRORS = REGISTRY.counter(
    "tpu_chip_ici_link_errors_total",
    "Per-link error events, accumulated from the card's cumulative "
    "counter (reset-safe deltas), by chip and link",
)
TELEMETRY_TICKS = REGISTRY.counter(
    "tpu_telemetry_ticks_total",
    "Telemetry sampler passes, by outcome (ok/error); error means a "
    "chip read raised and that pass exported what it could",
)
# Node capacity (topology/placement.capacity_stats), recomputed from the
# placement state's own search when read after an allocate, free or health
# transition (telemetry.refresh_node_gauges).
NODE_FREE_CHIPS = REGISTRY.gauge(
    "tpu_node_free_chips",
    "Healthy-and-free chips on this node",
)
NODE_BOX_PLACEABLE = REGISTRY.gauge(
    "tpu_node_box_placeable",
    "1 when a request of {size} cards can be placed on this node now, "
    "else 0, for each size from 1 to the node's card count",
)
NODE_BEST_SET_SCORE = REGISTRY.gauge(
    "tpu_node_best_set_score",
    "The average pair link score of the card set the placement would "
    "pick now for a request of {size} cards (2 up to the free count; "
    "absent past it), the reference's getAverageScore",
)
# The consistency audit (audit.py): findings by invariant and severity,
# sweeps by outcome, sweep latency, last clean sweep. Absent/0 unless
# --audit-interval-s starts the auditor.
AUDIT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0,
)
AUDIT_FINDINGS = REGISTRY.gauge(
    "tpu_audit_findings",
    "Open consistency-audit findings by invariant and severity "
    "(audit.py; served at /debug/audit). A series disappears when its "
    "findings clear: absent means clean",
)
AUDIT_SWEEPS = REGISTRY.counter(
    "tpu_audit_sweeps_total",
    "Consistency-audit sweeps run, by outcome (clean/findings/error; "
    "error means an invariant raised and its planes went unaudited that "
    "pass)",
)
AUDIT_SWEEP_SECONDS = REGISTRY.histogram(
    "tpu_audit_sweep_seconds",
    "Wall latency of one consistency-audit sweep across every "
    "registered invariant",
    buckets=AUDIT_BUCKETS,
)
AUDIT_LAST_CLEAN = REGISTRY.gauge(
    "tpu_audit_last_clean_sweep_timestamp",
    "Unix time of the last sweep that found zero drift (and raised no "
    "errors)",
)
BUILD_INFO = REGISTRY.gauge(
    "tpu_build_info",
    "Always 1; the labels are the point: version (the package "
    "__version__), python, and component identify exactly what build "
    "answered this scrape",
)

# The scheduler extender's process exposes its own registry: sharing the
# daemon's would publish every tpu_plugin_* family as constant zeros from
# the extender's Service. The families of the filter/score plane keep the
# JAX names; the evidence planes' twins (same family names as the
# daemon's) are picked by ``family(name, service)``.
EXTENDER_REGISTRY = Registry(uptime_name="tpu_extender_uptime_seconds")
EXTENDER_REQUESTS = EXTENDER_REGISTRY.counter(
    "tpu_extender_requests_total",
    "Scheduler-extender HTTP requests served, by verb (filter/"
    "prioritize) and outcome (ok/error/not_ready/degraded_paused)",
)
EXT_REQUEST_LATENCY = EXTENDER_REGISTRY.histogram(
    "tpu_extender_request_latency_seconds",
    "Scheduler-extender HTTP serving latency by verb (filter/prioritize)",
)
GANG_RESERVED = EXTENDER_REGISTRY.gauge(
    "tpu_gang_reservations",
    "Released-but-unscheduled gangs currently holding a card reservation",
)
GANG_RESERVED_CHIPS = EXTENDER_REGISTRY.gauge(
    "tpu_gang_reserved_chips",
    "Cards fenced off for released-but-unscheduled gangs",
)
GANG_RESERVATIONS_LAPSED = EXTENDER_REGISTRY.counter(
    "tpu_gang_reservations_lapsed_total",
    "Gang reservations that hit the hard age cap with pods still "
    "unscheduled (their cards are no longer fenced)",
)
NODE_CACHE_NODES = EXTENDER_REGISTRY.gauge(
    "tpu_extender_node_cache_nodes",
    "Nodes in the annotation cache by state (with_topology/"
    "without_topology); constant 0 when --node-cache is off",
)
NODE_CACHE_SYNCED = EXTENDER_REGISTRY.gauge(
    "tpu_extender_node_cache_synced",
    "1 once a node relist has succeeded; 0 means no successful relist "
    "yet (name-only requests answer no-topology for unknown nodes) or "
    "--node-cache is off",
)
NODE_CACHE_RELIST_ERRORS = EXTENDER_REGISTRY.counter(
    "tpu_extender_node_cache_relist_errors_total",
    "Node relists that failed (the cache serves stale entries meanwhile)",
)
INDEX_REBUILDS = EXTENDER_REGISTRY.counter(
    "tpu_extender_index_rebuilds_total",
    "Per-node index entry rebuilds (parse + derived-state refresh); "
    "steady state is ~0: a node costs a rebuild only when its "
    "annotation string changes",
)
INDEX_EVENTS = EXTENDER_REGISTRY.counter(
    "tpu_extender_index_events_total",
    "Node observations applied to the topology index, by source "
    "(relist/watch/fetch) and kind (add/update/clear/delete/noop/"
    "restore/coalesced)",
)
INDEX_SLICES = EXTENDER_REGISTRY.gauge(
    "tpu_extender_index_slices",
    "Multi-host slices tracked by the topology index (always 0 on GPU "
    "nodes, which form no multi-host slice)",
)
PARSE_AVOIDED = EXTENDER_REGISTRY.counter(
    "tpu_extender_parse_avoided_total",
    "Annotation parses/derivations avoided, by reason: indexed_rpc "
    "(candidates served by /filter and /prioritize from the topology "
    "index), unchanged_annotation (watch event whose annotation string "
    "was unchanged), derived_memo (entry rebuild served from the "
    "content-addressed derived-state memo), snapshot_restore (entry "
    "installed from the persisted index snapshot with its parse "
    "deferred)",
)
INDEX_SNAPSHOT_LOADS = EXTENDER_REGISTRY.counter(
    "tpu_extender_index_snapshot_loads_total",
    "Persisted topology-index snapshot loads at startup, by outcome "
    "(ok/empty/corrupt/version_mismatch/error)",
)
INDEX_SNAPSHOT_ENTRIES = EXTENDER_REGISTRY.counter(
    "tpu_extender_index_snapshot_entries_total",
    "Per-node snapshot records reconciled against the first relist, by "
    "source (restored/stale/vanished)",
)
INDEX_SNAPSHOT_WRITES = EXTENDER_REGISTRY.counter(
    "tpu_extender_index_snapshot_writes_total",
    "Topology-index snapshot persists (post-relist and graceful stop), "
    "by outcome (ok/error)",
)
INDEX_WARM_SECONDS = EXTENDER_REGISTRY.gauge(
    "tpu_extender_index_warm_seconds",
    "Duration of the last cold-start index warm (snapshot-restored "
    "entries parsed by the background worker pool)",
)
TIME_TO_READY = EXTENDER_REGISTRY.gauge(
    "tpu_extender_time_to_ready_seconds",
    "Startup to /readyz 200 for this incarnation",
)
EXT_PLACEABLE_NODES = EXTENDER_REGISTRY.gauge(
    "tpu_extender_placeable_nodes",
    "Nodes whose published availability places a request of {size} "
    "cards now, for every size from 1 to the node's card count (from "
    "the incremental topology index; absent when --node-cache is off)",
)
EXT_KUBE_RETRIES = EXTENDER_REGISTRY.counter(
    "tpu_extender_kube_retries_total",
    "Kube API attempts retried after a transport-level failure, by verb",
)
EXT_KUBE_CIRCUIT_STATE = EXTENDER_REGISTRY.gauge(
    "tpu_extender_kube_circuit_state",
    "Kube API circuit breaker: 0 closed, 1 open (failing fast), "
    "2 half-open (probing)",
)
EXT_KUBE_REQUEST_LATENCY = EXTENDER_REGISTRY.histogram(
    "tpu_extender_kube_request_latency_seconds",
    "Wall latency of individual kube API request attempts, by verb and "
    "outcome",
)
EXT_KUBE_CALL_OUTCOMES = EXTENDER_REGISTRY.counter(
    "tpu_extender_kube_call_outcomes_total",
    "Kube API call outcomes by verb and outcome (ok / retry / "
    "retry_after / semantic / unavailable / circuit_open)",
)
EXT_KUBE_DEGRADED_MODE = EXTENDER_REGISTRY.gauge(
    "tpu_extender_kube_degraded_mode",
    "1 while the extender serves in explicit degraded mode (circuit "
    "breaker open: /filter and /prioritize answer from the "
    "last-known-good index)",
)
EXT_KUBE_DEGRADED_STALENESS = EXTENDER_REGISTRY.gauge(
    "tpu_extender_kube_degraded_staleness_seconds",
    "Age of the last successful cluster-state sync behind degraded "
    "serving; past --staleness-cap-s /filter answers 503",
)
EXT_KUBE_WATCH_STREAMS = EXTENDER_REGISTRY.counter(
    "tpu_extender_kube_watch_streams_total",
    "Node watch stream recoveries by outcome: resumed (from the "
    "bookmarked resourceVersion after a drop) or relist (410 Gone)",
)
EXT_FLIGHT_EVENTS = EXTENDER_REGISTRY.counter(
    "tpu_extender_flight_events_total",
    "Flight-recorder events captured, by kind (utils/flightrecorder.py; "
    "served at /debug/events)",
)
EXT_DECISIONS = EXTENDER_REGISTRY.counter(
    "tpu_extender_decisions_total",
    "Scheduling decisions recorded by the extender's decision ledger "
    "(utils/decisions.py; served at /debug/decisions), by kind and "
    "machine-readable reason token",
)
EXT_BLACKBOX_RECORDS = EXTENDER_REGISTRY.counter(
    "tpu_blackbox_records_total",
    "Records persisted to the crash-durable black box, by kind",
)
EXT_BLACKBOX_DROPPED = EXTENDER_REGISTRY.counter(
    "tpu_blackbox_dropped_total",
    "Black-box records dropped instead of blocking a hot path, by "
    "reason (queue_full / write_error)",
)
EXT_BLACKBOX_BYTES = EXTENDER_REGISTRY.counter(
    "tpu_blackbox_bytes_total",
    "Bytes appended to black-box segment files (statestore-framed)",
)
EXT_BLACKBOX_ROTATIONS = EXTENDER_REGISTRY.counter(
    "tpu_blackbox_segment_rotations_total",
    "Black-box segment rotations (oldest segments pruned past the "
    "directory byte budget)",
)
EXT_BLACKBOX_QUEUE = EXTENDER_REGISTRY.gauge(
    "tpu_blackbox_queue_depth",
    "Black-box records waiting in the bounded producer queue at the "
    "last writer drain",
)
EXT_BUILD_INFO = EXTENDER_REGISTRY.gauge(
    "tpu_build_info",
    "Always 1; labels version/python/component identify the build "
    "answering this scrape",
)
EXT_HEARTBEAT_AGE = EXTENDER_REGISTRY.gauge(
    "tpu_thread_heartbeat_age_seconds",
    "Seconds since each registered long-lived loop last beat its "
    "heartbeat (utils/profiling.py; pruned on clean stop)",
)
EXT_LOOP_STALLS = EXTENDER_REGISTRY.counter(
    "tpu_loop_stall_total",
    "Loop stall transitions by loop and reason (stalled/died)",
)
EXT_GC_PAUSE = EXTENDER_REGISTRY.histogram(
    "tpu_gc_pause_seconds",
    "Stop-the-world duration of each Python GC pass, by generation",
    buckets=PAUSE_BUCKETS,
)
EXT_LOCK_WAIT = EXTENDER_REGISTRY.histogram(
    "tpu_lock_wait_seconds",
    "Wall time spent waiting for a contended hot-path lock, by lock "
    "(topology_index, reservations: utils/profiling.TimedLock); an "
    "uncontended acquire records nothing",
    buckets=PAUSE_BUCKETS,
)
EXT_PROFILE_SAMPLES = EXTENDER_REGISTRY.counter(
    "tpu_profile_samples_total",
    "Thread-stack samples captured by the sampling profiler "
    "(utils/stackprof.py; --profile-hz, served at /debug/profile)",
)
EXT_PROFILE_CAPTURES = EXTENDER_REGISTRY.counter(
    "tpu_profile_captures_total",
    "SLO-triggered capture bundles, by reason and outcome "
    "(ok/budget/error), written to --capture-dir",
)
EXT_LOCKDEP_EDGES = EXTENDER_REGISTRY.gauge(
    "tpu_lockdep_edges",
    "Distinct lock-order edges recorded by the runtime lockdep graph "
    "(utils/profiling.LockdepGraph; --lockdep)",
)
EXT_LOCKDEP_CYCLES = EXTENDER_REGISTRY.counter(
    "tpu_lockdep_cycles_total",
    "Lock-order inversion cycles detected; the lock_order audit "
    "invariant pages CRITICAL while any cycle stands",
)


def family(name: str, service: str):
    """The family ``name`` (a module attribute of the daemon's registry,
    e.g. ``"HEARTBEAT_AGE"``) as ``service`` exports it: its ``EXT_`` twin
    in the extender's process, itself in the node daemon's."""
    return globals()[f"EXT_{name}" if service == "extender" else name]


def registry_for(service: str) -> Registry:
    """The registry ``service``'s process serves at /metrics."""
    return EXTENDER_REGISTRY if service == "extender" else REGISTRY


def build_info() -> dict:
    """The build's identity (the /debug/audit payload carries it)."""
    import platform

    from .. import __version__

    return {"version": __version__, "python": platform.python_version()}


def set_build_info(component: str) -> None:
    """Publish the build-identity info gauge for this process (value 1,
    identity in the labels). Called once by the entry point."""
    family("BUILD_INFO", component).set(1, component=component, **build_info())


OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def render_scrape(registry: Registry, accept: str) -> Tuple[bytes, str]:
    """(body, content_type) for one /metrics scrape: OpenMetrics (with
    histogram exemplars and ``# EOF``) when the Accept header asks for it,
    classic Prometheus text otherwise."""
    openmetrics = "application/openmetrics-text" in (accept or "")
    body = registry.render(openmetrics=openmetrics).encode()
    ctype = OPENMETRICS_CONTENT_TYPE if openmetrics else "text/plain; version=0.0.4"
    return body, ctype


# Every debug surface this daemon serves, with a line on each: the
# GET /debug index.
DEBUG_ENDPOINTS: Dict[str, str] = {
    "/debug/traces": (
        "span collector OTLP-JSON export (?trace_id= narrows to one "
        "trace); populated when --trace is on"
    ),
    "/debug/events": "flight-recorder ring (bounded, newest last); populated when --trace is on",
    "/debug/decisions": (
        "decision ledger (?pod=/?gang=/?node=/?kind=/?trace_id=/"
        "?limit= filtering); populated when --decisions/--trace is on"
    ),
    "/debug/telemetry": (
        "card-telemetry snapshot: sampler state, attributed per-card "
        "readings and the node's capacity (telemetry.py; "
        "--telemetry-interval-s)"
    ),
    "/debug/audit": (
        "consistency-audit snapshot: invariant registry, open "
        "findings, sweep stats (audit.py; --audit-interval-s)"
    ),
    "/debug/profile": (
        "sampling-profiler export (utils/stackprof.py): speedscope "
        "JSON by default, ?format=collapsed for folded stacks, "
        "?seconds=N for the trailing window (or a one-shot burst "
        "when --profile-hz is 0); a bare GET answers at once with "
        "the profiler's table (or enabled: false)"
    ),
    "/debug/lockdep": (
        "runtime lock-order graph (utils/profiling.LockdepGraph; "
        "--lockdep): recorded edges and any inversion cycles with "
        "their witness stacks; enabled: false when the flag is off"
    ),
    "/debug/blackbox": (
        "crash-durable black-box recorder status (utils/blackbox.py; "
        "--blackbox-dir): config, queue depth, drop counts and "
        "on-disk segment metadata, never record bodies; enabled: "
        "false when no --blackbox-dir is configured"
    ),
    "/debug/resilience": (
        "resilience-layer snapshot (utils/resilience.py TRACKER): "
        "per-verb kube-call outcome counts, breaker open/close "
        "windows, watch resume-vs-relist counts, Retry-After-honored "
        "retries, degraded-mode state and staleness, and the "
        "mutation-while-open evidence the degraded_consistency audit "
        "invariant checks"
    ),
    "/debug/readyz": (
        "readiness phase and index warm progress (extender: "
        "replaying|warming|ready with warm parsed/total, always 200; "
        "the probe's 503 lives at /readyz; node daemon: not configured)"
    ),
}

# () -> dict readiness snapshot (extender/server.py ReadyStatus), installed
# by the extender's entry point. /debug/readyz, unlike /readyz, always
# answers 200, so a not-ready extender still shows its phase.
READYZ_PROVIDER = None


def debug_payload(path: str) -> Optional[bytes]:
    """JSON body for the /debug/* surfaces: /debug (or /debug/) is the
    index of DEBUG_ENDPOINTS, each other path its plane's snapshot. None
    for an unknown path.

    Each provider runs isolated: one that raises degrades its endpoint to
    a 200 ``{"error": ...}`` body instead of taking down the whole /debug
    surface."""
    import json as _json
    import urllib.parse as _up

    parsed = _up.urlparse(path)

    def build() -> Optional[dict]:
        from .decisions import LEDGER
        from .flightrecorder import RECORDER

        if parsed.path in ("/debug", "/debug/"):
            return {"endpoints": dict(DEBUG_ENDPOINTS)}
        if parsed.path == "/debug/telemetry":
            from .. import telemetry

            return telemetry.debug_snapshot()
        if parsed.path == "/debug/audit":
            from .. import audit

            return audit.debug_snapshot()
        if parsed.path == "/debug/resilience":
            from .resilience import TRACKER

            return TRACKER.snapshot()
        if parsed.path == "/debug/readyz":
            if READYZ_PROVIDER is None:
                return {
                    "configured": False,
                    "note": "no readiness status wired in this process (the "
                    "extender's entry point installs one)",
                }
            return READYZ_PROVIDER()
        if parsed.path == "/debug/profile":
            from . import profiling, stackprof

            return stackprof.debug_profile(parsed.query, service=profiling._SERVICE)
        if parsed.path == "/debug/lockdep":
            from . import profiling

            return profiling.LOCKDEP.snapshot()
        if parsed.path == "/debug/blackbox":
            from .blackbox import BLACKBOX

            return BLACKBOX.snapshot()
        if parsed.path == "/debug/traces":
            trace_id = dict(_up.parse_qsl(parsed.query)).get("trace_id", "")
            return tracing.COLLECTOR.otlp_json(trace_id=trace_id)
        if parsed.path == "/debug/events":
            return RECORDER.snapshot()
        if parsed.path == "/debug/decisions":
            q = dict(_up.parse_qsl(parsed.query))
            try:
                limit = int(q.get("limit", "0"))
            except ValueError:
                limit = 0
            return LEDGER.snapshot(
                pod=q.get("pod", ""),
                gang=q.get("gang", ""),
                node=q.get("node", ""),
                kind=q.get("kind", ""),
                trace_id=q.get("trace_id", ""),
                limit=limit,
            )
        return None

    try:
        payload = build()
    except Exception as e:  # noqa: BLE001 - one broken provider must not 500 the plane
        payload = {"error": f"{type(e).__name__}: {e}"}
    if payload is None:
        return None
    try:
        return _json.dumps(payload).encode()
    except (TypeError, ValueError) as e:
        return _json.dumps({"error": f"unserializable payload: {e}"}).encode()


class MetricsServer(BackgroundHTTPServer):
    """Serves GET /metrics and /healthz for Prometheus scrapes and the
    kubelet's liveness probe, plus the /debug/* surfaces.

    ``liveness_check`` (optional, () -> bool) backs /healthz: this server
    runs on its own thread, so an unconditional 200 would only prove the
    HTTP thread is alive. The daemon passes a check of its supervisor
    loop's heartbeat (wedged loop: 503, and the kubelet restarts the
    container). A check that raises reads as not live. Without a check,
    /healthz is process-up.
    """

    def __init__(self, registry: Registry = REGISTRY, host: str = "0.0.0.0",
                 port: int = 0, liveness_check=None):
        super().__init__(host, port)
        self.registry = registry
        self.liveness_check = liveness_check

    def handler_class(self):
        registry = self.registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    # The capacity gauges are computed when read, not in
                    # the RPC that changed them.
                    from .. import telemetry

                    telemetry.refresh_node_gauges()
                    body, ctype = render_scrape(registry, self.headers.get("Accept", ""))
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                elif self.path == "/debug" or self.path.startswith("/debug/"):
                    payload = debug_payload(self.path)
                    if payload is None:
                        body = b"not found\n"
                        self.send_response(404)
                        self.send_header("Content-Type", "text/plain")
                    else:
                        body = payload
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                elif self.path == "/healthz":
                    check = server.liveness_check
                    live = True
                    if check is not None:
                        try:
                            live = bool(check())
                        except Exception:  # noqa: BLE001 - a broken check
                            live = False  # reads as not live, not a 500
                    body = b"ok\n" if live else b"supervisor stalled\n"
                    self.send_response(200 if live else 503)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler
