"""Entry point: ``python -m k8s_device_plugin_tpu_torch.extender [--port
12346] [--node-cache [--kubeconfig ...]]``, the scheduler extender's
filter/score plane for ``nvidia.com/gpu`` pods.

The flags keep the JAX extender's names and defaults and are read from the
command line only (no ``TPU_*`` environment alias). A flag of a plane this
slice does not have is refused with a message naming the slice that brings
it, never accepted and then ignored.
"""

from __future__ import annotations

import argparse
import gc
import logging
import signal
import sys
import threading

from ..utils import logging as tpulog
from ..utils import metrics, profiling, stackprof, tracing
from ..utils.blackbox import BLACKBOX
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from .reservations import ReservationTable
from .server import ExtenderHTTPServer, NodeAnnotationCache, ReadyStatus, TopologyExtender

# The JAX extender's flags of planes that later slices of the port bring.
_ADMISSION = "gang admission with its journal and leader lease (the extender's next slice)"
_SHARDING = "reservation refencing and sharding"
_PREEMPTION = "preemption"
_DEFRAG = "defragmentation and rescue"
UNPORTED_FLAGS = {
    "--gang-admission": _ADMISSION,
    "--gang-resync-s": _ADMISSION,
    "--gang-full-sweep-s": _ADMISSION,
    "--no-gang-watch": _ADMISSION,
    "--gang-pending-event-s": _ADMISSION,
    "--journal-dir": _ADMISSION,
    "--journal-fsync": _ADMISSION,
    "--no-singleton-lease": _ADMISSION,
    "--lease-namespace": _ADMISSION,
    "--lease-seconds": _ADMISSION,
    "--audit-interval-s": _ADMISSION + ", which brings the extender's audit",
    "--shards": _SHARDING,
    "--shard-index": _SHARDING,
    "--no-shard-takeover": _SHARDING,
    "--no-preemption": _PREEMPTION,
    "--preemption-rounds-per-tick": _PREEMPTION,
    "--no-defrag": _DEFRAG,
    "--defrag-max-evictions-per-hour": _DEFRAG,
    "--defrag-max-concurrent": _DEFRAG,
    "--defrag-stranded-ticks": _DEFRAG,
    "--no-rescue": _DEFRAG,
    "--rescue-grace-ticks": _DEFRAG,
}


class _Unported(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: it comes with the slice of "
                     f"{UNPORTED_FLAGS[option_string]}")


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="nvidia-scheduler-extender",
        description="kube-scheduler extender that filters and scores nodes for "
        "nvidia.com/gpu pods on the nvidia.com/gpu-topology annotation",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12346)
    p.add_argument("--kubeconfig", default="",
                   help="kube config of the API server (default $KUBECONFIG, else the "
                   "in-cluster service account)")
    p.add_argument("--node-cache", action="store_true",
                   help="serve nodeCacheCapable (name-only) scheduler requests from a "
                   "relisted and watched node-annotation cache (needs API access)")
    p.add_argument("--node-cache-interval-s", type=float, default=5.0,
                   help="node-annotation cache relist interval")
    p.add_argument("--no-node-watch", action="store_true",
                   help="no node watch: the topology index is invalidated by the "
                   "relist alone, at the cache interval")
    p.add_argument("--node-relist-backstop-s", type=float, default=300.0,
                   help="with the node watch on, how often a full relist runs anyway "
                   "(the level-triggered backstop against missed events)")
    p.add_argument("--index-snapshot-dir", default="",
                   help="directory of the persisted topology-index snapshot "
                   "(index.snapshot.json): on restart a node whose annotation is "
                   "unchanged restores without a parse. Empty pays the full parse on "
                   "every start. Needs --node-cache")
    p.add_argument("--index-warm-workers", type=int, default=2,
                   help="threads that parse snapshot-restored index entries in the "
                   "background (0: entries parse on first demand)")
    p.add_argument("--node-event-coalesce-s", type=float, default=0.25,
                   help="coalesce node watch events for this long and apply the latest "
                   "per node; 0 applies every event inline")
    p.add_argument("--staleness-cap-s", type=float, default=60.0,
                   help="degraded-serving staleness cap: while the kube circuit breaker "
                   "is open /filter and /prioritize answer from the last-known-good "
                   "index until the last successful sync is this old, then 503")
    p.add_argument("--trace", action="store_true",
                   help="spans at /debug/traces (/filter and /prioritize of one cycle "
                   "in one trace) and the flight recorder at /debug/events")
    p.add_argument("--decisions", action="store_true",
                   help="the decision ledger at /debug/decisions (filter rejections "
                   "with their reason tokens, prioritize breakdowns); implied by --trace")
    p.add_argument("--log-json", action="store_true",
                   help="JSON-lines logs with trace correlation")
    p.add_argument("--flight-dir", default="",
                   help="directory of the flight-recorder dumps on SIGTERM; empty keeps "
                   "the ring in memory and HTTP only")
    p.add_argument("--profile-hz", type=float, default=0.0,
                   help="run the sampling wall-clock profiler at this rate "
                   "(/debug/profile); 0 runs no sampler thread")
    p.add_argument("--capture-dir", default="",
                   help="directory of the SLO capture bundles; empty disables capture")
    p.add_argument("--capture-p99-ms", type=float, default=0.0,
                   help="windowed /filter and /prioritize p99 threshold (ms) that writes "
                   "a capture bundle; 0 disables the SLO trigger")
    p.add_argument("--lockdep", action="store_true",
                   help="record the runtime lock-order graph of the index's and the "
                   "reservation table's locks (/debug/lockdep)")
    p.add_argument("--blackbox-dir", default="",
                   help="directory of the crash-durable black box (flight events, ledger "
                   "decisions, spans, heartbeat and metric snapshots); implies the "
                   "flight recorder; empty disables it")
    p.add_argument("--blackbox-fsync-s", type=float, default=2.0,
                   help="black-box fsync cadence in seconds; 0 fsyncs every drain")
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", action=_Unported, default=argparse.SUPPRESS,
                       help=argparse.SUPPRESS)
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(sys.argv[1:] if argv is None else argv)
    tpulog.setup(verbose=a.verbose, json=a.log_json, service="extender")
    if a.trace:
        tracing.enable(service="extender")
        RECORDER.enable(service="extender", dump_dir=a.flight_dir)
    if a.decisions or a.trace:
        LEDGER.enable(service="extender")
    metrics.set_build_info("extender")
    # The runtime-performance plane: the watchdog and the GC monitor always
    # run; the profiler and the capture only with their flags.
    profiling.set_service("extender")
    profiling.enable_gc_monitor()
    if a.lockdep:
        profiling.LOCKDEP.enable()
    profiler = None
    if a.profile_hz > 0:
        profiler = stackprof.SamplingProfiler(hz=a.profile_hz, service="extender")
        stackprof.install_profiler(profiler)
        profiler.start()
    profiling.CAPTURE.configure(capture_dir=a.capture_dir, p99_ms=a.capture_p99_ms,
                                service="extender")
    watchdog = profiling.StallWatchdog(service="extender",
                                       on_stall=profiling.CAPTURE.heartbeat_stall).start()
    if a.blackbox_dir:
        if not RECORDER.enabled:
            RECORDER.enable(service="extender", dump_dir=a.flight_dir)
        BLACKBOX.start(a.blackbox_dir, service="extender",
                       fsync_interval_s=a.blackbox_fsync_s)

    # The table gang admission will fill; /filter and /prioritize shield
    # with it, /reservations serves it.
    reservations = ReservationTable()
    # Created first, so time-to-ready covers the whole start, relist
    # included.
    ready = threading.Event()
    status = ReadyStatus(ready)
    metrics.READYZ_PROVIDER = status.snapshot
    degraded = None
    node_cache = None
    if a.node_cache:
        from ..kube.client import KubeClient
        from ..utils import resilience

        client = KubeClient.from_env(a.kubeconfig)
        # Flipped by the circuit breaker: while open, serving continues from
        # the last-known-good index; past --staleness-cap-s it pauses.
        degraded = resilience.DegradedMode(
            staleness_cap_s=a.staleness_cap_s, name="extender",
            gauge=metrics.EXT_KUBE_DEGRADED_MODE,
            staleness_gauge=metrics.EXT_KUBE_DEGRADED_STALENESS)
        status.degraded = degraded
        client.resilience = resilience.Resilience(metrics=resilience.extender_metrics(),
                                                  degraded=degraded)
        node_cache = NodeAnnotationCache(
            client,
            interval_s=a.node_cache_interval_s,
            watch=not a.no_node_watch,
            watch_backstop_s=a.node_relist_backstop_s,
            snapshot_dir=a.index_snapshot_dir,
            warm_workers=a.index_warm_workers,
            event_coalesce_s=a.node_event_coalesce_s,
        )
        node_cache.degraded = degraded
        node_cache.start()
        status.warm_progress = node_cache.index.warm_progress
    # The parsed topologies alive at start leave the GC's scan set: a full
    # collection over them is a tail-latency spike on a scheduler RPC.
    gc.collect()
    gc.freeze()
    srv = ExtenderHTTPServer(
        extender=TopologyExtender(reservations=reservations, node_cache=node_cache),
        host=a.host, port=a.port, ready_check=ready.is_set, ready_status=status.snapshot,
        degraded=degraded)
    srv.start()
    logging.getLogger(__name__).info("extender serving on %s:%d", a.host, srv.port)
    status.mark_ready()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    RECORDER.dump_on("sigterm")
    watchdog.stop()
    if profiler is not None:
        profiler.stop()
        stackprof.install_profiler(None)
    if node_cache is not None:
        node_cache.stop()
    srv.stop()
    # Last out: the black box drains what the teardown recorded.
    BLACKBOX.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
