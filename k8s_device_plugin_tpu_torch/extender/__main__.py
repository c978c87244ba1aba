"""Entry point: ``python -m k8s_device_plugin_tpu_torch.extender [--port
12346] [--node-cache] [--gang-admission [--journal-dir D]] [--kubeconfig
...]``, the scheduler extender's filter/score plane for ``nvidia.com/gpu``
pods and the gang admitter beside it.

With ``--gang-admission`` the process first takes the singleton lease (a
second replica exits 1 and leaves the holder untouched), then replays the
journal while /readyz reads ``replaying``, then serves; the node cache's
index feeds the admitter's capacity view and marks its waiting gangs dirty,
and ``--audit-interval-s`` drives the extender's auditor from the admission
loop. SIGTERM stops the admitter and releases the lease.

With ``--shards N`` (N > 1) admission is sharded (``sharding.py``): the
replica takes its home shard's lease (``--shard-index``, by default the
trailing ordinal of HOSTNAME), runs one admitter per shard it owns with its
journal under ``--journal-dir/shard-<k>``, takes over dead shards' leases
unless ``--no-shard-takeover``, and serves /filter and /prioritize over
every shard's holds.

With ``--gang-admission`` the three eviction planes are on, as in JAX:

* preemption (``preemption.py``): complete gangs are evaluated in
  PriorityClass order, a capacity-blocked gang may evict running gangs of
  strictly lower priority (the minimal victim set, cheapest first, two-phase
  journaled), and ``/preemption`` answers the engine's dry run;
  ``--no-preemption`` keeps every gang equal;
* defragmentation (``defrag.py``): a waiting gang whose demand is stranded
  (enough free cards, no node that places its largest member) may, after
  ``--defrag-stranded-ticks`` and within ``--defrag-max-evictions-per-hour``,
  migrate lower-priority gangs off one node; ``--no-defrag`` turns it off;
* rescue (``rescue.py``): a running gang on a withdrawn card, a NotReady node
  or a draining node is evacuated onto healthy capacity after
  ``--rescue-grace-ticks``; cordoned and tainted nodes leave placement, and
  ``/drain`` serves ``tpu-doctor drain``; ``--no-rescue`` turns it off.

Each admitter (the singleton, or each shard's) gets its own engines over the
one PriorityClass resolver of the process; one node tracker per process
follows the node cache's objects.

The flags keep the JAX extender's names and defaults and are read from the
command line only (no ``TPU_*`` environment alias). A flag of a plane this
port does not have yet is refused with a message naming the slice that
brings it, never accepted and then ignored; every flag of the JAX extender
is taken now.
"""

from __future__ import annotations

import argparse
import gc
import logging
import os
import re
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

# The JAX extender's flags of planes that later slices of the port bring,
# flag -> the slice: none left.
UNPORTED_FLAGS: dict = {}


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
    p.add_argument("--gang-admission", action="store_true",
                   help="run the scheduling-gate gang admitter next to the extender (needs "
                   "API access: in-cluster or --kubeconfig)")
    p.add_argument("--gang-resync-s", type=float, default=5.0,
                   help="gang re-evaluation interval")
    p.add_argument("--gang-full-sweep-s", type=float, default=60.0,
                   help="gang admission's full-sweep backstop interval: the resyncs in "
                   "between are dirty ticks over the event-marked gangs")
    p.add_argument("--no-gang-watch", action="store_true",
                   help="no gang pod watch: pod changes are seen at the full sweep")
    p.add_argument("--gang-pending-event-s", type=float, default=300.0,
                   help="post a kube Event on the members of a gang capacity-waiting longer "
                   "than this many seconds (budgeted and deduplicated; 0 disables)")
    p.add_argument("--journal-dir", default="",
                   help="directory of the crash-safe admission journal: gang reservations, "
                   "lapse bars and wait clocks survive a SIGKILL, and /readyz answers 503 "
                   "until the journal is replayed. Empty keeps admission state in memory "
                   "only")
    p.add_argument("--journal-fsync", action="store_true",
                   help="fsync every journal record (machine-crash durability); by default "
                   "the reserve, admit and lapse records reach the OS before the admitter "
                   "acts on them and the rest at the end of each tick")
    p.add_argument("--shards", type=int, default=1,
                   help="shard gang admission by consistent hash of the node's hostname across "
                   "this many per-shard Leases (extender/sharding.py). 1 keeps the singleton "
                   "admitter; N > 1 runs one admitter per owned shard, each journaled under "
                   "--journal-dir/shard-<k>, /filter and /prioritize on every replica over "
                   "every shard's holds (read off the shard leases' annotations). Run N "
                   "replicas, one home shard each")
    p.add_argument("--shard-index", type=int, default=-1,
                   help="this replica's home shard (0-based); -1 derives it from the trailing "
                   "ordinal of HOSTNAME (a StatefulSet pod's name), else 0")
    p.add_argument("--no-shard-takeover", action="store_true",
                   help="do not take over other shards' stale leases: a dead shard's gangs "
                   "then wait for its own replica's restart")
    p.add_argument("--no-singleton-lease", action="store_true",
                   help="skip the Lease that fences gang admission to one live replica; only "
                   "for dev clusters without lease RBAC")
    p.add_argument("--lease-namespace", default="kube-system",
                   help="namespace of the singleton lease")
    p.add_argument("--lease-seconds", type=float, default=30.0,
                   help="singleton lease duration; the holder demotes itself when it cannot "
                   "renew within 2/3 of it")
    p.add_argument("--audit-interval-s", type=float, default=0.0,
                   help="run the consistency auditor every N seconds from the admission "
                   "loop: the reservation table against the journal's replay, the "
                   "cluster's gangs and their gates (/debug/audit, tpu_audit_*); needs "
                   "--gang-admission. 0 disables it")
    p.add_argument("--no-preemption", action="store_true",
                   help="disable priority tiers and cost-aware preemption "
                   "(extender/preemption.py). By default (with --gang-admission) complete "
                   "gangs evaluate in PriorityClass order and a capacity-blocked "
                   "higher-priority gang may evict strictly lower-priority running gangs: "
                   "the minimal victim set, ranked by tier then restart cost (checkpoint "
                   "recency and duty cycle), two-phase journaled, served as the "
                   "scheduler-extender /preemption verb. With this flag every gang is equal "
                   "(FIFO)")
    p.add_argument("--preemption-rounds-per-tick", type=int, default=1,
                   help="max preemption rounds (one waiting gang's eviction wave) per "
                   "admission tick: the blast-radius budget")
    p.add_argument("--no-defrag", action="store_true",
                   help="disable active defragmentation (extender/defrag.py). By default "
                   "(with --gang-admission) a capacity-waiting gang whose demand is STRANDED "
                   "(enough free cards, but no node places its largest member) may, after "
                   "hysteresis and within the eviction budget, migrate strictly-lower-priority "
                   "running gangs (cheapest restart cost first, proven relocation target) off "
                   "one node, two-phase journaled, fencing the freed cards for the stranded "
                   "gang. With this flag fragmentation is only observed, never repacked")
    p.add_argument("--defrag-max-evictions-per-hour", type=int, default=12,
                   help="rolling-hour ceiling on victim-pod evictions the defrag engine may "
                   "execute: the operator's blast-radius knob (0 closes the gate: stranded "
                   "demand is still detected and exported, but no plan executes)")
    p.add_argument("--defrag-max-concurrent", type=int, default=2,
                   help="max victim GANGS one defrag plan may migrate; plans needing more "
                   "victims are rejected as no_plan")
    p.add_argument("--defrag-stranded-ticks", type=int, default=3,
                   help="consecutive admission ticks a gang's demand must stay stranded before "
                   "the planner is consulted: hysteresis so a transient release race never "
                   "triggers a repack")
    p.add_argument("--no-rescue", action="store_true",
                   help="disable the hardware-failure rescue plane (extender/rescue.py). By "
                   "default (with --gang-admission) a RUNNING gang bound to withdrawn cards, a "
                   "NotReady node, or a draining node is evacuated through a journaled "
                   "two-phase round onto proven healthy capacity (evicting strictly-lower-"
                   "priority gangs under the shared defrag eviction budget) and re-admitted at "
                   "the head of its tier; cordoned/tainted nodes are excluded from placement; "
                   "the /drain verb serves tpu-doctor drain. With this flag gangs die where "
                   "their hardware dies")
    p.add_argument("--rescue-grace-ticks", type=int, default=2,
                   help="consecutive admission ticks a gang must stay degraded before its "
                   "evacuation executes: hysteresis so a health-check flap or node-condition "
                   "blip never evacuates a live job")
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

    # One table joins the two halves: what the gang admitter reserves before
    # it releases gates, /filter and /prioritize withhold, /reservations
    # serves.
    reservations = ReservationTable()
    # Created first, so time-to-ready covers the whole start, relist
    # included. With a journal, /readyz reads "replaying" until recover().
    ready = threading.Event()
    status = ReadyStatus(ready, journal_configured=bool(a.journal_dir and a.gang_admission))
    metrics.READYZ_PROVIDER = status.snapshot
    degraded = None
    client = None
    node_cache = None
    if a.node_cache or a.gang_admission:
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
    # The rescue plane's node lifecycle: one tracker a process (a node's
    # Ready, cordon and taint are the cluster's, not a shard's), fed by the
    # node cache's tap from its first relist on, with no second node watch.
    rescue_tracker = None
    if a.gang_admission and not a.no_rescue:
        from .rescue import NodeStateTracker

        rescue_tracker = NodeStateTracker()
    if a.node_cache:
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
        if rescue_tracker is not None:
            def node_tap(etype, node, tracker=rescue_tracker):
                if etype == "DELETED":
                    tracker.remove_node((node.get("metadata") or {}).get("name", ""))
                else:
                    tracker.update_node(node)

            node_cache.on_node_object = node_tap
        node_cache.start()
        status.warm_progress = node_cache.index.warm_progress
    # The parsed topologies alive at start leave the GC's scan set: a full
    # collection over them is a tail-latency spike on a scheduler RPC.
    gc.collect()
    gc.freeze()
    log = logging.getLogger(__name__)
    sharded = a.gang_admission and a.shards > 1
    if sharded and a.no_singleton_lease:
        log.error("--shards %d needs the per-shard leases: they are the fence sharded "
                  "admission stands on, so --no-singleton-lease cannot go with it", a.shards)
        return 2

    def make_topo_source():
        if node_cache is None:
            return None
        cache = node_cache

        def topo_source():
            # Before the first relist the index is empty, not authoritative:
            # raising routes the tick through its serve-stale-or-skip path
            # instead of reading no capacity.
            if not cache.synced:
                raise RuntimeError("node cache never synced")
            return cache.index.topologies()
        return topo_source

    # The eviction planes (preemption.py, defrag.py, rescue.py): one
    # PriorityClass resolver a process (it caches the class vocabulary) while
    # any of them is on, and each admitter's own engines, the singleton's or
    # every shard's, so a shard's rounds stay inside its own gangs and nodes.
    preempt_resolver = None
    if a.gang_admission and not (a.no_preemption and a.no_defrag and a.no_rescue):
        from .preemption import PriorityResolver

        preempt_resolver = PriorityResolver(client)

    def wire_preemption(adm) -> None:
        if preempt_resolver is None:
            return
        if not a.no_preemption:
            from .preemption import PreemptionEngine

            # The queue's priority order belongs to the preemption plane:
            # --no-preemption keeps every gang equal, and defrag then reads
            # every requestor as standard (0), so it migrates only batch
            # (negative-priority) gangs.
            adm.priority_resolver = preempt_resolver
            adm.preemption = PreemptionEngine(adm, preempt_resolver,
                                              rounds_per_tick=a.preemption_rounds_per_tick)
        if not a.no_defrag:
            from . import defrag as defrag_mod

            # /debug/defrag serves it; the admitter's stop() takes it off
            # (a shard handed back).
            adm.defrag = defrag_mod.DefragEngine(
                adm, preempt_resolver, stranded_ticks=a.defrag_stranded_ticks,
                max_evictions_per_hour=a.defrag_max_evictions_per_hour,
                max_concurrent=a.defrag_max_concurrent)
            defrag_mod.install(adm.defrag)
        if not a.no_rescue:
            from . import rescue as rescue_mod

            # Its detection joins only the admitter's own gangs and nodes;
            # the tracker is the process's. With defrag wired it spends from
            # defrag's window: one blast-radius budget for both planes.
            adm.rescue = rescue_mod.RescueEngine(
                adm, preempt_resolver, tracker=rescue_tracker,
                grace_ticks=a.rescue_grace_ticks,
                max_evictions_per_hour=a.defrag_max_evictions_per_hour)
            adm.rescue.drain_coordinator = rescue_mod.DrainCoordinator(client, adm,
                                                                       rescue_tracker)
            rescue_mod.install(adm.rescue)

    manager = None
    reservations_view = reservations
    if sharded:
        # Built, not started, before the HTTP server, so /filter is shielded
        # by every owned shard's table and the peers' overlays from its
        # first request; the leases and the journals' replay come below,
        # behind the readiness gate, where the singleton's replay runs.
        from .gang import GangAdmission
        from .journal import AdmissionJournal
        from .leader import default_identity
        from .sharding import ShardManager

        home = a.shard_index
        if home < 0:
            m = re.search(r"-(\d+)$", os.environ.get("HOSTNAME", ""))
            home = int(m.group(1)) if m else 0
        home %= a.shards

        def shard_admitter(shard_id, gang_filter, topo_filter):
            shard_journal = None
            if a.journal_dir:
                shard_journal = AdmissionJournal(os.path.join(a.journal_dir, f"shard-{shard_id}"),
                                                 fsync_always=a.journal_fsync)
            adm = GangAdmission(
                client,
                resync_interval_s=a.gang_resync_s,
                reservations=ReservationTable(),
                full_sweep_interval_s=a.gang_full_sweep_s,
                topo_source=make_topo_source(),
                watch=not a.no_gang_watch,
                pending_event_threshold_s=a.gang_pending_event_s,
                journal=shard_journal,
                gang_filter=gang_filter,
                topo_filter=topo_filter,
                shard_id=shard_id,
            )
            adm.degraded = degraded
            wire_preemption(adm)
            return adm

        def shard_lost(shard_id: int) -> None:
            # The singleton's rationale, per shard: a write in flight dies
            # with the process; the kubelet restarts it into a clean acquire.
            log.error("shard %d lease lost; exiting immediately so no in-flight admission "
                      "write can land past the takeover horizon", shard_id)
            os._exit(1)

        manager = ShardManager(client, shards=a.shards, home_shard=home,
                               admitter_factory=shard_admitter,
                               lease_namespace=a.lease_namespace, lease_seconds=a.lease_seconds,
                               identity=default_identity(), takeover=not a.no_shard_takeover,
                               on_shard_lost=shard_lost)
        reservations_view = manager.reservations_view()
        metrics.SHARD_PROVIDER = manager.status
        status.shard_status = manager.status
        if node_cache is not None:
            node_cache.index.on_change = (
                lambda name, slice_keys: manager.note_node_event(slice_keys, node=name))
    # The singleton fence before anything serves: the reservation table is
    # this process's memory, so gang admission runs in exactly one live
    # replica. A second replica exits 1 here, loudly, and the holder is left
    # untouched. Sharded, the per-shard leases are this fence, once a shard.
    leader = None
    if a.gang_admission and not a.no_singleton_lease and not sharded:
        from .leader import LeaderLease, SecondReplica

        def lease_lost():
            # A hard exit, not a graceful stop: a stop takes seconds, in
            # which a gate patch already in flight could land after the
            # lease became takeover-able. The kubelet restarts the pod into
            # a clean acquire.
            log.error("singleton lease lost; exiting immediately so no in-flight admission "
                      "write can land past the takeover horizon")
            os._exit(1)

        leader = LeaderLease(client, namespace=a.lease_namespace,
                             lease_seconds=a.lease_seconds, on_lost=lease_lost)
        try:
            leader.start()
        except SecondReplica as e:
            log.error("REFUSING to start gang admission: %s. The extender Deployment must stay "
                      "at replicas: 1 (deploy/nvidia-extender-torch.yml): a second admitter "
                      "would run its own reservation table and the gang release fence would "
                      "silently stop holding. Scale back down, shard it (--shards, one "
                      "replica a shard), or pass --no-singleton-lease on a dev cluster "
                      "without lease RBAC.", e)
            return 1
    identity = manager.identity if manager is not None else (
        leader.identity if leader is not None else "")
    srv = ExtenderHTTPServer(
        extender=TopologyExtender(reservations=reservations_view, node_cache=node_cache),
        host=a.host, port=a.port, ready_check=ready.is_set, ready_status=status.snapshot,
        degraded=degraded, identity=identity)
    srv.start()
    log.info("extender serving on %s:%d", a.host, srv.port)
    gang = None
    if sharded:
        from .leader import SecondReplica

        try:
            # The home shard's lease (fail fast: the singleton's contract per
            # shard), its journal's replay, the peer scan; dead shards are
            # taken over on the scan loop.
            manager.start()
        except SecondReplica as e:
            log.error("REFUSING to start shard %d admission: %s. Another replica holds this "
                      "shard's lease as its home: give each replica its own --shard-index "
                      "(a StatefulSet's ordinal does by default).", manager.home_shard, e)
            return 1
        gang = manager.home_admission()
    elif a.gang_admission:
        from .gang import GangAdmission

        journal = None
        if a.journal_dir:
            from .journal import AdmissionJournal

            journal = AdmissionJournal(a.journal_dir, fsync_always=a.journal_fsync)
        gang = GangAdmission(
            client,
            resync_interval_s=a.gang_resync_s,
            reservations=reservations,
            full_sweep_interval_s=a.gang_full_sweep_s,
            topo_source=make_topo_source(),
            watch=not a.no_gang_watch,
            pending_event_threshold_s=a.gang_pending_event_s,
            journal=journal,
        )
        gang.degraded = degraded
        wire_preemption(gang)
        if node_cache is not None:
            # A node's annotation change wakes the capacity-waiting gangs.
            node_cache.index.on_change = (
                lambda name, slice_keys: gang.note_node_event(slice_keys, node=name))
        # Replay before the scheduler's calls are served or a tick runs: the
        # lease is held (the journal has one writer), and recover() never
        # raises. The index's warm pool runs beside it.
        gang.recover()
        gang.start()
    status.mark_replayed()
    if preempt_resolver is not None and not a.no_preemption:
        # Only with the preemption plane: with defrag or rescue alone the
        # verb answers 404, as without any plane, not an empty dry run.
        def preemption_verb(pod: dict) -> dict:
            # The dry run of the scheduler-extender verb (the scheduler that
            # calls it evicts); sharded, the home shard's engine answers.
            # Each shard's own tick drives its rounds regardless.
            adm = manager.home_admission() if manager is not None else gang
            engine = getattr(adm, "preemption", None)
            if engine is None:
                return {"nodeNameToMetaVictims": {}}
            return engine.dry_run(pod)

        srv.preemption_handler = preemption_verb
    if rescue_tracker is not None:
        def drain_verb(node: str, action: str) -> dict:
            # Cordon and taint are the cluster's, and every shard's placement
            # reads the one tracker: sharded, the home shard's plane answers.
            adm = manager.home_admission() if manager is not None else gang
            coord = getattr(getattr(adm, "rescue", None), "drain_coordinator", None)
            if coord is None:
                return {"error": "rescue plane not active on this replica"}
            if action == "drain":
                return coord.drain(node)
            if action == "uncordon":
                return coord.uncordon(node)
            return coord.status(node)

        srv.drain_handler = drain_verb
    auditor = None
    if a.audit_interval_s > 0:
        from .. import audit

        # The sweeps ride the admission tick: parse the package for the
        # static loop inventory now, before /readyz, not in the first tick.
        audit.static_loop_inventory()
        auditor_lock = threading.Lock()

        def build_auditor(gang_obj):
            # The scan thread's late adoption and this thread's check can
            # both reach here: the lock makes the second call a no-op.
            with auditor_lock:
                if gang_obj is not None and gang_obj.auditor is not None:
                    return gang_obj.auditor
                return _build_auditor(gang_obj)

        def _build_auditor(gang_obj):
            ext_audit = audit.ExtenderAudit(
                # Sharded: the home shard's own table and journal (the loop
                # the sweeps ride); unsharded, the one table.
                reservations=gang_obj.reservations if gang_obj is not None else reservations,
                journal=gang_obj.journal if gang_obj is not None else None,
                gang=gang_obj,
                index=node_cache.index if node_cache is not None else None,
                shard_manager=manager,
            )
            engine = ext_audit.engine(interval_s=a.audit_interval_s)
            if not engine.invariants:
                # No plane to join: an engine of no invariant would sweep
                # clean while auditing nothing.
                log.warning("--audit-interval-s set but no auditable plane is wired (need "
                            "--gang-admission and/or --node-cache); the consistency auditor "
                            "will not run")
                return None
            audit.install_engine(engine)
            if gang_obj is not None:
                # Sweeps ride the admission loop, the journal's one writer.
                gang_obj.auditor = engine
            else:
                # No admitter: only the index's invariant is wired, safe on
                # its own thread (entries are immutable, gauges atomic).
                engine.start()
            return engine

        if sharded and gang is None:
            # A standby start (an interim owner holds the home shard): the
            # auditor is built when the scan adopts the home shard. The scan
            # may have adopted it before the hook was set: build now if so
            # (build_auditor builds once, whichever thread comes first).
            manager.on_home_adopted = build_auditor
            late = manager.home_admission()
            if late is not None:
                build_auditor(late)
        else:
            auditor = build_auditor(gang)
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
    if auditor is not None and gang is None:
        auditor.stop()  # an engine the admission loop drives stops with it
    if manager is not None:
        # Every owned shard's admitter stopped and its lease released.
        manager.stop()
    elif gang is not None:
        gang.stop()
    if leader is not None:
        # Cleared on the way out, so a successor acquires at once.
        leader.stop()
    if node_cache is not None:
        node_cache.stop()
    srv.stop()
    # Last out: the black box drains what the teardown recorded.
    BLACKBOX.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
