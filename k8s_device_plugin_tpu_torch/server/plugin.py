"""The NVIDIA device-plugin gRPC server (kubelet-facing): the counterpart of
the JAX package's ``server/plugin.py`` (``TpuDevicePlugin``) over the node's
cards as NVML reads them (``topology/links.LinkTopology``).

The lifecycle is the JAX plugin's, copied: serve on its own unix socket
under the kubelet's device-plugins directory, self-dial the socket,
register with the kubelet (or through the plugin watcher), stream the
device list, answer GetPreferredAllocation through the placement state and
Allocate in two phases under one lock, re-advertise on both health
transitions, and re-serve and re-register after a kubelet restart. The
reference is the NvidiaDevicePlugin (server.go:36-284).

Where the GPU plugin differs from the TPU one is the container response:

* ``DeviceSpec``s for each card's ``/dev/nvidia<minor>`` and the node-level
  nodes of ``extra_device_paths`` (the daemon passes ``/dev/nvidiactl``).
* ``NVIDIA_VISIBLE_DEVICES``: the allocated UUIDs, in order, the env the
  reference returns (server.go:196-198) and the NVIDIA container runtime
  reads to inject the cards and the NVIDIA driver's libraries. There is no libtpu
  mount to make, and none of the TPU env (the bounds, accelerator type,
  worker and multi-host slice variables, the vfio reindex): CUDA reads
  none of it.
* ``TPU_PLUGIN_ALLOCATED_CHIPS``, the plugin's own count, which the smoke
  pod checks against the cards it sees (``workload/chips.py``); the
  pod-devices annotation; and CDI names ``<cdi_kind>=<uuid>`` when
  ``cdi_kind`` is set.

As in JAX, two hooks tell the kube plane (``controller/wiring.py``):
``on_availability_change`` on every allocation, free and health
transition (the node annotation's republish), and
``on_health_transition(card_id, healthy)`` (the Kubernetes Event and the
eviction of the pods on a broken card). The same transitions mark the
node's capacity gauges for recomputing when they are next read
(``telemetry.capacity_changed``). The SLO capture
of Allocate latency comes with the rest of the observability plane.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent import futures
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import grpc

from ..api import constants
from ..api import deviceplugin_pb2 as pb
from ..api import pluginregistration_pb2 as regpb
from ..api.grpc_defs import (
    DevicePluginServicer,
    RegistrationStub,
    WatcherRegistrationServicer,
    add_device_plugin_servicer,
    add_watcher_registration_servicer,
)
from ..discovery.chips import GpuChip
from ..topology.links import LinkTopology
from ..topology.placement import GpuPlacementState
from ..utils import metrics, profiling, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger

log = get_logger(__name__)

# cgroup device permissions for the /dev/nvidia* nodes.
DEVICE_PERMISSIONS = "rwm"


@dataclasses.dataclass
class PluginConfig:
    """Knobs the reference hard-codes or reads from env (server.go:30-33,
    main.go:19-21)."""

    resource_name: str = constants.RESOURCE_NAME
    plugin_socket_name: str = constants.PLUGIN_SOCKET_NAME
    device_plugin_dir: str = constants.DEVICE_PLUGIN_PATH
    # Reference-compatible Allocate-time substitution for kubelets too old
    # for GetPreferredAllocation (the reference's shadowMap,
    # server.go:185-216).
    substitute_on_allocate: bool = False
    # Node-level device nodes injected alongside every non-empty card
    # allocation: the NVIDIA driver's /dev/nvidiactl, which every CUDA process
    # opens beside its cards' nodes.
    extra_device_paths: tuple = ()
    # CDI (Container Device Interface, k8s >= 1.26): when set (e.g.
    # "nvidia.com/gpu"), Allocate also returns fully-qualified CDI device
    # names "<kind>=<uuid>" so CDI-aware runtimes do the device injection
    # instead of the raw DeviceSpecs. Both are returned; the runtime uses
    # whichever it supports.
    cdi_kind: str = ""
    # How to register with the kubelet:
    #   "register" — dial the kubelet's v1beta1 Registration.Register RPC
    #                (the only path the reference has, server.go:136-155);
    #   "watcher"  — serve pluginregistration/v1 on a socket under
    #                plugins_registry_dir and let the kubelet's plugin
    #                watcher dial us (kubelet >= 1.12);
    #   "both"     — do both (harmless: the kubelet dedups by resource).
    registration_mode: str = "register"
    plugins_registry_dir: str = "/var/lib/kubelet/plugins_registry/"
    watcher_socket_name: str = "nvidia.com-gpu-reg.sock"

    @property
    def socket_path(self) -> str:
        return os.path.join(self.device_plugin_dir, self.plugin_socket_name)

    @property
    def watcher_socket_path(self) -> str:
        return os.path.join(self.plugins_registry_dir, self.watcher_socket_name)

    @property
    def kubelet_socket(self) -> str:
        return os.path.join(self.device_plugin_dir, constants.KUBELET_SOCKET_NAME)


class GpuDevicePlugin(DevicePluginServicer):
    """Serves the DevicePlugin service for one node's NVIDIA cards."""

    def __init__(
        self,
        topology: LinkTopology,
        state: Optional[GpuPlacementState] = None,
        config: Optional[PluginConfig] = None,
    ):
        self.topology = topology
        self.state = state or GpuPlacementState(topology)
        self.config = config or PluginConfig()
        # kubelet-chosen ID → actually-allocated ID, drained by a
        # checkpoint reconciliation (the reference's shadowMap,
        # server.go:49, controller.go:200-210). Only populated in
        # substitute_on_allocate mode.
        self.shadow_map: Dict[str, str] = {}
        # Permanent record of substitution-mode kubeletID→realID mappings
        # (shadow_map entries are drained on reconcile): the latest
        # mapping per kubelet id.
        self.substitutions: Dict[str, str] = {}
        self._server: Optional[grpc.Server] = None
        self._watcher_server: Optional[grpc.Server] = None
        self._stop = threading.Event()
        # Kubelet-restart re-registration watcher (start_restart_watch):
        # its own stop event, NOT self._stop — a restart cycle calls
        # start(), which clears self._stop, and the watcher must
        # outlive every such cycle until the real stop().
        self._rereg_stop = threading.Event()
        self._rereg_thread: Optional[threading.Thread] = None
        self._rereg_baseline: Optional[Tuple[int, int]] = None
        self._rereg_interval = 5.0
        # Serializes Allocate plan→commit so concurrent RPCs (8-thread
        # executor) can't plan overlapping card sets.
        self._allocate_lock = threading.Lock()
        # Invoked (no args) whenever allocatable capacity changes —
        # allocation, free, health transition. The wiring attaches the
        # node-annotation republisher here so a scheduler extender sees
        # live availability.
        self.on_availability_change: Optional[Callable[[], None]] = None
        # Invoked (card_id, healthy) on health transitions; the wiring
        # attaches a Kubernetes Event emitter and the controller's
        # eviction (the reference wires an event broadcaster but never
        # emits, controller.go:76-80).
        self.on_health_transition: Optional[Callable[[str, bool], None]] = None
        # Cards held by a co-resident plane the kubelet can't see (a DRA
        # driver's prepared claims). Allocate refuses these outright.
        self.external_holds: Optional[Callable[[], set]] = None
        # The Allocate spans' ids while tracing is on ({ids, trace_id,
        # span_id}), for a controller to adopt into the pod's trace once
        # it knows the pod. Bounded.
        self.recent_allocations: "collections.deque" = collections.deque(maxlen=64)
        metrics.CHIPS.set(len(topology.chips), state="total")
        self._update_chip_gauges()
        # Device-list versioning: streams re-send whenever bumped.
        self._version = 0
        self._version_cv = threading.Condition()

    # ------------------------------------------------------------------
    # Lifecycle (reference Start/Stop/Serve/Register, server.go:93-155,256)
    # ------------------------------------------------------------------

    def start(self) -> None:
        sock = self.config.socket_path
        if os.path.exists(sock):
            os.unlink(sock)
        self._stop.clear()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[("grpc.max_concurrent_streams", 64)],
        )
        add_device_plugin_servicer(self, self._server)
        self._server.add_insecure_port(f"unix:{sock}")
        self._server.start()
        # Self-dial probe, like the reference's dial-after-listen
        # (server.go:110-116): fail fast if the socket isn't servable.
        with grpc.insecure_channel(f"unix:{sock}") as ch:
            grpc.channel_ready_future(ch).result(timeout=5)
        log.info("device plugin serving on %s", sock)

    def stop(self) -> None:
        self._rereg_stop.set()
        if self._rereg_thread is not None:
            self._rereg_thread.join(timeout=5)
            self._rereg_thread = None
        self._stop.set()
        with self._version_cv:
            self._version_cv.notify_all()
        if self._server is not None:
            self._server.stop(grace=1).wait()
            self._server = None
        if self._watcher_server is not None:
            self._watcher_server.stop(grace=1).wait()
            self._watcher_server = None
            try:
                os.unlink(self.config.watcher_socket_path)
            except OSError:
                pass
        try:
            os.unlink(self.config.socket_path)
        except OSError:
            pass

    def register(self, timeout: float = 10.0) -> None:
        """Register with the kubelet (reference server.go:136-155)."""
        with grpc.insecure_channel(f"unix:{self.config.kubelet_socket}") as ch:
            grpc.channel_ready_future(ch).result(timeout=timeout)
            stub = RegistrationStub(ch)
            stub.Register(
                pb.RegisterRequest(
                    version=constants.VERSION,
                    endpoint=self.config.plugin_socket_name,
                    resource_name=self.config.resource_name,
                    options=pb.DevicePluginOptions(
                        get_preferred_allocation_available=True,
                    ),
                ),
                timeout=timeout,
            )
        log.info(
            "registered %s with kubelet at %s",
            self.config.resource_name,
            self.config.kubelet_socket,
        )

    def start_watcher_registration(self) -> None:
        """Serve pluginregistration/v1 under plugins_registry so the
        kubelet's plugin watcher registers us (GetInfo → it dials our
        DevicePlugin endpoint; NotifyRegistrationStatus reports back)."""
        plugin = self

        class _Watcher(WatcherRegistrationServicer):
            def GetInfo(self, request, context):
                return regpb.PluginInfo(
                    type="DevicePlugin",
                    name=plugin.config.resource_name,
                    endpoint=plugin.config.socket_path,
                    supported_versions=[constants.VERSION],
                )

            def NotifyRegistrationStatus(self, request, context):
                if request.plugin_registered:
                    log.info(
                        "kubelet plugin watcher registered %s",
                        plugin.config.resource_name,
                    )
                else:
                    log.error(
                        "kubelet plugin watcher REJECTED %s: %s",
                        plugin.config.resource_name,
                        request.error,
                    )
                    metrics.GRPC_ERRORS.inc(method="WatcherRegistration")
                return regpb.RegistrationStatusResponse()

        sock = self.config.watcher_socket_path
        os.makedirs(self.config.plugins_registry_dir, exist_ok=True)
        if os.path.exists(sock):
            os.unlink(sock)
        self._watcher_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=2)
        )
        add_watcher_registration_servicer(_Watcher(), self._watcher_server)
        self._watcher_server.add_insecure_port(f"unix:{sock}")
        self._watcher_server.start()
        log.info("plugin-watcher registration socket at %s", sock)

    def serve(self) -> None:
        mode = self.config.registration_mode
        if mode not in ("register", "watcher", "both"):
            # Before start(): the error path must not leave a running gRPC
            # server + plugin socket behind (argparse choices guard the
            # CLI; this guards library callers).
            raise ValueError(f"unknown registration_mode {mode!r}")
        self.start()
        if mode in ("watcher", "both"):
            self.start_watcher_registration()
        if mode in ("register", "both"):
            self.register()

    # ------------------------------------------------------------------
    # Kubelet-restart re-registration
    # ------------------------------------------------------------------
    #
    # A kubelet restart silently unregisters every device plugin: the
    # kubelet wipes its device-plugins dir (taking our serving socket
    # with it), comes back up with an empty plugin registry, and the
    # node advertises zero cards until someone registers
    # again. The reference plugin handles this with an fsnotify watch
    # on the kubelet socket (the upstream nvidia pattern); here a
    # supervised poll loop watches BOTH signals — the kubelet socket
    # changing identity (restart) and our own socket vanishing (dir
    # wipe) — and re-runs the serve()+register() cycle. Device,
    # health, and allocation state all live in PlacementState, not in
    # the gRPC server, so a re-serve loses nothing.

    def start_restart_watch(self, interval_s: float = 5.0) -> None:
        """Start the kubelet-restart watcher (supervised +
        heartbeat). Called by the daemon entrypoint after the first
        serve(); idempotent."""
        if self._rereg_thread is not None:
            return
        self._rereg_interval = max(0.5, float(interval_s))
        self._rereg_stop.clear()
        # Baseline the kubelet socket identity HERE, on the caller's
        # thread, not inside the loop: a kubelet restart that lands in
        # the window between this call and the thread's first
        # instruction would otherwise become the baseline and the
        # restart would never be detected.
        self._rereg_baseline = self._kubelet_socket_ino()
        self._rereg_thread = threading.Thread(
            target=profiling.supervised(
                "plugin_reregister", self._reregister_loop
            ),
            name="plugin-reregister",
            daemon=True,
        )
        self._rereg_thread.start()

    def _kubelet_socket_ino(self) -> Optional[Tuple[int, int]]:
        # Identity is (inode, mtime_ns), not inode alone: tmpfs and
        # overlayfs happily hand the recreated kubelet.sock the same
        # inode number back, which would make a fast kubelet bounce
        # invisible. The creation timestamp disambiguates.
        try:
            st = os.stat(self.config.kubelet_socket)
            return (st.st_ino, st.st_mtime_ns)
        except OSError:
            return None

    def _reregister_loop(self) -> None:
        hb = profiling.HEARTBEATS.register(
            "plugin_reregister", interval_s=self._rereg_interval
        )
        last_ino = self._rereg_baseline
        pending: Optional[str] = None
        while not self._rereg_stop.wait(self._rereg_interval):
            hb.beat()
            ino = self._kubelet_socket_ino()
            if pending is None:
                if not os.path.exists(self.config.socket_path):
                    pending = "plugin_socket_vanished"
                elif (
                    ino is not None
                    and last_ino is not None
                    and ino != last_ino
                ):
                    pending = "kubelet_restart"
            if ino is not None:
                last_ino = ino
            if pending is None:
                continue
            if ino is None:
                # The kubelet is still down: nothing to register
                # with. Keep the trigger pending and retry next beat.
                continue
            try:
                self._restart_serving(pending)
            except Exception as e:  # noqa: BLE001 — the kubelet may
                # still be coming up (Register refused, dial timeout):
                # keep the trigger pending, retry next beat.
                log.warning(
                    "re-registration after %s failed (%s); retrying",
                    pending, e,
                )
                continue
            pending = None
            last_ino = self._kubelet_socket_ino()

    def _restart_serving(self, trigger: str) -> None:
        """Tear down only the gRPC servers and re-run the serve +
        register cycle. PlacementState (allocations, health) is
        untouched — the kubelet re-learns the device list through the
        fresh ListAndWatch stream it opens after Register."""
        log.warning(
            "kubelet restart detected (%s): re-serving %s and "
            "re-registering",
            trigger, self.config.resource_name,
        )
        if self._server is not None:
            self._server.stop(grace=1).wait()
            self._server = None
        if self._watcher_server is not None:
            self._watcher_server.stop(grace=1).wait()
            self._watcher_server = None
        self.serve()
        metrics.PLUGIN_REREGISTRATIONS.inc(trigger=trigger)
        RECORDER.record(
            "reregister",
            f"re-registered {self.config.resource_name} with the "
            f"kubelet after {trigger}",
            trigger=trigger,
        )
        LEDGER.record(
            "reregister", trigger,
            f"kubelet restart detected ({trigger}): device plugin "
            f"re-served its socket and re-registered "
            f"{self.config.resource_name} — without this the node "
            f"advertises zero cards until the daemon is restarted",
            resource=self.config.resource_name,
        )

    # ------------------------------------------------------------------
    # Health plumbing (reference health chan, server.go:180-182)
    # ------------------------------------------------------------------

    def notify_health(self, chip_id: str, healthy: bool) -> None:
        """Called by the health watcher; re-advertises on any transition."""
        if self.state.set_health(chip_id, healthy):
            log.warning(
                "chip %s is now %s",
                chip_id,
                constants.HEALTHY if healthy else constants.UNHEALTHY,
            )
            metrics.HEALTH_TRANSITIONS.inc(
                direction="recovered" if healthy else "unhealthy"
            )
            RECORDER.record(
                "health_transition",
                f"chip {chip_id} "
                + ("recovered" if healthy else "went unhealthy"),
                chip=chip_id,
                healthy=healthy,
            )
            LEDGER.record(
                "chip_health",
                "recovered" if healthy else "unhealthy",
                f"chip {chip_id} "
                + ("recovered" if healthy else "went unhealthy")
                + "; device list re-advertised",
                chip=chip_id,
            )
            self._bump()
            self._availability_changed()
            hook = self.on_health_transition
            if hook is not None:
                try:
                    hook(chip_id, healthy)
                except Exception:
                    log.exception("health-transition hook failed")

    def free_devices(self, ids: Iterable[str]) -> None:
        """Controller free path (pod deleted)."""
        self.state.free(ids)
        self._availability_changed()

    def mark_allocated(self, ids: Iterable[str]) -> None:
        """Controller allocation path (checkpoint rebuild/reconcile) —
        like Allocate, keeps the gauges and the published availability
        fresh."""
        self.state.allocate(ids)
        self._availability_changed()

    def _availability_changed(self) -> None:
        self._update_chip_gauges()
        hook = self.on_availability_change
        if hook is not None:
            try:
                hook()
            except Exception:
                log.exception("availability-change hook failed")

    def _update_chip_gauges(self) -> None:
        available = self.state.available()
        # Event-ish states drop their series when they empty
        # (Metric.remove) instead of lingering at 0 — "no unhealthy
        # chips" reads as an absent series, the same shape the
        # per-chip telemetry families use after a free. The structural
        # states (total/available) always render, 0 included: an
        # exhausted node is a fact, not a stale series.
        for state, count in (
            ("allocated", len(self.state.allocated)),
            ("unhealthy", len(self.state.unhealthy)),
        ):
            if count:
                metrics.CHIPS.set(count, state=state)
            else:
                metrics.CHIPS.remove(state=state)
        metrics.CHIPS.set(len(available), state="available")
        # The capacity gauges ride the same hook: every allocate, free and
        # health transition marks them, and the placement search for every
        # size runs when they are read, not in the RPC.
        from .. import telemetry

        telemetry.capacity_changed(self.state)

    def _bump(self) -> None:
        with self._version_cv:
            self._version += 1
            self._version_cv.notify_all()

    # ------------------------------------------------------------------
    # DevicePlugin service
    # ------------------------------------------------------------------

    def _device_list(self) -> List[pb.Device]:
        unhealthy = self.state.unhealthy
        devices = []
        for chip in self.topology.chips:
            cid = chip.device_id_str
            d = pb.Device(
                ID=cid,
                health=(
                    constants.UNHEALTHY
                    if cid in unhealthy
                    else constants.HEALTHY
                ),
            )
            if chip.numa_node >= 0:
                d.topology.nodes.add(ID=chip.numa_node)
            devices.append(d)
        return devices

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        last_sent = -1
        while not self._stop.is_set():
            with self._version_cv:
                if self._version == last_sent:
                    self._version_cv.wait(timeout=5.0)
                if self._version == last_sent:
                    continue
                last_sent = self._version
            resp = pb.ListAndWatchResponse(devices=self._device_list())
            log.info(
                "ListAndWatch send: %d devices (%d unhealthy)",
                len(resp.devices),
                sum(1 for d in resp.devices if d.health != constants.HEALTHY),
            )
            metrics.LISTANDWATCH_SENDS.inc()
            yield resp

    def GetPreferredAllocation(self, request, context):
        with profiling.timed(
            metrics.RPC_LATENCY, method="GetPreferredAllocation"
        ):
            return self._get_preferred_allocation(request, context)

    def _get_preferred_allocation(self, request, context):
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            picked = self.state.select(
                creq.allocation_size,
                available=list(creq.available_deviceIDs),
                must_include=list(creq.must_include_deviceIDs),
            )
            log.info(
                "GetPreferredAllocation: size=%d pool=%d -> %s",
                creq.allocation_size,
                len(creq.available_deviceIDs),
                picked,
            )
            resp.container_responses.add(deviceIDs=picked)
        return resp

    def Allocate(self, request, context):
        if not tracing.enabled():
            with profiling.timed(metrics.RPC_LATENCY, method="Allocate"):
                return self._allocate(request, context)
        # Provisional root span: no pod identity is knowable here (the
        # kubelet sends device ids only), so the span starts its own
        # trace, remembered in recent_allocations for a controller to
        # adopt into the pod's trace. The RPC_LATENCY observation lands
        # inside the span, so the histogram keeps an exemplar of it.
        with tracing.span(
            "plugin.Allocate",
            service="plugin",
            containers=len(request.container_requests),
        ) as sp:
            with profiling.timed(metrics.RPC_LATENCY, method="Allocate"):
                resp = self._allocate(request, context)
            ids: set = set()
            for cresp in resp.container_responses:
                ann = cresp.annotations.get(
                    constants.POD_DEVICES_ANNOTATION, ""
                )
                ids.update(i for i in ann.split(",") if i)
            sp.set(chips=len(ids))
            self.recent_allocations.append({
                "ids": frozenset(ids),
                "trace_id": sp.trace_id,
                "span_id": sp.span_id,
            })
            return resp

    def _allocate(self, request, context):
        # Two-phase under one lock: validate + plan every container first,
        # then commit — a bad container can't leak partial allocation state,
        # and concurrent RPCs can't plan overlapping chip sets.
        with self._allocate_lock:
            plans = []
            planned: set = set()
            held_elsewhere = (
                self.external_holds() if self.external_holds else set()
            )
            for creq in request.container_requests:
                requested = list(creq.devicesIDs)
                unknown = [i for i in requested if i not in self.topology.by_id]
                if unknown:
                    metrics.GRPC_ERRORS.inc(method="Allocate")
                    context.abort(
                        grpc.StatusCode.INVALID_ARGUMENT,
                        f"unknown device ids: {unknown}",
                    )
                assigned = requested
                substitutions = {}
                if self.config.substitute_on_allocate and requested:
                    pool = [
                        a for a in self.state.available() if a not in planned
                    ]
                    best = self.state.select(len(requested), available=pool)
                    if best:
                        assigned = best
                        for kubelet_id, real_id in zip(sorted(requested), best):
                            if kubelet_id != real_id:
                                substitutions[kubelet_id] = real_id
                    elif not (
                        set(requested).issubset(pool)
                    ):
                        # No topology pick and the kubelet's own choice
                        # overlaps an earlier container's plan or an
                        # unavailable card: refusing beats double-mounting
                        # the same /dev/nvidia* into two containers.
                        metrics.GRPC_ERRORS.inc(method="Allocate")
                        context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED,
                            f"cannot allocate {len(requested)} chips "
                            f"disjoint from prior containers",
                        )
                staged = [i for i in assigned if i in held_elsewhere]
                if staged:
                    # The kubelet's device accounting can't see DRA-claim
                    # holds; refusing beats mounting one card into two
                    # containers. Checked on the FINAL set: in substitution
                    # mode the remap above already steered off held chips
                    # (select excludes them), so only a pick that survives
                    # to here is a real conflict.
                    metrics.GRPC_ERRORS.inc(method="Allocate")
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        f"chips staged by DRA claims: {staged}",
                    )
                planned.update(assigned)
                plans.append((requested, assigned, substitutions))
            resp = pb.AllocateResponse()
            for requested, assigned, substitutions in plans:
                self.shadow_map.update(substitutions)
                self.substitutions.update(substitutions)
                self.state.allocate(assigned)
                resp.container_responses.append(
                    self._container_response(assigned)
                )
                log.info(
                    "Allocate: requested=%s assigned=%s", requested, assigned
                )
                metrics.ALLOCATIONS.inc()
                metrics.ALLOCATED_CHIPS.inc(len(assigned))
                RECORDER.record(
                    "allocate",
                    "chips handed to a container",
                    chips=",".join(assigned),
                )
                if LEDGER.enabled and requested:
                    # The reference's Allocate-time substitution is a
                    # placement DECISION (kubelet pick vs topology
                    # pick); the record is provisional-trace-stamped
                    # here and retraced into the pod's carried trace
                    # at controller adoption (decisions.retrace).
                    LEDGER.record(
                        "allocate_substitution",
                        "substituted" if substitutions
                        else "kubelet_choice",
                        (
                            f"kubelet requested {sorted(requested)}, "
                            f"topology chose {sorted(assigned)}"
                            if substitutions
                            else f"kubelet's choice {sorted(requested)} "
                            "kept"
                        ),
                        requested=",".join(sorted(requested)),
                        assigned=",".join(sorted(assigned)),
                    )
        self._availability_changed()
        return resp

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()

    # ------------------------------------------------------------------
    # Response construction (the reference's server.go:195-202)
    # ------------------------------------------------------------------

    def _container_response(self, ids: Sequence[str]) -> pb.ContainerAllocateResponse:
        resp = pb.ContainerAllocateResponse()
        if not ids:
            # Protocol-legal: a container in the pod that requests no cards.
            return resp
        chips = [self.topology.by_id[i] for i in ids]
        for path in self.device_paths(chips):
            resp.devices.add(
                container_path=path,
                host_path=path,
                permissions=DEVICE_PERMISSIONS,
            )
        resp.envs[constants.NVIDIA_VISIBLE_DEVICES] = ",".join(ids)
        # The plugin's own count (not read by CUDA): the smoke pod checks
        # that it sees exactly the allocation.
        resp.envs["TPU_PLUGIN_ALLOCATED_CHIPS"] = str(len(chips))
        resp.annotations[constants.POD_DEVICES_ANNOTATION] = ",".join(ids)
        if self.config.cdi_kind:
            for i in ids:
                resp.cdi_devices.add(name=f"{self.config.cdi_kind}={i}")
        return resp

    def device_paths(self, chips: Sequence[GpuChip]) -> List[str]:
        """Host device nodes a container holding ``chips`` needs: each
        card's ``/dev/nvidia<minor>`` plus the node-level extras."""
        return [c.dev_path for c in chips] + list(self.config.extra_device_paths)
