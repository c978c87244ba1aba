"""Process supervisor: discovery → serve → register → watch → restart. The
counterpart of the JAX package's ``supervisor/main.py`` for NVIDIA cards,
and of the reference's main loop (main.go:23-113).

``Daemon.build_and_serve`` builds one plugin generation: the node's cards
through NVML (``discovery/scanner``), their ``LinkTopology``, a
``GpuPlacementState``, the ``GpuDevicePlugin``, and the health watcher,
whose first sweep runs before the plugin serves, so a card already broken
is never advertised Healthy; after serving, the kube plane
(``controller/wiring.py``): the node's ``nvidia.com/gpu-topology``
annotation, its labels and ``GPUsHealthy`` condition, and the pod
controller, which writes each pod's cards onto its
``nvidia.com/gpu-devices`` annotation, frees them when the pod goes and
evicts the pods of a broken card. ``Daemon.run`` then sits on an event queue fed
by the fs watcher and the signal handlers: a re-created kubelet.sock
(kubelet restart) or SIGHUP tears the generation down and builds the next;
SIGTERM or SIGINT returns 0.

As in the JAX daemon, a node without cards (no NVML, or NVML with no card)
serves zero devices instead of blocking before registration as the
reference does (main.go:33-41), and SIGHUP re-runs discovery, so an NVIDIA
driver installed later is picked up without a restart. One NVML backend lives
across generations, since a hardware XID withdraws its card until the
daemon restarts (``discovery/scanner.NvmlInfo``); only a node that had no
NVML looks for it again.

As in the JAX daemon, the kube client is built before serving, with its
``DegradedMode`` (flipped by the client's circuit breaker, marked fresh by
the controller's relists), and a node with no reachable kube config logs a
warning and serves its cards without the controller. Every start names its
kube config (``--kubeconfig``, default ``$KUBECONFIG``, else the in-cluster
service account) or turns the plane off (``--no-controller``).

The observability plane, as in JAX: ``--metrics-port`` (default 2112, 0
for none) serves ``/metrics``, ``/healthz`` (503 once the supervisor loop's
heartbeat is older than its threshold) and ``/debug/*`` from one server
started once a process; ``--trace`` turns on spans and the flight recorder,
``--decisions`` the decision ledger, ``--log-json`` JSON-lines logs. Each
plugin generation builds, last, the card telemetry sampler
(``--telemetry-interval-s``, ``telemetry.py``) and the consistency auditor
(``--audit-interval-s``, ``audit.py``), and its teardown stops both. The
new flags are read from the command line only, with no environment alias.

The daemon reads NVML only. It never imports ``torch`` and never creates a
CUDA context, which would cost device memory on every card of the node.

The planes that are not ported yet bring their flags with them: DRA, the
flight recorder's dumps, the black box, the profilers and lockdep.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import signal
import sys
from typing import List, Optional

from ..api import constants
from ..discovery import nvml
from ..discovery.chips import GpuChip
from ..discovery.scanner import (
    DEFAULT_DEV, DEFAULT_NUMA_DIR, DEFAULT_SYSFS_PCI, NoCards, get_backend)
from ..health.watcher import HealthWatcher, healthchecks_disabled
from ..server.plugin import GpuDevicePlugin, PluginConfig
from ..topology.links import LinkTopology
from ..topology.placement import GpuPlacementState
from ..utils import logging as tpulog
from ..utils import metrics, profiling, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from .watchers import FsWatcher, SignalWatcher

log = get_logger(__name__)


@dataclasses.dataclass
class DaemonConfig:
    node_name: str = ""
    device_plugin_dir: str = constants.DEVICE_PLUGIN_PATH
    # Where a card's NUMA node is read (<dir>/<bus id>/numa_node) and where
    # its /dev/nvidia<minor> and the NVIDIA driver's /dev/nvidiactl live.
    sysfs_pci_dir: str = DEFAULT_SYSFS_PCI
    dev_dir: str = DEFAULT_DEV
    # Where the host's NUMA nodes and memory/CPU summary are read for the
    # node annotation.
    numa_dir: str = DEFAULT_NUMA_DIR
    proc_dir: str = "/proc"
    resource_name: str = constants.RESOURCE_NAME
    substitute_on_allocate: bool = False
    health_interval_s: float = 5.0
    resync_interval_s: float = 30.0
    enable_controller: bool = True
    kubeconfig: str = ""
    # Kubelet PodResources socket for reconciliation ("" pins the
    # checkpoint file).
    podresources_socket: str = constants.POD_RESOURCES_SOCKET
    evict_on_unhealthy: bool = True
    # Degraded-serving staleness cap (utils/resilience.DegradedMode):
    # while the kube circuit breaker is open the controller serves its
    # last-known-good view; past this many seconds of staleness the mode
    # turns "paused".
    staleness_cap_s: float = 60.0
    # CDI kind for Allocate responses ("" disables; see PluginConfig).
    cdi_kind: str = ""
    # Registration path: "register" (dial kubelet, reference-style),
    # "watcher" (plugins_registry socket, kubelet >= 1.12), or "both".
    registration_mode: str = "register"
    plugins_registry_dir: str = "/var/lib/kubelet/plugins_registry/"
    # The NVML library to load (the dynamic loader's search by default).
    nvml_library: str = nvml.LIBRARY
    # /metrics, /healthz and /debug/* (utils/metrics.MetricsServer); 0 is
    # no server.
    metrics_port: int = 0
    # Spans (/debug/traces, exemplars) and the flight recorder
    # (/debug/events); the decision ledger (/debug/decisions), implied by
    # trace.
    trace: bool = False
    decisions: bool = False
    # The card telemetry sampler and the consistency auditor, each on its
    # own thread at this cadence; 0 is no thread.
    telemetry_interval_s: float = 0.0
    audit_interval_s: float = 0.0


class Daemon:
    """One node's device-plugin process."""

    # The supervisor loop beats once an event-queue turn (at most 1 s when
    # idle); /healthz reads 503 once it has been silent this long. Padded,
    # since one turn may rebuild a generation (scan, serve, register).
    heartbeat_stale_s = 60.0

    def __init__(self, cfg: DaemonConfig):
        self.cfg = cfg
        if cfg.trace:
            tracing.enable(service="plugin")
            RECORDER.enable(service="plugin")
        if cfg.decisions or cfg.trace:
            LEDGER.enable(service="plugin")
        self.backend = None
        self.events: "queue.Queue" = queue.Queue()
        self.plugin: Optional[GpuDevicePlugin] = None
        self.health: Optional[HealthWatcher] = None
        self.controller = None  # set by the kube wiring when enabled
        self._kube_client = None  # built before serving (build_and_serve)
        self.telemetry_sampler = None  # set by _start_telemetry when on
        self.auditor = None  # set by _start_audit when on
        # The build's identity is on the very first scrape.
        metrics.set_build_info("plugin")
        self.metrics_server = None
        if cfg.metrics_port:
            try:
                self.metrics_server = metrics.MetricsServer(
                    port=cfg.metrics_port, liveness_check=self.live)
                log.info("metrics at %s/metrics", self.metrics_server.start())
            except OSError as e:
                log.warning("metrics endpoint disabled: %s", e)
                self.metrics_server = None

    def live(self) -> bool:
        """/healthz: the supervisor loop has beaten within its threshold (or
        has not started yet)."""
        hb = profiling.HEARTBEATS.get("supervisor")
        return hb is None or not hb.stalled()

    # -- build/teardown of one plugin generation ---------------------------

    def discover(self) -> List[GpuChip]:
        """The node's cards through NVML. The backend is kept across
        generations; a node that had no NVML (``NoCards``) looks again."""
        if self.backend is None or isinstance(self.backend, NoCards):
            self.backend = get_backend(self.cfg.nvml_library)
        chips = self.backend.scan(self.cfg.sysfs_pci_dir, self.cfg.dev_dir)
        log.info(
            "discovered %d cards (%s) via %s",
            len(chips),
            chips[0].name if chips else "-",
            self.backend.version(),
        )
        return chips

    def build_and_serve(self) -> None:
        # The kube client before serving, as in JAX; it soft-fails (no
        # reachable kube config) and the cards are served all the same.
        self._kube_client = None
        if self.cfg.enable_controller:
            try:
                from ..kube.client import KubeClient
                from ..utils import metrics
                from ..utils.resilience import DegradedMode

                self._kube_client = KubeClient.from_env(self.cfg.kubeconfig)
                # Explicit degraded mode for the plugin's kube plane:
                # flipped by the client's circuit breaker; the controller
                # marks it fresh on every successful relist.
                self._kube_client.resilience.degraded = DegradedMode(
                    staleness_cap_s=self.cfg.staleness_cap_s,
                    name="plugin",
                    gauge=metrics.KUBE_DEGRADED_MODE,
                    staleness_gauge=metrics.KUBE_DEGRADED_STALENESS,
                )
            except Exception as e:
                log.warning("kube client unavailable pre-serve: %s", e)
        chips = self.discover()
        topology = LinkTopology(chips, self.backend)
        state = GpuPlacementState(topology)
        self.plugin = GpuDevicePlugin(
            topology,
            state=state,
            config=PluginConfig(
                resource_name=self.cfg.resource_name,
                device_plugin_dir=self.cfg.device_plugin_dir,
                substitute_on_allocate=self.cfg.substitute_on_allocate,
                cdi_kind=self.cfg.cdi_kind,
                registration_mode=self.cfg.registration_mode,
                plugins_registry_dir=self.cfg.plugins_registry_dir,
                extra_device_paths=(os.path.join(self.cfg.dev_dir, constants.NVIDIACTL),),
            ),
        )
        if chips:
            self.health = HealthWatcher(
                self.backend,
                self.cfg.sysfs_pci_dir,
                self.cfg.dev_dir,
                chips,
                self.plugin.notify_health,
                interval_s=self.cfg.health_interval_s,
            )
            if not healthchecks_disabled():
                # Synchronous first sweep BEFORE serving: a card that is
                # already broken at daemon start must never be advertised
                # Healthy for a poll interval.
                self.health.poll_once()
        self.plugin.serve()
        # Kubelet-restart watcher: a restarted kubelet wipes its plugin
        # registry (and our socket); the node would advertise zero cards
        # until this daemon re-registers.
        self.plugin.start_restart_watch()
        if self.health is not None:
            self.health.start()
        self._start_kube_integration()
        self._start_telemetry()
        self._start_audit()

    def _start_telemetry(self) -> None:
        """The card telemetry sampler, built after the controller so that its
        card→pod map labels the series; no cards or interval 0 is no
        thread."""
        chips = self.plugin.topology.chips
        if self.cfg.telemetry_interval_s <= 0 or not chips:
            return
        from .. import telemetry

        self.telemetry_sampler = telemetry.TelemetrySampler(
            self.backend,
            self.cfg.sysfs_pci_dir,
            chips,
            interval_s=self.cfg.telemetry_interval_s,
            attribution=self.controller.chip_attribution if self.controller is not None else None,
        )
        telemetry.install_sampler(self.telemetry_sampler)
        self.telemetry_sampler.start()

    def _start_audit(self) -> None:
        """The consistency auditor, built last so that every plane it joins
        exists; interval 0 is no thread."""
        if self.cfg.audit_interval_s <= 0:
            return
        from .. import audit

        controller = self.controller
        node_audit = audit.NodeAudit(
            self.plugin,
            controller=controller,
            client=self._kube_client,
            node_name=(controller.node_name if controller is not None
                       else self.cfg.node_name or os.uname().nodename),
            checkpoint_path=(controller.checkpoint_path if controller is not None
                             else os.path.join(self.cfg.device_plugin_dir,
                                               "kubelet_internal_checkpoint")),
            # The controller's PodResources channel is reused (grpc channels
            # are thread-safe); without a controller the kubelet-joined
            # invariants read the checkpoint only.
            podres=controller.podres if controller is not None else None,
            resource_name=self.cfg.resource_name,
        )
        self.auditor = node_audit.engine(interval_s=self.cfg.audit_interval_s)
        audit.install_engine(self.auditor)
        self.auditor.start()

    def _start_kube_integration(self) -> None:
        """Node-annotation publishing and the pod controller, on the client
        built before serving; soft-fails when no API server is reachable
        (a node without a kube config has already logged why)."""
        if self._kube_client is None:
            return
        try:
            from ..controller.wiring import start_kube_integration

            self.controller, _ = start_kube_integration(self, client=self._kube_client)
            self.controller.degraded = self._kube_client.resilience.degraded
        except Exception as e:
            log.warning("kube integration disabled: %s", e)
            self.controller = None

    def teardown(self) -> None:
        if self.auditor is not None:
            from .. import audit

            try:
                self.auditor.stop()
            except Exception:
                log.exception("auditor stop failed")
            audit.install_engine(None)
            self.auditor = None
        if self.telemetry_sampler is not None:
            from .. import telemetry

            try:
                self.telemetry_sampler.stop()
            except Exception:
                log.exception("telemetry sampler stop failed")
            telemetry.install_sampler(None)
            self.telemetry_sampler = None
        if self.controller is not None:
            try:
                self.controller.stop()
            except Exception:
                log.exception("controller stop failed")
            self.controller = None
        if self.health is not None:
            self.health.stop()
            self.health = None
        if self.plugin is not None:
            self.plugin.stop()
            self.plugin = None
        if self._kube_client is not None:
            # The generation's degraded mode leaves the resilience tracker
            # with it: a daemon rebuilt on every SIGHUP keeps one entry.
            from ..utils.resilience import TRACKER

            degraded = self._kube_client.resilience.degraded
            if degraded is not None:
                TRACKER.detach_degraded(degraded)
            self._kube_client = None

    # -- supervisor loop ---------------------------------------------------

    def run(self) -> int:
        """The restart loop, until SIGTERM or SIGINT (which return 0)."""
        fs = FsWatcher(self.cfg.device_plugin_dir, self.events)
        sigs = SignalWatcher(self.events)
        fs.start()
        sigs.start()
        # The supervisor loop's heartbeat: one beat per event-queue turn.
        hb = profiling.HEARTBEATS.register("supervisor", interval_s=1.0,
                                           max_silence_s=self.heartbeat_stale_s)
        restart = True
        try:
            while True:
                hb.beat()
                if restart:
                    self.teardown()
                    try:
                        self.build_and_serve()
                    except Exception:
                        log.exception("build/serve failed; will retry on "
                                      "next kubelet event or SIGHUP")
                    restart = False
                try:
                    kind, payload = self.events.get(timeout=1.0)
                except queue.Empty:
                    continue
                if kind == "create" and payload == constants.KUBELET_SOCKET_NAME:
                    log.info("kubelet socket recreated; restarting plugin")
                    RECORDER.record(
                        "plugin_restart",
                        "kubelet socket recreated; rebuilding",
                        reason="kubelet_socket",
                    )
                    restart = True
                elif kind == "signal" and payload == signal.SIGHUP:
                    log.info("SIGHUP; restarting plugin")
                    RECORDER.record("plugin_restart", "SIGHUP rebuild", reason="sighup")
                    restart = True
                elif kind == "signal" and payload in (signal.SIGTERM, signal.SIGINT):
                    log.info("signal %d; shutting down", payload)
                    return 0
        finally:
            self.teardown()
            if self.backend is not None:
                self.backend.close()
                self.backend = None
            fs.stop()
            sigs.stop()
            profiling.HEARTBEATS.unregister("supervisor")
            if self.metrics_server is not None:
                self.metrics_server.stop()
                self.metrics_server = None


def parse_args(argv) -> DaemonConfig:
    p = argparse.ArgumentParser(
        prog="nvidia-device-plugin",
        description="Kubernetes device plugin for NVIDIA cards, over NVML",
    )
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--device-plugin-dir", default=constants.DEVICE_PLUGIN_PATH)
    p.add_argument("--sysfs-pci-dir", default=DEFAULT_SYSFS_PCI,
                   help="sysfs PCI devices dir, where each card's NUMA node "
                   "is read")
    p.add_argument("--dev-dir", default=DEFAULT_DEV,
                   help="dir of the cards' nvidia<minor> nodes and nvidiactl")
    p.add_argument("--resource-name", default=constants.RESOURCE_NAME)
    p.add_argument(
        "--substitute-on-allocate",
        action="store_true",
        help="reference-compatible Allocate-time substitution for kubelets "
        "without GetPreferredAllocation",
    )
    p.add_argument("--health-interval", type=float, default=5.0)
    p.add_argument("--resync-interval", type=float, default=30.0)
    p.add_argument("--cdi-kind", default="",
                   help="emit CDI device names of this kind in Allocate "
                   "responses (e.g. nvidia.com/gpu); empty disables")
    p.add_argument("--registration-mode", default="register",
                   choices=["register", "watcher", "both"],
                   help="kubelet registration path: dial its Register RPC "
                   "(reference-compatible), serve a plugins_registry "
                   "watcher socket, or both")
    p.add_argument("--plugins-registry-dir",
                   default="/var/lib/kubelet/plugins_registry/")
    p.add_argument("--podresources-socket",
                   default=constants.POD_RESOURCES_SOCKET,
                   help="kubelet PodResources API socket, preferred over "
                   "the checkpoint file for reconciliation; '' forces "
                   "checkpoint-only")
    p.add_argument("--no-evict-on-unhealthy", action="store_true",
                   help="do not evict pods whose cards go Unhealthy "
                   "(eviction is on by default so they reschedule onto "
                   "healthy capacity)")
    p.add_argument("--no-controller", action="store_true",
                   help="no kube plane: no node annotation, no pod controller")
    p.add_argument("--kubeconfig", default=os.environ.get("KUBECONFIG", ""),
                   help="kube config of the API server (default $KUBECONFIG, "
                   "else the in-cluster service account)")
    p.add_argument("--staleness-cap-s", type=float, default=60.0,
                   help="degraded-serving staleness cap: while the kube "
                   "circuit breaker is open the controller serves its "
                   "last-known-good pod view and skips evictions")
    p.add_argument("--metrics-port", type=int, default=2112,
                   help="port of /metrics, /healthz and /debug/*; 0 disables")
    p.add_argument("--trace", action="store_true",
                   help="spans at /debug/traces (exemplars on the latency "
                   "histograms) and the flight recorder at /debug/events; "
                   "off is an exact no-op")
    p.add_argument("--decisions", action="store_true",
                   help="the decision ledger at /debug/decisions (allocate "
                   "substitutions, health transitions, evictions, audit "
                   "divergences); implied by --trace")
    p.add_argument("--log-json", action="store_true",
                   help="JSON-lines logs with trace correlation")
    p.add_argument("--telemetry-interval-s", type=float, default=0.0,
                   help="sample each card's telemetry (utilization, memory in "
                   "use, temperature, power, NVLink state) every N seconds "
                   "into the tpu_chip_* series, labeled by the holding pod; "
                   "0 disables the sampler")
    p.add_argument("--audit-interval-s", type=float, default=0.0,
                   help="run the consistency auditor every N seconds "
                   "(checkpoint vs PodResources vs pod annotations vs the "
                   "attribution map vs the gauges; findings at /debug/audit "
                   "and tpu_audit_*); 0 disables it")
    p.add_argument("-v", "--verbose", action="count", default=0)
    a = p.parse_args(argv)
    tpulog.setup(verbose=a.verbose, json=a.log_json, service="plugin")
    return DaemonConfig(
        node_name=a.node_name,
        device_plugin_dir=a.device_plugin_dir,
        sysfs_pci_dir=a.sysfs_pci_dir,
        dev_dir=a.dev_dir,
        resource_name=a.resource_name,
        substitute_on_allocate=a.substitute_on_allocate,
        health_interval_s=a.health_interval,
        resync_interval_s=a.resync_interval,
        enable_controller=not a.no_controller,
        kubeconfig=a.kubeconfig,
        podresources_socket=a.podresources_socket,
        evict_on_unhealthy=not a.no_evict_on_unhealthy,
        staleness_cap_s=a.staleness_cap_s,
        cdi_kind=a.cdi_kind,
        registration_mode=a.registration_mode,
        plugins_registry_dir=a.plugins_registry_dir,
        metrics_port=a.metrics_port,
        trace=a.trace,
        decisions=a.decisions,
        telemetry_interval_s=a.telemetry_interval_s,
        audit_interval_s=a.audit_interval_s,
    )


def main(argv=None) -> int:
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    return Daemon(cfg).run()
