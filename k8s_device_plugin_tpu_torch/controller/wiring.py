"""Wires the kube-facing pieces onto a running daemon: the JAX package's
``controller/wiring.py`` for NVIDIA cards.

The reference's post-Serve sequence (main.go:80-89): build the kube
client, publish the node's topology annotation for a scheduler extender
(RegisterToSched, server.go:287-309) and run the pod controller, here in
threads so the supervisor loop stays responsive.

What the node tells the cluster:

* the annotation ``nvidia.com/gpu-topology`` (``topology/schema.py``),
  republished on every allocation, free and health change;
* NVIDIA GPU Feature Discovery's node labels ``nvidia.com/gpu.product``
  and ``nvidia.com/gpu.count``;
* the node condition ``GPUsHealthy``, and the Events ``GPUUnhealthy`` and
  ``GPURecovered`` on the node at each health transition.

The GKE TPU slice derivation of the JAX wiring has no twin.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Optional, Tuple

from ..api import constants
from ..kube.client import KubeClient, KubeError, rfc3339_now
from ..topology.links import LinkTopology
from ..topology.schema import NodeTopology
from ..utils import profiling
from ..utils.logging import get_logger
from ..utils.resilience import Backoff, delay_for_attempt
from .controller import EVICT_EVENT_REASON, Controller

log = get_logger(__name__)

GPU_CONDITION_TYPE = "GPUsHealthy"
RECOVERED_EVENT_REASON = "GPURecovered"


def label_value(s: str) -> str:
    """``s`` as a Kubernetes label value (at most 63 characters of
    ``[A-Za-z0-9._-]``, alphanumeric at both ends), spaces and other
    characters turned into ``-`` as GPU Feature Discovery writes the
    product: "NVIDIA H100 80GB HBM3" → "NVIDIA-H100-80GB-HBM3"."""
    return re.sub(r"[^A-Za-z0-9._-]", "-", s)[:63].strip("-_.")


def publish_node_topology(
    client: KubeClient,
    node_name: str,
    topology: LinkTopology,
    numa_nodes: int = 1,
    annotation: str = constants.TOPOLOGY_ANNOTATION,
    retries: int = 3,
    available=None,
    numa_info=None,
    host_info=None,
    failed=None,
) -> NodeTopology:
    """Publish the node's cards and links as a node annotation, retrying on
    conflict like the reference's patchNode loop (server.go:312-347), and
    label the node with the product and count."""
    topo = NodeTopology.from_topology(
        topology, numa_nodes=numa_nodes, hostname=node_name, available=available,
        numa_info=numa_info, host_info=host_info, failed=failed,
    )
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            client.patch_node_annotations(node_name, {annotation: topo.to_json()})
            if topo.chips:
                client.patch_node_labels(node_name, {
                    constants.PRODUCT_LABEL: label_value(topo.product),
                    constants.COUNT_LABEL: str(topo.chip_count),
                })
            log.info("published topology for %s: %d x %s", node_name, topo.chip_count,
                     topo.product or "-")
            return topo
        except KubeError as e:
            # Transport failures and 5xx are already retried inside the
            # client (utils/resilience.py); only the 409 conflict is a
            # caller-owned semantic worth a local retry.
            last = e
            if e.status_code != 409:
                raise
            time.sleep(delay_for_attempt(attempt, base=0.2, max_delay=2.0))
    raise last  # type: ignore[misc]


class TopologyPublisher:
    """Debounced node-annotation republisher: allocation/health changes
    trigger a publish of the current availability within ``debounce_s``,
    coalescing bursts (e.g. a multi-container Allocate)."""

    def __init__(
        self,
        client: KubeClient,
        node_name: str,
        plugin,
        numa_nodes: int = 1,
        debounce_s: float = 0.3,
        heartbeat_s: float = 300.0,
        numa_info=None,
        host_info=None,
    ):
        self.client = client
        self.node_name = node_name
        self.plugin = plugin
        self.numa_nodes = numa_nodes
        self.debounce_s = debounce_s
        self.heartbeat_s = heartbeat_s
        self.numa_info = numa_info
        self.host_info = host_info
        self._dirty = threading.Event()
        self._stop = threading.Event()
        # Serializes publish_now between the publisher thread and direct
        # callers (the startup publish), so condition-cache reads/writes
        # and the patches themselves can't interleave out of order.
        self._publish_lock = threading.Lock()
        # Last-written GPUsHealthy state (publish_gpu_condition cache).
        self._condition_cache: dict = {}
        self._thread = threading.Thread(
            target=profiling.supervised("topology_publisher", self._run),
            name="topology-publisher",
            daemon=True,
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self._thread.join(timeout=5)

    def trigger(self) -> None:
        self._dirty.set()

    def publish_now(self) -> None:
        with self._publish_lock:
            publish_node_topology(
                self.client,
                self.node_name,
                self.plugin.topology,
                numa_nodes=self.numa_nodes,
                available=self.plugin.state.available(),
                numa_info=self.numa_info,
                host_info=self.host_info,
                failed=sorted(self.plugin.state.unhealthy),
            )
            # The health condition rides the same serialized publish:
            # availability changes (allocation AND health transitions)
            # trigger it, and the retry loop in _run heals transient
            # apiserver failures for both.
            publish_gpu_condition(
                self.client, self.node_name, self.plugin, cache=self._condition_cache,
            )

    def publish_heartbeat(self) -> None:
        """Condition-only publish: advances lastHeartbeatTime without the
        annotation/label patches (nothing else changed on an idle node —
        two extra node-object writes per cycle would wake every node
        watcher in the cluster for no information)."""
        with self._publish_lock:
            publish_gpu_condition(
                self.client, self.node_name, self.plugin, cache=self._condition_cache,
            )

    def _run(self) -> None:
        backoff = Backoff(base=1.0, max_delay=30.0)
        # One healthy iteration legitimately spans the idle heartbeat
        # wait plus a full retry backoff; the threshold covers both.
        hb = profiling.HEARTBEATS.register(
            "topology_publisher",
            interval_s=self.heartbeat_s,
            max_silence_s=profiling.default_max_silence(self.heartbeat_s) + 30.0,
        )
        while not self._stop.is_set():
            hb.beat()
            # Timed wait = heartbeat: an idle node still republishes every
            # heartbeat_s, advancing the condition's lastHeartbeatTime so
            # tooling can treat a STALE heartbeat as "plugin dead, health
            # unknown" (the node-problem-detector contract).
            triggered = self._dirty.wait(timeout=self.heartbeat_s)
            if self._stop.is_set():
                return
            if triggered:
                self._stop.wait(self.debounce_s)  # coalesce bursts
            self._dirty.clear()
            try:
                if triggered:
                    self.publish_now()
                else:
                    self.publish_heartbeat()
                backoff.reset()
            except Exception as e:
                # A dropped publish would leave a stale condition or
                # availability annotation until the NEXT change — retry
                # on the shared jittered backoff (resilience.py).
                # Post-stop failures are the expected shape of teardown
                # (the apiserver is already gone): exit silently.
                if self._stop.is_set():
                    return
                delay = backoff.next_delay()
                log.warning("node publish failed (retry in %.1fs): %s", delay, e)
                if self._stop.wait(delay):
                    return
                self._dirty.set()


def publish_gpu_condition(
    client: KubeClient, node_name: str, plugin, cache: Optional[dict] = None
) -> None:
    """Surface card health as the node status condition ``GPUsHealthy`` —
    the node-problem-detector pattern: cluster tooling (alerts, autorepair,
    taints-by-condition) reads conditions, not custom annotations.

    lastTransitionTime is preserved when the status is UNCHANGED from
    the published condition: a daemon restart, or one of several broken
    cards recovering, must not reset "False for > X minutes" alert
    clocks. ``cache`` (a dict the caller owns) remembers what was last
    written so steady-state publishes skip the read round trip; the
    first publish (empty cache) reads the existing condition from the
    node. The heartbeat advances on every publish."""
    unhealthy = sorted(plugin.state.unhealthy)
    status = "False" if unhealthy else "True"
    now = rfc3339_now()
    transition_time = now
    if cache is not None and cache.get("status") == status:
        transition_time = cache["transition_time"]
    elif cache is None or not cache:
        try:
            node = client.get_node(node_name)
            for c in (node.get("status") or {}).get("conditions") or []:
                if (
                    c.get("type") == GPU_CONDITION_TYPE
                    and c.get("status") == status
                    and c.get("lastTransitionTime")
                ):
                    transition_time = c["lastTransitionTime"]
                    break
        except (KubeError, OSError):
            pass  # unreadable: a fresh transition stamp is the default
    client.patch_node_condition(
        node_name,
        {
            "type": GPU_CONDITION_TYPE,
            "status": status,
            "reason": "GPUsUnhealthy" if unhealthy else "AllGPUsHealthy",
            "message": (
                f"unhealthy GPUs: {', '.join(unhealthy)}"
                if unhealthy
                else f"all {len(plugin.topology.chips)} GPUs healthy"
            ),
            "lastHeartbeatTime": now,
            "lastTransitionTime": transition_time,
        },
    )
    if cache is not None:
        cache["status"] = status
        cache["transition_time"] = transition_time


def start_kube_integration(daemon, client: Optional[KubeClient] = None
                           ) -> Tuple[Controller, KubeClient]:
    """Start the publisher and the controller on ``daemon``'s running
    plugin generation, and attach the plugin's two hooks."""
    cfg = daemon.cfg
    if client is None:
        client = KubeClient.from_env(cfg.kubeconfig)
    node_name = cfg.node_name or os.uname().nodename
    numa = 1
    numa_info = []
    host_info = {}
    # A node without NVML (NoCards) has no host surface; it publishes
    # zero cards all the same.
    if hasattr(daemon.backend, "numa_topology"):
        try:
            numa = daemon.backend.numa_node_count(cfg.numa_dir)
            numa_info = daemon.backend.numa_topology(cfg.numa_dir)
        except OSError:
            pass
        try:
            host_info = daemon.backend.host_info(cfg.proc_dir)
        except OSError:
            host_info = {}
    publisher = TopologyPublisher(
        client, node_name, daemon.plugin, numa_nodes=numa,
        numa_info=numa_info, host_info=host_info,
    )
    publisher.start()
    daemon.plugin.on_availability_change = publisher.trigger

    controller = Controller(
        client,
        daemon.plugin,
        node_name=node_name,
        resource_name=cfg.resource_name,
        checkpoint_path=os.path.join(cfg.device_plugin_dir, "kubelet_internal_checkpoint"),
        podresources_socket=cfg.podresources_socket,
        resync_interval_s=cfg.resync_interval_s,
        evict_on_unhealthy=cfg.evict_on_unhealthy,
    )

    def emit_health_event(chip_id: str, healthy: bool) -> None:
        try:
            client.create_event(
                "default",
                {"kind": "Node", "name": node_name},
                reason=RECOVERED_EVENT_REASON if healthy else EVICT_EVENT_REASON,
                message=f"GPU {chip_id} is now {'Healthy' if healthy else 'Unhealthy'}",
                event_type="Normal" if healthy else "Warning",
            )
        except (KubeError, OSError) as e:
            log.warning("event emit failed: %s", e)
        # The GPUsHealthy condition follows via the publisher thread:
        # notify_health also fires on_availability_change → trigger.
        if not healthy:
            controller.on_chip_unhealthy(chip_id)

    daemon.plugin.on_health_transition = emit_health_event
    controller.publisher = publisher  # stopped with the controller
    controller.start()  # rebuilds allocation state from the kubelet
    # Authoritative initial publish AFTER the rebuild, so a restarted
    # daemon never advertises cards that running pods already hold. A
    # failure here (apiserver blip, stale RBAC during a rolling upgrade)
    # must not take down the whole kube integration — the publisher
    # thread retries it.
    try:
        publisher.publish_now()
    except Exception as e:
        log.warning("initial node publish failed (retrying in background): %s", e)
        publisher.trigger()
    # Transitions that fired before the hook attached (the health
    # watcher's pre-serve sweep) still get their pods evicted.
    controller.evict_unhealthy_now()
    return controller, client
