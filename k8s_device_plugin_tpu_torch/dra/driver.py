"""The NVIDIA DRA driver: the kubelet's DRAPlugin service and claim staging,
the counterpart of the JAX package's ``dra/driver.py``.

DRA (Dynamic Resource Allocation, resource.k8s.io) divides the work
otherwise than the device-plugin API:

* **Inventory**: the driver publishes a ResourceSlice that lists every card
  with its attributes (``dra/slices.py``); the scheduler picks the devices
  of a claim, so there is no ListAndWatch and no Allocate.
* **Staging**: once a ResourceClaim is allocated and its pod placed, the
  kubelet calls NodePrepareResources; the driver resolves the claim's
  allocated devices, writes a per-claim CDI spec with the cards' device
  nodes and env (``dra/cdi.py``) and returns its CDI id.
  NodeUnprepareResources reverts it.
* **Registration**: the plugins_registry watcher socket with type
  "DRAPlugin" (the pluginregistration/v1 contract the device-plugin plane
  serves in its watcher mode).

The driver shares the ``GpuDevicePlugin``'s cards, env, device nodes and
placement state, so a node can run both planes without handing one card
to two containers: the plugin's ``Allocate`` refuses the cards prepared
claims hold (``external_holds``), and a prepare refuses the cards the
plugin or another claim holds, checked and committed under the plugin's
``_allocate_lock``. The lock order everywhere is ``_allocate_lock``, then
the driver's ``_lock``.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from ..api import dra_pb2 as pb
from ..api import pluginregistration_pb2 as regpb
from ..api.grpc_defs import (
    DRA_PLUGIN_SERVICES,
    DraPluginServicer,
    WatcherRegistrationServicer,
    add_dra_plugin_servicer,
    add_watcher_registration_servicer,
)
from ..kube.client import KubeError
from ..utils import metrics, profiling
from ..utils.logging import get_logger
from . import cdi, slices

log = get_logger(__name__)

DEFAULT_PLUGINS_DIR = "/var/lib/kubelet/plugins"


class DraDriver(DraPluginServicer):
    def __init__(
        self,
        plugin,  # GpuDevicePlugin: topology, config, state, _gpu_env, device_paths
        kube_client=None,  # KubeClient; None: no claim lookup, no ResourceSlice
        driver_name: str = slices.DEFAULT_DRIVER,
        node_name: str = "",
        plugins_dir: str = DEFAULT_PLUGINS_DIR,
        plugins_registry_dir: str = "/var/lib/kubelet/plugins_registry/",
        cdi_dir: str = cdi.DEFAULT_CDI_DIR,
        resync_interval_s: float = 60.0,
    ):
        self.plugin = plugin
        self.client = kube_client
        self.driver_name = driver_name
        self.node_name = node_name or os.uname().nodename
        self.plugins_dir = plugins_dir
        self.plugins_registry_dir = plugins_registry_dir
        self.resync_interval_s = resync_interval_s
        self.cdi = cdi.CdiRegistry(cdi_dir)
        self.socket_path = os.path.join(plugins_dir, driver_name, "dra.sock")
        self.registry_socket_path = os.path.join(plugins_registry_dir,
                                                 f"{driver_name}-reg.sock")
        self._by_device_name = slices.chips_by_device_name(plugin.topology)
        self._lock = threading.Lock()
        # claim uid -> the card ids staged for it (an idempotent prepare;
        # an unprepare frees them with the API server unreachable).
        self.prepared: Dict[str, List[str]] = {}
        # claim uid -> (namespace, name): how the controller's eviction
        # finds the pods of a claim on a broken card.
        self.claim_refs: Dict[str, tuple] = {}
        # claim uid -> the claim's allocation results (its request names).
        self._results_by_uid: Dict[str, List[dict]] = {}
        # claim uid -> whether its CDI spec has one device a request, as
        # written at prepare and read back at recovery from the spec itself:
        # counting the surviving groups after a restart that dropped one
        # request's cards would name the CDI ids wrongly.
        self._multi_request: Dict[str, bool] = {}
        self._server: Optional[grpc.Server] = None
        self._registry_server: Optional[grpc.Server] = None
        # The resource.k8s.io version negotiated from the group's discovery,
        # cached after the first success.
        self._api_version: Optional[str] = None
        # The ResourceSlice publisher: woken by health transitions, retried
        # with backoff, so a publish that failed on a transient API error
        # does not leave a registered driver advertising nothing.
        self._generation = 0
        self._republish = threading.Event()
        self._stop_pub = threading.Event()
        self._pub_thread: Optional[threading.Thread] = None
        # The classic plane refuses the cards our claims hold: the kubelet's
        # device accounting cannot see them.
        plugin.external_holds = self._held_chip_ids

    def _held_chip_ids(self) -> set:
        with self._lock:
            return {c for ids in self.prepared.values() for c in ids}

    def api_version(self) -> str:
        """The cluster's negotiated resource.k8s.io version; raises with a
        message that tells "no DRA" from "no common version"."""
        if self._api_version is None:
            self._api_version = slices.negotiate_api_version(self.client)
            log.info("negotiated resource.k8s.io/%s for driver %s",
                     self._api_version, self.driver_name)
        return self._api_version

    # -- DRAPlugin service -------------------------------------------------

    def NodePrepareResources(self, request, context):
        resp = pb.NodePrepareResourcesResponse()
        for claim in request.claims:
            try:
                devices = self._prepare_claim(claim)
                resp.claims[claim.uid].devices.extend(devices)
                metrics.DRA_CLAIMS.inc(op="prepare", outcome="ok")
            except Exception as e:  # a per-claim error, not an RPC failure
                log.error("prepare claim %s/%s failed: %s", claim.namespace, claim.name, e)
                resp.claims[claim.uid].error = f"preparing {claim.namespace}/{claim.name}: {e}"
                metrics.DRA_CLAIMS.inc(op="prepare", outcome="error")
        self._update_prepared_gauge()
        return resp

    def NodeUnprepareResources(self, request, context):
        resp = pb.NodeUnprepareResourcesResponse()
        for claim in request.claims:
            try:
                self._unprepare_claim(claim.uid)
                resp.claims[claim.uid].SetInParent()
                metrics.DRA_CLAIMS.inc(op="unprepare", outcome="ok")
            except Exception as e:
                log.error("unprepare claim %s failed: %s", claim.uid, e)
                resp.claims[claim.uid].error = str(e)
                metrics.DRA_CLAIMS.inc(op="unprepare", outcome="error")
        self._update_prepared_gauge()
        return resp

    def _update_prepared_gauge(self) -> None:
        with self._lock:
            metrics.DRA_PREPARED.set(len(self.prepared))

    # -- claim staging -----------------------------------------------------

    def _allocated_results(self, claim_obj: dict) -> List[dict]:
        """This driver's device results in the claim's allocation."""
        alloc = (claim_obj.get("status") or {}).get("allocation") or {}
        results = (alloc.get("devices") or {}).get("results") or []
        return [r for r in results if r.get("driver") == self.driver_name]

    def _request_groups(self, results: List[dict]) -> List[tuple]:
        """[(request name, [card ids])] in result order, one group a
        distinct request: the unit of a multi-request claim's CDI
        isolation."""
        by_req: Dict[str, List[str]] = {}
        for r in results:
            chip = self._by_device_name.get(r.get("device", ""))
            if chip is not None:
                by_req.setdefault(r.get("request", ""), []).append(chip.device_id_str)
        return list(by_req.items())

    def _prepare_claim(self, claim) -> List[pb.Device]:
        with self._lock:
            already = self.prepared.get(claim.uid)
            if already is not None:
                # Idempotent: the kubelet retries prepare after restarts.
                # Backfill the reference, which a claim recovered from a
                # spec without one lacks, or it would never be evicted.
                self.claim_refs.setdefault(claim.uid, (claim.namespace, claim.name))
        if already is not None:
            return self._device_msgs(claim.uid, already)
        if self.client is None:
            raise RuntimeError("no API client to resolve the claim")
        claim_obj = slices.get_resource_claim(self.client, claim.namespace, claim.name,
                                              api_version=self.api_version())
        if claim_obj is None:
            # A 404 may mean the claim is gone, or that an in-place cluster
            # upgrade stopped serving the cached version: negotiate again
            # (one discovery GET) and retry once before concluding.
            fresh = slices.negotiate_api_version(self.client)
            if fresh != self._api_version:
                log.info("resource.k8s.io re-negotiated %s -> %s", self._api_version, fresh)
                self._api_version = fresh
                claim_obj = slices.get_resource_claim(self.client, claim.namespace,
                                                      claim.name, api_version=fresh)
        if claim_obj is None:
            raise RuntimeError("ResourceClaim not found")
        uid = (claim_obj.get("metadata") or {}).get("uid", "")
        if uid and claim.uid and uid != claim.uid:
            raise RuntimeError(f"claim uid mismatch: kubelet {claim.uid}, API {uid}")
        results = self._allocated_results(claim_obj)
        if not results:
            raise RuntimeError("claim has no allocation for this driver")
        chip_ids = []
        for r in results:
            chip = self._by_device_name.get(r.get("device", ""))
            if chip is None:
                raise RuntimeError(f"allocated device {r.get('device')!r} not on this node")
            chip_ids.append(chip.device_id_str)
        # Check and commit under the classic plane's Allocate lock: an
        # Allocate reads external_holds before its commit, so a prepare
        # between its plan and its commit could pass both guards and hand
        # one card to two containers.
        with self.plugin._allocate_lock:
            # Two concurrent prepares of one uid both pass the early check;
            # the loser answers idempotently here instead of tripping over
            # its twin's cards below.
            with self._lock:
                already = self.prepared.get(claim.uid)
            if already is not None:
                return self._device_msgs(claim.uid, already)
            # The scheduler allocates against the ResourceSlice and cannot
            # see live use: refuse cards any holder owns, a device-plugin
            # pod or another prepared claim (a duplicated scheduler
            # decision).
            conflict = set(chip_ids) & self.plugin.state.allocated
            if conflict:
                by_dra = sorted(conflict & self._held_chip_ids())
                by_classic = sorted(conflict - set(by_dra))
                parts = []
                if by_dra:
                    parts.append(f"by another ResourceClaim: {by_dra}")
                if by_classic:
                    parts.append(f"by the device-plugin plane: {by_classic}")
                raise RuntimeError("chips already held " + "; ".join(parts))
            broken = sorted(set(chip_ids) & self.plugin.state.unhealthy)
            if broken:
                raise RuntimeError(f"chips currently unhealthy: {broken}")
            # One CDI device a request: a container that references one
            # request of a multi-request claim gets that request's cards
            # and an env over exactly those cards.
            cdi_groups = []
            for request, ids in self._request_groups(results):
                cards = [self.plugin.topology.by_id[i] for i in ids]
                cdi_groups.append((request, self.plugin.device_paths(cards),
                                   self.plugin._gpu_env(cards), ids))
            self.cdi.write_claim_devices(claim.uid, cdi_groups,
                                         claim_ref=(claim.namespace, claim.name))
            with self._lock:
                self.prepared[claim.uid] = chip_ids
                self.claim_refs[claim.uid] = (claim.namespace, claim.name)
                self._results_by_uid[claim.uid] = results
                self._multi_request[claim.uid] = len(cdi_groups) > 1
            self.plugin.mark_allocated(chip_ids)
        log.info("prepared claim %s/%s: cards %s", claim.namespace, claim.name, chip_ids)
        return self._device_msgs(claim.uid, chip_ids)

    def _device_msgs(self, claim_uid: str, chip_ids: List[str]) -> List[pb.Device]:
        groups = self._request_groups(self._results_by_uid.get(claim_uid, []))
        multi = self._multi_request.get(claim_uid, len(groups) > 1)
        request_by_chip = {cid: req for req, ids in groups for cid in ids}
        msgs = []
        for chip_id in chip_ids:
            req = request_by_chip.get(chip_id, "")
            msgs.append(pb.Device(
                request_names=[req] if req else [],
                pool_name=self.node_name,
                device_name=slices.device_name(self.plugin.topology.by_id[chip_id]),
                # A multi-request claim has one CDI device a request; the
                # kubelet gives each container the ids of its requests.
                cdi_device_ids=[self.cdi.claim_device_id(claim_uid, req if multi else "")],
            ))
        return msgs

    def claims_on_chips(self, chip_ids) -> Dict[tuple, set]:
        """(namespace, name) → the given cards each prepared claim holds: how
        the controller's eviction finds a DRA pod on a broken card (it has
        no devices annotation) and names the cards in its Event."""
        wanted = set(chip_ids)
        out: Dict[tuple, set] = {}
        with self._lock:
            for uid, held in self.prepared.items():
                hit = wanted & set(held)
                if hit and uid in self.claim_refs:
                    ref = self.claim_refs[uid]
                    out[ref] = out.get(ref, set()) | hit
        return out

    def _unprepare_claim(self, claim_uid: str) -> None:
        self.cdi.remove_claim_device(claim_uid)
        with self._lock:
            chip_ids = self.prepared.pop(claim_uid, [])
            self.claim_refs.pop(claim_uid, None)
            self._results_by_uid.pop(claim_uid, None)
            self._multi_request.pop(claim_uid, None)
        if chip_ids:
            self.plugin.free_devices(chip_ids)
            log.info("unprepared claim %s: freed %s", claim_uid, chip_ids)

    # -- lifecycle ---------------------------------------------------------

    def recover_prepared(self) -> None:
        """Rebuild the prepared claims' holds from the CDI specs on disk: a
        restarted daemon must not forget which cards live claims hold, or
        the classic plane would hand them out. Claims unprepared while the
        daemon was down are settled by the kubelet's unprepare retries."""
        by_id = self.plugin.topology.by_id
        recovered = []
        refless = []
        for uid in self.cdi.list_claim_uids():
            spec = self.cdi.read_claim_spec(uid)  # outside the lock: file I/O
            if not spec:
                continue
            ids = [i for i in cdi.spec_chip_ids(spec) if i in by_id]
            if not ids:
                continue
            ref = cdi.spec_claim_ref(spec)
            groups = cdi.spec_request_groups(spec)
            # The request → cards association from the per-device
            # annotations, so a re-prepare after the restart answers the
            # request names and per-request CDI ids the first one did.
            results = [{"device": slices.device_name(by_id[i]), "request": req,
                        "driver": self.driver_name}
                       for req, group in groups for i in group if i in by_id]
            with self._lock:
                self.prepared[uid] = ids
                if results:
                    self._results_by_uid[uid] = results
                # The spec's device count, not the surviving groups'.
                self._multi_request[uid] = len(groups) > 1
                if ref is not None:
                    self.claim_refs[uid] = ref
            if ref is None:
                refless.append(uid)
            recovered.extend(ids)
        if recovered:
            self.plugin.mark_allocated(recovered)
            log.info("recovered %d prepared DRA claims holding %s", len(self.prepared),
                     sorted(recovered))
        self._update_prepared_gauge()
        # After the holds are recorded: a blocking API call, and the cards
        # must not look free while it runs.
        self._resolve_missing_refs(refless)

    def _resolve_missing_refs(self, uids: List[str]) -> None:
        """Find (namespace, name) for recovered claims whose specs carry no
        reference, by listing ResourceClaims and matching the uid: the
        kubelet does not prepare a running claim again, so without this
        their pods would never be evicted from a broken card."""
        if self.client is None or not uids:
            return
        try:
            resp = self.client.get(f"{slices.resource_api(self.api_version())}/resourceclaims")
        except Exception as e:
            log.warning("claim-ref resolution for %d legacy claims failed (their pods won't "
                        "be evicted on card failure): %s", len(uids), e)
            return
        by_uid = {}
        for item in resp.get("items", []):
            m = item.get("metadata", {})
            if m.get("uid"):
                by_uid[m["uid"]] = (m.get("namespace", "default"), m.get("name", ""))
        resolved = []
        with self._lock:
            for uid in uids:
                if uid in by_uid:
                    self.claim_refs[uid] = by_uid[uid]
                    resolved.append((uid, by_uid[uid]))
        # Written into the spec, so the next restart recovers it from disk
        # with the API server unreachable.
        for uid, ref in resolved:
            try:
                self.cdi.update_claim_ref(uid, ref)
            except OSError as e:
                log.warning("claim-ref persist for %s failed: %s", uid, e)

    def start(self) -> None:
        self.recover_prepared()
        os.makedirs(os.path.dirname(self.socket_path), exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        add_dra_plugin_servicer(self, self._server)
        self._server.add_insecure_port(f"unix:{self.socket_path}")
        self._server.start()
        self._start_registry_socket()
        if self.client is not None:
            self._stop_pub.clear()
            self._pub_thread = threading.Thread(
                target=profiling.supervised("dra_slice_publisher", self._publisher_loop),
                name="dra-slice-publisher",
                daemon=True,
            )
            self._pub_thread.start()
            # A health transition changes the advertised inventory: chain
            # onto the plugin's hook, so the wiring's Events still fire.
            # Each plugin generation is new, so a rebuilt driver chains
            # once onto its own plugin's hook.
            prev_hook = self.plugin.on_health_transition

            def _chained(chip_id: str, healthy: bool) -> None:
                if prev_hook is not None:
                    prev_hook(chip_id, healthy)
                self.trigger_republish()

            self.plugin.on_health_transition = _chained
        log.info("DRA driver %s serving at %s", self.driver_name, self.socket_path)

    def trigger_republish(self) -> None:
        self._republish.set()

    def _publisher_loop(self) -> None:
        backoff = 2.0
        need_publish = True
        # An iteration spans the resync wait plus, after a failed publish,
        # one capped backoff: the threshold covers both.
        hb = profiling.HEARTBEATS.register(
            "dra_slice_publisher",
            interval_s=self.resync_interval_s,
            max_silence_s=profiling.default_max_silence(self.resync_interval_s) + 60.0,
        )
        while not self._stop_pub.is_set():
            hb.beat()
            if need_publish:
                try:
                    self.publish()
                    backoff = 2.0
                    need_publish = False
                except Exception as e:
                    log.warning("ResourceSlice publish failed (retry in %.0fs): %s", backoff, e)
                    if self._stop_pub.wait(backoff):
                        return
                    backoff = min(backoff * 2, 60.0)
                    continue
            # Woken by a trigger (a health transition) or by the resync: a
            # slice deleted under us (the kubelet's orphan cleanup, an
            # admin) is made again without waiting for a transition, and a
            # resync that finds the slice there writes nothing.
            triggered = self._republish.wait(timeout=self.resync_interval_s)
            if self._stop_pub.is_set():
                return
            if triggered:
                # Cleared on this path only: clearing after a timed-out
                # wait would eat a trigger set between the two.
                self._republish.clear()
                self._stop_pub.wait(0.3)  # a burst of transitions, one publish
                need_publish = True
            else:
                need_publish = not self._slice_exists()

    def _slice_exists(self) -> bool:
        try:
            self.client.get(f"{slices.resource_api(self.api_version())}/resourceslices/"
                            f"{slices.slice_name(self.node_name, self.driver_name)}")
            return True
        except KubeError as e:
            # A transient error is not a missing slice: no churn, and the
            # next wake asks again.
            return e.status_code != 404
        except Exception:
            return True

    def _start_registry_socket(self) -> None:
        driver = self

        class _Watcher(WatcherRegistrationServicer):
            def GetInfo(self, request, context):
                return regpb.PluginInfo(
                    type="DRAPlugin",
                    name=driver.driver_name,
                    endpoint=driver.socket_path,
                    # The kubelet matches full gRPC service names and takes
                    # the newest it supports; a bare "v1beta1" is refused.
                    supported_versions=list(DRA_PLUGIN_SERVICES),
                )

            def NotifyRegistrationStatus(self, request, context):
                if request.plugin_registered:
                    log.info("kubelet registered DRA driver %s", driver.driver_name)
                else:
                    log.error("kubelet REJECTED DRA driver %s: %s", driver.driver_name,
                              request.error)
                return regpb.RegistrationStatusResponse()

        os.makedirs(self.plugins_registry_dir, exist_ok=True)
        sock = self.registry_socket_path
        if os.path.exists(sock):
            os.unlink(sock)
        self._registry_server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        add_watcher_registration_servicer(_Watcher(), self._registry_server)
        self._registry_server.add_insecure_port(f"unix:{sock}")
        self._registry_server.start()

    def publish(self) -> Optional[dict]:
        """Publish the node's ResourceSlice without its unhealthy cards (the
        DRA form of ListAndWatch's Unhealthy), bumping the pool generation
        so consumers see updates in order. None without a client."""
        if self.client is None:
            return None
        with self._lock:
            self._generation += 1
            generation = self._generation
        kwargs = dict(driver=self.driver_name, pool_generation=generation,
                      exclude=self.plugin.state.unhealthy)
        try:
            return slices.publish_resource_slice(self.client, self.plugin.topology,
                                                 self.node_name,
                                                 api_version=self.api_version(), **kwargs)
        except KubeError as e:
            if e.status_code != 404:
                raise
            # The versioned collection answering 404: the cluster no longer
            # serves the cached version (an in-place upgrade under a
            # long-running daemon). Negotiate again and retry once.
            stale, self._api_version = self._api_version, None
            fresh = self.api_version()
            log.info("resource.k8s.io re-negotiated %s -> %s", stale, fresh)
            return slices.publish_resource_slice(self.client, self.plugin.topology,
                                                 self.node_name, api_version=fresh, **kwargs)

    def stop(self, unpublish: bool = False) -> None:
        self._stop_pub.set()
        self._republish.set()
        if self._pub_thread is not None:
            self._pub_thread.join(timeout=5)
            self._pub_thread = None
        if self._server is not None:
            self._server.stop(grace=0.5).wait()
            self._server = None
        if self._registry_server is not None:
            self._registry_server.stop(grace=0.5).wait()
            self._registry_server = None
        for path in (self.socket_path, self.registry_socket_path):
            try:
                os.unlink(path)
            except OSError:
                pass
        if unpublish and self.client is not None:
            try:
                # The cached version: discovery at teardown is a wasted
                # round trip, and a transient error in it would skip the
                # delete and leave a slice advertising a node that is gone.
                slices.delete_resource_slice(self.client, self.node_name, self.driver_name,
                                             api_version=self._api_version)
            except Exception as e:
                log.warning("ResourceSlice delete failed: %s", e)
