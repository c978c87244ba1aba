"""Pod reconciliation controller: the JAX package's
``controller/controller.py`` over the port's ``GpuDevicePlugin``.

The reference's informer controller (controller.go:75-249): watch this
node's pods that request ``nvidia.com/gpu``, and

* on pod **update** — once the kubelet has admitted the pod, translate the
  kubelet's device IDs for the pod through the plugin's shadow map
  (Allocate-time substitution mode) and patch the *real* card UUIDs onto
  the pod's ``nvidia.com/gpu-devices`` annotation, so a scheduler knows
  which physical cards the pod got (controller.go:173-225). The kubelet's
  IDs come from the PodResources API when served (kube/podresources.py),
  else from the internal checkpoint file — the reference's only option at
  k8s 1.14;
* on pod **delete** — free the pod's cards in the placement state
  (controller.go:148-171);
* at **startup** — rebuild allocation state from PodResources or the
  checkpoint, which the reference loses across restarts;
* on a card going **unhealthy** — evict the pods holding it (the Eviction
  API, so PodDisruptionBudgets hold), which the reference never does.

Beside the pod tracking it keeps the card→pod attribution map
(``chip_attribution``: pod, namespace, container from the PodResources
API, and the gang label) that the telemetry sampler labels each card's
series with and the audit's ``attribution_vs_kubelet`` checks.

Card ids are NVML UUIDs, the same ids the kubelet holds.

Implementation shape: a list+watch loop feeding a work queue, one worker
draining it with bounded retries — the same informer/workqueue pattern as
client-go, sized to this plugin's needs.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Set

from ..api import constants
from ..kube import checkpoint as ckpt
from ..kube.client import KubeClient, KubeError
from ..kube.podresources import PodResourcesClient
from ..utils import metrics, profiling, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger
from ..utils.podresources import is_gpu_pod
from ..utils.resilience import (
    TRACKER,
    Backoff,
    PendingWrites,
    UnavailableError,
    delay_for_attempt,
)

log = get_logger(__name__)

# The Warning Event on a pod evicted from a broken card (the JAX plugin's
# TPUChipUnhealthy).
EVICT_EVENT_REASON = "GPUUnhealthy"


def _pod_claim_refs(pod: dict) -> set:
    """(namespace, claim name) pairs of the ResourceClaims a pod uses.
    Template-generated claims surface in status.resourceClaimStatuses
    (pod-level name → actual object name); directly-named claims sit in
    spec.resourceClaims[].resourceClaimName."""
    meta = pod.get("metadata", {})
    ns = meta.get("namespace", "default")
    refs = set()
    for st in (pod.get("status") or {}).get("resourceClaimStatuses") or []:
        if st.get("resourceClaimName"):
            refs.add((ns, st["resourceClaimName"]))
    for rc in (pod.get("spec") or {}).get("resourceClaims") or []:
        if rc.get("resourceClaimName"):
            refs.add((ns, rc["resourceClaimName"]))
    return refs


def _nsname(meta: dict) -> str:
    """Tracking key for a pod without a knowable uid (apiserver-less
    rebuild) and the deferral guard's self-key. One definition so the
    'default'-namespace fallback can't drift between the prune, delete,
    defer, and rebuild sites."""
    return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"


class Controller:
    def __init__(
        self,
        client: KubeClient,
        plugin,  # GpuDevicePlugin
        node_name: str,
        resource_name: str = constants.RESOURCE_NAME,
        checkpoint_path: str = constants.KUBELET_CHECKPOINT,
        podresources_socket: str = constants.POD_RESOURCES_SOCKET,
        devices_annotation: str = constants.POD_DEVICES_ANNOTATION,
        watch_timeout_s: int = 60,
        max_retries: int = 5,
        resync_interval_s: float = 30.0,
        evict_on_unhealthy: bool = True,
    ):
        self.client = client
        self.plugin = plugin
        self.node_name = node_name
        self.resource_name = resource_name
        self.checkpoint_path = checkpoint_path
        self.podres = PodResourcesClient(podresources_socket)
        self.devices_annotation = devices_annotation
        self.watch_timeout_s = watch_timeout_s
        self.max_retries = max_retries
        self.resync_interval_s = resync_interval_s
        self.evict_on_unhealthy = evict_on_unhealthy
        # Hook for the DRA plane, None until it is ported: chips →
        # [(ns, name)] of prepared ResourceClaims holding them. DRA pods
        # carry no devices annotation and no checkpoint entry, so eviction
        # finds them through their claim references instead.
        self.dra_claims_lookup = None
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._threads = []
        # Degradation queue: pod-annotation patches computed while the
        # apiserver is unreachable park here and drain after the next
        # successful relist — the annotation is delivered, not lost
        # (utils/resilience.py; tests/test_chaos.py).
        self._pending_writes = PendingWrites(
            gauge=metrics.KUBE_QUEUED_WRITES
        )
        # Escalating reconnect delay for the informer loop, reset on any
        # successful relist (replaces the old fixed 2 s wait).
        self._watch_backoff = Backoff(base=0.5, max_delay=15.0)
        # pod uid -> chip ids we believe it holds (for delete-time free when
        # the annotation is missing).
        self._pod_devices: Dict[str, Set[str]] = {}
        # chip id -> {pod, namespace, container, gang} for the chips we
        # track: the attribution side of _pod_devices, read by the
        # telemetry sampler (chip_attribution) to label tpu_chip_* series
        # with the holder. Own lock: the sampler reads from its thread
        # while the worker mutates.
        self._attr_lock = threading.Lock()
        self._chip_attr: Dict[str, Dict[str, str]] = {}
        # Optional TopologyPublisher owned by the wiring; stopped with us.
        self.publisher = None
        # Optional utils/resilience.DegradedMode (supervisor wiring):
        # every successful relist marks it fresh, so the plugin-side
        # staleness gauge ages only while the apiserver is actually
        # unreachable.
        self.degraded = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        self.rebuild_state()
        self._stop.clear()
        # Supervised targets (utils/profiling.py): a dead informer
        # means annotations/attribution silently freeze; a dead worker
        # means chips stop being freed — both now count, flight-record,
        # and trip the thread_liveness audit invariant.
        for name, loop_name, target in (
            ("pod-informer", "pod_informer", self._informer_loop),
            ("pod-worker", "pod_worker", self._worker_loop),
        ):
            t = threading.Thread(
                target=profiling.supervised(loop_name, target),
                name=name,
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        if self.publisher is not None:
            self.publisher.stop()
        self._stop.set()
        self._queue.put(None)
        # Abort the informer's in-flight streaming watch: without this it
        # sits in a blocking read for up to the watch window (~30 s),
        # outliving any bounded join and logging connection errors
        # against an apiserver that is already gone.
        self.client.interrupt_watches()
        # Bounded joins, both well under the DaemonSet's 30 s SIGTERM
        # grace: the informer now exits promptly (watch aborted above);
        # the worker mutates the SHARED plugin placement state, so it
        # gets the full REST-timeout budget to drain — freeing chips
        # from pre-stop state after a rebuild's rebuild_state() would
        # corrupt the new generation's accounting.
        for t in self._threads:
            t.join(timeout=15 if t.name == "pod-worker" else 5)
            if t.is_alive() and t.name == "pod-informer":
                # The interrupt can race a watch being opened (issued
                # but not yet registered in _live_watches): re-abort now
                # that the registration has certainly happened, and give
                # the raise-and-return a moment.
                self.client.interrupt_watches()
                t.join(timeout=2)
        leaked = [t.name for t in self._threads if t.is_alive()]
        if leaked:
            log.warning("controller threads still draining: %s", leaked)
        if "pod-worker" not in leaked:
            # The worker is podres's only user and must not leak the
            # channel on every supervisor rebuild.
            self.podres.close()
        self._threads = []

    # ------------------------------------------------------------------
    # Chip→pod attribution (the telemetry sampler's join source)
    # ------------------------------------------------------------------

    def chip_attribution(self) -> Dict[str, Dict[str, str]]:
        """chip id → {pod, namespace, container, gang} for every chip a
        tracked pod holds. The sampler (telemetry.py) joins this against
        the per-chip counters each tick; entries appear at reconcile and
        vanish when the chips are freed, so a scrape after a pod's
        deletion carries no stale attribution."""
        with self._attr_lock:
            return {
                cid: {k: v for k, v in attr.items() if k != "_partial"}
                for cid, attr in self._chip_attr.items()
            }

    def _record_attribution(
        self,
        meta: dict,
        chip_ids,
        container_of: Optional[Dict[str, str]] = None,
        partial: bool = False,
    ) -> None:
        """``partial=True`` marks a rebuild-time record (no container
        lookup ran; an apiserver-less rebuild has no labels either) so
        _attribution_stale refreshes it at the pod's next reconcile
        pass instead of trusting it forever."""
        name = meta.get("name", "")
        ns = meta.get("namespace", "default")
        gang = (meta.get("labels") or {}).get(constants.GANG_NAME_LABEL, "")
        container_of = container_of or {}
        with self._attr_lock:
            for cid in chip_ids:
                self._chip_attr[cid] = {
                    "pod": name,
                    "namespace": ns,
                    "container": container_of.get(cid, ""),
                    "gang": gang,
                    "_partial": partial,
                }

    def _drop_attribution(self, chip_ids) -> None:
        with self._attr_lock:
            for cid in chip_ids:
                self._chip_attr.pop(cid, None)

    def _attribution_stale(self, meta: dict, chip_ids) -> bool:
        """True when any chip's record is missing, names another pod,
        or is a rebuild-time partial (container/gang not yet looked
        up): the conditions under which the tracked-pod resync branch
        pays the per-container PodResources lookup."""
        name = meta.get("name", "")
        ns = meta.get("namespace", "default")
        with self._attr_lock:
            return any(
                (attr := self._chip_attr.get(cid)) is None
                or attr["pod"] != name
                or attr["namespace"] != ns
                or attr.get("_partial")
                for cid in chip_ids
            )

    def _container_of_chips(self, meta: dict) -> Optional[Dict[str, str]]:
        """real chip id → container name, from the PodResources API's
        per-container assignment (translated through the plugin's
        substitution record like reconciliation). Empty on checkpoint-
        only kubelets: the checkpoint has no container dimension, so
        those series attribute to the pod with container unset. None on
        a TRANSIENT lookup failure (kubelet mid-restart), so the caller
        records the attribution as partial and the next resync retries
        instead of freezing an empty container forever."""
        if not self.podres.available():
            return {}
        try:
            by_container = self.podres.pod_container_device_ids(
                meta.get("namespace", "default"),
                meta.get("name", ""),
                self.resource_name,
            )
        except Exception as e:
            log.warning("podresources container lookup failed: %s", e)
            return None
        out: Dict[str, str] = {}
        for container, kids in (by_container or {}).items():
            for kid in kids:
                rid = self.plugin.substitutions.get(kid, kid)
                if rid in self.plugin.topology.by_id:
                    out[rid] = container
        return out

    # ------------------------------------------------------------------
    # Startup state rebuild (a gap of the reference)
    # ------------------------------------------------------------------

    def rebuild_state(self) -> None:
        """Reconstruct allocated-chip state, keeping only entries whose pod
        still exists on this node. Source order: PodResources API when the
        kubelet serves it (stable contract), else the internal checkpoint
        file (all the reference's k8s-1.14 kubelet offered)."""
        # None = no authoritative PodResources answer (socket absent or RPC
        # failed); {} = the API answered "no assignments", which must NOT
        # fall through to a possibly-stale checkpoint from a prior boot.
        by_name = None  # (namespace, name) -> kubelet device ids
        by_uid: Dict[str, List[str]] = {}
        if self.podres.available():
            try:
                by_name = self.podres.device_ids_by_pod(self.resource_name)
            except Exception as e:
                log.warning(
                    "podresources List failed (%s); using checkpoint", e
                )
        if by_name is None:
            entries = ckpt.read_checkpoint(self.checkpoint_path)
            by_uid = ckpt.device_ids_by_pod(entries, self.resource_name)
        if not by_name and not by_uid:
            return
        items = None
        try:
            pods = self.client.list_pods(node_name=self.node_name)
            items = pods.get("items", [])
        except (KubeError, OSError) as e:
            log.warning(
                "state rebuild: pod list failed (%s); trusting kubelet", e
            )
        # Normalize both sources to live pods keyed the way _handle_delete
        # will look them up (uid; namespace/name when no uid is knowable).
        live: Dict[str, List[str]] = {}
        meta_by_key: Dict[str, dict] = {}
        if items is None:
            if by_uid:
                live = dict(by_uid)
            else:
                live = {
                    _nsname({"namespace": ns, "name": name}): ids
                    for (ns, name), ids in by_name.items()
                }
                meta_by_key = {
                    _nsname({"namespace": ns, "name": name}): {
                        "namespace": ns, "name": name,
                    }
                    for (ns, name) in by_name
                }
        else:
            # One (namespace, name) assignment belongs to exactly ONE pod
            # instance, but a same-name recreation briefly lists both the
            # Terminating old pod and its replacement. The kubelet's chips
            # belong to the instance still tearing down (matching the
            # update path's deferral), so claim in deletionTimestamp-first
            # order and never attribute one entry twice — a dual-holder
            # rebuild would later free the chips on the old pod's DELETED
            # while the replacement still runs on them.
            def claim_order(p):
                return 0 if p.get("metadata", {}).get(
                    "deletionTimestamp"
                ) else 1

            consumed = set()
            for p in sorted(items, key=claim_order):
                meta = p.get("metadata", {})
                if by_name:
                    key = (
                        meta.get("namespace", "default"),
                        meta.get("name", ""),
                    )
                    if key in consumed:
                        continue
                    ids = by_name.get(key)
                    if ids:
                        consumed.add(key)
                else:
                    ids = by_uid.get(meta.get("uid", ""))
                if ids:
                    live[meta.get("uid", "")] = ids
                    meta_by_key[meta.get("uid", "")] = meta
        allocated = []
        for key, ids in live.items():
            real = [self.plugin.shadow_map.get(i, i) for i in ids]
            known = [r for r in real if r in self.plugin.topology.by_id]
            allocated.extend(known)
            if known:
                self._pod_devices[key] = set(known)
                # Rebuild-time attribution (pod identity, and the gang
                # label when the API server answered); marked partial so
                # the next reconcile pass refreshes the container (and,
                # API-server-less, the gang) via _attribution_stale.
                if key in meta_by_key:
                    self._record_attribution(meta_by_key[key], known, partial=True)
        if allocated:
            self.plugin.mark_allocated(allocated)
            log.info(
                "rebuilt allocation state from %s: %d chips across %d pods",
                "podresources" if by_name else "checkpoint",
                len(allocated), len(self._pod_devices),
            )

    # ------------------------------------------------------------------
    # Informer
    # ------------------------------------------------------------------

    def _informer_loop(self) -> None:
        resource_version = ""
        last_list = 0.0
        # A healthy iteration can block in the watch stream for the
        # whole window, so the threshold is generous.
        hb = profiling.HEARTBEATS.register(
            "pod_informer",
            interval_s=self.resync_interval_s,
            max_silence_s=max(
                4 * self.resync_interval_s, 180.0
            ),
        )
        while not self._stop.is_set():
            hb.beat()
            try:
                # Periodic resync (informer-style): catches pods whose
                # kubelet checkpoint entry appeared after their last pod
                # event, so reconciliation never needs a fresh event.
                if time.time() - last_list > self.resync_interval_s:
                    resource_version = ""
                if not resource_version:
                    pods = self.client.list_pods(node_name=self.node_name)
                    last_list = time.time()
                    self._watch_backoff.reset()
                    if self.degraded is not None:
                        self.degraded.mark_fresh()
                    # The relist succeeded, so the apiserver is back:
                    # deliver the annotation patches queued while it was
                    # unreachable before this cycle's events re-derive
                    # the same writes.
                    if len(self._pending_writes):
                        self._pending_writes.drain()
                    resource_version = (
                        pods.get("metadata", {}).get("resourceVersion", "")
                    )
                    live_keys = set()
                    for pod in pods.get("items", []):
                        m = pod.get("metadata", {})
                        live_keys.add(m.get("uid", ""))
                        live_keys.add(_nsname(m))
                    # Prune tracking for pods that vanished while the watch
                    # was down (a missed DELETED event would otherwise hold
                    # their chips forever). Enqueued BEFORE the MODIFIED
                    # batch so a recreated pod deferring on a stale holder
                    # reconciles in this cycle, not the next; runs in the
                    # worker for ordering with in-flight events.
                    self._queue.put(("PRUNE", live_keys, 0))
                    # Level-triggered eviction: one sweep item covering
                    # ALL still-unhealthy chips per resync (a single pod
                    # list, not one per chip), so PDB-blocked evictions
                    # and pods that weren't reconciled when the
                    # transition fired are retried until the chip
                    # recovers or its pods are gone.
                    if (
                        self.evict_on_unhealthy
                        and self.plugin.state.unhealthy
                    ):
                        self._queue.put(("EVICT", None, 0))
                    for pod in pods.get("items", []):
                        self._enqueue("MODIFIED", pod)
                # Last gate before blocking in a streaming read: a stop()
                # that fired during the relist above has already run its
                # interrupt_watches() and found nothing — opening a watch
                # now would block uninterrupted for the whole window.
                if self._stop.is_set():
                    return
                for etype, obj in self.client.watch_pods(
                    node_name=self.node_name,
                    resource_version=resource_version,
                    timeout_seconds=min(
                        self.watch_timeout_s, int(self.resync_interval_s) or 1
                    ),
                ):
                    if self._stop.is_set():
                        return
                    rv = obj.get("metadata", {}).get("resourceVersion")
                    if rv:
                        resource_version = rv
                    if etype == "BOOKMARK":
                        continue
                    self._enqueue(etype, obj)
            except KubeError as e:
                if self._stop.is_set():
                    return
                if e.status_code == 410:  # resourceVersion too old: relist
                    log.info("watch expired; relisting")
                    metrics.KUBE_WATCH_STREAMS.inc(outcome="relist")
                    TRACKER.record_watch("relist")
                    resource_version = ""
                else:
                    log.warning("watch error: %s", e)
                    self._stop.wait(self._watch_backoff.next_delay())
            except Exception as e:  # noqa: BLE001 — informer must survive
                # stop() aborts an in-flight watch by closing its raw
                # connection (interrupt_watches) — the resulting error
                # (ConnectionError/ChunkedEncodingError/ValueError,
                # library-dependent) is the expected shape of teardown,
                # not warn-worthy; exit immediately. Any error while
                # running (apiserver restart mid-stream) is retried.
                if self._stop.is_set():
                    return
                log.warning("watch connection error: %s", e)
                if resource_version:
                    # The loop re-enters with resource_version intact:
                    # a resume from the bookmarked rv, not a relist —
                    # the apiserver replays everything we missed.
                    metrics.KUBE_WATCH_STREAMS.inc(outcome="resumed")
                    TRACKER.record_watch("resumed")
                self._stop.wait(self._watch_backoff.next_delay())

    def _enqueue(self, etype: str, pod: dict, retries: int = 0) -> None:
        if is_gpu_pod(pod, self.resource_name) or etype == "DELETED":
            self._queue.put((etype, pod, retries))

    # ------------------------------------------------------------------
    # Worker
    # ------------------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None or self._stop.is_set():
                return
            etype, pod, retries = item
            if etype in ("PRUNE", "EVICT"):
                # Outside the generic retry machinery: the give-up log
                # below assumes dict-shaped items. Both retry by being
                # re-fired at the next resync (eviction is level-
                # triggered — no bounded give-up; see _evict_pods_on_chip).
                try:
                    if etype == "PRUNE":
                        self._prune_stale(pod)  # pod = set of live keys
                    else:
                        # pod = chip id, or None for a full sweep
                        self._evict_pods_on_chip(pod)
                except Exception as e:
                    log.warning("%s failed: %s", etype.lower(), e)
                continue
            try:
                if etype == "DELETED":
                    self._handle_delete(pod)
                else:
                    self._handle_update(pod)
            except Exception as e:  # bounded retry, workqueue-style
                if retries + 1 >= self.max_retries:
                    log.error(
                        "giving up on pod %s after %d tries: %s",
                        pod.get("metadata", {}).get("name"),
                        retries + 1,
                        e,
                    )
                else:
                    log.warning("pod event retry (%s): %s", etype, e)
                    # Jittered workqueue backoff (resilience.py), stop-
                    # aware so shutdown never waits out a sleep.
                    self._stop.wait(
                        delay_for_attempt(retries, base=0.1, max_delay=2.0)
                    )
                    self._queue.put((etype, pod, retries + 1))

    def _prune_stale(self, live_keys: Set[str]) -> None:
        """Free chips tracked for pods no longer on the node. Tracking keys
        are pod uids (or namespace/name from an apiserver-less rebuild);
        ``live_keys`` carries both forms from a fresh list."""
        for key in list(self._pod_devices):
            if key not in live_keys:
                ids = self._pod_devices.pop(key, set())
                if ids:
                    self._drop_attribution(ids)
                    self.plugin.free_devices(ids)
                    log.info(
                        "pruned stale tracking for vanished pod %s "
                        "(freed %s)", key, sorted(ids),
                    )

    def _kubelet_ids_for_pod(self, meta: dict) -> Optional[List[str]]:
        """The kubelet's device IDs for one pod: PodResources API first
        (kube/podresources.py), checkpoint file as the fallback — the only
        source the reference had (controller.go:184-197)."""
        if self.podres.available():
            try:
                return self.podres.pod_device_ids(
                    meta.get("namespace", "default"),
                    meta.get("name", ""),
                    self.resource_name,
                )
            except Exception as e:
                log.warning(
                    "podresources Get failed (%s); using checkpoint", e
                )
        entries = ckpt.read_checkpoint(self.checkpoint_path)
        return ckpt.device_ids_by_pod(entries, self.resource_name).get(
            meta.get("uid", "")
        )

    # reference updatePodFunc, controller.go:173-225
    def _handle_update(self, pod: dict) -> None:
        """Trace-joining wrapper: a pod carrying the trace-context
        annotation (stamped by the gang admitter before its gates came
        off) gets its reconcile recorded as a ``controller.reconcile``
        span in that trace — which also makes the annotation PATCH a
        kube.* child span — and the plugin's provisional Allocate span
        adopted in (see _adopt_allocate_span). Pods without a carrier
        (or with tracing off) reconcile exactly as before."""
        if not tracing.enabled():
            return self._handle_update_impl(pod)
        ctx = tracing.extract(pod)
        if ctx is None:
            return self._handle_update_impl(pod)
        with tracing.span(
            "controller.reconcile",
            parent=ctx,
            service="controller",
            pod=tracing.pod_key(pod),
        ):
            return self._handle_update_impl(pod)

    def _adopt_allocate_span(self, pod: dict, real: List[str]) -> None:
        """The plugin-side trace join (utils/tracing.py module doc):
        Allocate ran before any pod identity was knowable, recording a
        provisional span + its chip ids in plugin.recent_allocations;
        now that THIS pod resolved to those chips (podresources/
        checkpoint lookup) and carries the trace annotation, adopt the
        span into the pod's trace."""
        if not tracing.enabled():
            return
        ctx = tracing.extract(pod)
        recents = getattr(self.plugin, "recent_allocations", None)
        if ctx is None or not recents:
            return
        target = None
        # Snapshot: the gRPC Allocate thread appends concurrently, and
        # a deque raises on mutation during iteration.
        for rec in list(recents):
            if rec.get("ids") and rec["ids"] & set(real):
                target = rec
                break
        if target is None:
            return
        try:
            recents.remove(target)
        except ValueError:
            pass  # another reconcile raced us to it
        tracing.adopt(target["span_id"], ctx)
        # The ledger's half of the same retroactive join: Allocate's
        # decision records were stamped under the provisional trace.
        LEDGER.retrace(target["trace_id"], ctx.trace_id)

    def _handle_update_impl(self, pod: dict) -> None:
        meta = pod.get("metadata", {})
        uid = meta.get("uid", "")
        annotations = meta.get("annotations") or {}
        if self.devices_annotation in annotations:
            # Already reconciled; just track for delete-time free.
            ids = [
                i
                for i in annotations[self.devices_annotation].split(",")
                if i in self.plugin.topology.by_id
            ]
            if ids:
                # Supersedes any namespace/name tracking from an
                # apiserver-less rebuild (rebuild_state).
                self._pod_devices.pop(_nsname(meta), None)
                self._pod_devices[uid] = set(ids)
                # Refresh the attribution only when it is missing or names
                # another pod (daemon restart, recreation): this branch
                # runs on every resync for every reconciled pod, and an
                # unconditional per-container lookup would cost a
                # PodResources RPC each pass.
                if self._attribution_stale(meta, ids):
                    containers = self._container_of_chips(meta)
                    self._record_attribution(meta, ids, containers, partial=containers is None)
            return
        kubelet_ids = self._kubelet_ids_for_pod(meta)
        if not kubelet_ids:
            return  # kubelet hasn't admitted the pod yet
        # Translate through the shadow map (reference controller.go:200-210)
        # — but only *read* here; entries are drained after the patch lands,
        # so a transient apiserver failure can retry (the reference drains
        # eagerly and would wedge that pod forever on a failed patch).
        real = []
        consumed = []
        for kid in kubelet_ids:
            rid = self.plugin.shadow_map.get(kid, kid)
            if rid in self.plugin.topology.by_id:
                real.append(rid)
                if kid in self.plugin.shadow_map:
                    consumed.append(kid)
        if not real:
            return
        # PodResources has no pod-UID dimension, so a recreated pod (same
        # namespace/name, new uid — e.g. a StatefulSet replacement) can
        # briefly inherit the OLD instance's assignment while the kubelet
        # tears it down. If another tracked pod still holds any of these
        # chips, defer: the old instance's DELETED event (or the resync
        # prune for a missed one, _prune_stale) frees them and the periodic
        # resync retries this pod. The pod's own namespace/name key (from
        # an apiserver-less rebuild, rebuild_state) is this pod, not a
        # conflicting holder.
        nsname = _nsname(meta)
        for other_key, held in self._pod_devices.items():
            if other_key not in (uid, nsname) and held & set(real):
                log.info(
                    "pod %s devices %s still held by pod %s; deferring",
                    nsname, sorted(held & set(real)), other_key,
                )
                return
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        value = ",".join(sorted(real))
        self._adopt_allocate_span(pod, real)
        RECORDER.record(
            "reconcile",
            f"pod {ns}/{name} reconciled to its real chips",
            pod=f"{ns}/{name}",
            chips=value,
        )
        try:
            self.client.patch_pod_annotations(
                ns, name, {self.devices_annotation: value}
            )
        except UnavailableError as e:
            # The apiserver is unreachable (retries/deadline/circuit all
            # exhausted inside the client). The kubelet has already
            # handed the chips over, so local state must proceed; only
            # the PUBLISH is deferred — queued and drained after the
            # next successful relist, so the annotation is delivered,
            # not lost to the bounded workqueue retry.
            log.warning(
                "pod %s/%s annotation patch queued (apiserver "
                "unreachable): %s", ns, name, e,
            )
            self._pending_writes.put(
                ("pod-ann", ns, name),
                lambda: self._deliver_queued_annotation(ns, name, uid, value),
                describe=f"devices annotation for pod {ns}/{name}",
            )
        # Allocation SLO: admission-stamp (gang release) → this
        # reconcile. Observed inside the reconcile span (exemplar), and
        # only on the pod's FIRST completed pass: it sits AFTER the
        # patch so a raising patch (409/5xx → workqueue retry) can't
        # observe, and the first_reconcile guard covers the queued-
        # UnavailableError path, whose next resync re-runs this whole
        # block with uid already tracked. Double samples would inflate
        # the histogram exactly during apiserver incidents. The
        # nsname key covers apiserver-less rebuilds (rebuild_state
        # tracks by namespace/name until this pass migrates it): a
        # pod reconciled before a daemon restart must not re-observe
        # its stale admitted-at stamp as a multi-hour sample.
        first_reconcile = (
            uid not in self._pod_devices
            and nsname not in self._pod_devices
        )
        admit_raw = annotations.get(constants.ADMIT_TS_ANNOTATION)
        elapsed = None
        if admit_raw and first_reconcile:
            try:
                elapsed = max(0.0, time.time() - float(admit_raw))
            except ValueError:
                pass  # a mangled stamp costs the sample, nothing else
            else:
                metrics.POD_TIME_TO_ALLOCATE.observe(elapsed)
        if LEDGER.enabled and first_reconcile:
            extra = (
                {"time_to_allocate_s": round(elapsed, 3)}
                if elapsed is not None
                else {}
            )
            LEDGER.record(
                "reconcile", "reconciled",
                f"pod {ns}/{name} reconciled to chips {value}",
                pod=f"{ns}/{name}",
                chips=value,
                **extra,
            )
        for kid in consumed:
            self.plugin.shadow_map.pop(kid, None)
        # Migrate any rebuild-time namespace/name tracking to the uid key.
        self._pod_devices.pop(nsname, None)
        self._pod_devices[uid] = set(real)
        containers = self._container_of_chips(meta)
        self._record_attribution(meta, real, containers, partial=containers is None)
        self.plugin.mark_allocated(real)
        log.info(
            "reconciled pod %s/%s -> chips %s",
            meta.get("namespace"),
            meta.get("name"),
            sorted(real),
        )

    # reference deletePodFunc, controller.go:148-171
    def _deliver_queued_annotation(
        self, ns: str, name: str, uid: str, value: str
    ) -> None:
        """Drain-time delivery of an annotation queued during an
        outage. The queue is keyed by namespace/name, but the chip list
        belongs to one pod INCARNATION: if the pod was deleted and
        recreated under the same name while the apiserver was
        unreachable (no DELETED event ever discarded the entry), the
        uid differs and patching would stamp the old incarnation's
        chips onto the new pod — later freed from under their real
        holder. Raising a semantic (non-Unavailable) error makes
        drain() drop the entry; the new incarnation's own RUNNING event
        derives its real annotation."""
        pod = self.client.get(f"/api/v1/namespaces/{ns}/pods/{name}")
        live_uid = (pod.get("metadata") or {}).get("uid", "")
        if live_uid != uid:
            raise ValueError(
                f"pod {ns}/{name} was recreated (uid {uid} -> "
                f"{live_uid}); queued annotation is stale"
            )
        self.client.patch_pod_annotations(
            ns, name, {self.devices_annotation: value}
        )

    def _handle_delete(self, pod: dict) -> None:
        meta = pod.get("metadata", {})
        uid = meta.get("uid", "")
        # A patch queued for this pod during an outage is moot now (and
        # would 404 at drain time anyway — dropped there too; this just
        # spares the round trip).
        self._pending_writes.discard(
            ("pod-ann", meta.get("namespace", "default"),
             meta.get("name", "")),
        )
        annotations = meta.get("annotations") or {}
        ids: Set[str] = set()
        if self.devices_annotation in annotations:
            ids = {
                i
                for i in annotations[self.devices_annotation].split(",")
                if i
            }
        ids |= self._pod_devices.pop(uid, set())
        # rebuild_state keys by namespace/name when no uid was knowable
        # (podresources data with the API server unreachable).
        ids |= self._pod_devices.pop(_nsname(meta), set())
        if not ids:
            return
        # The deleted pod's attribution drops for ALL its chips, including
        # any a replacement still holds: the stale pod name must never
        # scrape again, and the replacement's own reconcile re-attributes
        # the chips it keeps.
        self._drop_attribution(ids)
        # A replacement pod can already be RUNNING on this pod's chips by
        # the time the DELETED event lands (kubelet freed + re-Allocated
        # them while the old API object lingered on its grace period); its
        # reconcile is deferred by _handle_update's dual-holder guard, so
        # our tracking doesn't know yet. Freeing such chips would let a
        # third pod double-mount them — so chips the kubelet still reports
        # assigned are RE-BOUND to the namespace/name key instead of
        # freed: if the replacement holds them, its reconcile migrates the
        # key to its uid; if it was the old instance's lagging kubelet
        # cleanup, the entry disappears and the resync prune frees them.
        still_used = ids & self._kubelet_assigned_chips(exclude_uid=uid)
        if still_used:
            self._pod_devices[_nsname(meta)] = (
                self._pod_devices.get(_nsname(meta), set()) | still_used
            )
            log.info(
                "deleted pod %s/%s: chips %s still assigned per kubelet; "
                "re-bound for reconcile/prune",
                meta.get("namespace"), meta.get("name"), sorted(still_used),
            )
        freeable = ids - still_used
        if not freeable:
            return
        self.plugin.free_devices(freeable)
        log.info(
            "freed chips %s from deleted pod %s/%s",
            sorted(freeable),
            meta.get("namespace"),
            meta.get("name"),
        )

    # ------------------------------------------------------------------
    # Unhealthy-card eviction. Kubernetes never evicts a running pod when
    # a device it holds goes Unhealthy — ListAndWatch only protects FUTURE
    # placements — so the controller does it: a broken card's pods are
    # evicted (Eviction API, so PDBs are honored) to reschedule onto
    # healthy capacity. The reference has no analog (its health path ends
    # at re-advertisement, server.go:169-176).
    # ------------------------------------------------------------------

    def on_chip_unhealthy(self, chip_id: str) -> None:
        """Health-transition hook (wired to plugin.on_health_transition);
        safe from any thread — the worker does the actual eviction."""
        if self.evict_on_unhealthy:
            self._queue.put(("EVICT", chip_id, 0))

    def evict_unhealthy_now(self) -> None:
        """Sweep chips already unhealthy (a transition that fired before
        the hook was attached, or pre-restart state)."""
        for chip_id in self.plugin.state.unhealthy:
            self.on_chip_unhealthy(chip_id)

    def _evict_pods_on_chip(self, chip_id: Optional[str]) -> None:
        """One eviction attempt per holding pod; ``chip_id`` None sweeps
        ALL currently unhealthy chips with a single pod list (the resync
        path). No in-line retry loop: eviction is LEVEL-triggered — the
        informer re-fires a sweep at each resync — so PDB-blocked (429)
        evictions and pods that weren't yet reconciled when the
        transition fired get retried for as long as the chip stays
        broken, without sleeping on the worker thread."""
        broken = self.plugin.state.unhealthy
        chips = broken if chip_id is None else ({chip_id} & broken)
        if not chips:
            if chip_id is not None:
                # The chip recovered while this item sat in the queue — a
                # transient blip must not evict pods running fine.
                log.info(
                    "chip %s recovered before eviction ran; skipping",
                    chip_id,
                )
            return
        if self.degraded is not None and self.degraded.active:
            # Breaker open: every Eviction would fail fast anyway (it
            # never blind-retries), and half-evicting a gang against an
            # unreachable apiserver helps nobody. Eviction is LEVEL-
            # triggered — the resync after recovery re-fires this sweep
            # for as long as the chip stays broken.
            log.warning(
                "eviction sweep skipped: kube circuit open "
                "(degraded mode); retried next resync"
            )
            RECORDER.record(
                "degraded_mode",
                "eviction sweep skipped while breaker open",
                state="degraded",
                reason="eviction_deferred",
            )
            return
        try:
            pods = self.client.list_pods(
                node_name=self.node_name
            ).get("items", [])
        except (KubeError, OSError) as e:
            log.warning("eviction: pod list failed: %s", e)
            metrics.EVICTIONS.inc(outcome="failed")
            return  # next resync re-fires
        tracked_chips = {
            key: held & chips
            for key, held in self._pod_devices.items()
            if held & chips
        }
        broken_claims: Dict = {}  # (ns, name) -> broken chips it holds
        if self.dra_claims_lookup is not None:
            try:
                broken_claims = dict(self.dra_claims_lookup(chips))
            except Exception as e:
                log.warning("DRA claim lookup failed: %s", e)
        for pod in pods:
            meta = pod.get("metadata", {})
            if meta.get("deletionTimestamp"):
                continue  # already terminating (e.g. our prior eviction)
            ann = (meta.get("annotations") or {}).get(
                self.devices_annotation, ""
            )
            pod_chips = (set(ann.split(",")) if ann else set()) & chips
            pod_chips |= tracked_chips.get(meta.get("uid", ""), set())
            pod_chips |= tracked_chips.get(_nsname(meta), set())
            if broken_claims:
                for ref in _pod_claim_refs(pod) & set(broken_claims):
                    pod_chips |= broken_claims[ref]
            if not pod_chips:
                continue
            ns = meta.get("namespace", "default")
            name = meta.get("name", "")
            try:
                self.client.evict_pod(ns, name)
                metrics.EVICTIONS.inc(outcome="evicted")
                RECORDER.record(
                    "evict",
                    f"pod {ns}/{name} evicted (unhealthy chips)",
                    pod=f"{ns}/{name}",
                    chips=",".join(sorted(pod_chips)),
                )
                LEDGER.record(
                    "evict", "chip_unhealthy",
                    f"pod {ns}/{name} evicted: GPU(s) "
                    f"{','.join(sorted(pod_chips))} unhealthy",
                    pod=f"{ns}/{name}",
                    node=self.node_name,
                    chips=",".join(sorted(pod_chips)),
                )
                log.warning(
                    "evicted pod %s/%s: GPU(s) %s unhealthy",
                    ns, name, sorted(pod_chips),
                )
                try:
                    self.client.create_event(
                        ns,
                        {"kind": "Pod", "name": name, "namespace": ns},
                        reason=EVICT_EVENT_REASON,
                        message=(
                            f"evicted: GPU(s) "
                            f"{','.join(sorted(pod_chips))} on "
                            f"{self.node_name} unhealthy"
                        ),
                        event_type="Warning",
                    )
                except (KubeError, OSError) as e:
                    log.warning("eviction event emit failed: %s", e)
            except (KubeError, OSError) as e:
                # 429: a PodDisruptionBudget blocked it; the next resync
                # re-fires (the budget frees up as other pods move).
                log.warning("eviction of %s/%s failed: %s", ns, name, e)
                metrics.EVICTIONS.inc(outcome="failed")
                LEDGER.record(
                    "evict", "eviction_failed",
                    f"eviction of {ns}/{name} failed (retried every "
                    f"resync): {e}",
                    pod=f"{ns}/{name}",
                    node=self.node_name,
                    chips=",".join(sorted(pod_chips)),
                )

    def _kubelet_assigned_chips(self, exclude_uid: str = "") -> Set[str]:
        """Real chip ids the kubelet currently reports assigned, translated
        through the shadow map like reconciliation. The checkpoint path can
        exclude the deleted pod's own entry by uid; PodResources entries
        carry no uid, so same-name entries are deliberately INCLUDED (the
        caller re-binds rather than frees — conservative either way).
        Empty on any source failure — freeing is then the lesser risk
        (matches pre-guard behavior)."""
        assigned = []
        try:
            if self.podres.available():
                for ids in self.podres.device_ids_by_pod(
                    self.resource_name
                ).values():
                    assigned.extend(ids)
            else:
                by_uid = ckpt.device_ids_by_pod(
                    ckpt.read_checkpoint(self.checkpoint_path),
                    self.resource_name,
                )
                for entry_uid, ids in by_uid.items():
                    if entry_uid != exclude_uid:
                        assigned.extend(ids)
        except Exception as e:
            log.warning("assignment lookup on delete failed: %s", e)
            return set()
        used: Set[str] = set()
        for kid in assigned:
            # plugin.substitutions, not shadow_map: shadow entries are
            # drained on reconcile, and a drained kubelet id that happens
            # to equal another pod's real chip id would mistranslate.
            rid = self.plugin.substitutions.get(kid, kid)
            if rid in self.plugin.topology.by_id:
                used.add(rid)
        return used
