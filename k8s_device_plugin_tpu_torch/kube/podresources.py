"""Client for the kubelet PodResources API (podresources/v1): the JAX
package's ``kube/podresources.py``, copied.

The kubelet serves ``PodResourcesLister`` on
``/var/lib/kubelet/pod-resources/kubelet.sock``. ``List`` reports, per pod
and container, the device IDs the device manager assigned — the same facts
the reference digs out of the kubelet's *internal* checkpoint file
(controller.go:184-197), but over a stable, supported API
(the checkpoint's JSON layout has changed across kubelet versions;
kube/checkpoint.py handles two of them).

The controller uses this as its primary pod→device source and falls back to
the checkpoint file on kubelets that don't serve the socket. Note one
difference that shapes the interface: the checkpoint keys entries by pod
UID, while PodResources identifies pods by (namespace, name) — callers
match on whichever key their pod object provides.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import grpc

from ..api import grpc_defs
from ..api import podresources_pb2 as pb
from ..utils.logging import get_logger

log = get_logger(__name__)

# One List round-trip over a local unix socket is milliseconds; anything
# slower means the kubelet is wedged and the checkpoint fallback is better.
_RPC_TIMEOUT_S = 5.0


class PodResourcesClient:
    """Holds one lazily-dialed channel — the informer re-queries on every
    pod event and resync, so per-call dials would dominate. The channel is
    dropped on UNAVAILABLE so a kubelet restart (socket recreated) just
    costs one failed call before the redial."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._lock = threading.Lock()
        self._channel: Optional[grpc.Channel] = None
        self._cached_stub: Optional[grpc_defs.PodResourcesListerStub] = None
        # Pre-1.27 kubelets serve List but not Get; remember the verdict so
        # steady state is a single List, not Get(UNIMPLEMENTED)+List.
        self._get_unimplemented = False

    def available(self) -> bool:
        """True when the kubelet exposes the PodResources socket."""
        return bool(self.socket_path) and os.path.exists(self.socket_path)

    def _stub(self) -> grpc_defs.PodResourcesListerStub:
        with self._lock:
            if self._cached_stub is None:
                self._channel = grpc.insecure_channel(
                    f"unix://{self.socket_path}"
                )
                self._cached_stub = grpc_defs.PodResourcesListerStub(
                    self._channel
                )
            return self._cached_stub

    def _drop_channel(self) -> None:
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None
            self._cached_stub = None

    def _call(self, method_name: str, request):
        try:
            return getattr(self._stub(), method_name)(
                request, timeout=_RPC_TIMEOUT_S
            )
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.UNAVAILABLE:
                self._drop_channel()
            raise

    def close(self) -> None:
        self._drop_channel()

    def list(self) -> List[pb.PodResources]:
        resp = self._call("List", pb.ListPodResourcesRequest())
        return list(resp.pod_resources)

    def allocatable_device_ids(self, resource_name: str) -> List[str]:
        """Device IDs the kubelet considers allocatable for ``resource_name``
        (GetAllocatableResources, GA k8s 1.28)."""
        resp = self._call(
            "GetAllocatableResources", pb.AllocatableResourcesRequest()
        )
        ids: List[str] = []
        for dev in resp.devices:
            if dev.resource_name == resource_name:
                ids.extend(dev.device_ids)
        return ids

    def device_ids_by_pod(
        self, resource_name: str
    ) -> Dict[Tuple[str, str], List[str]]:
        """(namespace, name) → kubelet device IDs for ``resource_name``,
        summed across the pod's containers (a pod can split chips across
        containers; the controller tracks the pod total, matching the
        checkpoint reader's per-pod aggregation)."""
        out: Dict[Tuple[str, str], List[str]] = {}
        for pod in self.list():
            ids = _ids_for_resource(pod.containers, resource_name)
            if ids:
                out[(pod.namespace, pod.name)] = ids
        return out

    def pod_device_ids(
        self, namespace: str, name: str, resource_name: str
    ) -> Optional[List[str]]:
        """Device IDs for one pod, or None when the kubelet has no entry
        (pod not yet admitted). Uses Get when available (k8s 1.27+). Any
        Get error other than UNAVAILABLE falls back to List: real kubelets
        return code Unknown (a plain fmt.Errorf), not NOT_FOUND, for a pod
        they haven't admitted, and List answers that case authoritatively
        (no entry → None) without log spam on every resync."""
        if not self._get_unimplemented:
            try:
                resp = self._call(
                    "Get",
                    pb.GetPodResourcesRequest(
                        pod_name=name, pod_namespace=namespace
                    ),
                )
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                ):
                    # Kubelet gone or wedged: don't stack a second 5 s
                    # timeout on List; the caller's checkpoint fallback is
                    # the right escape.
                    raise
                if code == grpc.StatusCode.UNIMPLEMENTED:
                    self._get_unimplemented = True  # pre-1.27, remember
                # Anything else (real kubelets answer "pod not found" with
                # code Unknown, not NOT_FOUND) → List below answers
                # authoritatively: no entry ⇒ None.
            else:
                return (
                    _ids_for_resource(
                        resp.pod_resources.containers, resource_name
                    )
                    or None
                )
        return self.device_ids_by_pod(resource_name).get((namespace, name))


    def pod_container_device_ids(
        self, namespace: str, name: str, resource_name: str
    ) -> Optional[Dict[str, List[str]]]:
        """container name → kubelet device IDs for one pod, or None
        when the kubelet has no entry. The per-container dimension the
        flat lookups above throw away — the telemetry exporter needs it
        to label a chip's series with the CONTAINER that mounted it
        (the checkpoint fallback has no container field, so checkpoint-
        only kubelets attribute to the pod and leave container empty)."""
        if not self._get_unimplemented:
            try:
                resp = self._call(
                    "Get",
                    pb.GetPodResourcesRequest(
                        pod_name=name, pod_namespace=namespace
                    ),
                )
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                ):
                    raise
                if code == grpc.StatusCode.UNIMPLEMENTED:
                    self._get_unimplemented = True
            else:
                out = _ids_by_container(
                    resp.pod_resources.containers, resource_name
                )
                return out or None
        for pod in self.list():
            if (pod.namespace, pod.name) == (namespace, name):
                return (
                    _ids_by_container(pod.containers, resource_name)
                    or None
                )
        return None


def _ids_by_container(
    containers, resource_name: str
) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for container in containers:
        ids: List[str] = []
        for dev in container.devices:
            if dev.resource_name == resource_name:
                ids.extend(dev.device_ids)
        if ids:
            out[container.name] = ids
    return out


def _ids_for_resource(containers, resource_name: str) -> List[str]:
    ids: List[str] = []
    for container in containers:
        for dev in container.devices:
            if dev.resource_name == resource_name:
                ids.extend(dev.device_ids)
    return ids
