"""ResourceSlice publishing (resource.k8s.io, v1 with a v1beta1 fallback):
the counterpart of the JAX package's ``dra/slices.py`` over the node's
cards (``topology/links.LinkTopology``).

Under DRA a node's inventory is not an opaque count (the device-plugin
plane's ``nvidia.com/gpu: 4``) but a ResourceSlice that lists each card
as a device with attributes a claim selects on with CEL. The attributes
keep the JAX names where their meaning holds: ``chipId`` (the NVML UUID),
``pciAddress`` ("" where NVML hides the bus), ``index`` (NVML's),
``numaNode`` (-1 when unknown) and ``chipType`` (the card's entry in
``workload/chips.py``), plus ``minor`` of its ``/dev/nvidia<minor>``. The
capacity ``hbm`` is NVML's memory total. The TPU coordinates, core count
and multi-host attributes have no GPU meaning and no twin. Devices are
named ``gpu-<NVML index>``: a DNS-1123 label, where the UUID is not one.

API versions: DRA is GA as ``v1``; clusters through Kubernetes 1.32 serve
only ``v1beta1``. The version is negotiated from the
``/apis/resource.k8s.io`` group document. v1beta1 wraps a device's
attributes and capacity in ``basic``; v1 puts them on the device.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from ..discovery.chips import GpuChip
from ..kube.client import KubeClient, KubeError
from ..topology.links import LinkTopology
from ..topology.schema import minor_of
from ..utils.logging import get_logger

log = get_logger(__name__)

RESOURCE_GROUP = "/apis/resource.k8s.io"
# Newest first: negotiation takes the first one the cluster serves.
SUPPORTED_API_VERSIONS = ("v1", "v1beta1")
# NVIDIA's public DRA driver's name (NVIDIA/k8s-dra-driver-gpu).
DEFAULT_DRIVER = "gpu.nvidia.com"


def resource_api(api_version: str) -> str:
    return f"{RESOURCE_GROUP}/{api_version}"


def negotiate_api_version(client: KubeClient) -> str:
    """The newest resource.k8s.io version both sides speak, from the API
    group's discovery document. The two failures stay distinct: a cluster
    with no DRA at all (the group answers 404) and one whose DRA versions
    this driver does not speak (the group is there, no version in
    common)."""
    try:
        group = client.get(RESOURCE_GROUP)
    except KubeError as e:
        if e.status_code == 404:
            raise RuntimeError(
                "cluster does not serve resource.k8s.io — DRA is not enabled (needs the "
                "DynamicResourceAllocation feature gate / resource.k8s.io API group)"
            ) from e
        raise
    served = [v.get("version") for v in group.get("versions", []) if v.get("version")]
    for want in SUPPORTED_API_VERSIONS:
        if want in served:
            return want
    raise RuntimeError(
        f"cluster serves resource.k8s.io versions {served}; this driver supports "
        f"{list(SUPPORTED_API_VERSIONS)} — cluster DRA is too new/old for this driver build"
    )


def device_name(chip: GpuChip) -> str:
    """A ResourceSlice device name must be a DNS-1123 label, which a UUID
    is not: devices are named by NVML index, and the UUID rides in the
    ``chipId`` attribute."""
    return f"gpu-{chip.index}"


def chips_by_device_name(topology: LinkTopology) -> Dict[str, GpuChip]:
    return {device_name(c): c for c in topology.chips}


def slice_name(node_name: str, driver: str = DEFAULT_DRIVER) -> str:
    return re.sub(r"[^a-z0-9.-]", "-", f"{node_name}-{driver}".lower())


def build_resource_slice(
    topology: LinkTopology,
    node_name: str,
    driver: str = DEFAULT_DRIVER,
    pool_generation: int = 1,
    exclude=(),
    api_version: str = "v1",
) -> dict:
    """``exclude`` drops cards (by id) from the advertised inventory: the
    DRA form of ListAndWatch's Unhealthy, since the scheduler only sees
    what the slice lists."""
    devices = []
    for chip in sorted(topology.chips, key=lambda c: c.index):
        if chip.device_id_str in exclude:
            continue
        attributes = {
            "chipId": {"string": chip.device_id_str},
            "pciAddress": {"string": chip.pci_addr},
            "index": {"int": chip.index},
            "minor": {"int": minor_of(chip.dev_path)},
            "numaNode": {"int": chip.numa_node},
            "chipType": {"string": chip.chip_type},
        }
        capacity = {"hbm": {"value": str(chip.hbm_bytes)}}
        if api_version == "v1beta1":
            devices.append({"name": device_name(chip),
                            "basic": {"attributes": attributes, "capacity": capacity}})
        else:
            devices.append({"name": device_name(chip), "attributes": attributes,
                            "capacity": capacity})
    return {
        "apiVersion": f"resource.k8s.io/{api_version}",
        "kind": "ResourceSlice",
        "metadata": {"name": slice_name(node_name, driver)},
        "spec": {
            "driver": driver,
            "nodeName": node_name,
            "pool": {"name": node_name, "generation": pool_generation,
                     "resourceSliceCount": 1},
            "devices": devices,
        },
    }


def publish_resource_slice(
    client: KubeClient,
    topology: LinkTopology,
    node_name: str,
    driver: str = DEFAULT_DRIVER,
    pool_generation: int = 1,
    exclude=(),
    api_version: Optional[str] = None,
) -> dict:
    """Create or replace this node's ResourceSlice in the negotiated (or the
    given) resource.k8s.io version; returns the object as the API server
    stored it."""
    if api_version is None:
        api_version = negotiate_api_version(client)
    body = build_resource_slice(topology, node_name, driver, pool_generation,
                                exclude=exclude, api_version=api_version)
    name = body["metadata"]["name"]
    path = f"{resource_api(api_version)}/resourceslices"
    n = len(body["spec"]["devices"])
    try:
        existing = client.get(f"{path}/{name}")
    except KubeError as e:
        if e.status_code != 404:
            raise
        try:
            created = client.create(path, body)
        except KubeError as ce:
            if ce.status_code != 409:
                raise
            # Lost a create race: replace the object that won it.
            existing = client.get(f"{path}/{name}")
        else:
            log.info("published ResourceSlice %s: %d devices", name, n)
            return created
    body["metadata"]["resourceVersion"] = existing.get("metadata", {}).get(
        "resourceVersion", "")
    replaced = client.replace(f"{path}/{name}", body)
    log.info("replaced ResourceSlice %s: %d devices", name, n)
    return replaced


def delete_resource_slice(
    client: KubeClient,
    node_name: str,
    driver: str = DEFAULT_DRIVER,
    api_version: Optional[str] = None,
) -> None:
    if api_version is None:
        api_version = negotiate_api_version(client)
    try:
        client.delete(f"{resource_api(api_version)}/resourceslices/"
                      f"{slice_name(node_name, driver)}")
    except KubeError as e:
        if e.status_code != 404:
            raise


def get_resource_claim(
    client: KubeClient,
    namespace: str,
    name: str,
    api_version: Optional[str] = None,
) -> Optional[dict]:
    if api_version is None:
        api_version = negotiate_api_version(client)
    try:
        return client.get(f"{resource_api(api_version)}/namespaces/{namespace}"
                          f"/resourceclaims/{name}")
    except KubeError as e:
        if e.status_code == 404:
            return None
        raise
