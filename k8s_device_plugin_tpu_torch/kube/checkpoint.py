"""Kubelet device-manager checkpoint reader: the JAX package's
``kube/checkpoint.py``, copied.

The kubelet persists pod→device bindings at
/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint; the reference
reads it to learn which kubelet-side device IDs each pod actually holds
(controller.go:184-197; the schema is the vendored kubelet's
devicemanager/checkpoint/checkpoint.go:27-85). The format is the kubelet's
own, whatever the device; this reader also takes the post-1.20 layout
where DeviceIDs is a NUMA-node-keyed map instead of a flat list.

Read-only: we never write this file. The checksum field is kubelet-internal
(a hash of Go runtime object layout) and is not validated here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List
from ..utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class PodDevicesEntry:
    pod_uid: str
    container_name: str
    resource_name: str
    device_ids: List[str]


def parse_checkpoint(content: str) -> List[PodDevicesEntry]:
    """Parse checkpoint JSON into entries. Tolerates both DeviceIDs formats:
    pre-1.20 ``["id", ...]`` and post-1.20 ``{"0": ["id", ...], ...}``."""
    doc = json.loads(content)
    data = doc.get("Data", doc)
    entries = []
    for raw in data.get("PodDeviceEntries", []) or []:
        ids = raw.get("DeviceIDs") or []
        if isinstance(ids, dict):
            flat: List[str] = []
            for numa_ids in ids.values():
                flat.extend(numa_ids or [])
            ids = flat
        entries.append(
            PodDevicesEntry(
                pod_uid=raw.get("PodUID", ""),
                container_name=raw.get("ContainerName", ""),
                resource_name=raw.get("ResourceName", ""),
                device_ids=list(ids),
            )
        )
    return entries


def read_checkpoint(path: str) -> List[PodDevicesEntry]:
    """Read and parse; missing or corrupt files are empty, not fatal (the
    plugin must come up on nodes where the kubelet hasn't written one)."""
    try:
        with open(path) as f:
            content = f.read()
    except OSError as e:
        log.debug("no kubelet checkpoint at %s: %s", path, e)
        return []
    try:
        return parse_checkpoint(content)
    except (json.JSONDecodeError, AttributeError, TypeError) as e:
        log.warning("unparseable kubelet checkpoint %s: %s", path, e)
        return []


def entries_for_resource(
    entries: List[PodDevicesEntry], resource_name: str
) -> List[PodDevicesEntry]:
    return [e for e in entries if e.resource_name == resource_name]


def device_ids_by_pod(
    entries: List[PodDevicesEntry], resource_name: str
) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for e in entries_for_resource(entries, resource_name):
        out.setdefault(e.pod_uid, []).extend(e.device_ids)
    return out
