"""The two planes of the scheduler extender's parity tests
(tests/test_torch_extender.py, tests/test_torch_topology_index.py,
tests/test_torch_index_snapshot.py, tests/test_torch_reservations.py).

The JAX plane publishes the ``google.com/tpu-topology`` annotation of a v5p
host of 4 chips (tests/test_extender.py's ``make_node``); the port's plane
publishes ``nvidia.com/gpu-topology`` for H100 hosts read through the fake
NVML (tests/fake_nvml.c): the 4-card host of tests/torch_kube_planes.py,
whose NVLinks join the same pairs as the v5p host's ICI links (0-1, 0-2,
1-3, 2-3), an HGX host (every pair NV18 through NVSwitches, of 4 or 8
cards) and an 8-card host of two PCIe islands (PIX inside an island, SYS
across, no NVLink). Card i stands for chip i. Each layout's
``LinkTopology`` is read once; a node's annotation is
``NodeTopology.from_topology`` over it with the availability asked for.
"""

from __future__ import annotations

import os

from k8s_device_plugin_tpu.api import constants as jax_constants
from k8s_device_plugin_tpu.extender import index as jax_index
from k8s_device_plugin_tpu.extender import reservations as jax_reservations
from k8s_device_plugin_tpu.extender import server as jax_server
from k8s_device_plugin_tpu.kube.client import KubeClient as JaxKubeClient
from k8s_device_plugin_tpu.topology import schema as jax_schema
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import statestore as jax_statestore
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.extender import index
from k8s_device_plugin_tpu_torch.extender import reservations
from k8s_device_plugin_tpu_torch.extender import server
from k8s_device_plugin_tpu_torch.kube.client import KubeClient
from k8s_device_plugin_tpu_torch.topology import schema
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.utils import metrics
from k8s_device_plugin_tpu_torch.utils import statestore
from tests import torch_fake_nvml as fk
from tests.test_extender import make_mesh as jax_make_mesh
from tests.test_extender import make_node as jax_make_node
from tests.torch_kube_planes import EDGES


class ListClient:
    """list_nodes/get_node over a fixed node list (the JAX
    tests/test_topology_index.py ``_ListClient``)."""

    def __init__(self, nodes):
        self.nodes = list(nodes)
        self.get_calls = 0

    def list_nodes(self, label_selector=""):
        return {"metadata": {"resourceVersion": "1"}, "items": self.nodes}

    def get_node(self, name):
        self.get_calls += 1
        for n in self.nodes:
            if n["metadata"]["name"] == name:
                return n
        raise KeyError(name)


def read_layouts(fake, root) -> dict:
    """name -> LinkTopology of every fake-NVML layout the tests use, each
    scanned on its own (the fake is reset between them)."""
    out = {}

    def scan(name, build):
        fake.reset()
        sysfs = os.path.join(str(root), name, "sys")
        build(sysfs)
        info = NvmlInfo(fake.path)
        try:
            out[name] = LinkTopology(info.scan(sysfs, os.path.join(str(root), name, "dev")), info)
        finally:
            info.close()

    scan("grid4", lambda sysfs: fk.grid_node(fake, sysfs, 4, EDGES))
    scan("hgx4", lambda sysfs: fk.hgx_node(fake, sysfs, 4))
    scan("hgx8", lambda sysfs: fk.hgx_node(fake, sysfs, 8, numa=(0,) * 4 + (1,) * 4))

    def islands(sysfs):
        fk.grid_node(fake, sysfs, 8, [])
        for a in range(8):
            for b in range(a + 1, 8):
                fake.set_ancestor(a, b, "PIX" if a // 4 == b // 4 else "SYS")

    scan("islands8", islands)
    fake.reset()
    return out


class JaxPlane:
    name = "jax"
    server = jax_server
    index = jax_index
    reservations = jax_reservations
    schema = jax_schema
    metrics = jax_metrics
    statestore = jax_statestore
    constants = jax_constants
    KubeClient = JaxKubeClient
    resource = "google.com/tpu"

    def __init__(self):
        self.ids = jax_make_mesh().ids
        self.chip_count = 4

    def raw(self, name, avail_idx=None) -> str:
        return self.node(name, avail_idx)["metadata"]["annotations"][
            self.constants.TOPOLOGY_ANNOTATION]

    def node(self, name, avail_idx=None) -> dict:
        available = None if avail_idx is None else [self.ids[i] for i in avail_idx]
        return jax_make_node(name, available=available)[0]

    def reject(self, ext, n, topo, avail, held=0):
        return ext._reject_reason(n, topo, avail, held, {})


class TorchPlane:
    name = "torch"
    server = server
    index = index
    reservations = reservations
    schema = schema
    metrics = metrics
    statestore = statestore
    constants = constants
    KubeClient = KubeClient
    resource = "nvidia.com/gpu"

    def __init__(self, topology: LinkTopology):
        self.topology = topology
        self.ids = topology.ids
        self.chip_count = len(self.ids)

    def raw(self, name, avail_idx=None) -> str:
        available = None if avail_idx is None else [self.ids[i] for i in avail_idx]
        return schema.NodeTopology.from_topology(
            self.topology, hostname=name, available=available).to_json()

    def node(self, name, avail_idx=None) -> dict:
        return {"metadata": {"name": name,
                             "annotations": {constants.TOPOLOGY_ANNOTATION: self.raw(name, avail_idx)}}}

    def reject(self, ext, n, topo, avail, held=0):
        return ext._reject_reason(n, topo, avail, held)


def pod(plane, n, name="p", gang=None) -> dict:
    """A pod asking ``n`` of the plane's resource (the JAX ``tpu_pod``);
    ``gang`` = (name, size) adds the gang labels."""
    meta = {"name": name, "namespace": "default", "uid": f"u-{name}"}
    if gang is not None:
        meta["labels"] = {"tpu.google.com/gang-name": gang[0],
                          "tpu.google.com/gang-size": str(gang[1])}
    return {"metadata": meta,
            "spec": {"containers": [{"name": "c",
                                     "resources": {"requests": {plane.resource: str(n)}}}]}}


def patterns(count: int = 4):
    """Every availability pattern of a ``count``-card node, as index
    tuples."""
    return [tuple(i for i in range(count) if mask >> i & 1) for mask in range(1 << count)]


def pattern_name(p) -> str:
    return "a" + "".join(str(i) for i in p)
