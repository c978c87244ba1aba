"""The two planes of the kube-facing parity tests (tests/test_torch_controller.py,
tests/test_torch_kube_resilience.py): the JAX package's kube client, pod
controller, wiring, checkpoint reader and resilience layer over
``TpuDevicePlugin`` on a fake v5p host of 4 chips (tests/fakes.py), and
the port's over ``GpuDevicePlugin`` on 4 H100s of the fake NVML
(tests/fake_nvml.c) whose NVLinks join the same pairs as the v5p host's
ICI links. Card i stands for chip i; each plane names its own resource,
annotation keys, node condition and Event reasons.
"""

from __future__ import annotations

import os
import threading

from k8s_device_plugin_tpu.api import constants as jax_constants
from k8s_device_plugin_tpu.controller import controller as jax_controller
from k8s_device_plugin_tpu.controller import wiring as jax_wiring
from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.kube import checkpoint as jax_ckpt
from k8s_device_plugin_tpu.kube import client as jax_client
from k8s_device_plugin_tpu.kube import podresources as jax_podres
from k8s_device_plugin_tpu.server import plugin as jax_plugin
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import podresources as jax_requests
from k8s_device_plugin_tpu.utils import resilience as jax_resilience
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.controller import controller
from k8s_device_plugin_tpu_torch.controller import wiring
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.kube import checkpoint as ckpt
from k8s_device_plugin_tpu_torch.kube import client
from k8s_device_plugin_tpu_torch.kube import podresources
from k8s_device_plugin_tpu_torch.server import plugin
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.utils import metrics
from k8s_device_plugin_tpu_torch.utils import podresources as requests_
from k8s_device_plugin_tpu_torch.utils import resilience
from tests import fakes
from tests import torch_fake_nvml as fk

NODE = "tpu-node-1"
# The v5p host's ICI links (chip i's neighbours), which the fake H100s'
# NVLinks copy (2 a pair): 0-1, 0-2, 1-3, 2-3.
EDGES = [(0, 1), (0, 2), (1, 3), (2, 3)]


class JaxPlane:
    name = "jax"
    constants = jax_constants
    controller = jax_controller
    Controller = jax_controller.Controller
    wiring = jax_wiring
    ckpt = jax_ckpt
    KubeClient = jax_client.KubeClient
    KubeError = jax_client.KubeError
    PodResourcesClient = jax_podres.PodResourcesClient
    metrics = jax_metrics
    resilience = jax_resilience
    resource = "google.com/tpu"
    request = staticmethod(jax_requests.tpu_request)
    is_pod = staticmethod(jax_requests.is_tpu_pod)
    condition_type = jax_wiring.TPU_CONDITION_TYPE
    publish_condition = staticmethod(jax_wiring.publish_tpu_condition)
    condition_unhealthy = "ChipsUnhealthy"
    unhealthy_reason = "TPUChipUnhealthy"
    recovered_reason = "TPUChipRecovered"

    def __init__(self, root):
        accel, dev = fakes.make_fake_tpu_node(str(root), "v5p", 4)
        self.chips = PyTpuInfo().scan(accel, dev)

    def make_plugin(self):
        return jax_plugin.TpuDevicePlugin(
            IciMesh(self.chips), config=jax_plugin.PluginConfig(libtpu_host_path=""))

    @staticmethod
    def ids(p):
        return p.mesh.ids

    @staticmethod
    def publish_topology(client_, p, numa_nodes=2):
        return jax_wiring.publish_node_topology(client_, NODE, p.mesh, numa_nodes=numa_nodes)

    def close(self):
        pass


class TorchPlane:
    name = "torch"
    constants = constants
    controller = controller
    Controller = controller.Controller
    wiring = wiring
    ckpt = ckpt
    KubeClient = client.KubeClient
    KubeError = client.KubeError
    PodResourcesClient = podresources.PodResourcesClient
    metrics = metrics
    resilience = resilience
    resource = "nvidia.com/gpu"
    request = staticmethod(requests_.gpu_request)
    is_pod = staticmethod(requests_.is_gpu_pod)
    condition_type = wiring.GPU_CONDITION_TYPE
    publish_condition = staticmethod(wiring.publish_gpu_condition)
    condition_unhealthy = "GPUsUnhealthy"
    unhealthy_reason = "GPUUnhealthy"
    recovered_reason = "GPURecovered"

    def __init__(self, root, fake):
        self.fake = fake
        fake.reset()
        sysfs, self.dev = os.path.join(str(root), "sys"), os.path.join(str(root), "dev")
        self.uuids = fk.grid_node(fake, sysfs, 4, EDGES)
        self.info = NvmlInfo(fake.path)
        self.chips = self.info.scan(sysfs, self.dev)

    def make_plugin(self):
        return plugin.GpuDevicePlugin(LinkTopology(self.chips, self.info))

    @staticmethod
    def ids(p):
        return p.topology.ids

    @staticmethod
    def publish_topology(client_, p, numa_nodes=2):
        return wiring.publish_node_topology(client_, NODE, p.topology, numa_nodes=numa_nodes)

    def close(self):
        self.info.close()
        self.fake.reset()


def make_plane(name, root, fake_factory):
    """The ``name`` plane over a fresh fake host under ``root``;
    ``fake_factory()`` gives the loaded fake NVML (torch only)."""
    return JaxPlane(root) if name == "jax" else TorchPlane(root, fake_factory())


def pod_dict(plane, name, uid, cards=0, node=NODE, annotations=None, init_cards=0):
    """A pod on ``node`` requesting ``cards`` of the plane's resource
    (and ``init_cards`` in an init container)."""
    containers = [{"name": "main",
                   "resources": {"requests": {plane.resource: str(cards)} if cards else {}}}]
    spec = {"nodeName": node, "containers": containers}
    if init_cards:
        spec["initContainers"] = [
            {"name": "init", "resources": {"requests": {plane.resource: str(init_cards)}}}]
    return {
        "metadata": {"name": name, "namespace": "default", "uid": uid,
                     "annotations": annotations or {}},
        "spec": spec,
        "status": {},
    }


def stop_in_background(server) -> None:
    """Stop a FakeApiServer without waiting out its serve loop's half-second
    poll: every test starts its own, and the waits add up."""
    threading.Thread(target=server.stop, daemon=True).start()
