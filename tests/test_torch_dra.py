"""The port's DRA plane (dra/{cdi,slices,driver}.py, the daemon's --dra and
tools/topo.py) against the JAX one.

Every scenario of the JAX ``tests/test_dra.py`` that holds on GPUs is one
test parametrised over the two planes: ``jax`` (``TpuDevicePlugin`` on a
fake v5p host of 4 chips, tests/fakes.py, driver ``tpu.google.com``,
devices ``chip-<i>``) and ``torch`` (``GpuDevicePlugin`` on 4 H100s of the
fake NVML, tests/fake_nvml.c, whose NVLinks join the v5p host's ICI pairs,
driver ``gpu.nvidia.com``, devices ``gpu-<i>``). Card i stands for chip i.
ResourceClaims and ResourceSlices live in tests/fake_apiserver.FakeApiServer;
the DRAPlugin and registry services are dialled over real unix sockets.

Two JAX scenarios get no port case: ``test_slice_attributes_on_multi_host``
and ``test_malformed_slice_bounds_do_not_break_publishing`` publish the
multi-host TPU slice attributes, which have no GPU meaning (as
``kube/gke.py`` has no twin). ``test_cdi_libtpu_mount`` neither: the port
mounts no library.

Every socket lives under a short temporary dir in /tmp: a unix socket path
holds 107 bytes, and a pytest temp path under xdist is longer than that.
"""

import json
import os
import re
import shutil
import signal
import tempfile
import threading
import time
import queue
import random

import grpc
import pytest

from k8s_device_plugin_tpu.api import constants as jax_constants
from k8s_device_plugin_tpu.api import deviceplugin_pb2 as jax_dppb
from k8s_device_plugin_tpu.api import dra_pb2 as jax_drapb
from k8s_device_plugin_tpu.api import grpc_defs as jax_grpc
from k8s_device_plugin_tpu.api import pluginregistration_pb2 as jax_regpb
from k8s_device_plugin_tpu.controller import controller as jax_controller
from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.dra import cdi as jax_cdi
from k8s_device_plugin_tpu.dra import driver as jax_driver
from k8s_device_plugin_tpu.dra import slices as jax_slices
from k8s_device_plugin_tpu.kube import client as jax_client
from k8s_device_plugin_tpu.server import plugin as jax_plugin
from k8s_device_plugin_tpu.supervisor import main as jax_main
from k8s_device_plugin_tpu.tools import topo as jax_topo
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu.topology.schema import NodeTopology as JaxTopology
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as dppb
from k8s_device_plugin_tpu_torch.api import dra_pb2 as drapb
from k8s_device_plugin_tpu_torch.api import grpc_defs
from k8s_device_plugin_tpu_torch.api import pluginregistration_pb2 as regpb
from k8s_device_plugin_tpu_torch.controller import controller
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.dra import cdi
from k8s_device_plugin_tpu_torch.dra import driver
from k8s_device_plugin_tpu_torch.dra import slices
from k8s_device_plugin_tpu_torch.kube import client
from k8s_device_plugin_tpu_torch.server import plugin
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.tools import topo
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.topology.schema import NodeTopology
from k8s_device_plugin_tpu_torch.utils import metrics
from tests import fakes
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakeKubelet
from tests.torch_kube_planes import stop_in_background

NODE = "tpu-node-1"
# The v5p host's ICI links, which the fake H100s' NVLinks copy.
EDGES = [(0, 1), (0, 2), (1, 3), (2, 3)]
WAIT_S = 10


class _Ctx:
    def abort(self, code, details):
        raise grpc.RpcError(f"{code}: {details}")


class JaxPlane:
    name = "jax"
    driver_name = "tpu.google.com"
    kind = "google.com/tpu"
    prefix = "chip"
    annotation = jax_constants.POD_DEVICES_ANNOTATION
    pb, dppb, regpb, grpc_defs = jax_drapb, jax_dppb, jax_regpb, jax_grpc
    cdi, slices, driver, metrics = jax_cdi, jax_slices, jax_driver, jax_metrics
    KubeClient = jax_client.KubeClient
    Controller = jax_controller.Controller
    topo = jax_topo

    def __init__(self, root, short):
        self.root, self.short = str(root), short
        self.accel, self.dev = fakes.make_fake_tpu_node(self.root, "v5p", 4)
        self.chips = PyTpuInfo().scan(self.accel, self.dev)

    def make_plugin(self, **cfg):
        return jax_plugin.TpuDevicePlugin(
            IciMesh(self.chips), config=jax_plugin.PluginConfig(libtpu_host_path="", **cfg))

    @staticmethod
    def topology(p):
        return p.mesh

    @staticmethod
    def ids(p):
        return p.mesh.ids

    def id_of(self, p, name):
        return self.slices.chips_by_device_name(p.mesh)[name].id

    @staticmethod
    def dev_path(p, cid):
        return p.mesh.by_id[cid].chip.dev_path

    @staticmethod
    def visible(p, env):
        """The card indexes a container env names."""
        return [int(i) for i in env["TPU_VISIBLE_CHIPS"].split(",")]

    def daemon(self, dp_dir, **kw):
        return jax_main.Daemon(jax_main.DaemonConfig(
            device_plugin_dir=dp_dir, sysfs_accel_dir=self.accel, dev_dir=self.dev,
            libtpu_host_path="", prefer_native_backend=False, **kw))

    def close(self):
        pass


class TorchPlane:
    name = "torch"
    driver_name = "gpu.nvidia.com"
    kind = "nvidia.com/gpu"
    prefix = "gpu"
    annotation = constants.POD_DEVICES_ANNOTATION
    pb, dppb, regpb, grpc_defs = drapb, dppb, regpb, grpc_defs
    cdi, slices, driver, metrics = cdi, slices, driver, metrics
    KubeClient = client.KubeClient
    Controller = controller.Controller
    topo = topo

    def __init__(self, root, short, fake):
        self.root, self.short, self.fake = str(root), short, fake
        fake.reset()
        self.sysfs, self.dev = os.path.join(self.root, "sys"), os.path.join(self.root, "dev")
        self.uuids = fk.grid_node(fake, self.sysfs, 4, EDGES)
        self.info = NvmlInfo(fake.path)
        self.chips = self.info.scan(self.sysfs, self.dev)

    def make_plugin(self, **cfg):
        return plugin.GpuDevicePlugin(
            LinkTopology(self.chips, self.info),
            config=plugin.PluginConfig(
                extra_device_paths=(os.path.join(self.dev, constants.NVIDIACTL),), **cfg))

    @staticmethod
    def topology(p):
        return p.topology

    @staticmethod
    def ids(p):
        return p.topology.ids

    def id_of(self, p, name):
        return self.slices.chips_by_device_name(p.topology)[name].device_id_str

    @staticmethod
    def dev_path(p, cid):
        return p.topology.by_id[cid].dev_path

    def visible(self, p, env):
        return [self.uuids.index(u) for u in env["NVIDIA_VISIBLE_DEVICES"].split(",")]

    def daemon(self, dp_dir, **kw):
        return main.Daemon(main.DaemonConfig(
            device_plugin_dir=dp_dir, sysfs_pci_dir=self.sysfs, dev_dir=self.dev,
            nvml_library=self.fake.path, **kw))

    def close(self):
        self.info.close()
        self.fake.reset()


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture
def short():
    """A short dir for every socket (a unix socket path holds 107 bytes)."""
    d = tempfile.mkdtemp(prefix="dra", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(params=["jax", "torch"])
def plane(request, tmp_path, short):
    if request.param == "jax":
        p = JaxPlane(tmp_path, short)
    else:
        p = TorchPlane(tmp_path, short, request.getfixturevalue("fake"))
    yield p
    p.close()


@pytest.fixture
def plugin_(plane):
    return plane.make_plugin()


@pytest.fixture
def api(plane):
    s = FakeApiServer()
    url = s.start()
    s.add_node(NODE)
    yield s, plane.KubeClient(url)
    stop_in_background(s)


def dirs(plane, sub=""):
    return dict(plugins_dir=os.path.join(plane.short, f"plugins{sub}"),
                plugins_registry_dir=os.path.join(plane.short, f"registry{sub}"),
                cdi_dir=os.path.join(plane.short, "cdi"))


def make_driver(plane, p, client_, sub="", **kw):
    return plane.driver.DraDriver(p, kube_client=client_, driver_name=plane.driver_name,
                                  node_name=NODE, **dirs(plane, sub), **kw)


@pytest.fixture
def drv(plane, plugin_, api):
    d = make_driver(plane, plugin_, api[1])
    d.start()
    yield d
    d.stop()


def dev(plane, i):
    return f"{plane.prefix}-{i}"


def claim_obj(plane, uid, indexes, requests=None, driver_name=None):
    results = [{"request": (requests or ["gpus"] * len(indexes))[k],
                "driver": driver_name or plane.driver_name, "pool": NODE,
                "device": dev(plane, i) if isinstance(i, int) else i}
               for k, i in enumerate(indexes)]
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceClaim",
        "metadata": {"name": f"claim-{uid}", "namespace": "default", "uid": uid},
        "status": {"allocation": {"devices": {"results": results}}},
    }


def stub_for(plane, d, service=None):
    ch = grpc.insecure_channel(f"unix:{d.socket_path}")
    grpc.channel_ready_future(ch).result(timeout=5)
    if service is None:
        return plane.grpc_defs.DraPluginStub(ch)
    return plane.grpc_defs.DraPluginStub(ch, service=service)


def prepare(plane, stub, uid, name=None, namespace="default"):
    req = plane.pb.NodePrepareResourcesRequest()
    req.claims.add(namespace=namespace, name=name or f"claim-{uid}", uid=uid)
    return stub.NodePrepareResources(req, timeout=WAIT_S).claims[uid]


def unprepare(plane, stub, uid):
    req = plane.pb.NodeUnprepareResourcesRequest()
    req.claims.add(namespace="default", name=f"claim-{uid}", uid=uid)
    return stub.NodeUnprepareResources(req, timeout=WAIT_S).claims[uid]


def spec_env(device):
    return dict(e.split("=", 1) for e in device["containerEdits"]["env"])


def wait_for(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def kubeconfig_for(path, url):
    path.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "cl", "user": "u"}}],
        "clusters": [{"name": "cl", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    return str(path)


# ---------------------------------------------------------------------------
# The wire copies
# ---------------------------------------------------------------------------

def test_port_dra_pb2_equals_jax_byte_for_byte():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert drapb.DESCRIPTOR.serialized_pb == jax_drapb.DESCRIPTOR.serialized_pb
    assert (root / "k8s_device_plugin_tpu_torch" / "api" / "dra_pb2.py").read_bytes() == \
        (root / "k8s_device_plugin_tpu" / "api" / "dra_pb2.py").read_bytes()
    assert grpc_defs.DRA_PLUGIN_SERVICES == jax_grpc.DRA_PLUGIN_SERVICES


# ---------------------------------------------------------------------------
# CDI registry
# ---------------------------------------------------------------------------

def test_cdi_write_read_remove(plane, tmp_path):
    reg = plane.cdi.CdiRegistry(str(tmp_path / "cdi"))
    cdi_id = reg.write_claim_device("uid-1", ["/dev/a0", "/dev/a1"], {"VISIBLE": "0,1"})
    assert cdi_id == f"{plane.kind}=claim-uid-1"
    spec = reg.read_claim_spec("uid-1")
    assert (spec["cdiVersion"], spec["kind"]) == ("0.6.0", plane.kind)
    d = spec["devices"][0]
    assert d["name"] == "claim-uid-1"
    assert [n["path"] for n in d["containerEdits"]["deviceNodes"]] == ["/dev/a0", "/dev/a1"]
    assert "VISIBLE=0,1" in d["containerEdits"]["env"]
    assert "mounts" not in d["containerEdits"]
    assert reg.list_claim_uids() == ["uid-1"]
    assert os.listdir(tmp_path / "cdi") == [re.sub(r"[^a-zA-Z0-9_.-]", "-", plane.kind)
                                           + "-claim-uid-1.json"]
    reg.remove_claim_device("uid-1")
    assert reg.read_claim_spec("uid-1") is None
    reg.remove_claim_device("uid-1")  # idempotent


def test_cdi_registry_touches_only_its_own_specs(plane, plugin_, api):
    """The dir also holds the container toolkit's specs of the same kind
    (devices ``0``, ``all``, a UUID): the registry lists, recovers and
    removes only its own ``<kind>-claim-*.json`` files, and its claim
    device names can equal none of the toolkit's."""
    cdi_dir = dirs(plane)["cdi_dir"]
    os.makedirs(cdi_dir)
    dashed = re.sub(r"[^a-zA-Z0-9_.-]", "-", plane.kind)
    foreign = {
        "nvidia.yaml": "cdiVersion: 0.6.0\nkind: nvidia.com/gpu\ndevices: []\n",
        f"{dashed}.json": json.dumps({"cdiVersion": "0.6.0", "kind": plane.kind, "devices": [
            {"name": n, "containerEdits": {"deviceNodes": [{"path": "/dev/x"}]}}
            for n in ("0", "all", "GPU-00000000-0000-4000-8000-000000000000")]}),
        f"{dashed}-claimless.json": json.dumps({"kind": plane.kind, "devices": []}),
    }
    for fname, text in foreign.items():
        with open(os.path.join(cdi_dir, fname), "w") as f:
            f.write(text)
    reg = plane.cdi.CdiRegistry(cdi_dir)
    cid = plane.chips[0].device_id_str
    reg.write_claim_device("u-own", ["/dev/a0"], {}, chip_ids=[cid],
                           claim_ref=("default", "claim-u-own"))
    assert reg.list_claim_uids() == ["u-own"]
    assert reg.claim_device_name("u-own") not in ("0", "all") and \
        not reg.claim_device_name("u-own").startswith("GPU-")
    d = make_driver(plane, plugin_, api[1])
    d.recover_prepared()
    assert list(d.prepared) == ["u-own"]
    d._unprepare_claim("u-own")
    for fname, text in foreign.items():
        with open(os.path.join(cdi_dir, fname)) as f:
            assert f.read() == text
    assert sorted(os.listdir(cdi_dir)) == sorted(foreign)


def test_cdi_edits_equal_the_allocate_response(plane, drv, api, plugin_):
    """One source for both planes: a claim's CDI device nodes and env are
    those of a classic Allocate of the same cards."""
    api[0].add_resource_claim(claim_obj(plane, "uid-eq", [1, 2]))
    assert not prepare(plane, stub_for(plane, drv), "uid-eq").error
    edits = drv.cdi.read_claim_spec("uid-eq")["devices"][0]["containerEdits"]
    ids = [plane.id_of(plugin_, dev(plane, i)) for i in (1, 2)]
    cresp = plugin_._container_response(ids)
    assert [n["hostPath"] for n in edits["deviceNodes"]] == [d.host_path for d in cresp.devices]
    assert [n["path"] for n in edits["deviceNodes"]] == [d.container_path for d in cresp.devices]
    assert spec_env({"containerEdits": edits}) == dict(cresp.envs)


# ---------------------------------------------------------------------------
# ResourceSlice
# ---------------------------------------------------------------------------

def test_build_resource_slice_shape(plane, plugin_):
    body = plane.slices.build_resource_slice(plane.topology(plugin_), NODE)
    assert body["spec"]["driver"] == plane.driver_name == plane.slices.DEFAULT_DRIVER
    assert (body["spec"]["nodeName"], body["spec"]["pool"]["name"]) == (NODE, NODE)
    devices = body["spec"]["devices"]
    names = [d["name"] for d in devices]
    assert names == [dev(plane, i) for i in range(4)]
    for n in names:  # DNS-1123 labels, which a card id is not
        assert re.fullmatch(r"[a-z0-9]([-a-z0-9]*[a-z0-9])?", n)
    attrs = [d["attributes"] for d in devices]
    assert [a["chipId"]["string"] for a in attrs] == [plane.id_of(plugin_, n) for n in names]
    assert [a["index"]["int"] for a in attrs] == [0, 1, 2, 3]
    assert all(int(d["capacity"]["hbm"]["value"]) > 0 for d in devices)
    if plane.name == "jax":
        assert attrs[3]["coordX"] == {"int": 1} and attrs[0]["chipType"] == {"string": "v5p"}
    else:
        assert [a["chipId"]["string"] for a in attrs] == plane.uuids
        assert set(attrs[0]) == {"chipId", "pciAddress", "index", "minor", "numaNode",
                                 "chipType"}
        assert [a["minor"]["int"] for a in attrs] == [0, 1, 2, 3]
        assert [a["pciAddress"]["string"] for a in attrs] == [
            c.pci_addr for c in plane.chips]
        assert attrs[0]["numaNode"] == {"int": 0}
        assert attrs[0]["chipType"] == {"string": plane.chips[0].chip_type}
        assert [int(d["capacity"]["hbm"]["value"]) for d in devices] == [fk.H100_BYTES] * 4


def test_publish_resource_slice_create_then_replace(plane, plugin_, api):
    server, kc = api
    topology = plane.topology(plugin_)
    plane.slices.publish_resource_slice(kc, topology, NODE)
    name = plane.slices.slice_name(NODE)
    assert name in server.resourceslices
    first_rv = server.resourceslices[name]["metadata"]["resourceVersion"]
    plane.slices.publish_resource_slice(kc, topology, NODE, pool_generation=2)
    obj = server.resourceslices[name]
    assert obj["spec"]["pool"]["generation"] == 2
    assert obj["metadata"]["resourceVersion"] != first_rv
    assert ("PUT", f"/apis/resource.k8s.io/v1/resourceslices/{name}") in server.requests
    plane.slices.delete_resource_slice(kc, NODE)
    assert name not in server.resourceslices
    plane.slices.delete_resource_slice(kc, NODE)  # a 404 is fine


# ---------------------------------------------------------------------------
# DRAPlugin service
# ---------------------------------------------------------------------------

def test_prepare_and_unprepare_claim(plane, drv, api, plugin_):
    api[0].add_resource_claim(claim_obj(plane, "uid-1", [0, 1]))
    stub = stub_for(plane, drv)
    result = prepare(plane, stub, "uid-1")
    assert not result.error
    assert {d.device_name for d in result.devices} == {dev(plane, 0), dev(plane, 1)}
    assert result.devices[0].pool_name == NODE
    assert list(result.devices[0].request_names) == ["gpus"]
    assert list(result.devices[0].cdi_device_ids) == [f"{plane.kind}=claim-uid-1"]
    spec = drv.cdi.read_claim_spec("uid-1")
    edits = spec["devices"][0]["containerEdits"]
    env = spec_env(spec["devices"][0])
    assert plane.visible(plugin_, env) == [0, 1]
    ids = [plane.id_of(plugin_, dev(plane, i)) for i in (0, 1)]
    want_nodes = [plane.dev_path(plugin_, i) for i in ids]
    if plane.name == "torch":
        assert env == {"NVIDIA_VISIBLE_DEVICES": ",".join(ids), "TPU_PLUGIN_ALLOCATED_CHIPS": "2"}
        want_nodes.append(os.path.join(plane.dev, "nvidiactl"))
    assert [n["hostPath"] for n in edits["deviceNodes"]] == want_nodes
    assert plugin_.state.allocated == set(ids)
    # The kubelet retries a prepare after its restarts.
    assert len(prepare(plane, stub, "uid-1").devices) == 2
    assert not unprepare(plane, stub, "uid-1").error
    assert plugin_.state.allocated == set()
    assert drv.cdi.read_claim_spec("uid-1") is None


def test_prepare_claim_not_found_is_per_claim_error(plane, drv):
    result = prepare(plane, stub_for(plane, drv), "uid-x", name="missing")
    assert "not found" in result.error
    assert not result.devices


def test_prepare_unknown_device_is_per_claim_error(plane, drv, api):
    api[0].add_resource_claim(claim_obj(plane, "uid-2", [9]))
    assert dev(plane, 9) in prepare(plane, stub_for(plane, drv), "uid-2").error


def test_prepare_uid_mismatch_rejected(plane, drv, api):
    """The kubelet's reference names another instance of the claim (deleted
    and made again): the wrong one is not staged."""
    api[0].add_resource_claim(claim_obj(plane, "uid-real", [0]))
    result = prepare(plane, stub_for(plane, drv), "uid-other", name="claim-uid-real")
    assert "uid mismatch" in result.error


def test_registry_socket_announces_dra_plugin(plane, drv):
    ch = grpc.insecure_channel(f"unix:{drv.registry_socket_path}")
    grpc.channel_ready_future(ch).result(timeout=5)
    stub = plane.grpc_defs.WatcherRegistrationStub(ch)
    info = stub.GetInfo(plane.regpb.InfoRequest())
    assert (info.type, info.name, info.endpoint) == ("DRAPlugin", plane.driver_name,
                                                    drv.socket_path)
    assert list(info.supported_versions) == ["v1.DRAPlugin", "v1beta1.DRAPlugin"]
    assert drv.socket_path == os.path.join(plane.short, "plugins", plane.driver_name, "dra.sock")
    assert drv.registry_socket_path == os.path.join(plane.short, "registry",
                                                    f"{plane.driver_name}-reg.sock")
    stub.NotifyRegistrationStatus(plane.regpb.RegistrationStatus(plugin_registered=True))


def test_other_driver_results_ignored(plane, drv, api):
    """A claim may mix the devices of several drivers; only ours are staged."""
    claim = claim_obj(plane, "uid-3", [2])
    claim["status"]["allocation"]["devices"]["results"].append(
        {"request": "nic", "driver": "nic.vendor.io", "pool": NODE, "device": "nic-0"})
    api[0].add_resource_claim(claim)
    result = prepare(plane, stub_for(plane, drv), "uid-3")
    assert not result.error
    assert [d.device_name for d in result.devices] == [dev(plane, 2)]


def test_classic_plane_excludes_dra_held_chips(plane, drv, api, plugin_):
    """The cards a claim stages are invisible to the kubelet's accounting, so
    the classic plane must not prefer them and must refuse an Allocate
    naming them."""
    api[0].add_resource_claim(claim_obj(plane, "uid-x", [0, 1]))
    assert not prepare(plane, stub_for(plane, drv), "uid-x").error
    held = drv._held_chip_ids()
    assert len(held) == 2
    picked = plugin_.state.select(2, available=plane.ids(plugin_))
    assert picked and not set(picked) & held
    assert plugin_.state.select(4, available=plane.ids(plugin_)) == []
    areq = plane.dppb.AllocateRequest()
    areq.container_requests.add(devicesIDs=sorted(held)[:1])
    with pytest.raises(grpc.RpcError, match="RESOURCE_EXHAUSTED"):
        plugin_._allocate(areq, _Ctx())


def test_prepare_refuses_classic_held_chips(plane, drv, api, plugin_):
    """The mirror guard: a claim on a card a device-plugin pod holds errors."""
    plugin_.state.allocate([plane.id_of(plugin_, dev(plane, 0))])
    api[0].add_resource_claim(claim_obj(plane, "uid-c", [0]))
    assert "device-plugin plane" in prepare(plane, stub_for(plane, drv), "uid-c").error
    assert drv.cdi.read_claim_spec("uid-c") is None


def test_prepare_refuses_chips_held_by_another_claim(plane, drv, api):
    """Two claims allocated one device (a duplicated scheduler decision):
    the second prepare errors instead of staging it twice."""
    api[0].add_resource_claim(claim_obj(plane, "uid-a", [0]))
    api[0].add_resource_claim(claim_obj(plane, "uid-b", [0]))
    stub = stub_for(plane, drv)
    assert not prepare(plane, stub, "uid-a").error
    assert "another ResourceClaim" in prepare(plane, stub, "uid-b").error


def test_substitution_mode_steers_around_dra_holds(plane, drv, api, plugin_):
    """In substitute_on_allocate mode a kubelet pick of a claim's card is
    remapped onto free cards, not refused: the guard reads the final set."""
    api[0].add_resource_claim(claim_obj(plane, "uid-s", [0]))
    assert not prepare(plane, stub_for(plane, drv), "uid-s").error
    held = plane.id_of(plugin_, dev(plane, 0))
    plugin_.config.substitute_on_allocate = True
    areq = plane.dppb.AllocateRequest()
    areq.container_requests.add(devicesIDs=[held])
    resp = plugin_._allocate(areq, _Ctx())
    assigned = [d.host_path for d in resp.container_responses[0].devices]
    assert assigned and plane.dev_path(plugin_, held) not in assigned


def test_dra_metrics_count_claims(plane, drv, api):
    """The two families under their JAX names: claims by op and outcome,
    and the prepared gauge."""
    def count(op, outcome):
        return sum(v for lab, v in plane.metrics.DRA_CLAIMS.series()
                   if lab == {"op": op, "outcome": outcome})

    before = {k: count(*k) for k in (("prepare", "ok"), ("prepare", "error"),
                                      ("unprepare", "ok"))}
    api[0].add_resource_claim(claim_obj(plane, "uid-m", [3]))
    stub = stub_for(plane, drv)
    assert not prepare(plane, stub, "uid-m").error
    assert prepare(plane, stub, "uid-none", name="missing").error
    assert [v for _, v in plane.metrics.DRA_PREPARED.series()] == [1]
    assert not unprepare(plane, stub, "uid-m").error
    assert [v for _, v in plane.metrics.DRA_PREPARED.series()] == [0]
    assert {k: count(*k) - before[k] for k in before} == {
        ("prepare", "ok"): 1, ("prepare", "error"): 1, ("unprepare", "ok"): 1}
    assert plane.metrics.DRA_CLAIMS.name == "tpu_plugin_dra_claims_total"
    assert plane.metrics.DRA_PREPARED.name == "tpu_plugin_dra_prepared_claims"


def test_dra_grpc_served_under_both_service_names(plane, drv, api):
    """A GA kubelet dials /v1.DRAPlugin/..., a beta one /v1beta1.DRAPlugin/...:
    one server answers both."""
    api[0].add_resource_claim(claim_obj(plane, "uid-v1", [2]))
    for service in plane.grpc_defs.DRA_PLUGIN_SERVICES:
        stub = stub_for(plane, drv, service=service)
        assert not prepare(plane, stub, "uid-v1").error
        assert not unprepare(plane, stub, "uid-v1").error


# ---------------------------------------------------------------------------
# Health, eviction, the publisher
# ---------------------------------------------------------------------------

def test_unhealthy_chip_dropped_from_slice_and_refused(plane, drv, api, plugin_):
    """A health transition republishes the slice without the broken card
    (a later pool generation), and a claim allocated onto it is refused."""
    server = api[0]
    cid = plane.id_of(plugin_, dev(plane, 0))
    name = plane.slices.slice_name(NODE, plane.driver_name)

    def devices():
        return [d["name"] for d in server.resourceslices[name]["spec"]["devices"]]

    assert wait_for(lambda: name in server.resourceslices)
    assert len(devices()) == 4
    gen0 = server.resourceslices[name]["spec"]["pool"]["generation"]
    plugin_.notify_health(cid, healthy=False)
    assert wait_for(lambda: len(devices()) == 3)
    assert server.resourceslices[name]["spec"]["pool"]["generation"] > gen0
    assert dev(plane, 0) not in devices()
    server.add_resource_claim(claim_obj(plane, "uid-h", [0]))
    assert "unhealthy" in prepare(plane, stub_for(plane, drv), "uid-h").error
    plugin_.notify_health(cid, healthy=True)
    assert wait_for(lambda: len(devices()) == 4)


def test_deleted_slice_recreated_on_resync(plane, plugin_, api):
    """A slice deleted under the driver is made again at the next resync."""
    server = api[0]
    d = make_driver(plane, plugin_, api[1], resync_interval_s=0.3)
    d.start()
    try:
        name = plane.slices.slice_name(NODE, plane.driver_name)
        assert wait_for(lambda: name in server.resourceslices)
        with server._lock:
            del server.resourceslices[name]
        assert wait_for(lambda: name in server.resourceslices)
    finally:
        d.stop()


def test_unhealthy_chip_evicts_dra_claim_pod(plane, drv, api, plugin_, tmp_path):
    """A pod on a DRA claim has no devices annotation and no checkpoint
    entry: eviction finds it through the claim when its card breaks."""
    server, kc = api
    server.add_resource_claim(claim_obj(plane, "uid-e", [0]))
    assert not prepare(plane, stub_for(plane, drv), "uid-e").error
    server.add_pod({
        "metadata": {"name": "dra-pod", "namespace": "default", "uid": "uid-p",
                     "annotations": {}},
        "spec": {"nodeName": NODE, "containers": [{"name": "m"}],
                 "resourceClaims": [{"name": "gpus"}]},
        "status": {"resourceClaimStatuses": [{"name": "gpus", "resourceClaimName": "claim-uid-e"}]},
    })
    server.add_pod({
        "metadata": {"name": "bystander", "namespace": "default", "uid": "uid-b",
                     "annotations": {}},
        "spec": {"nodeName": NODE, "containers": [{"name": "m"}]}, "status": {},
    })
    ckpt = tmp_path / "ckpt"
    ckpt.write_text("{}")
    ctrl = plane.Controller(kc, plugin_, node_name=NODE, checkpoint_path=str(ckpt),
                            podresources_socket="", watch_timeout_s=2)
    ctrl.dra_claims_lookup = drv.claims_on_chips
    cid = plane.id_of(plugin_, dev(plane, 0))
    plugin_.state.set_health(cid, healthy=False)
    ctrl._evict_pods_on_chip(cid)
    assert ("default", "dra-pod") in server.evictions
    assert ("default", "bystander") not in server.evictions


# ---------------------------------------------------------------------------
# Restarts: recovery from the CDI dir
# ---------------------------------------------------------------------------

def test_recover_prepared_from_cdi_specs(plane, plugin_, api):
    """A restarted driver rebuilds the claims' holds from the specs on disk,
    so the classic plane cannot hand out cards live claims own."""
    api[0].add_resource_claim(claim_obj(plane, "uid-r", [0, 1]))
    d1 = make_driver(plane, plugin_, api[1])
    d1.start()
    try:
        assert not prepare(plane, stub_for(plane, d1), "uid-r").error
    finally:
        d1.stop()
    plugin2 = plane.make_plugin()  # a new process: fresh state, same disk
    d2 = make_driver(plane, plugin2, api[1], sub="2")
    d2.start()
    try:
        assert d2.prepared.get("uid-r") is not None
        assert len(plugin2.state.allocated) == 2
        assert not unprepare(plane, stub_for(plane, d2), "uid-r").error
        assert plugin2.state.allocated == set()
    finally:
        d2.stop()


def test_claim_refs_recovered_from_disk(plane, plugin_, api):
    """The eviction's join key survives a restart in the spec annotations."""
    api[0].add_resource_claim(claim_obj(plane, "uid-r2", [1]))
    d1 = make_driver(plane, plugin_, api[1])
    d1.start()
    try:
        assert not prepare(plane, stub_for(plane, d1), "uid-r2").error
    finally:
        d1.stop()
    plugin2 = plane.make_plugin()
    d2 = make_driver(plane, plugin2, api[1], sub="2")
    d2.recover_prepared()
    cid = plane.id_of(plugin2, dev(plane, 1))
    assert d2.claims_on_chips([cid]) == {("default", "claim-uid-r2"): {cid}}


def test_legacy_spec_refs_resolved_via_api(plane, plugin_, api):
    """A spec without a claim reference gets it by listing ResourceClaims
    and matching the uid: the kubelet never prepares a running claim again."""
    server, kc = api
    cid = plane.id_of(plugin_, dev(plane, 0))
    reg = plane.cdi.CdiRegistry(dirs(plane)["cdi_dir"])
    reg.write_claim_device("uid-legacy", ["/dev/x0"], {}, chip_ids=[cid])
    server.add_resource_claim({"metadata": {"name": "old-claim", "namespace": "ml",
                                            "uid": "uid-legacy"}, "status": {}})
    d = make_driver(plane, plugin_, kc)
    d.recover_prepared()
    assert d.claims_on_chips([cid]) == {("ml", "old-claim"): {cid}}


def test_resolved_legacy_ref_persisted_to_spec(plane, plugin_, api):
    """A reference resolved through the API is written into the spec, so
    the next restart needs no API call."""
    server, kc = api
    cid = plane.id_of(plugin_, dev(plane, 0))
    reg = plane.cdi.CdiRegistry(dirs(plane)["cdi_dir"])
    reg.write_claim_device("uid-lp", ["/dev/x0"], {}, chip_ids=[cid])
    server.add_resource_claim({"metadata": {"name": "old2", "namespace": "ml",
                                            "uid": "uid-lp"}, "status": {}})
    d1 = make_driver(plane, plugin_, kc)
    d1.recover_prepared()
    assert d1.claim_refs["uid-lp"] == ("ml", "old2")
    assert reg.claim_ref("uid-lp") == ("ml", "old2")
    plugin_.state.reset()
    d2 = make_driver(plane, plugin_, None)
    d2.recover_prepared()
    assert d2.claim_refs["uid-lp"] == ("ml", "old2")


def test_multi_request_claim_gets_per_request_cdi_devices(plane, drv, api, plugin_):
    """Two requests, two CDI devices: a container that references request
    'a' gets only a's cards and an env over exactly them."""
    api[0].add_resource_claim(claim_obj(plane, "uid-mr", [0, 1, 2], requests=["a", "a", "b"]))
    result = prepare(plane, stub_for(plane, drv), "uid-mr")
    assert not result.error
    by_name = {d.device_name: d for d in result.devices}
    assert list(by_name[dev(plane, 0)].request_names) == ["a"]
    assert list(by_name[dev(plane, 2)].request_names) == ["b"]
    assert list(by_name[dev(plane, 0)].cdi_device_ids) == [f"{plane.kind}=claim-uid-mr-a"]
    assert list(by_name[dev(plane, 2)].cdi_device_ids) == [f"{plane.kind}=claim-uid-mr-b"]
    devs = {d["name"]: d for d in drv.cdi.read_claim_spec("uid-mr")["devices"]}
    assert set(devs) == {"claim-uid-mr-a", "claim-uid-mr-b"}
    assert plane.visible(plugin_, spec_env(devs["claim-uid-mr-a"])) == [0, 1]
    assert plane.visible(plugin_, spec_env(devs["claim-uid-mr-b"])) == [2]
    extra = 1 if plane.name == "torch" else 0  # /dev/nvidiactl
    assert len(devs["claim-uid-mr-a"]["containerEdits"]["deviceNodes"]) == 2 + extra
    assert len(devs["claim-uid-mr-b"]["containerEdits"]["deviceNodes"]) == 1 + extra


def test_multi_request_association_survives_restart(plane, drv, api, plugin_):
    """Recovery rebuilds request → cards from the spec's annotations: the
    re-prepare answers the first prepare's request names and CDI ids."""
    api[0].add_resource_claim(claim_obj(plane, "uid-rr", [0, 3], requests=["x", "y"]))
    assert not prepare(plane, stub_for(plane, drv), "uid-rr").error
    drv.stop()
    d2 = make_driver(plane, plane.make_plugin(), api[1], sub="2")
    d2.start()
    try:
        result = prepare(plane, stub_for(plane, d2), "uid-rr")
        assert not result.error
        by_name = {d.device_name: d for d in result.devices}
        assert list(by_name[dev(plane, 0)].request_names) == ["x"]
        assert list(by_name[dev(plane, 3)].request_names) == ["y"]
        assert list(by_name[dev(plane, 0)].cdi_device_ids) == [f"{plane.kind}=claim-uid-rr-x"]
        assert list(by_name[dev(plane, 3)].cdi_device_ids) == [f"{plane.kind}=claim-uid-rr-y"]
    finally:
        d2.stop()


# ---------------------------------------------------------------------------
# API versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("served", ["v1", "v1beta1"])
def test_negotiates_served_dra_version_end_to_end(plane, plugin_, served):
    """A v1-only and a v1beta1-only cluster both end with a slice in the
    served shape and a prepared claim."""
    server = FakeApiServer(dra_versions=(served,))
    server.add_node(NODE)
    d = make_driver(plane, plugin_, plane.KubeClient(server.start()))
    d.start()
    try:
        assert d.publish() is not None
        obj = server.resourceslices[plane.slices.slice_name(NODE, plane.driver_name)]
        assert obj["apiVersion"] == f"resource.k8s.io/{served}"
        dev0 = obj["spec"]["devices"][0]
        if served == "v1beta1":
            assert set(dev0) == {"name", "basic"} and "attributes" in dev0["basic"]
        else:
            assert "basic" not in dev0 and "attributes" in dev0
        server.add_resource_claim(claim_obj(plane, "uid-n", [0]))
        result = prepare(plane, stub_for(plane, d), "uid-n")
        assert not result.error and len(result.devices) == 1
    finally:
        d.stop()
        stop_in_background(server)


def test_no_dra_cluster_yields_distinct_error(plane):
    """No resource.k8s.io (DRA off) reads "DRA is not enabled", and a
    cluster of other versions names them."""
    for versions, match in (((), "DRA is not enabled"), (("v99alpha1",), "v99alpha1")):
        server = FakeApiServer(dra_versions=versions)
        try:
            with pytest.raises(RuntimeError, match=match):
                plane.slices.negotiate_api_version(plane.KubeClient(server.start()))
        finally:
            stop_in_background(server)


def test_in_place_cluster_upgrade_renegotiates(plane, plugin_):
    """A driver that negotiated v1beta1 survives the cluster's in-place
    upgrade to v1 only: the next publish 404s once, negotiates again and
    succeeds, and claim lookups follow."""
    server = FakeApiServer(dra_versions=("v1beta1",))
    server.add_node(NODE)
    d = make_driver(plane, plugin_, plane.KubeClient(server.start()))
    d.start()
    try:
        assert d.api_version() == "v1beta1"
        assert d.publish() is not None
        server.dra_versions = ("v1",)
        server.resourceslices.clear()
        assert d.publish() is not None
        assert d.api_version() == "v1"
        obj = server.resourceslices[plane.slices.slice_name(NODE, plane.driver_name)]
        assert obj["apiVersion"] == "resource.k8s.io/v1"
        server.add_resource_claim(claim_obj(plane, "uid-up", [1]))
        assert not prepare(plane, stub_for(plane, d), "uid-up").error
    finally:
        d.stop()
        stop_in_background(server)


# ---------------------------------------------------------------------------
# The daemon (--dra)
# ---------------------------------------------------------------------------

def run_dra_daemon(plane, tmp_path, **kw):
    """The daemon with --dra against a FakeApiServer, in a thread; every
    socket under the plane's short dir."""
    api = FakeApiServer()
    url = api.start()
    api.add_node(NODE)
    dp_dir = os.path.join(plane.short, "dp")
    os.makedirs(dp_dir)
    kubelet = FakeKubelet(dp_dir)
    kubelet.start()
    daemon = plane.daemon(dp_dir, node_name=NODE,
                          kubeconfig=kubeconfig_for(tmp_path / "kubeconfig", url),
                          podresources_socket="", enable_dra=True, **dirs(plane), **kw)
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    return api, kubelet, daemon, t


def stop_dra_daemon(api, kubelet, daemon, t):
    daemon.events.put(("signal", signal.SIGTERM))
    t.join(timeout=25)
    kubelet.stop()
    stop_in_background(api)
    assert not t.is_alive()


def test_daemon_serves_dra_plane(plane, tmp_path):
    """The daemon with --dra publishes the slice and serves
    NodePrepareResources beside the classic plane, over one placement
    state; SIGTERM removes the DRA sockets."""
    api, kubelet, daemon, t = run_dra_daemon(plane, tmp_path)
    try:
        assert kubelet.registered.wait(15)
        assert wait_for(lambda: daemon.dra is not None)
        name = plane.slices.slice_name(NODE, plane.driver_name)
        assert wait_for(lambda: name in api.resourceslices)
        assert len(api.resourceslices[name]["spec"]["devices"]) == 4
        api.add_resource_claim(claim_obj(plane, "uid-d", [0]))
        assert not prepare(plane, stub_for(plane, daemon.dra), "uid-d").error
        assert len(daemon.plugin.state.allocated) == 1
        assert daemon.controller is not None
        assert daemon.controller.dra_claims_lookup == daemon.dra.claims_on_chips
        sockets = (daemon.dra.socket_path, daemon.dra.registry_socket_path)
    finally:
        stop_dra_daemon(api, kubelet, daemon, t)
    assert not any(os.path.exists(s) for s in sockets)


def test_sighup_rebuild_recovers_dra_claims(plane, tmp_path):
    """A SIGHUP rebuilds the DRA plane with the plugin generation; the new
    generation takes the prepared claim back from its CDI spec, still
    withholds the card, and chains the health hook once: one transition
    gives one unhealthy Event and a slice without the card."""
    api, kubelet, daemon, t = run_dra_daemon(plane, tmp_path)
    try:
        assert kubelet.registered.wait(15)
        assert wait_for(lambda: daemon.dra is not None)
        gen1 = daemon.dra
        api.add_resource_claim(claim_obj(plane, "uid-hup", [0]))
        assert not prepare(plane, stub_for(plane, gen1), "uid-hup").error
        assert len(daemon.plugin.state.allocated) == 1
        daemon.events.put(("signal", signal.SIGHUP))
        assert wait_for(lambda: daemon.dra is not None and daemon.dra is not gen1
                        and daemon.dra.prepared.get("uid-hup") is not None)
        held = daemon.dra.prepared["uid-hup"]
        assert daemon.plugin.state.allocated == set(held)
        assert daemon.dra.claims_on_chips(held) == {("default", "claim-uid-hup"): set(held)}
        name = plane.slices.slice_name(NODE, plane.driver_name)
        assert wait_for(lambda: name in api.resourceslices
                        and len(api.resourceslices[name]["spec"]["devices"]) == 4)
        events = len(api.events)
        cid = plane.id_of(daemon.plugin, dev(plane, 3))
        daemon.plugin.notify_health(cid, healthy=False)
        assert wait_for(lambda: len(api.resourceslices[name]["spec"]["devices"]) == 3)
        assert wait_for(lambda: len(api.events) > events)
        time.sleep(0.3)
        assert len(api.events) == events + 1, api.events[events:]
    finally:
        stop_dra_daemon(api, kubelet, daemon, t)


def test_dra_without_a_kube_client_serves_on(plane, tmp_path, caplog):
    """--dra --no-controller with no reachable kube config: the plane logs
    an error and stays off, and the classic plane serves its cards."""
    dp_dir = os.path.join(plane.short, "dp")
    os.makedirs(dp_dir)
    kubelet = FakeKubelet(dp_dir)
    kubelet.start()
    daemon = plane.daemon(dp_dir, node_name=NODE, enable_controller=False,
                          kubeconfig=str(tmp_path / "missing"), enable_dra=True,
                          podresources_socket="", **dirs(plane))
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        assert kubelet.registered.wait(15)
        assert wait_for(lambda: "DRA plane disabled" in caplog.text)
        assert daemon.dra is None and daemon.plugin is not None
    finally:
        daemon.events.put(("signal", signal.SIGTERM))
        t.join(timeout=25)
        kubelet.stop()
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# Both planes on the same cards at once
# ---------------------------------------------------------------------------

def test_cross_plane_concurrency_never_double_allocates(plane, tmp_path):
    """Classic Allocate (substitution mode) and DRA prepare/unprepare hammer
    the same cards from six threads: the two planes' grants stay disjoint at
    every instant, and all is free at the end. A lock taken in the wrong
    order deadlocks here."""
    dp_dir = os.path.join(plane.short, "dp")
    os.makedirs(dp_dir)
    kubelet = FakeKubelet(dp_dir)
    kubelet.start()
    api = FakeApiServer()
    url = api.start()
    p = plane.make_plugin(device_plugin_dir=dp_dir, substitute_on_allocate=True)
    p.serve()
    d = plane.driver.DraDriver(p, kube_client=plane.KubeClient(url), node_name="stress-node",
                               driver_name=plane.driver_name, **dirs(plane))
    d.start()
    name_by_id = {plane.id_of(p, n): n
                  for n in plane.slices.chips_by_device_name(plane.topology(p))}
    ids = list(plane.ids(p))
    stub = kubelet.plugin_stub()
    dra_stub = stub_for(plane, d)
    lock = threading.Lock()
    classic_held, dra_held = set(), set()
    failures: queue.Queue = queue.Queue()
    rounds = 25

    def classic_worker(tid):
        rng = random.Random(tid)
        for _ in range(rounds):
            req = plane.dppb.AllocateRequest()
            req.container_requests.add().devicesIDs.extend(ids[:2])
            try:
                resp = stub.Allocate(req, timeout=10)
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    continue
                failures.put(f"classic rpc error: {e.code()}")
                return
            assigned = {i for c in resp.container_responses
                        for i in c.annotations[plane.annotation].split(",")}
            with lock:
                if assigned & (classic_held | dra_held):
                    failures.put(f"classic got held cards {assigned & (classic_held | dra_held)}")
                    return
                classic_held.update(assigned)
            time.sleep(rng.uniform(0, 0.01))
            with lock:
                classic_held.difference_update(assigned)
            p.free_devices(assigned)

    def dra_worker(tid):
        rng = random.Random(1000 + tid)
        for n in range(rounds):
            uid = f"u-{tid}-{n}"
            pick = rng.sample(ids, 2)
            api.add_resource_claim({
                "metadata": {"name": f"claim-{uid}", "namespace": "default", "uid": uid},
                "status": {"allocation": {"devices": {"results": [
                    {"request": "gpus", "driver": plane.driver_name, "pool": "stress-node",
                     "device": name_by_id[i]} for i in pick]}}},
            })
            if prepare(plane, dra_stub, uid).error:
                continue  # cards held elsewhere right now: a legal refusal
            staged = set(d.prepared.get(uid, []))
            with lock:
                if staged & (classic_held | dra_held):
                    failures.put(f"DRA staged held cards {staged & (classic_held | dra_held)}")
                    return
                dra_held.update(staged)
            time.sleep(rng.uniform(0, 0.01))
            with lock:
                dra_held.difference_update(staged)
            unprepare(plane, dra_stub, uid)

    threads = ([threading.Thread(target=classic_worker, args=(k,)) for k in range(3)]
               + [threading.Thread(target=dra_worker, args=(k,)) for k in range(3)])
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive(), "worker hung"
        assert failures.empty(), failures.get()
        assert p.state.allocated == set()
        assert d.prepared == {}
    finally:
        d.stop()
        p.stop()
        kubelet.stop()
        stop_in_background(api)


# ---------------------------------------------------------------------------
# tools/topo.py
# ---------------------------------------------------------------------------

def published(plane, p, available):
    """The node annotation of each plane, as its publisher writes it."""
    if plane.name == "jax":
        return JaxTopology.from_mesh(p.mesh, available=available).to_json()
    return NodeTopology.from_topology(p.topology, available=available).to_json()


def test_topo_from_json_renders_the_tree_and_select(plane, plugin_, tmp_path, capsys):
    """--from-json over the published annotation: the tree marks the taken
    cards, and --select 2 picks a linked free pair on both planes."""
    ids = plane.ids(plugin_)
    path = tmp_path / "topo.json"
    path.write_text(published(plane, plugin_, available=ids[1:]))
    assert plane.topo.main(["--from-json", str(path), "--select", "2"]) == 0
    out = capsys.readouterr().out
    picked = [int(i) for i in re.search(r"select\(2\) -> \[([0-9, ]+)\]", out).group(1).split(",")]
    assert 0 not in picked and tuple(sorted(picked)) in EDGES
    if plane.name == "torch":
        assert re.search(rf"^ \*gpu0 {ids[0]} minor=0 numa=0 ", out, re.M)
        assert re.search(rf"^  gpu1 {ids[1]} minor=1 ", out, re.M)
        assert "nvlink-peers=[gpu1, gpu2]" in out
        assert re.search(r"^  gpu0 +X +NV2/5 +NV2/5 +SYS/1$", out, re.M)
        assert "nvlink-pairs=1  avg-score=5.0" in out


def test_topo_live_scan_renders_the_node(plane, capsys, monkeypatch):
    """No flags: the tree of a live scan (the fake sysfs for JAX, the fake
    NVML for the port)."""
    if plane.name == "jax":
        argv = ["--sysfs", plane.accel, "--dev", plane.dev]
    else:
        monkeypatch.setattr(topo, "get_backend", lambda: NvmlInfo(plane.fake.path))
        argv = ["--sysfs", plane.sysfs, "--dev", plane.dev]
    assert plane.topo.main(argv) == 0
    out = capsys.readouterr().out
    if plane.name == "torch":
        assert out.startswith(f"cards: 4  {fk.H100} (")
        for i, uuid in enumerate(plane.uuids):
            assert f"gpu{i} {uuid} minor={i} " in out
        assert "(* = allocated/unhealthy)" in out and "*gpu" not in out
    else:
        assert "accel0" in out


def test_topo_cdi_dir_lists_prepared_claims(plane, drv, api, plugin_, tmp_path, capsys):
    """--cdi-dir lists the claims prepared on the node, as text and, with
    --json, beside the topology."""
    api[0].add_resource_claim(claim_obj(plane, "uid-t", [1, 3]))
    assert not prepare(plane, stub_for(plane, drv), "uid-t").error
    path = tmp_path / "topo.json"
    path.write_text(published(plane, plugin_, available=None))
    cdi_dir = dirs(plane)["cdi_dir"]
    assert plane.topo.main(["--from-json", str(path), "--cdi-dir", cdi_dir]) == 0
    out = capsys.readouterr().out
    assert f"DRA: 1 prepared claim(s) in {cdi_dir}" in out
    word = "chips" if plane.name == "jax" else "cards"
    assert f"claim default/claim-uid-t: {word} [1, 3]  cdi={plane.kind}=claim-uid-t" in out
    assert plane.topo.main(["--from-json", str(path), "--cdi-dir", cdi_dir, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    (claim,) = doc["dra_claims"]
    assert (claim["uid"], claim["namespace"], claim["name"], claim["chip_indexes"]) == (
        "uid-t", "default", "claim-uid-t", [1, 3])
    assert claim["chip_ids"] == [plane.id_of(plugin_, dev(plane, i)) for i in (1, 3)]
    assert len(doc["topology"]["chips"]) == 4


def test_published_topology_reads_back_its_links(tmp_path, short, fake):
    """The port's annotation, read back as the consumer's topology (the twin
    of the JAX ``to_mesh``), gives every card its fields and every pair the
    class and score the daemon published."""
    plane = TorchPlane(tmp_path, short, fake)
    t = plane.make_plugin().topology
    back = NodeTopology.from_json(NodeTopology.from_topology(t).to_json()).to_topology()
    plane.close()
    assert [(c.index, c.device_id_str, c.dev_path, c.pci_addr, c.numa_node, c.hbm_bytes,
             c.name, c.chip_type) for c in back.chips] == [
        (c.index, c.device_id_str, c.dev_path, c.pci_addr, c.numa_node, c.hbm_bytes, c.name,
         c.chip_type) for c in t.chips]
    for a in t.ids:
        for b in t.ids:
            assert (back.link_class(a, b), back.score_pair(a, b)) == (
                t.link_class(a, b), t.score_pair(a, b))
