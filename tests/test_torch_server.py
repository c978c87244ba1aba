"""The port's device-plugin server (server/plugin.py) against the JAX one,
each driven over unix sockets by the fake kubelet (tests/fake_kubelet.py).

Every scenario of the JAX ``tests/test_server.py`` is one test
parametrised over the two planes: ``jax`` (``TpuDevicePlugin`` on a fake
v5p host of 4 chips, tests/fakes.py) and ``torch`` (``GpuDevicePlugin`` on
4 H100s of the fake NVML, tests/fake_nvml.c, whose NVLinks join the same
pairs as the v5p host's ICI links). Both planes must give the same gRPC
status codes and the same state effects, card i standing for chip i.
Container responses are compared field by field where the planes agree
(the pod-devices annotation, the allocated count, the CDI names); where
they differ by design each is held to its own spec (the TPU env and
/dev/accel* nodes; NVIDIA_VISIBLE_DEVICES and the /dev/nvidia* nodes).
"""

import os
import queue
import threading
import time

import grpc
import pytest

from k8s_device_plugin_tpu.api import constants as jax_constants
from k8s_device_plugin_tpu.api import deviceplugin_pb2 as jax_pb
from k8s_device_plugin_tpu.api import pluginregistration_pb2 as jax_regpb
from k8s_device_plugin_tpu.api.grpc_defs import DevicePluginStub, WatcherRegistrationStub
from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.server import plugin as jax_plugin
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import tracing as jax_tracing
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.server import plugin
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.utils import metrics, tracing
from tests import fakes
from tests import torch_fake_nvml as fk
from tests.fake_kubelet import FakeKubelet

# The v5p host's ICI links (chip i's neighbours), which the fake H100s'
# NVLinks copy: 0-1, 0-2, 1-3, 2-3; 0-3 and 1-2 are the diagonals.
EDGES = [(0, 1), (0, 2), (1, 3), (2, 3)]
WAIT_S = 10


class JaxPlane:
    name = "jax"
    constants = jax_constants
    metrics = jax_metrics
    tracing = jax_tracing

    def __init__(self, root, dp_dir):
        self.dp_dir = dp_dir
        accel, dev = fakes.make_fake_tpu_node(str(root), "v5p", 4)
        self.chips = PyTpuInfo().scan(accel, dev)

    def make(self, **cfg):
        return jax_plugin.TpuDevicePlugin(
            IciMesh(self.chips),
            config=jax_plugin.PluginConfig(device_plugin_dir=self.dp_dir, libtpu_host_path="",
                                           **cfg),
        )

    @staticmethod
    def ids(p):
        return p.mesh.ids

    @staticmethod
    def linked(p, a, b):
        return p.mesh.hops(a, b) == 1

    def check_container(self, p, ids, cresp):
        """The TPU spec: the chips' /dev/accel* nodes and the TPU env."""
        assert [d.host_path for d in cresp.devices] == [p.mesh.by_id[i].chip.dev_path
                                                        for i in ids]
        assert cresp.envs["TPU_VISIBLE_CHIPS"] == ",".join(
            str(p.mesh.by_id[i].chip.index) for i in ids)
        assert "NVIDIA_VISIBLE_DEVICES" not in cresp.envs

    def close(self):
        pass


class TorchPlane:
    name = "torch"
    constants = constants
    metrics = metrics
    tracing = tracing

    def __init__(self, root, dp_dir, fake):
        self.dp_dir = dp_dir
        self.fake = fake
        fake.reset()
        sysfs, self.dev = os.path.join(root, "sys"), os.path.join(root, "dev")
        self.uuids = fk.grid_node(fake, sysfs, 4, EDGES)
        self.info = NvmlInfo(fake.path)
        self.chips = self.info.scan(sysfs, self.dev)

    def make(self, **cfg):
        return plugin.GpuDevicePlugin(
            LinkTopology(self.chips, self.info),
            config=plugin.PluginConfig(
                device_plugin_dir=self.dp_dir,
                extra_device_paths=(os.path.join(self.dev, constants.NVIDIACTL),), **cfg),
        )

    @staticmethod
    def ids(p):
        return p.topology.ids

    @staticmethod
    def linked(p, a, b):
        return b in p.topology.neighbors(a)

    def check_container(self, p, ids, cresp):
        """The NVIDIA spec: each card's /dev/nvidia<minor>, then
        /dev/nvidiactl, and the UUIDs in NVIDIA_VISIBLE_DEVICES in order;
        no mount and no TPU runtime env."""
        assert [d.host_path for d in cresp.devices] == [
            os.path.join(self.dev, f"nvidia{self.uuids.index(i)}") for i in ids
        ] + [os.path.join(self.dev, "nvidiactl")]
        assert [d.container_path for d in cresp.devices] == [d.host_path for d in cresp.devices]
        assert cresp.envs["NVIDIA_VISIBLE_DEVICES"] == ",".join(ids)
        assert set(cresp.envs) == {"NVIDIA_VISIBLE_DEVICES", "TPU_PLUGIN_ALLOCATED_CHIPS"}
        assert len(cresp.mounts) == 0

    def close(self):
        self.info.close()
        self.fake.reset()


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture
def dp_dir(tmp_path):
    d = tmp_path / "dp"  # a unix socket path holds 107 bytes
    d.mkdir()
    return str(d)


@pytest.fixture(params=["jax", "torch"])
def plane(request, tmp_path, dp_dir):
    if request.param == "jax":
        p = JaxPlane(tmp_path, dp_dir)
    else:
        p = TorchPlane(str(tmp_path), dp_dir, request.getfixturevalue("fake"))
    yield p
    p.close()


@pytest.fixture
def kubelet(dp_dir):
    k = FakeKubelet(dp_dir)
    k.start()
    yield k
    k.stop()


@pytest.fixture
def served(plane, kubelet):
    p = plane.make()
    p.serve()
    yield p
    p.stop()


def recv_stream(stub, out: queue.Queue, stop: threading.Event):
    try:
        for resp in stub.ListAndWatch(pb.Empty()):
            out.put(resp)
            if stop.is_set():
                break
    except grpc.RpcError:
        pass


def allocate(stub, *containers):
    req = pb.AllocateRequest()
    for ids in containers:
        req.container_requests.add(devicesIDs=list(ids))
    return stub.Allocate(req, timeout=WAIT_S)


def abort_code(call):
    with pytest.raises(grpc.RpcError) as exc:
        call()
    return exc.value.code()


def wait_for(predicate, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        time.sleep(0.05)


def test_messages_are_one_class_in_both_planes():
    """Byte-identical pb2 copies register one descriptor: the fake
    kubelet's messages are the port's."""
    assert pb.Device is jax_pb.Device
    assert pb.AllocateRequest is jax_pb.AllocateRequest


def test_the_fake_nvlinks_join_the_v5p_host_links(plane, dp_dir):
    p = plane.make()
    ids = plane.ids(p)
    assert [(a, b) for a in range(4) for b in range(a + 1, 4)
            if plane.linked(p, ids[a], ids[b])] == EDGES


def test_register_with_kubelet(plane, served, kubelet):
    assert kubelet.registered.wait(WAIT_S)
    req = kubelet.registrations[-1]
    assert req.resource_name == plane.constants.RESOURCE_NAME
    assert req.version == "v1beta1"
    assert req.endpoint == plane.constants.PLUGIN_SOCKET_NAME
    assert req.options.get_preferred_allocation_available


def test_get_device_plugin_options(served, kubelet):
    opts = kubelet.plugin_stub().GetDevicePluginOptions(pb.Empty(), timeout=WAIT_S)
    assert opts.get_preferred_allocation_available
    assert not opts.pre_start_required


def test_list_and_watch_initial_list(plane, served, kubelet):
    resp = next(iter(kubelet.plugin_stub().ListAndWatch(pb.Empty(), timeout=WAIT_S)))
    assert [d.ID for d in resp.devices] == plane.ids(served)
    assert all(d.health == plane.constants.HEALTHY for d in resp.devices)
    # Both fakes pin every card to NUMA node 0, and the hint is sent.
    assert [[n.ID for n in d.topology.nodes] for d in resp.devices] == [[0]] * 4


def test_health_transition_readvertises_and_recovers(plane, served, kubelet):
    out: queue.Queue = queue.Queue()
    stop = threading.Event()
    t = threading.Thread(target=recv_stream, args=(kubelet.plugin_stub(), out, stop),
                         daemon=True)
    t.start()
    first = out.get(timeout=WAIT_S)
    assert all(d.health == plane.constants.HEALTHY for d in first.devices)
    bad = plane.ids(served)[0]
    served.notify_health(bad, healthy=False)
    second = {d.ID: d.health for d in out.get(timeout=WAIT_S).devices}
    assert second[bad] == plane.constants.UNHEALTHY
    assert sum(h == plane.constants.UNHEALTHY for h in second.values()) == 1
    assert served.state.unhealthy == {bad}
    served.notify_health(bad, healthy=True)
    third = out.get(timeout=WAIT_S)
    assert all(d.health == plane.constants.HEALTHY for d in third.devices)
    stop.set()


def test_get_preferred_allocation_is_linked(plane, served, kubelet):
    ids = plane.ids(served)
    req = pb.PreferredAllocationRequest()
    req.container_requests.add(available_deviceIDs=ids, allocation_size=2)
    req.container_requests.add(available_deviceIDs=ids, allocation_size=2,
                               must_include_deviceIDs=[ids[3]])
    req.container_requests.add(available_deviceIDs=ids[:2], allocation_size=3)
    resp = kubelet.plugin_stub().GetPreferredAllocation(req, timeout=WAIT_S)
    first, second, over = (list(c.deviceIDs) for c in resp.container_responses)
    assert len(first) == 2 and plane.linked(served, *first)
    assert ids[3] in second and len(second) == 2 and plane.linked(served, *second)
    assert over == []


def test_allocate_returns_devices_env_annotations(plane, served, kubelet):
    ids = plane.ids(served)[:2]
    cresp = allocate(kubelet.plugin_stub(), ids).container_responses[0]
    assert cresp.annotations[plane.constants.POD_DEVICES_ANNOTATION] == ",".join(ids)
    assert cresp.envs["TPU_PLUGIN_ALLOCATED_CHIPS"] == "2"
    assert all(d.permissions == "rwm" for d in cresp.devices)
    assert len(cresp.cdi_devices) == 0
    plane.check_container(served, ids, cresp)
    assert served.state.allocated == set(ids)


def test_cdi_devices_when_enabled(plane, kubelet):
    kind = plane.constants.RESOURCE_NAME
    p = plane.make(cdi_kind=kind)
    p.serve()
    try:
        ids = plane.ids(p)[:2]
        cresp = allocate(kubelet.plugin_stub(), ids).container_responses[0]
        assert [c.name for c in cresp.cdi_devices] == [f"{kind}={i}" for i in ids]
        plane.check_container(p, ids, cresp)  # the raw specs stay for other runtimes
    finally:
        p.stop()


def test_allocate_unknown_id_rejected(served, kubelet):
    assert abort_code(lambda: allocate(kubelet.plugin_stub(), ["bogus"])) == \
        grpc.StatusCode.INVALID_ARGUMENT
    assert served.state.allocated == set()


def test_allocate_multi_container_bad_one_leaks_nothing(plane, served, kubelet):
    ids = plane.ids(served)
    assert abort_code(lambda: allocate(kubelet.plugin_stub(), ids[:2], ["bogus"])) == \
        grpc.StatusCode.INVALID_ARGUMENT
    assert served.state.allocated == set()


def test_allocate_empty_container_request_ok(served, kubelet):
    cresp = allocate(kubelet.plugin_stub(), []).container_responses[0]
    assert len(cresp.devices) == 0 and len(cresp.envs) == 0 and len(cresp.annotations) == 0


def test_allocate_refuses_externally_held_cards(plane, served, kubelet):
    ids = plane.ids(served)
    served.external_holds = lambda: {ids[1]}
    assert abort_code(lambda: allocate(kubelet.plugin_stub(), ids[:2])) == \
        grpc.StatusCode.RESOURCE_EXHAUSTED
    assert served.state.allocated == set()


def test_substitution_mode_records_shadow_map(plane, kubelet):
    p = plane.make(substitute_on_allocate=True)
    p.serve()
    try:
        ids = plane.ids(p)
        diagonal = [ids[0], ids[3]]
        assert not plane.linked(p, *diagonal)
        cresp = allocate(kubelet.plugin_stub(), diagonal).container_responses[0]
        real = cresp.annotations[plane.constants.POD_DEVICES_ANNOTATION].split(",")
        assert len(real) == 2 and plane.linked(p, *real)
        assert len(cresp.devices) == len(p.device_paths(
            [p.mesh.by_id[i] for i in real] if plane.name == "jax"
            else [p.topology.by_id[i] for i in real]))
        assert p.shadow_map
        for k, v in p.shadow_map.items():
            assert k in diagonal and v in real
        assert p.substitutions == p.shadow_map
        assert p.state.allocated == set(real)
    finally:
        p.stop()


def test_substitution_mode_still_rejects_bogus_ids(plane, kubelet):
    p = plane.make(substitute_on_allocate=True)
    p.serve()
    try:
        assert abort_code(lambda: allocate(kubelet.plugin_stub(), ["bogus"])) == \
            grpc.StatusCode.INVALID_ARGUMENT
        assert "bogus" not in p.shadow_map
        assert p.state.allocated == set()
    finally:
        p.stop()


def test_substitution_multi_container_gets_disjoint_cards(plane, kubelet):
    p = plane.make(substitute_on_allocate=True)
    p.serve()
    try:
        ids = plane.ids(p)
        resp = allocate(kubelet.plugin_stub(), ids[:2], ids[2:4])
        sets = [set(c.annotations[plane.constants.POD_DEVICES_ANNOTATION].split(","))
                for c in resp.container_responses]
        assert sets[0].isdisjoint(sets[1]) and len(sets[0]) == len(sets[1]) == 2
        hosts = [{d.host_path for d in c.devices} for c in resp.container_responses]
        assert hosts[0] & hosts[1] == set(p.config.extra_device_paths)
        assert p.state.allocated == set(ids)
    finally:
        p.stop()


def test_substitution_fallback_never_overlaps(plane, kubelet):
    p = plane.make(substitute_on_allocate=True)
    p.serve()
    try:
        ids = plane.ids(p)
        p.notify_health(ids[3], healthy=False)  # only 3 cards available
        assert abort_code(lambda: allocate(kubelet.plugin_stub(), ids[2:4], ids[0:2])) == \
            grpc.StatusCode.RESOURCE_EXHAUSTED
        assert p.state.allocated == set()
    finally:
        p.stop()


def test_restart_reuses_socket(plane, kubelet):
    p = plane.make()
    p.serve()
    p.stop()
    assert not os.path.exists(p.config.socket_path)
    p2 = plane.make()
    p2.serve()  # must not fail on leftover socket state
    try:
        resp = next(iter(kubelet.plugin_stub().ListAndWatch(pb.Empty(), timeout=WAIT_S)))
        assert len(resp.devices) == 4
    finally:
        p2.stop()


def test_allocate_is_traced_when_tracing_is_on(plane, served, kubelet):
    """With tracing on, Allocate records a plugin.Allocate span and keeps
    its ids for a controller to adopt; off, it records nothing."""
    ids = plane.ids(served)[:2]
    plane.tracing.COLLECTOR.clear()
    plane.tracing.enable("plugin")
    try:
        allocate(kubelet.plugin_stub(), ids)
    finally:
        plane.tracing.disable()
    spans = [s for s in plane.tracing.COLLECTOR.spans() if s["name"] == "plugin.Allocate"]
    assert len(spans) == 1 and spans[0]["attrs"] == {"containers": "1", "chips": "2"}
    last = served.recent_allocations[-1]
    assert last["ids"] == frozenset(ids) and last["span_id"] == spans[0]["span_id"]
    served.free_devices(ids)
    allocate(kubelet.plugin_stub(), ids)
    assert len(served.recent_allocations) == 1


# -- plugin-watcher registration (pluginregistration/v1) ---------------------

def test_watcher_registration_flow(plane, tmp_path, dp_dir):
    registry = tmp_path / "reg"  # a unix socket path holds 107 bytes
    p = plane.make(registration_mode="watcher", plugins_registry_dir=str(registry))
    p.serve()  # no kubelet: watcher mode must not dial Register
    try:
        socks = os.listdir(registry)
        assert socks == [p.config.watcher_socket_name]
        with grpc.insecure_channel(f"unix:{registry / socks[0]}") as ch:
            stub = WatcherRegistrationStub(ch)
            info = stub.GetInfo(jax_regpb.InfoRequest(), timeout=WAIT_S)
            assert info.type == "DevicePlugin"
            assert info.name == plane.constants.RESOURCE_NAME
            assert list(info.supported_versions) == ["v1beta1"]
            with grpc.insecure_channel(f"unix:{info.endpoint}") as pch:
                opts = DevicePluginStub(pch).GetDevicePluginOptions(pb.Empty(), timeout=WAIT_S)
                assert opts.get_preferred_allocation_available
            stub.NotifyRegistrationStatus(
                jax_regpb.RegistrationStatus(plugin_registered=True), timeout=WAIT_S)
    finally:
        p.stop()
    assert not os.path.exists(registry / p.config.watcher_socket_name)


def test_watcher_mode_both_also_dials_kubelet(plane, tmp_path, kubelet):
    registry = tmp_path / "reg"  # a unix socket path holds 107 bytes
    p = plane.make(registration_mode="both", plugins_registry_dir=str(registry))
    p.serve()
    try:
        assert kubelet.registered.wait(WAIT_S)
        assert os.listdir(registry) == [p.config.watcher_socket_name]
    finally:
        p.stop()


def test_unknown_registration_mode_rejected(plane):
    p = plane.make(registration_mode="bogus")
    with pytest.raises(ValueError):
        p.serve()
    assert not os.path.exists(p.config.socket_path)
    p.stop()


# -- kubelet-restart re-registration -----------------------------------------

@pytest.mark.parametrize("wipe, trigger", [(True, "plugin_socket_vanished"),
                                           (False, "kubelet_restart")],
                         ids=["kubelet_restart", "inode_change_alone"])
def test_kubelet_restart_triggers_reregistration(plane, kubelet, dp_dir, wipe, trigger):
    """A kubelet restart (the device-plugins dir wiped, a fresh
    kubelet.sock) and a kubelet.sock that changes identity alone each make
    the watch loop re-serve and re-register, keeping the placement state."""
    p = plane.make()
    p.serve()
    try:
        assert kubelet.registered.wait(WAIT_S)
        first = kubelet.registrations[-1]
        ids = plane.ids(p)
        p.mark_allocated(ids[:1])
        base = plane.metrics.PLUGIN_REREGISTRATIONS.get(trigger=trigger)
        p.start_restart_watch(interval_s=0.1)
        p.start_restart_watch(interval_s=0.1)  # idempotent, no second thread
        kubelet.restart(wipe_plugin_sockets=wipe)
        assert kubelet.registered.wait(WAIT_S), "no re-registration after the kubelet restart"
        again = kubelet.registrations[-1]
        assert (again.resource_name, again.endpoint) == (first.resource_name, first.endpoint)
        wait_for(lambda: plane.metrics.PLUGIN_REREGISTRATIONS.get(trigger=trigger) > base)
        assert os.path.exists(os.path.join(dp_dir, plane.constants.PLUGIN_SOCKET_NAME))
        assert p.state.allocated == set(ids[:1])
        resp = next(iter(kubelet.plugin_stub().ListAndWatch(pb.Empty(), timeout=WAIT_S)))
        assert len(resp.devices) == 4
    finally:
        p.stop()
