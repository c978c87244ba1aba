"""The port's card telemetry (telemetry.py), capacity gauges
(topology/placement.capacity_stats) and the controller's attribution map,
against the JAX package's.

The JAX ``tests/test_telemetry.py`` scenarios over the fake NVML
(tests/fake_nvml.c), each run through both samplers where both take the
same input: the JAX ``TelemetrySampler`` is handed the port's NVML backend
and a mesh-shaped view of the same cards, so both read the same readings
and attribution, and their series are held label for label. Link errors,
which NVML's backend does not count, come from a scripted backend. The
capacity twin is held to a brute-force search over every n-set.
"""

import itertools
import threading
import time
import types

import pytest
import requests

from k8s_device_plugin_tpu import telemetry as jax_telemetry
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils.flightrecorder import RECORDER as JAX_RECORDER
from k8s_device_plugin_tpu_torch import telemetry
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
from k8s_device_plugin_tpu_torch.discovery.chips import ChipTelemetry, IciLinkTelemetry
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin, PluginConfig
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.topology.placement import GpuPlacementState, capacity_stats
from k8s_device_plugin_tpu_torch.utils import metrics
from k8s_device_plugin_tpu_torch.utils.flightrecorder import RECORDER
from tests import torch_fake_nvml as fk
from tests import torch_kube_planes as planes
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakeKubelet, FakePodResources

NODE = planes.NODE
GIB = fk.GIB


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture(autouse=True)
def _clean_series():
    """The families live in process-global registries: every test ends with
    no per-card or per-size series in either, and no state marked for the
    capacity gauges."""
    telemetry._CHANGED = None
    yield
    for fam in (*telemetry.CHIP_FAMILIES, metrics.NODE_BOX_PLACEABLE,
                metrics.NODE_BEST_SET_SCORE, metrics.TELEMETRY_TICKS,
                *jax_telemetry.CHIP_FAMILIES, jax_metrics.TELEMETRY_TICKS):
        fam.remove_matching()
    telemetry.install_sampler(None)
    telemetry.NODE_STATS = None
    telemetry._CHANGED = None


class Node:
    """Four H100s of the fake NVML under ``root``, read by the port's NVML
    backend."""

    def __init__(self, fake, root, n=4):
        fake.reset()
        self.fake = fake
        self.sysfs, self.dev = str(root / "sys"), str(root / "dev")
        self.uuids = fk.hgx_node(fake, self.sysfs, n)  # by NVML index
        self.info = NvmlInfo(fake.path)
        self.chips = self.info.scan(self.sysfs, self.dev)


def jax_mesh(chips):
    """The JAX sampler's view of the port's cards: ``mesh_chips`` with an
    ``id`` and a ``chip`` holding ``index`` and ``hbm_bytes``."""
    return types.SimpleNamespace(
        mesh_chips=[types.SimpleNamespace(id=c.device_id_str, chip=c) for c in chips])


def make_sampler(plane, backend, root, chips, **kw):
    if plane == "jax":
        return jax_telemetry.TelemetrySampler(backend, root, jax_mesh(chips), **kw)
    return telemetry.TelemetrySampler(backend, root, chips, **kw)


def families(plane):
    return jax_telemetry.CHIP_FAMILIES if plane == "jax" else telemetry.CHIP_FAMILIES


def series(plane):
    """family name → sorted (labels, value) of every per-card series."""
    return {fam.name: sorted((sorted(labels.items()), value) for labels, value in fam.series())
            for fam in families(plane)}


def fams(plane):
    return jax_metrics if plane == "jax" else metrics


class Scripted:
    """A backend whose readings a test writes: card index → ChipTelemetry,
    or an exception to raise."""

    def __init__(self):
        self.readings = {}

    def chip_telemetry(self, root, index):
        r = self.readings[index]
        if isinstance(r, Exception):
            raise r
        return r


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_metric_remove_and_remove_matching(plane):
    m = fams(plane).Metric("t", "t", "gauge")
    m.set(1, chip="a", pod="p1")
    m.set(2, chip="a", link="0", pod="p1")
    m.set(3, chip="b")
    assert m.remove(chip="b") is True
    assert m.remove(chip="b") is False  # already gone
    assert m.remove_matching(chip="a") == 2
    assert m.series() == []
    m.set(4, chip="c")
    assert m.remove_matching() == 1  # the empty subset matches everything


def test_series_match_the_jax_sampler_label_for_label(fake, tmp_path):
    """The same fake-NVML readings and attribution through both samplers:
    the same series, label for label and value for value, through an
    attribution change, an unsupported counter and a card falling off."""
    node = Node(fake, tmp_path)
    a, b = node.uuids[0], node.uuids[1]
    attribution = {"now": {a: {"pod": "w0", "namespace": "ml", "container": "train",
                               "gang": "g1"},
                           b: {"pod": "w1", "namespace": "ml", "container": "",
                               "gang": ""}}}
    samplers = {p: make_sampler(p, node.info, node.sysfs, node.chips,
                                attribution=lambda: attribution["now"])
                for p in ("jax", "torch")}

    def poll_and_compare():
        for s in samplers.values():
            s.poll_once()
        jax, port = series("jax"), series("torch")
        assert port == jax
        return port

    got = poll_and_compare()
    duty = dict((tuple(l), v) for l, v in got["tpu_chip_duty_cycle"])
    assert duty[(("chip", a), ("container", "train"), ("gang", "g1"), ("namespace", "ml"),
                 ("pod", "w0"))] == 30.0  # hgx_node: NVML's card 0 is slot 3, at 30%
    # Empty attribution values are omitted, never pod="".
    assert duty[(("chip", b), ("namespace", "ml"), ("pod", "w1"))] == 20.0
    assert len(got["tpu_chip_ici_link_up"]) == 4 * 18
    fake.set_telemetry(0, util_gpu=97, mem_used=40 * GIB, temp_c=None, power_mw=612345)
    attribution["now"] = {b: attribution["now"][b]}
    got = poll_and_compare()
    assert not [l for l, _ in got["tpu_chip_temperature_celsius"] if ("chip", a) in l]
    assert [v for l, v in got["tpu_chip_power_watts"] if l == [("chip", a)]] == [612.345]
    fake.set_lost(1)
    got = poll_and_compare()
    assert not [l for fam in got.values() for l, _ in fam if ("chip", b) in l]
    assert [s.snapshot()["ticks"] for s in samplers.values()] == [3, 3]


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_sampler_attribution_pruning_and_link_deltas(plane, fake, tmp_path):
    node = Node(fake, tmp_path, n=2)
    chip = node.chips[0]
    cid = chip.device_id_str
    backend = Scripted()

    def reading(links=((0, True, 100),), temp=60.0, duty=50.0):
        return ChipTelemetry(index=chip.index, duty_cycle_pct=duty, temp_c=temp,
                             links=tuple(IciLinkTelemetry(k, up, e) for k, up, e in links))

    backend.readings = {chip.index: reading()}
    holder = {cid: {"pod": "w0", "namespace": "ml", "container": "train", "gang": "g1"}}
    state = {"attr": holder}
    sampler = make_sampler(plane, backend, node.sysfs, [chip], attribution=lambda: state["attr"])
    m = fams(plane)
    sampler.poll_once()
    labels = {"chip": cid, "pod": "w0", "namespace": "ml", "container": "train", "gang": "g1"}
    assert m.CHIP_DUTY_CYCLE.get(**labels) == 50
    assert m.CHIP_TEMP.get(**labels) == 60.0
    # The first link sample is the baseline: no history imported.
    assert m.CHIP_LINK_ERRORS.get(**labels, link="0") == 0
    backend.readings[chip.index] = reading(links=((0, True, 107),))
    sampler.poll_once()
    assert m.CHIP_LINK_ERRORS.get(**labels, link="0") == 7
    # The card's counter reset: the delta restarts from the new value.
    backend.readings[chip.index] = reading(links=((0, True, 3),))
    sampler.poll_once()
    assert m.CHIP_LINK_ERRORS.get(**labels, link="0") == 10
    # The holder vanishes: the old-labeled series go on the next tick.
    state["attr"] = {}
    sampler.poll_once()
    assert not [s for fam in families(plane) for s in fam.series() if s[0].get("pod") == "w0"]
    assert m.CHIP_DUTY_CYCLE.get(chip=cid) == 50
    # A counter the card stops giving drops its series.
    backend.readings[chip.index] = reading(links=((0, True, 3),), temp=None)
    sampler.poll_once()
    assert not [s for s in m.CHIP_TEMP.series() if s[0].get("chip") == cid]
    # So does a link it stops reporting.
    backend.readings[chip.index] = reading(links=(), temp=None)
    sampler.poll_once()
    assert not [s for fam in (m.CHIP_LINK_UP, m.CHIP_LINK_ERRORS)
                for s in fam.series() if s[0].get("chip") == cid]
    snap = sampler.snapshot()
    assert snap["ticks"] == 6
    # A card whose read starts failing prunes everything it exported.
    backend.readings[chip.index] = OSError(15, "GPU is lost")
    sampler.poll_once()
    assert not [s for fam in families(plane) for s in fam.series() if s[0].get("chip") == cid]
    assert m.TELEMETRY_TICKS.get(outcome="error") >= 1
    assert any(c["chip"] == cid for c in snap["chips"])


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_sampler_threshold_flight_events(plane, fake, tmp_path):
    node = Node(fake, tmp_path, n=1)
    recorder = JAX_RECORDER if plane == "jax" else RECORDER
    recorder.enable(service="plugin")
    recorder.clear()
    try:
        fake.set_telemetry(0, temp_c=95, mem_used=int(fk.H100_BYTES * 0.99))
        sampler = make_sampler(plane, node.info, node.sysfs, node.chips)
        sampler.poll_once()
        sampler.poll_once()  # deduped while the condition persists
        events = recorder.export()["events"]
        thermal = [e for e in events if e["kind"] == "chip_thermal"]
        hbm = [e for e in events if e["kind"] == "chip_hbm_pressure"]
        assert len(thermal) == 1 and len(hbm) == 1
        assert thermal[0]["attrs"]["state"] == "over"
        # Crossing back records the clear, once.
        fake.set_telemetry(0, temp_c=60, mem_used=int(fk.H100_BYTES * 0.99))
        sampler.poll_once()
        thermal = [e for e in recorder.export()["events"] if e["kind"] == "chip_thermal"]
        assert [e["attrs"]["state"] for e in thermal] == ["over", "cleared"]
    finally:
        recorder.clear()
        recorder.disable()


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_sampler_thread_start_stop(plane, fake, tmp_path):
    node = Node(fake, tmp_path, n=1)
    ticks = fams(plane).TELEMETRY_TICKS
    sampler = make_sampler(plane, node.info, node.sysfs, node.chips, interval_s=0.05)
    before = ticks.get(outcome="ok")
    sampler.start()
    try:
        wait_for(lambda: ticks.get(outcome="ok") >= before + 2)
    finally:
        sampler.stop()
    assert ticks.get(outcome="ok") >= before + 2
    assert not [t for t in threading.enumerate()
                if t.name == "tpu-telemetry-sampler" and t.is_alive()]


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        time.sleep(0.02)


# -- capacity -----------------------------------------------------------------

def brute_force(topo, free, n):
    """The best average pair score over every n-set of ``free``."""
    return max((topo.set_score(c) for c in itertools.combinations(free, n)), default=None)


@pytest.mark.parametrize("edges", [planes.EDGES, [(0, 1), (2, 3)], []],
                         ids=["ring", "pairs", "pcie"])
def test_capacity_stats_equal_a_brute_force_search(fake, tmp_path, edges):
    fake.reset()
    fk.grid_node(fake, tmp_path / "sys", 4, edges)
    with NvmlInfo(fake.path) as info:
        topo = LinkTopology(info.scan(str(tmp_path / "sys"), str(tmp_path / "dev")), info)
    state = GpuPlacementState(topo)
    ids = topo.ids
    for free in (ids, ids[1:], ids[::3], ids[:1], []):
        stats = capacity_stats(state, free)
        assert stats["free"] == len(free)
        assert stats["placeable"] == {n: n <= len(free) for n in range(1, 5)}
        assert stats["best_score"] == {n: brute_force(topo, free, n)
                                       for n in range(2, len(free) + 1)}
        # The gauge's score is the score of the set select itself picks.
        for n, score in stats["best_score"].items():
            assert topo.set_score(state.select(n, available=free)) == score


def test_plugin_updates_capacity_gauges_on_allocation(fake, tmp_path):
    fake.reset()
    fk.grid_node(fake, tmp_path / "sys", 4, planes.EDGES)
    with NvmlInfo(fake.path) as info:
        topo = LinkTopology(info.scan(str(tmp_path / "sys"), str(tmp_path / "dev")), info)
    plugin = GpuDevicePlugin(topo, config=PluginConfig(device_plugin_dir=str(tmp_path)))
    ids = topo.ids
    # The gauges are computed when read (a scrape refreshes them).
    telemetry.refresh_node_gauges()
    assert metrics.NODE_FREE_CHIPS.get() == 4
    assert metrics.NODE_BOX_PLACEABLE.get(size="4") == 1
    full = metrics.NODE_BEST_SET_SCORE.get(size="2")
    assert full == brute_force(topo, ids, 2)
    # Empty event-ish states carry no series.
    assert not [s for s in metrics.CHIPS.series() if s[0].get("state") == "allocated"]
    # Hold cards 0 and 3: cards 1 and 2 are left, joined by no NVLink, so
    # the best pair score drops and sizes 3 and 4 no longer place.
    plugin.state.allocate([ids[0], ids[3]])
    plugin._availability_changed()
    assert metrics.CHIPS.get(state="allocated") == 2
    # The hook only marks the state: no placement search runs in the RPC.
    assert telemetry._CHANGED is plugin.state and metrics.NODE_FREE_CHIPS.get() == 4
    assert telemetry.refresh_node_gauges()["free"] == 2
    assert telemetry._CHANGED is None
    assert metrics.NODE_FREE_CHIPS.get() == 2
    assert metrics.NODE_BOX_PLACEABLE.get(size="3") == 0
    assert metrics.NODE_BEST_SET_SCORE.get(size="2") == brute_force(topo, [ids[1], ids[2]], 2)
    assert metrics.NODE_BEST_SET_SCORE.get(size="2") < full
    assert not [s for s in metrics.NODE_BEST_SET_SCORE.series() if s[0]["size"] in ("3", "4")]
    plugin.free_devices(plugin.state.allocated)
    telemetry.refresh_node_gauges()
    assert metrics.NODE_FREE_CHIPS.get() == 4
    assert metrics.NODE_BEST_SET_SCORE.get(size="4") == brute_force(topo, ids, 4)
    assert not [s for s in metrics.CHIPS.series() if s[0].get("state") == "allocated"]


def test_debug_telemetry_endpoint(fake, tmp_path):
    node = Node(fake, tmp_path)
    fake.set_telemetry(0, util_gpu=41)
    first = node.uuids[0]
    sampler = telemetry.TelemetrySampler(
        node.info, node.sysfs, node.chips,
        attribution=lambda: {first: {"pod": "p", "namespace": "n", "gang": "g"}})
    telemetry.install_sampler(sampler)
    sampler.poll_once()
    state = GpuPlacementState(LinkTopology(node.chips, node.info))
    state.allocate([first])
    telemetry.capacity_changed(state)
    srv = metrics.MetricsServer(host="127.0.0.1")
    url = srv.start()
    try:
        payload = requests.get(f"{url}/debug/telemetry", timeout=5).json()
        assert payload["enabled"] is True
        assert payload["ticks"] == 1
        chip0 = [c for c in payload["chips"] if c["chip"] == first]
        assert chip0 and chip0[0]["pod"] == "p" and chip0[0]["gang"] == "g"
        assert chip0[0]["duty_cycle_pct"] == 41.0
        assert payload["node"]["free"] == 3
        assert set(payload["node"]["best_score"]) == {"2", "3"}
    finally:
        srv.stop()


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_rebuild_partial_attribution_refreshed_at_resync(plane, fake, tmp_path):
    """A restart's rebuild records the attribution without the container
    (and, API-server-less, without the gang); the pod's next resync through
    the already-reconciled branch refreshes both."""
    p = planes.make_plane(plane, tmp_path, lambda: fake)
    podres = FakePodResources(str(tmp_path / "podres" / "kubelet.sock"))
    podres.start()
    try:
        plugin = p.make_plugin()
        controller = p.Controller(None, plugin, node_name=NODE,
                                  checkpoint_path=str(tmp_path / "no-checkpoint"),
                                  podresources_socket=podres.socket_path)
        want = p.ids(plugin)[:2]
        controller._record_attribution({"namespace": "ml", "name": "w0"}, want, partial=True)
        assert controller.chip_attribution()[want[0]]["container"] == ""
        assert "_partial" not in controller.chip_attribution()[want[0]]
        podres.set_pod("ml", "w0", p.resource, want)
        pod = {
            "metadata": {"name": "w0", "namespace": "ml", "uid": "u-w0",
                         "labels": {p.constants.GANG_NAME_LABEL: "g"},
                         "annotations": {p.constants.POD_DEVICES_ANNOTATION: ",".join(want)}},
            "spec": {"containers": [{"name": "main",
                                     "resources": {"requests": {p.resource: "2"}}}]},
        }
        controller._handle_update_impl(pod)
        attr = controller.chip_attribution()[want[0]]
        assert attr["container"] == "main" and attr["gang"] == "g"
        # Fresh now: the next resync does not pay the lookup again.
        assert not controller._attribution_stale(pod["metadata"], want)
    finally:
        podres.stop()
        p.close()


def test_supervisor_flag_and_sampler_lifecycle(fake, tmp_path):
    assert main.parse_args(["--telemetry-interval-s", "7"]).telemetry_interval_s == 7.0
    assert main.parse_args([]).telemetry_interval_s == 0.0  # off by default
    node = Node(fake, tmp_path)
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(tmp_path), sysfs_pci_dir=node.sysfs, dev_dir=node.dev,
        nvml_library=fake.path, enable_controller=False, telemetry_interval_s=0.2))
    chips = daemon.discover()
    daemon.plugin = GpuDevicePlugin(LinkTopology(chips, daemon.backend),
                                    config=PluginConfig(device_plugin_dir=str(tmp_path)))
    try:
        daemon._start_telemetry()
        assert daemon.telemetry_sampler is not None
        assert telemetry.SAMPLER is daemon.telemetry_sampler
        wait_for(lambda: daemon.telemetry_sampler.snapshot()["ticks"] >= 1)
    finally:
        daemon.teardown()
    assert daemon.telemetry_sampler is None
    assert telemetry.SAMPLER is None
    # Interval 0 is no sampler at all.
    daemon.cfg.telemetry_interval_s = 0.0
    daemon.plugin = GpuDevicePlugin(LinkTopology(chips, daemon.backend),
                                    config=PluginConfig(device_plugin_dir=str(tmp_path)))
    daemon._start_telemetry()
    assert daemon.telemetry_sampler is None
    daemon.backend.close()


def test_e2e_allocate_attribute_scrape_free_prune(fake, tmp_path):
    """Allocate → a sampler tick → the scrape shows tpu_chip_* series with
    the pod's labels (and the capacity gauges moved) → the pod is deleted
    and reconciled → the next scrape carries no stale labels."""
    from k8s_device_plugin_tpu_torch.controller.controller import Controller
    from k8s_device_plugin_tpu_torch.kube.client import KubeClient

    api = FakeApiServer()
    api_url = api.start()
    api.add_node(NODE)
    client = KubeClient(api_url)
    kubelet_dir = tmp_path / "dp"
    kubelet_dir.mkdir()
    kubelet = FakeKubelet(str(kubelet_dir))
    kubelet.start()
    podres = FakePodResources(str(tmp_path / "podres" / "kubelet.sock"))
    podres.start()
    plugin = srv = None
    try:
        node = Node(fake, tmp_path)
        fake.set_telemetry(0, util_gpu=97, mem_used=4 * GIB, temp_c=68)
        fake.set_telemetry(1, util_gpu=96, mem_used=2 * GIB)
        topo = LinkTopology(node.chips, node.info)
        plugin = GpuDevicePlugin(topo, config=PluginConfig(device_plugin_dir=str(kubelet_dir)))
        plugin.serve()
        assert kubelet.registered.wait(10)
        controller = Controller(client, plugin, node_name=NODE,
                                checkpoint_path=str(tmp_path / "no-checkpoint"),
                                podresources_socket=podres.socket_path)
        sampler = telemetry.TelemetrySampler(node.info, node.sysfs, node.chips,
                                             attribution=controller.chip_attribution)
        telemetry.install_sampler(sampler)
        srv = metrics.MetricsServer(host="127.0.0.1")
        url = srv.start()

        # 1) The kubelet allocates two cards to a gang-labeled pod.
        want = node.uuids[:2]
        req = pb.AllocateRequest()
        req.container_requests.add(devicesIDs=want)
        kubelet.plugin_stub().Allocate(req)
        pod = {
            "metadata": {"name": "train-w0", "namespace": "ml", "uid": "uid-train-0",
                         "labels": {constants.GANG_NAME_LABEL: "train"}},
            "spec": {"nodeName": NODE, "containers": [{
                "name": "main", "resources": {"requests": {constants.RESOURCE_NAME: "2"}}}]},
        }
        api.add_pod(pod)
        podres.set_pod("ml", "train-w0", constants.RESOURCE_NAME, want)
        controller._handle_update(client.get_pod("ml", "train-w0"))

        # 2) A tick, then the scrape: the series carry the pod and gang,
        # and the capacity gauges moved.
        sampler.poll_once()
        scrape = requests.get(f"{url}/metrics", timeout=5).text
        assert ('tpu_chip_duty_cycle{chip="%s",container="main",gang="train",'
                'namespace="ml",pod="train-w0"} 97' % want[0]) in scrape
        assert ('tpu_chip_hbm_used_bytes{chip="%s",container="main",gang="train",'
                'namespace="ml",pod="train-w0"} %d' % (want[0], 4 * GIB)) in scrape
        assert "tpu_node_free_chips 2" in scrape
        assert 'tpu_node_box_placeable{size="3"} 0' in scrape
        dbg = requests.get(f"{url}/debug/telemetry", timeout=5).json()
        attributed = [c for c in dbg["chips"] if c.get("pod")]
        assert {c["chip"] for c in attributed} == set(want)
        assert all(c["gang"] == "train" for c in attributed)

        # 3) The pod is deleted and reconciled: the next tick prunes every
        # attributed series.
        podres.set_pod("ml", "train-w0", constants.RESOURCE_NAME, [])
        controller._handle_delete(pod)
        sampler.poll_once()
        scrape = requests.get(f"{url}/metrics", timeout=5).text
        assert 'pod="train-w0"' not in scrape and 'gang="train"' not in scrape
        assert 'tpu_chip_duty_cycle{chip="%s"} 97' % want[0] in scrape
        assert "tpu_node_free_chips 4" in scrape
    finally:
        if srv is not None:
            srv.stop()
        if plugin is not None:
            plugin.stop()
        podres.stop()
        kubelet.stop()
        planes.stop_in_background(api)


@pytest.mark.parametrize("plane_name", ["jax", "torch"])
def test_index_maintains_placeable_aggregate(plane_name, fake, tmp_path):
    """The JAX case over both indexes: two whole 8-card nodes, one then
    fragmented to two scattered free cards, the other removed. The JAX host
    is a v5e of 8 chips (boxes 1, 2, 4, 8); the port's is an HGX of 8 cards,
    where any n <= free cards places. The aggregate, the gauge and the
    /debug/telemetry cluster panel move together; an index built with
    ``track_placeable=False`` (the scale bench's control arm) keeps none of
    it."""
    from k8s_device_plugin_tpu.extender.index import TopologyIndex as JaxIndex
    from k8s_device_plugin_tpu_torch.extender.index import TopologyIndex
    from k8s_device_plugin_tpu_torch.topology.schema import NodeTopology
    from tests.test_telemetry import _topo_json

    if plane_name == "jax":
        m, tel, index = jax_metrics, jax_telemetry, None
        raw_b, mesh = _topo_json(tmp_path, "node-b", count=8)
        scattered = [mesh.by_coords[(0, 0, 0)].id, mesh.by_coords[(1, 3, 0)].id]
        raw_frag, _ = _topo_json(tmp_path, "node-a2", count=8, available=scattered)
        whole, frag = (1, 2, 4, 8), (1,)
    else:
        m, tel = metrics, telemetry
        fake.reset()
        ids = fk.hgx_node(fake, str(tmp_path / "sys"), 8, numa=(0,) * 4 + (1,) * 4)
        info = NvmlInfo(fake.path)
        try:
            topology = LinkTopology(info.scan(str(tmp_path / "sys"), str(tmp_path / "dev")), info)
        finally:
            info.close()
        raw_b = NodeTopology.from_topology(topology, hostname="node-b").to_json()
        raw_frag = NodeTopology.from_topology(topology, hostname="node-a",
                                              available=[ids[0], ids[5]]).to_json()
        whole, frag = tuple(range(1, 9)), (1, 2)
    m.EXT_PLACEABLE_NODES.remove_matching()
    try:
        index = (JaxIndex if plane_name == "jax" else TopologyIndex)()
        index.update("node-a", raw_b)
        index.update("node-b", raw_b)
        assert index.get("node-a").placeable == whole
        assert m.EXT_PLACEABLE_NODES.get(size="8") == 2
        assert index.placeable_snapshot()["placeable_nodes"]["8"] == 2
        index.update("node-a", raw_frag)
        assert index.get("node-a").placeable == frag
        assert m.EXT_PLACEABLE_NODES.get(size="8") == 1
        assert m.EXT_PLACEABLE_NODES.get(size="1") == 2
        # node-b leaves: the emptied size drops its series entirely.
        index.remove("node-b")
        assert not [s for s in m.EXT_PLACEABLE_NODES.series() if s[0].get("size") == "8"]
        assert m.EXT_PLACEABLE_NODES.get(size="1") == 1
        assert tel.debug_snapshot()["cluster"]["placeable_nodes"] == {str(n): 1 for n in frag}
        # The scale bench's control arm: tracking off maintains nothing, not
        # even from the derived record the tracking index left in the memo.
        off = (JaxIndex if plane_name == "jax" else TopologyIndex)(track_placeable=False)
        off.update("node-c", raw_b)
        assert off.get("node-c").placeable == ()
        assert off.placeable_snapshot()["placeable_nodes"] == {}
        assert m.EXT_PLACEABLE_NODES.get(size="1") == 1
    finally:
        m.EXT_PLACEABLE_NODES.remove_matching()
