"""The port's kube client, checkpoint reader, pod controller and node
publishing (kube/, controller/, topology/schema.py, utils/podresources.py)
against the JAX package's.

Every scenario of the JAX ``tests/test_controller.py`` is one test
parametrised over the two planes of tests/torch_kube_planes.py: ``jax``
(``TpuDevicePlugin`` on a fake v5p host) and ``torch`` (``GpuDevicePlugin``
on four fake-NVML H100s), both against tests/fake_apiserver.FakeApiServer
and tests/fake_kubelet.FakePodResources. Both planes must give the same
annotations, frees, evictions, conditions and rebuilt state, card i
standing for chip i; each node annotation is held to its own schema.
"""

import json
import logging
import os
import threading
import time

import pytest

from k8s_device_plugin_tpu_torch.topology import schema
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakePodResources
from tests.torch_kube_planes import EDGES, NODE, make_plane, pod_dict, stop_in_background


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture(params=["jax", "torch"])
def plane(request, tmp_path):
    p = make_plane(request.param, tmp_path,
                   lambda: request.getfixturevalue("fake"))
    yield p
    p.close()


@pytest.fixture
def api(plane):
    s = FakeApiServer()
    url = s.start()
    s.add_node(NODE)
    yield s, plane.KubeClient(url)
    stop_in_background(s)


@pytest.fixture
def plugin(plane):
    return plane.make_plugin()


@pytest.fixture
def podres(tmp_path):
    s = FakePodResources(str(tmp_path / "pod-resources" / "kubelet.sock"))
    s.start()
    yield s
    s.stop()


def wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def checkpoint_doc(entries):
    return json.dumps({"Data": {"PodDeviceEntries": entries,
                                "RegisteredDevices": {}},
                       "Checksum": 12345})


def test_request_scheduler_semantics(plane):
    assert plane.request(pod_dict(plane, "p", "u", cards=2)) == 2
    # init containers max, not sum (reference utils.go:14-26 semantics).
    assert plane.request(pod_dict(plane, "p", "u", cards=2, init_cards=4)) == 4
    assert plane.request(pod_dict(plane, "p", "u", cards=4, init_cards=2)) == 4
    assert not plane.is_pod(pod_dict(plane, "p", "u", cards=0))
    assert plane.request({}) == 0


# ---------------------------------------------------------------------------
# checkpoint parsing
# ---------------------------------------------------------------------------

def test_checkpoint_flat_format(plane):
    doc = checkpoint_doc([
        {"PodUID": "u1", "ContainerName": "c", "ResourceName": plane.resource,
         "DeviceIDs": ["a", "b"]},
        {"PodUID": "u2", "ContainerName": "c", "ResourceName": "other/res",
         "DeviceIDs": ["x"]},
    ])
    entries = plane.ckpt.parse_checkpoint(doc)
    assert len(entries) == 2
    by_pod = plane.ckpt.device_ids_by_pod(entries, plane.resource)
    assert by_pod == {"u1": ["a", "b"]}


def test_checkpoint_numa_map_format(plane):
    # post-1.20 kubelet: DeviceIDs keyed by NUMA node.
    doc = checkpoint_doc([
        {"PodUID": "u1", "ContainerName": "c", "ResourceName": plane.resource,
         "DeviceIDs": {"0": ["a"], "1": ["b", "c"]}},
    ])
    by_pod = plane.ckpt.device_ids_by_pod(plane.ckpt.parse_checkpoint(doc), plane.resource)
    assert sorted(by_pod["u1"]) == ["a", "b", "c"]


def test_checkpoint_missing_and_corrupt(plane, tmp_path):
    assert plane.ckpt.read_checkpoint(str(tmp_path / "nope")) == []
    bad = tmp_path / "ckpt"
    bad.write_text("{not json")
    assert plane.ckpt.read_checkpoint(str(bad)) == []


# ---------------------------------------------------------------------------
# controller end-to-end against fake API server
# ---------------------------------------------------------------------------

def write_checkpoint(plane, tmp_path, by_pod):
    entries = [
        {"PodUID": uid, "ContainerName": "main",
         "ResourceName": plane.resource, "DeviceIDs": ids}
        for uid, ids in by_pod.items()
    ]
    path = tmp_path / "kubelet_internal_checkpoint"
    path.write_text(checkpoint_doc(entries))
    return str(path)


def make_controller(plane, api, plugin, tmp_path, by_pod=None):
    server, client = api
    path = write_checkpoint(plane, tmp_path, by_pod or {})
    return plane.Controller(
        client,
        plugin,
        node_name=NODE,
        checkpoint_path=path,
        # Pin checkpoint-only: on a real k8s node the default socket would
        # exist and silently switch these tests' data source.
        podresources_socket="",
        watch_timeout_s=2,
    ), server


def test_update_patches_real_ids_onto_pod(plane, api, plugin, tmp_path):
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    # kubelet admits the pod: checkpoint appears with its device picks.
    write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches)
        ns, name, body = server.pod_patches[0]
        assert (ns, name) == ("default", "jax-pod")
        got = body["metadata"]["annotations"][plane.constants.POD_DEVICES_ANNOTATION]
        assert got == ",".join(sorted(ids[:2]))
        assert set(ids[:2]).issubset(plugin.state.allocated)
    finally:
        ctrl.stop()


def test_update_translates_shadow_map(plane, api, plugin, tmp_path):
    ids = plane.ids(plugin)
    # Substitution mode: kubelet thinks it allocated ids[0],ids[3]; plugin
    # actually handed out ids[0],ids[1].
    plugin.shadow_map[ids[3]] = ids[1]
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    write_checkpoint(plane, tmp_path, {"uid-1": [ids[0], ids[3]]})
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches)
        _, _, body = server.pod_patches[0]
        got = body["metadata"]["annotations"][plane.constants.POD_DEVICES_ANNOTATION]
        assert got == ",".join(sorted([ids[0], ids[1]]))
        assert plugin.shadow_map == {}  # drained (controller.go:200-210)
    finally:
        ctrl.stop()


def test_delete_frees_devices(plane, api, plugin, tmp_path):
    ids = plane.ids(plugin)
    plugin.state.allocate(ids[:2])
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    pod = pod_dict(plane,
        "jax-pod", "uid-1", cards=2,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ",".join(ids[:2])},
    )
    server.add_pod(pod)
    ctrl.start()
    try:
        # Let the informer's initial list land before deleting, as in real
        # life (the pod existed long before it is deleted).
        assert wait_for(lambda: ctrl._pod_devices)
        server.delete_pod("default", "jax-pod")
        assert wait_for(lambda: plugin.state.allocated == set())
    finally:
        ctrl.stop()


def test_startup_rebuild_from_checkpoint(plane, api, plugin, tmp_path):
    """The reference loses allocation state across restarts (SURVEY §5);
    we rebuild it, ignoring entries for pods that no longer exist."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(
        plane, api, plugin, tmp_path,
        by_pod={"uid-live": ids[:2], "uid-gone": [ids[2]]},
    )
    server.add_pod(pod_dict(plane, "live-pod", "uid-live", cards=2))
    # uid-gone has no live pod: its chips must stay free.
    ctrl.rebuild_state()
    assert plugin.state.allocated == set(ids[:2])


def test_resync_catches_late_checkpoint(plane, api, plugin, tmp_path):
    """The kubelet writes its checkpoint *after* the pod event in real life;
    the informer resync must reconcile without a fresh pod event."""
    ids = plane.ids(plugin)
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        watch_timeout_s=2, resync_interval_s=0.3,
    )
    server.add_pod(pod_dict(plane, "late-pod", "uid-late", cards=2))
    ctrl.start()
    try:
        time.sleep(0.5)  # pod event long processed, checkpoint still empty
        assert not server.pod_patches
        write_checkpoint(plane, tmp_path, {"uid-late": ids[:2]})
        assert wait_for(lambda: server.pod_patches)
    finally:
        ctrl.stop()


def test_watch_stream_delivers_events(plane, api):
    server, client = api
    server.add_pod(pod_dict(plane, "w1", "uid-w1", cards=1))
    events = []
    for etype, obj in client.watch_pods(node_name=NODE, timeout_seconds=2):
        events.append((etype, obj["metadata"]["name"]))
        break
    assert events == [("ADDED", "w1")]


def test_watch_event_arrives_before_the_window_ends(tmp_path):
    """The port's watch hands over each event when its line arrives. The
    fake API server's streams are close-delimited (HTTP/1.0), where the
    JAX client's 512-byte reads hold a small event back until the window
    ends; both clients give the same event."""
    from tests.torch_kube_planes import JaxPlane, TorchPlane

    server = FakeApiServer()
    url = server.start()
    got = {}

    def watch(plane):
        t0 = time.monotonic()
        for etype, obj in plane.KubeClient(url).watch_pods(node_name=NODE, timeout_seconds=3):
            got[plane.name] = (time.monotonic() - t0, etype, obj["metadata"]["name"])
            break

    threads = [threading.Thread(target=watch, args=(p,)) for p in (JaxPlane, TorchPlane)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        server.add_pod(pod_dict(TorchPlane, "w1", "uid-w1", cards=1))
        for t in threads:
            t.join(timeout=10)
        assert got["torch"][1:] == got["jax"][1:] == ("ADDED", "w1")
        assert got["torch"][0] < 1.0, got
    finally:
        stop_in_background(server)


def test_publish_node_topology(plane, api, plugin):
    """Each schema to its own spec: the v5p mesh's labels; the H100s'
    cards, pairs and GPU Feature Discovery's labels."""
    server, client = api
    topo = plane.publish_topology(client, plugin, numa_nodes=2)
    node = server.nodes[NODE]
    ann = node["metadata"]["annotations"][plane.constants.TOPOLOGY_ANNOTATION]
    parsed = type(topo).from_json(ann)
    assert parsed == topo
    assert parsed.chip_count == 4
    assert parsed.numa_nodes == 2
    assert parsed.available == sorted(plane.ids(plugin)) and parsed.failed == []
    labels = node["metadata"]["labels"]
    if plane.name == "jax":
        assert labels["google.com/tpu-topology"] == "2x2x1"
        assert labels["google.com/tpu-accelerator"] == "v5p"
        return
    assert plane.constants.TOPOLOGY_ANNOTATION == "nvidia.com/gpu-topology"
    assert labels == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
                      "nvidia.com/gpu.count": "4"}
    assert (parsed.chip_type, parsed.product) == ("H100", "NVIDIA H100 80GB HBM3")
    assert [(c.id, c.index, c.minor, c.numa_node, c.hbm_bytes) for c in parsed.chips] == [
        (u, i, i, 0, 81559 * 2 ** 20) for i, u in enumerate(plane.uuids)]
    assert [c.dev_path for c in parsed.chips] == [
        os.path.join(plane.dev, f"nvidia{i}") for i in range(4)]
    assert [c.pci_addr for c in parsed.chips] == [
        f"0000:{0x18 + 0x10 * i:02x}:00.0" for i in range(4)]
    # Card i and chip i share their links: NV2 (score 5) on the v5p host's
    # ICI pairs, SYS (score 1) on the diagonals.
    u = plane.uuids
    assert [(p.a, p.b, p.link, p.score) for p in parsed.pairs] == [
        (u[a], u[b], "NV2" if (a, b) in EDGES else "SYS", 5 if (a, b) in EDGES else 1)
        for a in range(4) for b in range(a + 1, 4)]
    # The cached parse hands out a private ``available``.
    cached = schema.parse_topology_cached(ann)
    cached.available.clear()
    assert schema.parse_topology_cached(ann).available == parsed.available


def test_rebuild_updates_gauges_and_hooks(plane, api, plugin, tmp_path):
    """Checkpoint rebuild must flow through the notifying allocation path
    so the published availability and metrics reflect held chips."""
    ids = plane.ids(plugin)
    changed = []
    plugin.on_availability_change = lambda: changed.append(True)
    ctrl, server = make_controller(plane, api, plugin, tmp_path,
                                   by_pod={"uid-live": ids[:2]})
    server.add_pod(pod_dict(plane, "live-pod", "uid-live", cards=2))
    ctrl.rebuild_state()
    assert plugin.state.allocated == set(ids[:2])
    assert changed  # hook fired -> publisher would republish


# ---------------------------------------------------------------------------
# PodResources API path (podresources/v1) — preferred over the checkpoint
# ---------------------------------------------------------------------------

def make_podres_controller(plane, api, plugin, tmp_path, podres):
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})  # empty: API must be the source
    return plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket=podres.socket_path, watch_timeout_s=2,
    ), server


def test_update_reconciles_via_podresources(plane, api, plugin, tmp_path, podres):
    """With a modern kubelet the controller never reads the checkpoint:
    the PodResources Get/List RPCs carry the device assignment."""
    ids = plane.ids(plugin)
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    podres.set_pod("default", "jax-pod", plane.resource, ids[:2])
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches)
        _, _, body = server.pod_patches[0]
        got = body["metadata"]["annotations"][plane.constants.POD_DEVICES_ANNOTATION]
        assert got == ",".join(sorted(ids[:2]))
        assert set(ids[:2]).issubset(plugin.state.allocated)
    finally:
        ctrl.stop()


def test_podresources_list_fallback_pre127(plane, api, plugin, tmp_path, podres):
    """Kubelets before 1.27 serve List but not Get; the client must fall
    back transparently."""
    ids = plane.ids(plugin)
    podres.serve_get = False
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    podres.set_pod("default", "jax-pod", plane.resource, ids[2:4])
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches)
        _, _, body = server.pod_patches[0]
        got = body["metadata"]["annotations"][plane.constants.POD_DEVICES_ANNOTATION]
        assert got == ",".join(sorted(ids[2:4]))
    finally:
        ctrl.stop()


def test_rebuild_from_podresources(plane, api, plugin, tmp_path, podres):
    """Startup rebuild prefers the PodResources API; entries for pods that
    no longer exist on the node are ignored, same as the checkpoint path."""
    ids = plane.ids(plugin)
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    server.add_pod(pod_dict(plane, "live-pod", "uid-live", cards=2))
    podres.set_pod("default", "live-pod", plane.resource, ids[:2])
    podres.set_pod("default", "gone-pod", plane.resource, [ids[2]])
    ctrl.rebuild_state()
    assert plugin.state.allocated == set(ids[:2])
    # Delete frees through the same uid-keyed tracking.
    assert ctrl._pod_devices.get("uid-live") == set(ids[:2])


def test_podresources_failure_falls_back_to_checkpoint(plane, api, plugin, tmp_path, podres):
    """A wedged PodResources endpoint (socket exists, RPCs fail) must not
    stop reconciliation: the checkpoint file still carries the facts."""
    ids = plane.ids(plugin)
    podres.fail = True
    server, client = api
    path = write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket=podres.socket_path, watch_timeout_s=2,
    )
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches)
        _, _, body = server.pod_patches[0]
        got = body["metadata"]["annotations"][plane.constants.POD_DEVICES_ANNOTATION]
        assert got == ",".join(sorted(ids[:2]))
    finally:
        ctrl.stop()


def test_podresources_client_allocatable(plane, podres):
    podres.allocatable = {plane.resource: ["a", "b", "c", "d"],
                          "other.com/nic": ["n0"]}
    c = plane.PodResourcesClient(podres.socket_path)
    assert c.available()
    assert c.allocatable_device_ids(plane.resource) == ["a", "b", "c", "d"]
    assert plane.PodResourcesClient("/nonexistent/sock").available() is False


def test_empty_podresources_beats_stale_checkpoint(plane, api, plugin, tmp_path, podres):
    """An authoritative empty PodResources answer must NOT fall through to
    the checkpoint: after a node reboot the fresh kubelet reports no
    assignments while the previous boot's checkpoint file still lists
    chips for a live pod. Trusting it would withhold free capacity."""
    ids = plane.ids(plugin)
    server, client = api
    path = write_checkpoint(plane, tmp_path, {"uid-stale": ids[:2]})  # previous boot
    server.add_pod(pod_dict(plane, "survivor-pod", "uid-stale", cards=2))
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket=podres.socket_path, watch_timeout_s=2,
    )
    ctrl.rebuild_state()
    assert plugin.state.allocated == set()  # API said: nothing assigned


def test_recreated_pod_defers_until_old_instance_freed(plane, api, plugin, tmp_path, podres):
    """PodResources keys pods by (namespace, name) — no uid. A recreated
    pod must not inherit the old instance's chips while the old instance
    is still tracked; reconciliation defers until delete frees them."""
    ids = plane.ids(plugin)
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    podres.set_pod("default", "pod-0", plane.resource, ids[:2])
    server.add_pod(pod_dict(plane, "pod-0", "uid-new", cards=2))
    # Old instance (uid-old) still holds the chips.
    ctrl._pod_devices["uid-old"] = set(ids[:2])
    ctrl._handle_update(pod_dict(plane, "pod-0", "uid-new", cards=2))
    assert not server.pod_patches  # deferred
    # Old instance's DELETED event frees them; resync retries.
    ctrl._handle_delete(pod_dict(plane, "pod-0", "uid-old", cards=2))
    ctrl._handle_update(pod_dict(plane, "pod-0", "uid-new", cards=2))
    assert server.pod_patches
    assert ctrl._pod_devices.get("uid-new") == set(ids[:2])


def test_shadow_map_survives_transient_patch_failure(plane, api, plugin, tmp_path):
    """Substitution-mode entries must drain only after the pod patch lands,
    so an apiserver blip doesn't wedge the pod forever."""
    ids = plane.ids(plugin)
    plugin.shadow_map[ids[3]] = ids[1]
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    write_checkpoint(plane, tmp_path, {"uid-1": [ids[0], ids[3]]})
    calls = []
    real_patch = ctrl.client.patch_pod_annotations

    def flaky_patch(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("apiserver blip")
        return real_patch(*a, **kw)

    ctrl.client.patch_pod_annotations = flaky_patch
    pod = pod_dict(plane, "jax-pod", "uid-1", cards=2)
    server.add_pod(pod)
    with pytest.raises(OSError):
        ctrl._handle_update(pod)
    assert plugin.shadow_map == {ids[3]: ids[1]}  # NOT drained
    ctrl._handle_update(pod)  # retry succeeds
    assert plugin.shadow_map == {}
    _, _, body = server.pod_patches[0]
    got = body["metadata"]["annotations"][plane.constants.POD_DEVICES_ANNOTATION]
    assert got == ",".join(sorted([ids[0], ids[1]]))


def test_nsname_rebuild_key_does_not_deadlock_own_pod(plane, api, plugin, tmp_path, podres):
    """An apiserver-less rebuild tracks pods by namespace/name; the same
    pod's later update event must treat that key as itself, reconcile, and
    migrate the tracking to its uid."""
    ids = plane.ids(plugin)
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    podres.set_pod("default", "jax-pod", plane.resource, ids[:2])
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    # As rebuild_state stores it when list_pods failed:
    ctrl._pod_devices["default/jax-pod"] = set(ids[:2])
    ctrl._handle_update(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    assert server.pod_patches  # NOT deferred
    assert ctrl._pod_devices == {"uid-1": set(ids[:2])}  # migrated


def test_resync_prunes_missed_delete(plane, api, plugin, tmp_path, podres):
    """A DELETED event missed during a watch gap must not hold chips
    forever: the periodic relist prunes tracking for vanished pods, which
    also unblocks a recreated same-name pod's deferral."""
    ids = plane.ids(plugin)
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket=podres.socket_path,
        watch_timeout_s=2, resync_interval_s=0.3,
    )
    # uid-old's pod vanished while the watch was down; its entry is stale.
    plugin.state.allocate(ids[:2])
    ctrl._pod_devices["uid-old"] = set(ids[:2])
    # The replacement instance exists and the kubelet reassigned the chips.
    server.add_pod(pod_dict(plane, "pod-0", "uid-new", cards=2))
    podres.set_pod("default", "pod-0", plane.resource, ids[:2])
    ctrl.start()
    try:
        assert wait_for(lambda: "uid-old" not in ctrl._pod_devices)
        assert wait_for(lambda: server.pod_patches)  # recreated pod freed up
        assert wait_for(
            lambda: ctrl._pod_devices.get("uid-new") == set(ids[:2])
        )
    finally:
        ctrl.stop()


def test_rebuild_attributes_assignment_to_single_instance(plane, api, plugin, tmp_path, podres):
    """During a same-name recreation the pod list briefly holds both the
    Terminating old pod and its replacement; the rebuild must attribute
    the kubelet's (ns,name)-keyed assignment to exactly one of them (the
    Terminating holder), or the old pod's DELETED would free chips the
    replacement still runs on."""
    ids = plane.ids(plugin)
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    podres.set_pod("default", "pod-0", plane.resource, ids[:2])
    old = pod_dict(plane, "pod-0", "uid-old", cards=2)
    old["metadata"]["deletionTimestamp"] = "2026-07-30T00:00:00Z"
    server.add_pod(old)
    # FakeApiServer keys pods by (ns, name); inject the same-name
    # replacement directly into the listing the way a real apiserver
    # briefly shows both instances.
    new = pod_dict(plane, "pod-0", "uid-new", cards=2)
    ctrl.client.list_pods = lambda **kw: {"items": [new, old],
                                          "metadata": {}}
    ctrl.rebuild_state()
    assert ctrl._pod_devices == {"uid-old": set(ids[:2])}
    assert plugin.state.allocated == set(ids[:2])
    # Old instance finally dies. While the kubelet still reports the
    # (ns,name) assigned, the chips are re-bound (not freed — the entry
    # may be the replacement's); once the kubelet drops the entry, the
    # delete frees.
    ctrl._handle_delete(old)
    assert plugin.state.allocated == set(ids[:2])  # re-bound, conservative
    assert ctrl._pod_devices == {"default/pod-0": set(ids[:2])}
    podres.pods.pop(("default", "pod-0"))
    ctrl._handle_delete(old)
    assert plugin.state.allocated == set()


def test_delete_does_not_free_chips_reassigned_to_replacement(plane, api, plugin, tmp_path, podres):
    """An old pod's DELETED event can arrive after the kubelet already
    re-assigned its chips to a replacement pod (grace-period lag). The
    delete path must consult the kubelet's current assignments and keep
    such chips allocated, or a third pod could double-mount them."""
    ids = plane.ids(plugin)
    ctrl, server = make_podres_controller(plane, api, plugin, tmp_path, podres)
    # Old pod-0 instance held ids[:2]; its replacement (uid-new) already
    # has them per the kubelet, and an unrelated pod holds ids[2].
    plugin.state.allocate(ids[:3])
    ctrl._pod_devices["uid-old"] = set(ids[:2])
    ctrl._pod_devices["uid-other"] = {ids[2]}
    podres.set_pod("default", "pod-0", plane.resource, ids[:2])
    podres.set_pod("default", "other", plane.resource, [ids[2]])
    old = pod_dict(plane, "pod-0", "uid-old", cards=2)
    # The DELETED object is the OLD instance, but (ns,name) now belongs to
    # the replacement — the kubelet's entry for pod-0 is the NEW holder's,
    # so its chips must NOT be freed.
    ctrl._handle_delete(old)
    assert plugin.state.allocated == set(ids[:3])  # nothing freed
    assert "uid-old" not in ctrl._pod_devices
    # Whereas a pod whose chips the kubelet no longer assigns frees fine.
    podres.pods.pop(("default", "other"))
    other = pod_dict(plane, "other", "uid-other", cards=1)
    ctrl._handle_delete(other)
    assert plugin.state.allocated == set(ids[:2])


def test_delete_guard_translates_via_persistent_substitutions(plane, api, plugin, tmp_path):
    """Substitution mode: pod A's kubelet id K was substituted to real
    chip R, and the shadow entry was drained on A's reconcile. When pod B
    (holding real chip K) is deleted, the delete-time guard must translate
    A's kubelet assignment through the PERSISTENT substitution record —
    via the drained shadow map, A's entry K would masquerade as B's real
    chip and wrongly defer the free."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    # Pod A: kubelet allocated ids[1], plugin substituted real ids[0];
    # reconcile drained the shadow entry but the permanent record remains.
    plugin.substitutions[ids[1]] = ids[0]
    plugin.state.allocate([ids[0], ids[1]])  # A holds ids[0], B holds ids[1]
    write_checkpoint(plane, tmp_path, {"uid-a": [ids[1]]})  # A's kubelet entry
    ctrl._pod_devices["uid-b"] = {ids[1]}
    b = pod_dict(plane, "pod-b", "uid-b", cards=1)
    ctrl._handle_delete(b)
    # B's chip ids[1] freed (A's kubelet id ids[1] means real ids[0]).
    assert plugin.state.allocated == {ids[0]}


# ---------------------------------------------------------------------------
# Unhealthy-chip eviction (BASELINE config 4)
# ---------------------------------------------------------------------------

def test_unhealthy_chip_evicts_holding_pod(plane, api, plugin, tmp_path):
    """A chip going Unhealthy evicts exactly the pods holding it (matched
    by devices annotation), so they reschedule onto healthy capacity;
    uninvolved pods survive. The eviction's DELETED event then frees the
    chips through the normal delete path."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    victim = pod_dict(plane,
        "victim", "uid-v", cards=2,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ",".join(ids[:2])},
    )
    bystander = pod_dict(plane,
        "bystander", "uid-b", cards=1,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ids[3]},
    )
    server.add_pod(victim)
    server.add_pod(bystander)
    plugin.state.allocate(ids[:2])
    ctrl.start()
    try:
        assert wait_for(lambda: ctrl._pod_devices.get("uid-v"))
        plugin.state.set_health(ids[0], healthy=False)
        ctrl.on_chip_unhealthy(ids[0])
        assert wait_for(lambda: server.evictions)
        assert server.evictions == [("default", "victim")]
        assert ("default", "bystander") not in [
            (ns, n) for ns, n in server.evictions
        ]
        # Eviction deleted the pod; the DELETED event frees its chips.
        assert wait_for(lambda: plugin.state.allocated == set())
        # A Warning event was emitted on the pod.
        assert any(
            e.get("reason") == plane.unhealthy_reason for e in server.events
        )
    finally:
        ctrl.stop()


def test_eviction_disabled_by_flag(plane, api, plugin, tmp_path):
    ids = plane.ids(plugin)
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket="", watch_timeout_s=2,
        evict_on_unhealthy=False,
    )
    server.add_pod(pod_dict(plane,
        "victim", "uid-v", cards=1,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ids[0]},
    ))
    ctrl.start()
    try:
        ctrl.on_chip_unhealthy(ids[0])
        time.sleep(0.5)
        assert server.evictions == []
    finally:
        ctrl.stop()


def test_evict_unhealthy_now_sweeps_preexisting(plane, api, plugin, tmp_path):
    """A chip that was already broken before the controller started (the
    health watcher's pre-serve sweep marked it) still gets its pods
    evicted via the startup sweep."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    server.add_pod(pod_dict(plane,
        "victim", "uid-v", cards=1,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ids[0]},
    ))
    plugin.state.set_health(ids[0], healthy=False)
    ctrl.start()
    try:
        ctrl.evict_unhealthy_now()
        assert wait_for(lambda: server.evictions)
        assert server.evictions == [("default", "victim")]
    finally:
        ctrl.stop()


def test_health_blip_does_not_evict(plane, api, plugin, tmp_path):
    """A chip that recovers before the queued eviction runs must not have
    its pods evicted — transient sysfs blips are not grounds for
    disruption."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    server.add_pod(pod_dict(plane,
        "victim", "uid-v", cards=1,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ids[0]},
    ))
    # Blip: unhealthy then healthy again before the worker starts.
    plugin.state.set_health(ids[0], healthy=False)
    ctrl.on_chip_unhealthy(ids[0])
    plugin.state.set_health(ids[0], healthy=True)
    ctrl.start()
    try:
        time.sleep(0.6)
        assert server.evictions == []
    finally:
        ctrl.stop()


def test_pdb_blocked_eviction_retries_until_unblocked(plane, api, plugin, tmp_path):
    """Eviction is level-triggered: a PodDisruptionBudget 429 doesn't
    exhaust a bounded retry budget — as long as the chip stays unhealthy,
    each informer resync re-fires the eviction until it lands."""
    ids = plane.ids(plugin)
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket="", watch_timeout_s=2, resync_interval_s=0.3,
    )
    server.add_pod(pod_dict(plane,
        "victim", "uid-v", cards=1,
        annotations={plane.constants.POD_DEVICES_ANNOTATION: ids[0]},
    ))
    plugin.state.set_health(ids[0], healthy=False)
    server.block_evictions = True
    ctrl.start()
    try:
        ctrl.on_chip_unhealthy(ids[0])
        time.sleep(1.0)  # several resyncs' worth of blocked attempts
        assert server.evictions == []
        assert plane.metrics.EVICTIONS.get(outcome="failed") >= 1
        server.block_evictions = False  # the budget frees up
        assert wait_for(lambda: ("default", "victim") in server.evictions)
    finally:
        ctrl.stop()


def test_late_reconciled_pod_still_evicted(plane, api, plugin, tmp_path):
    """A chip that dies before its pod is reconciled (no annotation, no
    tracking yet) still gets the pod evicted once reconciliation catches
    up, via the resync re-fire."""
    ids = plane.ids(plugin)
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket="", watch_timeout_s=2, resync_interval_s=0.3,
    )
    plugin.state.set_health(ids[0], healthy=False)
    ctrl.start()
    try:
        ctrl.on_chip_unhealthy(ids[0])  # fires with no pods at all
        time.sleep(0.4)
        # Pod appears (kubelet admitted it against its stale view) and the
        # checkpoint names the broken chip.
        server.add_pod(pod_dict(plane, "late", "uid-l", cards=1))
        write_checkpoint(plane, tmp_path, {"uid-l": [ids[0]]})
        assert wait_for(lambda: ("default", "late") in server.evictions)
    finally:
        ctrl.stop()


# ---------------------------------------------------------------------------
# Node condition (TPUChipsHealthy / GPUsHealthy)
# ---------------------------------------------------------------------------

def test_node_condition_tracks_chip_health(plane, api, plugin):
    """Chip health surfaces as a node status condition (the
    node-problem-detector pattern): False with the broken chips named,
    back to True on recovery, merged by type."""
    server, client = api
    ids = plane.ids(plugin)
    plane.publish_condition(client, NODE, plugin)
    conds = server.nodes[NODE]["status"]["conditions"]
    assert len(conds) == 1
    assert conds[0]["type"] == plane.condition_type
    assert conds[0]["status"] == "True"
    assert "all 4" in conds[0]["message"]

    plugin.state.set_health(ids[0], healthy=False)
    plane.publish_condition(client, NODE, plugin)
    conds = server.nodes[NODE]["status"]["conditions"]
    assert len(conds) == 1  # merged by type, not appended
    assert conds[0]["status"] == "False"
    assert ids[0] in conds[0]["message"]
    assert conds[0]["reason"] == plane.condition_unhealthy

    plugin.state.set_health(ids[0], healthy=True)
    plane.publish_condition(client, NODE, plugin)
    conds = server.nodes[NODE]["status"]["conditions"]
    assert conds[0]["status"] == "True"


def test_node_condition_preserves_transition_time(plane, api, plugin):
    """Re-publishing an UNCHANGED status (daemon restart; one of several
    broken chips recovering) keeps lastTransitionTime — alert clocks keyed
    on 'False for > X minutes' must not reset — while the heartbeat
    advances on every publish."""
    server, client = api
    ids = plane.ids(plugin)
    plugin.state.set_health(ids[0], healthy=False)
    plugin.state.set_health(ids[1], healthy=False)
    plane.publish_condition(client, NODE, plugin)
    # Simulate a later republish with the same status (chip 1 recovered,
    # chip 0 still broken — still False overall).
    server.nodes[NODE]["status"]["conditions"][0]["lastTransitionTime"] = (
        "2026-01-01T00:00:00Z"
    )
    plugin.state.set_health(ids[1], healthy=True)
    plane.publish_condition(client, NODE, plugin)
    cond = server.nodes[NODE]["status"]["conditions"][0]
    assert cond["status"] == "False"
    assert cond["lastTransitionTime"] == "2026-01-01T00:00:00Z"  # kept
    assert ids[1] not in cond["message"]
    # A real flip stamps a new transition time.
    plugin.state.set_health(ids[0], healthy=True)
    plane.publish_condition(client, NODE, plugin)
    cond = server.nodes[NODE]["status"]["conditions"][0]
    assert cond["status"] == "True"
    assert cond["lastTransitionTime"] != "2026-01-01T00:00:00Z"


def test_publisher_heartbeats_when_idle(plane, api, plugin):
    """An idle node still republishes on the heartbeat interval so the
    condition's lastHeartbeatTime advances — tooling can treat a stale
    heartbeat as 'plugin dead, health unknown'."""
    server, client = api
    pub = plane.wiring.TopologyPublisher(
        client, NODE, plugin, debounce_s=0.05, heartbeat_s=0.3
    )
    pub.start()
    try:
        # No trigger at all: the timed wait alone must publish the
        # condition...
        assert wait_for(
            lambda: (server.nodes[NODE].get("status") or {}).get(
                "conditions"
            ),
            timeout=5,
        )
        n_status = len(server.node_status_patches)
        n_node = len(server.node_patches)
        assert wait_for(
            lambda: len(server.node_status_patches) > n_status, timeout=5
        )  # a second heartbeat cycle advanced the condition
        # ...but heartbeats are condition-only: no annotation/label churn
        # (node-object writes wake every node watcher in the cluster).
        assert len(server.node_patches) == n_node
    finally:
        pub.stop()


def test_stop_interrupts_inflight_watch_and_joins_threads(plane, api, plugin, tmp_path, caplog):
    """stop() must abort the streaming watch and fully join both threads
    promptly (VERDICT r2 weak #5): a leaked informer would keep logging
    connection errors against a torn-down apiserver after the suite's
    summary line."""
    server, client = api
    path = write_checkpoint(plane, tmp_path, {})
    ctrl = plane.Controller(
        client,
        plugin,
        node_name=NODE,
        checkpoint_path=path,
        podresources_socket="",
        # Long watch window + no resync pressure: only the interrupt can
        # get the informer out of the blocking read quickly.
        watch_timeout_s=30,
        resync_interval_s=3600,
    )
    ctrl.start()
    threads = list(ctrl._threads)
    wait_for(lambda: len(client._live_watches) > 0)

    with caplog.at_level(logging.WARNING):
        t0 = time.time()
        ctrl.stop()
        elapsed = time.time() - t0
    assert elapsed < 5.0, f"stop() took {elapsed:.1f}s"
    assert not any(t.is_alive() for t in threads), [
        t.name for t in threads if t.is_alive()
    ]
    assert "watch connection error" not in caplog.text
    assert "still draining" not in caplog.text
