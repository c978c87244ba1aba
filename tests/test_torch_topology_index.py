"""The port's incremental topology index (extender/index.py) and the node
cache that feeds it, against the JAX ones.

The cases of the JAX ``tests/test_topology_index.py`` whose subject is in
the filter/score plane, parametrised over the two planes of
tests/torch_extender_planes.py: the relist diff, watch events, negative
caching of malformed and missing annotations, the fast path declining
without a synced cache, and the indexed name-only answers equal to the
full-object ones (reservations and requests over several nodes included).
The gang dirty-marking cases (``test_dirty_marking_slice_dependencies``,
``test_single_host_gang_wakes_on_any_node_event``,
``test_pod_event_marks_only_its_gang_and_idle_ticks_are_noops``,
``test_cache_to_gang_wiring_marks_dirty_on_annotation_change``) wait for
gang admission, the extender's next slice.
"""

import threading
import time

import pytest

from k8s_device_plugin_tpu_torch.extender.index import TopologyIndex
from k8s_device_plugin_tpu_torch.extender.server import NodeAnnotationCache
from k8s_device_plugin_tpu_torch.topology.placement import (
    GpuPlacementState,
    capacity_stats,
    placeable_sizes,
)
from k8s_device_plugin_tpu_torch.topology.schema import parse_topology_cached
from k8s_device_plugin_tpu_torch.utils import metrics
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.torch_extender_planes import (
    JaxPlane,
    ListClient,
    TorchPlane,
    pattern_name,
    patterns,
    pod,
    read_layouts,
)
from tests.torch_kube_planes import stop_in_background


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


def ext_pair(plane, nodes, table=None):
    table = table or plane.reservations.ReservationTable()
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600)
    cache.refresh()
    return (plane.server.TopologyExtender(reservations=table),
            plane.server.TopologyExtender(reservations=table, node_cache=cache), table)


# ---------------------------------------------------------------------------
# index invalidation
# ---------------------------------------------------------------------------


def test_relist_diff_rebuilds_only_changed_entries(plane):
    n1, n2 = plane.node("n1"), plane.node("n2")
    client = ListClient([n1, n2])
    cache = plane.server.NodeAnnotationCache(client, interval_s=3600)
    cache.refresh()
    e1, e2 = cache.index.get("n1"), cache.index.get("n2")
    assert e1 is not None and e1.avail == 4
    cache.refresh()  # unchanged: every entry survives identically
    assert cache.index.get("n1") is e1 and cache.index.get("n2") is e2
    client.nodes = [plane.node("n1", (0,)), n2]
    cache.refresh()
    e1b = cache.index.get("n1")
    assert e1b is not e1 and e1b.avail == 1
    assert cache.index.get("n2") is e2


def test_watch_events_rebuild_exactly_the_affected_node(plane):
    n1, n2 = plane.node("n1"), plane.node("n2")
    cache = plane.server.NodeAnnotationCache(ListClient([n1, n2]), interval_s=3600)
    cache.refresh()
    e1, e2 = cache.index.get("n1"), cache.index.get("n2")
    assert cache.apply_event("MODIFIED", n1) == "noop"
    assert cache.index.get("n1") is e1
    assert cache.apply_event("MODIFIED", plane.node("n1", ())) == "update"
    assert cache.index.get("n1").avail == 0 and cache.index.get("n2") is e2
    assert cache.apply_event("ADDED", plane.node("n3")) == "add"
    assert cache.index.get("n3").avail == 4
    assert cache.apply_event("DELETED", plane.node("n3")) == "delete"
    assert cache.index.get("n3") is None and not cache.index.known("n3")
    # The annotation removed: the entry clears, the node stays known.
    assert cache.apply_event("MODIFIED", {"metadata": {"name": "n2"}}) == "clear"
    assert cache.index.get("n2") is None and cache.index.known("n2")


def test_malformed_annotation_is_negative_cached_and_keyed(plane):
    idx = plane.index.TopologyIndex()
    assert idx.update("bad", "{not json") == "add"
    assert idx.get("bad").topo is None
    assert idx.update("bad", "{not json") == "noop"


def test_watch_loop_applies_events_then_falls_back_to_relist(plane):
    n1, n1_new = plane.node("n1"), plane.node("n1", ())

    class WatchClient(ListClient):
        watch_calls = 0

        def watch_nodes(self, resource_version="", timeout_seconds=60):
            type(self).watch_calls += 1
            if type(self).watch_calls == 1:
                yield "MODIFIED", n1_new
            raise ConnectionError("stream died")

    client = WatchClient([n1])
    cache = plane.server.NodeAnnotationCache(client, interval_s=3600, watch=True)
    cache.refresh()
    assert cache.index.get("n1").avail == 4
    # One drop after a delivered event resumes; three barren drops hand
    # back to the relist loop.
    assert cache._watch_until_stale() is False
    assert type(client).watch_calls == 4
    assert cache.index.get("n1").avail == 0


# ---------------------------------------------------------------------------
# fast path: decline and fall back, parity
# ---------------------------------------------------------------------------


def test_fast_path_declines_without_cache_or_sync(plane):
    ext = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable())
    assert ext.filter_names(pod(plane, 1), ["n1"]) is None
    assert ext.prioritize_names(pod(plane, 1), ["n1"]) is None
    cache = plane.server.NodeAnnotationCache(ListClient([]), interval_s=3600)
    ext2 = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable(),
                                         node_cache=cache)
    assert ext2.filter_names(pod(plane, 1), ["n1"]) is None
    cache.refresh()
    assert ext2.filter_names(pod(plane, 1), ["n1"]) is not None


def test_indexed_filter_prioritize_match_full_object_path(plane):
    nodes = [plane.node("full"), plane.node("tight", (0,)), plane.node("empty", ())]
    names = [n["metadata"]["name"] for n in nodes]
    ext_obj, ext_idx, table = ext_pair(plane, nodes)
    # A standing reservation on "full" shields 2 cards from other pods.
    table.reserve(("default", "g"), {"full": 2})
    for n in (1, 2, 4):
        p = pod(plane, n)
        passing, failed = ext_obj.filter(p, nodes)
        fast = ext_idx.filter_names(p, names)
        assert fast == ([x["metadata"]["name"] for x in passing], failed)
        assert ext_idx.prioritize_names(p, names) == ext_obj.prioritize(p, nodes)


def test_indexed_request_over_several_nodes_matches_full_object_path(plane):
    """The JAX multi-host parity case on standalone nodes (a GPU node has
    no slice): every node is rejected alike on both paths."""
    nodes = [plane.node("h0"), plane.node("h1"), plane.node("h2", (0, 1)),
             plane.node("standalone")]
    names = [n["metadata"]["name"] for n in nodes]
    ext_obj, ext_idx, table = ext_pair(plane, nodes)
    table.reserve(("default", "g"), {"h1": 1})
    for n in (6, 8):
        p = pod(plane, n)
        passing, failed = ext_obj.filter(p, nodes)
        assert ext_idx.filter_names(p, names) == (
            [x["metadata"]["name"] for x in passing], failed)
        assert ext_idx.prioritize_names(p, names) == ext_obj.prioritize(p, nodes)


def test_every_pattern_and_size_matches_the_object_path(layouts):
    plane = TorchPlane(layouts["grid4"])
    nodes = [plane.node(pattern_name(p), p) for p in patterns(4)]
    names = [n["metadata"]["name"] for n in nodes]
    ext_obj, ext_idx, _ = ext_pair(plane, nodes)
    for n in range(0, 9):
        p = pod(plane, n)
        passing, failed = ext_obj.filter(p, nodes)
        assert ext_idx.filter_names(p, names) == (
            [x["metadata"]["name"] for x in passing], failed), n
        assert ext_idx.prioritize_names(p, names) == ext_obj.prioritize(p, nodes), n


def test_unknown_name_costs_one_fetch_and_is_indexed(plane):
    client = ListClient([plane.node("n1")])
    cache = plane.server.NodeAnnotationCache(client, interval_s=3600)
    cache.refresh()
    client.nodes.append(plane.node("late-joiner"))
    ext = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable(),
                                        node_cache=cache)
    fast = ext.filter_names(pod(plane, 1), ["n1", "late-joiner"])
    assert fast is not None and fast[0] == ["n1", "late-joiner"]
    assert client.get_calls == 1
    ext.filter_names(pod(plane, 1), ["n1", "late-joiner"])
    assert client.get_calls == 1


# ---------------------------------------------------------------------------
# the port's derived numbers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["grid4", "hgx8", "islands8"])
def test_entry_derives_its_numbers_from_the_gpu_annotation(layouts, layout):
    plane = TorchPlane(layouts[layout])
    count = len(plane.ids)
    for p in [tuple(range(count)), (0,), (), tuple(range(1, count, 2))]:
        idx = TopologyIndex()
        idx.update("n", plane.raw("n", p))
        e = idx.get("n")
        assert (e.chip_count, e.avail, e.hostname, e.slice_key) == (count, len(p), "n", None)
        topo = parse_topology_cached(plane.raw("n", p))
        stats = capacity_stats(GpuPlacementState(topo.to_topology()), topo.available)
        assert e.placeable == tuple(n for n, ok in sorted(stats["placeable"].items()) if ok)
        assert e.placeable == tuple(range(1, len(p) + 1))
        assert placeable_sizes(topo.to_topology(), topo.available) == e.placeable
    assert idx.stats()["slices"] == 0 and idx.slice_members(("n",)) == set()


def test_placeable_aggregate_counts_every_size(layouts):
    hgx, grid = TorchPlane(layouts["hgx8"]), TorchPlane(layouts["grid4"])
    idx = TopologyIndex()
    idx.update("a", hgx.raw("a"))
    idx.update("b", hgx.raw("b", (0, 1, 2)))
    idx.update("c", grid.raw("c", (3,)))
    snap = idx.placeable_snapshot()
    assert snap == {"placeable_nodes": {"1": 3, "2": 2, "3": 2, "4": 1, "5": 1, "6": 1,
                                        "7": 1, "8": 1}, "nodes_with_topology": 3}
    assert metrics.EXT_PLACEABLE_NODES.get(size="8") == 1
    idx.remove("a")
    assert metrics.EXT_PLACEABLE_NODES.get(size="8") == 0
    assert "8" not in {labels["size"] for labels, _ in metrics.EXT_PLACEABLE_NODES.series()}
    idx.remove("b")
    idx.remove("c")


def test_column_plane_follows_every_mutation(layouts):
    plane = TorchPlane(layouts["grid4"])
    idx = TopologyIndex()
    idx.update("n1", plane.raw("n1"))
    first = idx.column_plane()
    assert idx.column_plane() is first
    idx.update("n1", plane.raw("n1", (0,)))
    second = idx.column_plane()
    assert second is not first and second.avail[second.rows["n1"]] == 1
    idx.update("bare", None)
    assert "bare" in idx.column_plane().no_topo


# ---------------------------------------------------------------------------
# the kube client's node calls, against the fake API server
# ---------------------------------------------------------------------------


def test_list_and_watch_nodes_match_the_jax_client(layouts):
    plane, jplane = TorchPlane(layouts["grid4"]), JaxPlane()
    api = FakeApiServer()
    url = api.start()
    try:
        api.add_node("n1", plane.node("n1"))
        port, jax = plane.KubeClient(url), jplane.KubeClient(url)
        listing = port.list_nodes()
        assert [n["metadata"]["name"] for n in listing["items"]] == ["n1"]
        assert listing == jax.list_nodes()
        rv = listing["metadata"]["resourceVersion"]
        got = []

        def watch():
            for etype, node in port.watch_nodes(resource_version=rv, timeout_seconds=3):
                got.append((etype, node["metadata"]["name"], time.monotonic()))
                break

        t = threading.Thread(target=watch)
        t.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        port.patch_node_annotations("n1", {plane.constants.TOPOLOGY_ANNOTATION:
                                           plane.raw("n1", ())})
        t.join(10)
        # Read as it arrives (read1), not when the window ends.
        assert got and got[0][:2] == ("MODIFIED", "n1") and got[0][2] - t0 < 1.5
    finally:
        stop_in_background(api)


def test_node_cache_watch_over_the_fake_api_server(layouts):
    plane = TorchPlane(layouts["grid4"])
    api = FakeApiServer()
    url = api.start()
    cache = None
    try:
        api.add_node("n1", plane.node("n1"))
        cache = NodeAnnotationCache(plane.KubeClient(url), interval_s=0.2, watch=True,
                                    watch_backstop_s=30).start()
        assert cache.index.get("n1").avail == 4
        time.sleep(0.5)  # the watch is up after the loop's first relist
        api.add_node("n1", plane.node("n1", (2,)))
        deadline = time.time() + 5
        while time.time() < deadline and cache.index.get("n1").avail != 1:
            time.sleep(0.02)
        assert cache.index.get("n1").avail == 1
        assert metrics.INDEX_EVENTS.get(source="watch", kind="update") >= 1
    finally:
        if cache is not None:
            cache.stop()
        stop_in_background(api)
