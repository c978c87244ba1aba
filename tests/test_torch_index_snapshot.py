"""The topology index's cold-start snapshot, the watch plane's coalescing and
the warm pool (extender/index.py, extender/server.py NodeAnnotationCache,
utils/statestore.py's snapshot files) against the JAX ones.

The cases of the JAX ``tests/test_index_snapshot.py`` are parametrised over
the two planes of tests/torch_extender_planes.py: a restored index equals a
freshly parsed one (entries, placeable gauges, RPC answers before the warm
finishes), truncation and bit-flip fuzz and a version bump fall back to the
full parse, an annotation changed while the extender was down re-parses
exactly that node, unchanged watch events short-circuit, event storms
coalesce, the warm pool drains, and /readyz names its phase.

Snapshot files frame byte for byte as the JAX ones do (the statestore
envelope in ``<dir>/index.snapshot.json``), so each plane's
``read_snapshot_file`` reads the other's. Two JAX cases have no port case
yet: ``test_audit_placeable_recount_clean_after_restore`` waits for the
extender's audit (with gang admission, the next slice), and
``test_failover_docs_and_deploy_in_lockstep`` holds the JAX docs and
manifest; the port's manifest is held in tests/test_torch_manifests.py.
"""

import json
import os
import threading
import time

import pytest
import requests

from k8s_device_plugin_tpu_torch.extender.server import (
    ExtenderHTTPServer,
    NodeAnnotationCache,
    ReadyStatus,
    TopologyExtender,
)
from k8s_device_plugin_tpu_torch.extender.index import INDEX_SNAPSHOT_VERSION
from k8s_device_plugin_tpu_torch.utils import metrics, statestore
from tests import torch_fake_nvml as fk
from tests.torch_extender_planes import JaxPlane, ListClient, TorchPlane, pod, read_layouts

SNAP = "index.snapshot.json"


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("snap_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


@pytest.fixture(autouse=True)
def _fresh_process_caches():
    """Each test starts from a restarted process's shape (a cold memo) and
    leaves no placeable series behind."""
    planes = (JaxPlane, TorchPlane)
    for p in planes:
        p.index.clear_derived_memo()
    yield
    for p in planes:
        p.index.clear_derived_memo()
        p.metrics.EXT_PLACEABLE_NODES.remove_matching()


def cluster_nodes(plane):
    """Every entry shape the snapshot must round-trip: free, tight and empty
    nodes, a malformed annotation and a node without one."""
    return [
        plane.node("full"), plane.node("tight", (0,)), plane.node("empty", ()),
        plane.node("s0"), plane.node("s1", (1, 2, 3)),
        {"metadata": {"name": "mangled",
                      "annotations": {plane.constants.TOPOLOGY_ANNOTATION: "{not json"}}},
        {"metadata": {"name": "bare"}},
    ]


def snapshot_dir(plane, tmp_path, nodes):
    d = str(tmp_path / "snap")
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600, snapshot_dir=d)
    cache.refresh()  # writes the snapshot as its last step
    assert os.path.exists(os.path.join(d, SNAP))
    return d


def restored_cache(plane, nodes, d, **kw):
    plane.index.clear_derived_memo()
    plane.schema._parse_template.cache_clear()
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600,
                                             snapshot_dir=d, **kw)
    assert cache.load_snapshot() > 0
    cache.refresh()
    return cache


def fresh_cache(plane, nodes):
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600)
    cache.refresh()
    return cache


# ---------------------------------------------------------------------------
# parity: restored equals freshly parsed
# ---------------------------------------------------------------------------


def test_snapshot_restore_parity_after_warm(plane, tmp_path):
    nodes = cluster_nodes(plane)
    d = snapshot_dir(plane, tmp_path, nodes)
    fresh = fresh_cache(plane, nodes)
    restored = restored_cache(plane, nodes, d)
    # "mangled" restores as a non-deferred negative entry; 5 defer.
    assert restored.index.warm_progress() == {"parsed": 1, "total": 6}
    assert restored.index.warm_remaining() == 5
    for name in ("full", "tight", "empty", "s0", "s1", "mangled"):
        assert restored.index.get(name) == fresh.index.get(name), name
    assert restored.index.get("bare") is None and restored.index.known("bare")
    assert restored.index.placeable_snapshot() == fresh.index.placeable_snapshot()
    assert restored.index.stats() == fresh.index.stats()


def test_snapshot_restore_gauges_match_fresh(plane, tmp_path):
    nodes = cluster_nodes(plane)
    fam = plane.metrics.EXT_PLACEABLE_NODES
    fresh_cache(plane, nodes)
    want = sorted((labels["size"], v) for labels, v in fam.series())
    assert want
    d = snapshot_dir(plane, tmp_path, nodes)
    fam.remove_matching()
    restored = restored_cache(plane, nodes, d)
    assert sorted((labels["size"], v) for labels, v in fam.series()) == want
    restored.index.warm_remaining()
    assert sorted((labels["size"], v) for labels, v in fam.series()) == want


def test_rpc_parity_before_warm_materializes_on_demand(plane, tmp_path):
    nodes = cluster_nodes(plane)
    names = [n["metadata"]["name"] for n in nodes]
    d = snapshot_dir(plane, tmp_path, nodes)
    ext_fresh = plane.server.TopologyExtender(
        reservations=plane.reservations.ReservationTable(), node_cache=fresh_cache(plane, nodes))
    restored = restored_cache(plane, nodes, d)
    assert restored.index.warm_progress()["parsed"] == 1
    ext_restored = plane.server.TopologyExtender(
        reservations=plane.reservations.ReservationTable(), node_cache=restored)
    for n in (1, 2, 4, 8):
        p = pod(plane, n)
        assert ext_restored.filter_names(p, names) == ext_fresh.filter_names(p, names), n
        assert ext_restored.prioritize_names(p, names) == ext_fresh.prioritize_names(p, names), n
    assert restored.index.warm_progress()["parsed"] == 6


# ---------------------------------------------------------------------------
# staleness: exactly the changed node re-parses
# ---------------------------------------------------------------------------


def test_annotation_changed_while_down_invalidates_exactly_that_node(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(4)]
    d = snapshot_dir(plane, tmp_path, nodes)
    live = [nodes[0], nodes[1], plane.node("n2", ()), nodes[3]]
    before = plane.metrics.INDEX_SNAPSHOT_ENTRIES.get(source="stale")
    restored = restored_cache(plane, live, d)
    assert plane.metrics.INDEX_SNAPSHOT_ENTRIES.get(source="stale") - before == 1
    e2 = restored.index.get("n2")
    assert not e2.deferred and e2.avail == 0 and e2.topo is not None
    for name in ("n0", "n1", "n3"):
        e = restored.index.get(name)
        assert e.deferred and e.avail == 4, name


def test_vanished_node_records_are_discarded(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(3)]
    d = snapshot_dir(plane, tmp_path, nodes)
    before = plane.metrics.INDEX_SNAPSHOT_ENTRIES.get(source="vanished")
    restored = restored_cache(plane, nodes[:2], d)
    assert plane.metrics.INDEX_SNAPSHOT_ENTRIES.get(source="vanished") - before == 1
    assert restored.index.get("n2") is None and not restored.index.known("n2")
    assert len(restored.index) == 2


# ---------------------------------------------------------------------------
# corruption: a damaged snapshot falls back to the full parse, never wrong
# ---------------------------------------------------------------------------


def _expect_never_wrong(plane, nodes, d, require_fallback=False):
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600, snapshot_dir=d)
    cache.load_snapshot()
    cache.refresh()
    if require_fallback:
        assert cache.index.warm_progress()["parsed"] == len(cache.index)
    cache.index.warm_remaining()
    fresh = fresh_cache(plane, nodes)
    for n in nodes:
        name = n["metadata"]["name"]
        assert cache.index.get(name) == fresh.index.get(name), name


def test_snapshot_truncation_fuzz_falls_back_to_full_parse(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(3)]
    d = snapshot_dir(plane, tmp_path, nodes)
    path = os.path.join(d, SNAP)
    data = open(path, "rb").read()
    for cut in range(0, len(data), max(1, len(data) // 64)):
        with open(path, "wb") as f:
            f.write(data[:cut])
        _expect_never_wrong(plane, nodes, d, require_fallback=cut < len(data))
        plane.metrics.EXT_PLACEABLE_NODES.remove_matching()


def test_snapshot_bitflip_fuzz_falls_back_to_full_parse(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(3)]
    d = snapshot_dir(plane, tmp_path, nodes)
    path = os.path.join(d, SNAP)
    data = bytearray(open(path, "rb").read())
    for pos in range(0, len(data), max(1, len(data) // 48)):
        flipped = bytearray(data)
        flipped[pos] ^= 0x40
        with open(path, "wb") as f:
            f.write(bytes(flipped))
        # A flip in the syntax, the checksum or the data falls back; one in
        # the unchecksummed envelope (seq, version) still restores right.
        _expect_never_wrong(plane, nodes, d)
        plane.metrics.EXT_PLACEABLE_NODES.remove_matching()


def test_snapshot_version_mismatch_is_ignored(plane, tmp_path):
    nodes = [plane.node("n0")]
    d = snapshot_dir(plane, tmp_path, nodes)
    path = os.path.join(d, SNAP)
    data = json.loads(open(path).read())["data"]
    data["v"] = 999  # a valid checksum: the version gate stands alone
    plane.statestore.write_snapshot_file(path, plane.statestore.snapshot_doc(data))
    before = plane.metrics.INDEX_SNAPSHOT_LOADS.get(outcome="version_mismatch")
    cache = plane.server.NodeAnnotationCache(ListClient(nodes), interval_s=3600, snapshot_dir=d)
    assert cache.load_snapshot() == 0
    assert plane.metrics.INDEX_SNAPSHOT_LOADS.get(outcome="version_mismatch") - before == 1
    cache.refresh()
    assert cache.index.warm_progress()["parsed"] == 1


def test_snapshot_write_skipped_when_unchanged(plane, tmp_path):
    nodes = [plane.node("n0"), plane.node("n1"), {"metadata": {"name": "plain"}}]
    d = snapshot_dir(plane, tmp_path, nodes)
    path = os.path.join(d, SNAP)
    mtime = os.stat(path).st_mtime_ns
    restored = restored_cache(plane, nodes, d)
    assert os.stat(path).st_mtime_ns == mtime
    restored.apply_event("MODIFIED", plane.node("n0", ()))
    assert restored.write_snapshot() is True
    assert os.stat(path).st_mtime_ns != mtime
    cache2 = restored_cache(plane, [plane.node("n0", ()), nodes[1]], d)
    assert cache2.index.get("n0").deferred and cache2.index.get("n0").avail == 0


# ---------------------------------------------------------------------------
# the same bytes on both planes
# ---------------------------------------------------------------------------


def test_snapshot_files_frame_byte_for_byte_as_the_jax_ones(tmp_path):
    doc = {"v": 1, "nodes": {"n0": {"avail": 4, "chips": 4, "host": "n0", "slice": None,
                                    "placeable": [1, 2, 3, 4], "h": "ab" * 16}}}
    for seq in (0, 7):
        port_doc = statestore.snapshot_doc(doc, seq=seq)
        assert port_doc == JaxPlane.statestore.snapshot_doc(doc, seq=seq)
        statestore.write_snapshot_file(str(tmp_path / "p.json"), port_doc)
        JaxPlane.statestore.write_snapshot_file(str(tmp_path / "j.json"), port_doc)
        assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for reader in (statestore.read_snapshot_file, JaxPlane.statestore.read_snapshot_file):
        assert reader(str(tmp_path / "p.json")) == (doc, 7, "clean")
        assert reader(str(tmp_path / "missing.json")) == (None, 0, "empty")
    (tmp_path / "bad.json").write_bytes((tmp_path / "p.json").read_bytes()[:-9])
    assert statestore.read_snapshot_file(str(tmp_path / "bad.json")) == (
        None, 0, "snapshot_corrupt") == JaxPlane.statestore.read_snapshot_file(
        str(tmp_path / "bad.json"))


def test_each_plane_reads_the_others_index_snapshot(layouts, tmp_path):
    torch_, jax = TorchPlane(layouts["grid4"]), JaxPlane()
    for writer, reader in ((torch_, jax), (jax, torch_)):
        d = snapshot_dir(writer, tmp_path / writer.name, cluster_nodes(writer))
        path = os.path.join(d, SNAP)
        mine = writer.statestore.read_snapshot_file(path)
        theirs = reader.statestore.read_snapshot_file(path)
        assert theirs == mine and mine[2] == "clean"
        assert mine[0]["v"] == INDEX_SNAPSHOT_VERSION
        assert sorted(mine[0]["nodes"]) == ["empty", "full", "mangled", "s0", "s1", "tight"]
    # The JAX extender's StateStore loads the port's directory as its own.
    res = JaxPlane.statestore.StateStore(str(tmp_path / "torch" / "snap"), name="index").load()
    assert res.status == "clean" and res.snapshot["nodes"]["tight"]["avail"] == 1


# ---------------------------------------------------------------------------
# memoized parsing, the watch short-circuit and storm coalescing
# ---------------------------------------------------------------------------


def test_unchanged_annotation_watch_event_short_circuits(plane):
    node = plane.node("n1")
    cache = fresh_cache(plane, [node])
    entry = cache.index.get("n1")
    m = plane.metrics
    rebuilds = m.INDEX_REBUILDS.get()
    avoided = m.PARSE_AVOIDED.get(reason="unchanged_annotation")
    echo = {"metadata": {"name": "n1", "annotations": dict(node["metadata"]["annotations"]),
                         "resourceVersion": "999"}}
    assert cache.apply_event("MODIFIED", echo) == "noop"
    assert cache.index.get("n1") is entry
    assert m.INDEX_REBUILDS.get() == rebuilds
    assert m.PARSE_AVOIDED.get(reason="unchanged_annotation") - avoided == 1


def test_derived_memo_serves_flip_flop_rebuilds(plane):
    idx = plane.index.TopologyIndex()
    idx.update("n1", plane.raw("n1"))
    first = idx.get("n1")
    idx.update("n1", plane.raw("n1", ()))
    hits = plane.metrics.PARSE_AVOIDED.get(reason="derived_memo")
    idx.update("n1", plane.raw("n1"))
    assert plane.metrics.PARSE_AVOIDED.get(reason="derived_memo") - hits == 1
    assert idx.get("n1") == first


def test_malformed_annotation_memoized_as_bad(plane):
    idx = plane.index.TopologyIndex()
    assert idx.update("x", "{not json") == "add"
    hits = plane.metrics.PARSE_AVOIDED.get(reason="derived_memo")
    assert idx.update("y", "{not json") == "add"
    assert plane.metrics.PARSE_AVOIDED.get(reason="derived_memo") - hits == 1
    assert idx.get("y").topo is None


def test_event_storm_coalesces_to_one_rebuild_per_node(plane):
    cache = plane.server.NodeAnnotationCache(ListClient([plane.node("n1")]), interval_s=3600,
                                             event_coalesce_s=30.0)
    cache.refresh()
    cache._applier_thread = threading.current_thread()  # the applier, without a thread
    m = plane.metrics
    rebuilds = m.INDEX_REBUILDS.get()
    coalesced = m.INDEX_EVENTS.get(source="watch", kind="coalesced")
    for p in ((0,), (), None, ()):
        cache.offer_event("MODIFIED", plane.node("n1", p))
    assert m.INDEX_REBUILDS.get() == rebuilds
    assert cache.flush_events() == 1
    assert m.INDEX_REBUILDS.get() - rebuilds == 1
    assert m.INDEX_EVENTS.get(source="watch", kind="coalesced") - coalesced == 3
    assert cache.index.get("n1").avail == 0


def test_coalescer_delete_then_add_lands_on_final_state(plane):
    cache = plane.server.NodeAnnotationCache(ListClient([plane.node("n1")]), interval_s=3600,
                                             event_coalesce_s=30.0)
    cache.refresh()
    cache._applier_thread = threading.current_thread()
    cache.offer_event("DELETED", {"metadata": {"name": "n1"}})
    cache.offer_event("ADDED", plane.node("n1", ()))
    cache.flush_events()
    assert cache.index.get("n1").avail == 0


# ---------------------------------------------------------------------------
# the warm pool and the readiness surface
# ---------------------------------------------------------------------------


def test_background_warm_pool_drains_deferred_entries(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(8)]
    d = snapshot_dir(plane, tmp_path, nodes)
    restored = restored_cache(plane, nodes, d, warm_workers=2)
    assert restored.index.warm_progress()["parsed"] == 0
    restored.start_warm()
    try:
        for t in restored._warm_threads:
            t.join(timeout=10)
        assert restored.index.warm_progress() == {"parsed": 8, "total": 8}
        assert plane.metrics.INDEX_WARM_SECONDS.get() > 0
        fresh = fresh_cache(plane, nodes)
        for n in nodes:
            name = n["metadata"]["name"]
            assert restored.index.get(name) == fresh.index.get(name)
    finally:
        restored._stop.set()


def test_warm_pool_starts_after_failed_initial_relist(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(6)]
    d = snapshot_dir(plane, tmp_path, nodes)

    class FlakyClient(ListClient):
        fail = True

        def list_nodes(self, label_selector=""):
            if self.fail:
                raise ConnectionError("apiserver down at start")
            return super().list_nodes(label_selector)

    plane.index.clear_derived_memo()
    client = FlakyClient(nodes)
    cache = plane.server.NodeAnnotationCache(client, interval_s=3600, snapshot_dir=d,
                                             warm_workers=2)
    assert cache.load_snapshot() > 0
    with pytest.raises(ConnectionError):
        cache.refresh()
    cache.start_warm()
    assert not cache._warm_threads
    client.fail = False
    cache.refresh()
    assert cache.index.warm_progress()["parsed"] == 0
    cache.start_warm()
    try:
        threads = list(cache._warm_threads)
        assert threads
        cache.start_warm()
        assert set(cache._warm_threads) <= set(threads)
        for t in threads:
            t.join(timeout=10)
        assert cache.index.warm_progress() == {"parsed": 6, "total": 6}
    finally:
        cache._stop.set()


def test_indexed_rpc_parse_avoided_excludes_on_demand_parses(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(4)]
    names = [n["metadata"]["name"] for n in nodes]
    d = snapshot_dir(plane, tmp_path, nodes)
    ext = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable(),
                                        node_cache=restored_cache(plane, nodes, d))
    before = plane.metrics.PARSE_AVOIDED.get(reason="indexed_rpc")
    assert ext.filter_names(pod(plane, 1), names) is not None
    assert plane.metrics.PARSE_AVOIDED.get(reason="indexed_rpc") == before
    assert ext.filter_names(pod(plane, 1), names) is not None
    assert plane.metrics.PARSE_AVOIDED.get(reason="indexed_rpc") - before == 4


def test_gang_capacity_view_materializes_deferred_entries(plane, tmp_path):
    nodes = [plane.node(f"n{i}") for i in range(3)]
    d = snapshot_dir(plane, tmp_path, nodes)
    restored = restored_cache(plane, nodes, d)
    assert restored.index.warm_progress()["parsed"] == 0
    topos = restored.index.topologies()
    assert len(topos) == 3 and all(len(t.available) == 4 for t in topos)
    assert restored.index.warm_progress()["parsed"] == 3


def test_ready_status_phases_and_http_surface(layouts):
    plane = TorchPlane(layouts["grid4"])
    idx = plane.index.TopologyIndex()
    raw = plane.raw("n1")
    idx.restore("n1", raw, {"avail": 4, "chips": 4, "host": "n1", "slice": None,
                            "placeable": [1, 2, 3, 4]}, h=plane.index.annotation_hash(raw))
    ready = threading.Event()
    status = ReadyStatus(ready, journal_configured=True, warm_progress=idx.warm_progress)
    srv = ExtenderHTTPServer(extender=TopologyExtender(
        reservations=plane.reservations.ReservationTable()), host="127.0.0.1",
        ready_check=ready.is_set, ready_status=status.snapshot)
    url = srv.start()
    try:
        r = requests.get(f"{url}/readyz", timeout=5)
        assert r.status_code == 503
        body = r.json()
        assert body["phase"] == "replaying" and "rehydrating" in body["reason"]
        assert body["warm"] == {"parsed": 0, "total": 1}
        r = requests.post(f"{url}/filter", json={}, timeout=5)
        assert r.status_code == 503 and r.json()["phase"] == "replaying"
        status.mark_replayed()
        body = requests.get(f"{url}/readyz", timeout=5).json()
        assert body["phase"] == "warming" and "warming" in body["reason"]
        idx.warm_remaining()
        status.mark_ready()
        r = requests.get(f"{url}/readyz", timeout=5)
        assert r.status_code == 200
        body = r.json()
        assert body["ok"] and body["phase"] == "ready"
        assert body["warm"] == {"parsed": 1, "total": 1}
        assert metrics.TIME_TO_READY.get() == body["time_to_ready_s"] >= 0
    finally:
        srv.stop()


def test_debug_readyz_surface_always_200():
    assert "/debug/readyz" in metrics.DEBUG_ENDPOINTS
    ready = threading.Event()
    status = ReadyStatus(ready, journal_configured=True)
    saved = metrics.READYZ_PROVIDER
    metrics.READYZ_PROVIDER = status.snapshot
    srv = ExtenderHTTPServer(host="127.0.0.1")
    url = srv.start()
    try:
        r = requests.get(f"{url}/debug/readyz", timeout=5)
        assert r.status_code == 200 and r.json()["phase"] == "replaying"
    finally:
        srv.stop()
        metrics.READYZ_PROVIDER = saved
    msrv = metrics.MetricsServer(host="127.0.0.1")
    murl = msrv.start()
    try:
        r = requests.get(f"{murl}/debug/readyz", timeout=5)
        assert r.status_code == 200 and r.json()["configured"] is False
    finally:
        msrv.stop()


def test_degraded_past_the_cap_pauses_serving():
    class Paused:
        paused = True
        staleness_cap_s = 60.0

        def staleness_s(self):
            return 75.0

        def snapshot(self):
            return {"paused": True}

    srv = ExtenderHTTPServer(host="127.0.0.1", degraded=Paused())
    url = srv.start()
    try:
        before = metrics.EXTENDER_REQUESTS.get(verb="filter", outcome="degraded_paused")
        r = requests.post(f"{url}/filter", json={}, timeout=5)
        assert r.status_code == 503 and "75s old (cap 60s)" in r.json()["error"]
        # The handler counts the request after it has answered.
        deadline = time.monotonic() + 5
        while (metrics.EXTENDER_REQUESTS.get(verb="filter", outcome="degraded_paused")
               == before and time.monotonic() < deadline):
            time.sleep(0.01)
        assert metrics.EXTENDER_REQUESTS.get(verb="filter", outcome="degraded_paused") == before + 1
    finally:
        srv.stop()


def test_cache_load_and_stop_write_through_the_snapshot_files(layouts, tmp_path):
    """start() loads before its first relist; stop() leaves the freshest
    state on disk for the successor."""
    plane = TorchPlane(layouts["grid4"])
    d = str(tmp_path / "s")
    client = ListClient([plane.node("n0")])
    cache = NodeAnnotationCache(client, interval_s=3600, snapshot_dir=d).start()
    cache.apply_event("ADDED", plane.node("n1", (3,)))
    cache.stop()
    data, seq, status = statestore.read_snapshot_file(os.path.join(d, SNAP))
    assert status == "clean" and seq == 0
    assert {k: v["avail"] for k, v in data["nodes"].items()} == {"n0": 4, "n1": 1}
