"""The port's scheduler extender (extender/server.py, the filter/score plane)
against the JAX one.

The scenarios of the JAX ``tests/test_extender.py`` that hold on GPUs are
tests parametrised over the two planes of tests/torch_extender_planes.py:
``jax`` (a v5p host of 4 chips) and ``torch`` (4 H100s of the fake NVML
whose NVLinks join the v5p host's ICI pairs). Card i stands for chip i.
On these hosts both planes give the same filter verdict and reject token
for every availability pattern and every request size 1-8, and wherever
the JAX scores of two nodes differ the port orders them the same way.

The port's score is held to its formula by brute force on 8-card fake-NVML
layouts (HGX, every pair NV18; two PCIe islands): the best average pair
score of every n-set of the free cards, scaled to 8 (0 for one card), plus
2 when the request fills the node.

Four JAX scenarios have no port case, by the GPU gang model (a GPU node has
no multi-host slice): ``test_multi_host_insufficient_free_slice_hosts``,
``test_multi_host_adjacent_pair_outranks_non_adjacent``,
``test_multi_host_2x2_gang_scores_by_box`` and
``test_malformed_slice_annotation_never_crashes_scheduling``. A request
over several nodes is rejected on every node with the token a JAX host
without slice peers gets (``test_request_over_several_nodes_...`` below).
``test_shipped_manifest_matches_served_protocol`` and
``test_all_deploy_manifests_parse`` have their port cases in
tests/test_torch_manifests.py. No test here binds a unix socket.
"""

import itertools
import os
import random
import socket
import subprocess
import sys
import time

import pytest
import requests

from k8s_device_plugin_tpu_torch.extender import __main__ as ext_main
from k8s_device_plugin_tpu_torch.extender.reservations import ReservationTable
from k8s_device_plugin_tpu_torch.extender.server import (
    MAX_SCORE,
    NO_TOPOLOGY_MSG,
    ExtenderHTTPServer,
    NodeAnnotationCache,
    TopologyExtender,
)
from k8s_device_plugin_tpu_torch.topology import placement
from k8s_device_plugin_tpu_torch.topology.links import SCORE_MAX
from k8s_device_plugin_tpu_torch.topology.schema import NodeTopology, parse_topology_cached
from k8s_device_plugin_tpu_torch.utils import metrics, tracing
from k8s_device_plugin_tpu_torch.utils.decisions import LEDGER
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Pairs of 4-card nodes whose JAX scores differ while the port's order them
# otherwise, by request size: none on these hosts. A pair found here fails
# the test until it is named, with the decision recorded in ROADMAP.md.
KNOWN_ORDER_DISAGREEMENTS = {}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ext_nvml")
    return read_layouts(fk.FakeNvml(fk.build(root)), root)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    return JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])


@pytest.fixture
def http(plane):
    srv = plane.server.ExtenderHTTPServer(
        extender=plane.server.TopologyExtender(
            reservations=plane.reservations.ReservationTable()),
        host="127.0.0.1")
    url = srv.start()
    yield url
    srv.stop()


def post(url, path, body):
    resp = requests.post(f"{url}{path}", json=body, timeout=10)
    resp.raise_for_status()
    return resp.json()


def post_nodes(url, path, pod_, nodes, keycase="lower"):
    body = ({"pod": pod_, "nodes": {"items": nodes}} if keycase == "lower"
            else {"Pod": pod_, "Nodes": {"items": nodes}})
    return post(url, path, body)


def names_of(out):
    return [n["metadata"]["name"] for n in out["nodes"]["items"]]


# ---------------------------------------------------------------------------
# verdicts, tokens and order on the 4-card hosts, both planes
# ---------------------------------------------------------------------------


def _plane_tables(plane, n):
    """pattern -> (verdict, token, score) on ``plane`` for an n-card pod."""
    ext = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable())
    pats = patterns(4)
    nodes = [plane.node(pattern_name(p), p) for p in pats]
    passing, failed = ext.filter(pod(plane, n), nodes)
    passed = {node["metadata"]["name"] for node in passing}
    scores = {h["host"]: h["score"] for h in ext.prioritize(pod(plane, n), nodes)}
    out = {}
    for p in pats:
        name = pattern_name(p)
        topo = plane.schema.parse_topology_cached(plane.raw(name, p))
        rej = plane.reject(ext, n, topo, len(topo.available))
        assert (name in passed) == (rej is None), (name, rej)
        assert (name in failed) == (rej is not None)
        if rej is not None:
            assert failed[name] == rej[1]
        out[p] = (name in passed, rej and rej[0], scores[name])
    return out


@pytest.mark.parametrize("n", range(1, 9))
def test_filter_verdicts_and_reject_tokens_match_jax_for_every_pattern(layouts, n):
    jax = _plane_tables(JaxPlane(), n)
    torch_ = _plane_tables(TorchPlane(layouts["grid4"]), n)
    for p in patterns(4):
        assert jax[p][:2] == torch_[p][:2], (n, pattern_name(p), jax[p], torch_[p])
    if n > 4:
        # Over one node's cards: the JAX chain without its slice steps.
        want = "not_chip_multiple" if n % 4 else None
        for p in patterns(4):
            token = torch_[p][1]
            if want:
                assert token == want
            else:
                assert token == ("no_slice_peers" if len(p) == 4 else "host_not_whole_free")
            assert torch_[p][2] == 0


@pytest.mark.parametrize("n", range(1, 9))
def test_prioritize_orders_nodes_as_jax_does(layouts, n):
    jax = {p: v[2] for p, v in _plane_tables(JaxPlane(), n).items()}
    torch_ = {p: v[2] for p, v in _plane_tables(TorchPlane(layouts["grid4"]), n).items()}
    disagree = {(pattern_name(a), pattern_name(b))
                for a, b in itertools.permutations(patterns(4), 2)
                if jax[a] > jax[b] and not torch_[a] > torch_[b]}
    assert disagree == KNOWN_ORDER_DISAGREEMENTS.get(n, set()), disagree


# ---------------------------------------------------------------------------
# the GPU score against brute force
# ---------------------------------------------------------------------------


def _brute_force_score(topology, free, n):
    if n > len(topology.ids) or len(free) < n:
        return 0
    best = max(topology.set_score(s) if n >= 2 else 0.0
               for s in itertools.combinations(free, n))
    base = round((MAX_SCORE - 2) * best / SCORE_MAX) if n >= 2 else 0
    return min(base + (2 if len(free) == n else 0), MAX_SCORE)


@pytest.mark.parametrize("layout", ["hgx8", "islands8"])
@pytest.mark.parametrize("n", range(1, 9))
def test_score_is_the_best_average_pair_score_by_brute_force(layouts, layout, n):
    topology = layouts[layout]
    plane = TorchPlane(topology)
    ext = TopologyExtender(reservations=ReservationTable())
    rng = random.Random(1000 + n)
    pats = [tuple(range(8))] + [tuple(sorted(rng.sample(range(8), k)))
                                for k in range(n, 9) for _ in range(6)]
    for p in pats:
        topo = parse_topology_cached(plane.raw(f"{layout}-{pattern_name(p)}", p))
        free = [topology.ids[i] for i in p]
        terms = ext.score_terms(n, topo)
        assert terms["score"] == _brute_force_score(topology, free, n), (layout, n, p, terms)
        if n >= 2 and "term_set_score" in terms:
            best = max(topology.set_score(s) for s in itertools.combinations(free, n))
            assert terms["term_set_score"] == round(best, 3)


def test_islands_score_a_whole_island_above_a_set_across_them(layouts):
    """The JAX compact-block case on GPUs: four free cards of one PCIe
    island outscore four spread over both islands."""
    plane = TorchPlane(layouts["islands8"])
    ext = TopologyExtender(reservations=ReservationTable())
    block = plane.node("block", (0, 1, 2, 3, 4))
    spread = plane.node("spread", (0, 1, 4, 5, 6))
    scores = {h["host"]: h["score"] for h in ext.prioritize(pod(plane, 4), [block, spread])}
    assert scores["block"] > scores["spread"]


def test_packing_bonus_prefers_the_exact_fit_of_equal_links(layouts):
    """The JAX packing case: an exact fit outranks a roomier node. On GPUs
    it holds between nodes of equal link quality (HGX 4 against HGX 8); a
    4-card node of NV2 pairs scores below a free HGX 8 (5 < 8), since the
    set's pair score outweighs the bonus (ROADMAP.md, the GPU score)."""
    ext = TopologyExtender(reservations=ReservationTable())
    exact = TorchPlane(layouts["hgx4"]).node("exact")
    roomy = TorchPlane(layouts["hgx8"]).node("roomy")
    grid = TorchPlane(layouts["grid4"]).node("grid")
    scores = {h["host"]: h["score"]
              for h in ext.prioritize(pod(TorchPlane(layouts["hgx4"]), 4), [exact, roomy, grid])}
    assert scores == {"exact": 10, "roomy": 8, "grid": 5}


def test_score_zero_when_unsatisfiable(plane):
    ext = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable())
    topo = plane.schema.parse_topology_cached(plane.raw("n", (0,)))
    assert ext.score_node(4, topo) == 0


def test_score_terms_name_the_set(layouts):
    plane = TorchPlane(layouts["grid4"])
    ext = TopologyExtender(reservations=ReservationTable())
    topo = parse_topology_cached(plane.raw("n", (0, 1, 3)))
    # {0, 1} or {1, 3}: one NV2 pair (score 5).
    assert ext.score_terms(2, topo) == {
        "score": 4, "term_set_score": 5.0, "term_nvlink_pairs": 1, "term_base": 4,
        "term_packing": 0}
    assert ext.score_terms(1, parse_topology_cached(plane.raw("m", (2,))))["score"] == 2


# ---------------------------------------------------------------------------
# the JAX scenarios over HTTP, both planes
# ---------------------------------------------------------------------------


def test_filter_by_availability(plane, http):
    full = plane.node("full")
    partial = plane.node("partial", (0,))
    empty = plane.node("empty", ())
    bare = {"metadata": {"name": "cpu-node", "annotations": {}}}
    out = post_nodes(http, "/filter", pod(plane, 2), [full, partial, empty, bare])
    assert names_of(out) == ["full"]
    assert set(out["failedNodes"]) == {"partial", "empty", "cpu-node"}
    assert "available" in out["failedNodes"]["partial"]
    assert out["failedNodes"]["partial"].startswith("1 chips available, 2 needed")


def test_filter_passes_everything_for_a_pod_without_the_resource(plane, http):
    bare = {"metadata": {"name": "cpu-node", "annotations": {}}}
    plain = {"metadata": {"name": "p"}, "spec": {"containers": [{"name": "c"}]}}
    out = post_nodes(http, "/filter", plain, [plane.node("n1"), bare])
    assert len(out["nodes"]["items"]) == 2 and out["failedNodes"] == {}


def test_request_over_several_nodes_needs_whole_free_nodes_and_finds_no_peers(plane, http):
    """The JAX multi-host cases on standalone hosts: a busy node fails on
    its own free cards, a whole-free one for want of peers."""
    free, busy = plane.node("free-host"), plane.node("busy-host", (1, 2, 3))
    out = post_nodes(http, "/filter", pod(plane, 8), [free, busy])
    assert out["nodes"]["items"] == []
    assert "full" in out["failedNodes"]["busy-host"]
    peers = out["failedNodes"]["free-host"]
    if plane.name == "jax":
        assert "not part of a multi-host slice" in peers
    else:
        assert "no multi-node NVLink domain" in peers
    scores = post_nodes(http, "/prioritize", pod(plane, 8), [free, busy])
    assert [s["score"] for s in scores] == [0, 0]


def test_request_not_a_multiple_of_the_node_rejected(plane, http):
    out = post_nodes(http, "/filter", pod(plane, 6), [plane.node("h1")])
    assert out["nodes"]["items"] == []
    assert "multiple" in out["failedNodes"]["h1"]


def test_bad_annotation_fails_filter(plane, http):
    node = {"metadata": {"name": "corrupt",
                         "annotations": {plane.constants.TOPOLOGY_ANNOTATION: "{not json"}}}
    out = post_nodes(http, "/filter", pod(plane, 1), [node])
    assert "corrupt" in out["failedNodes"]
    assert post_nodes(http, "/prioritize", pod(plane, 1), [node]) == [
        {"host": "corrupt", "score": 0}]


def test_annotation_naming_an_unknown_card_is_malformed(layouts):
    plane = TorchPlane(layouts["grid4"])
    topo = NodeTopology.from_json(plane.raw("n"))
    topo.pairs[0].b = "GPU-not-on-this-node"
    node = {"metadata": {"name": "n", "annotations": {
        plane.constants.TOPOLOGY_ANNOTATION: topo.to_json()}}}
    passing, failed = TopologyExtender(reservations=ReservationTable()).filter(
        pod(plane, 1), [node])
    assert passing == [] and failed == {"n": NO_TOPOLOGY_MSG}


def test_healthz(plane, http):
    assert requests.get(f"{http}/healthz", timeout=5).json() == {"ok": True}


def test_go_cased_request_keys_accepted(plane, http):
    out = post_nodes(http, "/filter", pod(plane, 2), [plane.node("n1")], keycase="go")
    assert names_of(out) == ["n1"]


def test_preemption_and_drain_answer_as_without_their_planes(plane, http):
    for path, word in (("/preemption", "preemption"), ("/drain", "drain")):
        r = requests.post(f"{http}{path}", json={"pod": pod(plane, 1), "node": "n"}, timeout=5)
        assert r.status_code == 404
        assert r.json() == {"error": f"{word} not enabled"}
    r = requests.post(f"{http}/nope", json={}, timeout=5)
    assert r.status_code == 404


def test_reservations_endpoint_serves_the_table(plane):
    table = plane.reservations.ReservationTable()
    table.reserve(("default", "g"), {"n1": 2})
    srv = plane.server.ExtenderHTTPServer(
        extender=plane.server.TopologyExtender(reservations=table), host="127.0.0.1")
    url = srv.start()
    try:
        body = requests.get(f"{url}/reservations", timeout=5).json()
    finally:
        srv.stop()
    assert body["holder"] == ""
    (hold,) = body["holds"]
    assert (hold["namespace"], hold["gang"], hold["hosts"]) == ("default", "g", {"n1": 2})


def test_name_only_request_without_cache_is_an_error(plane, http):
    r = requests.post(f"{http}/filter", json={"pod": pod(plane, 1), "nodenames": ["n1"]},
                      timeout=5)
    assert r.status_code == 500
    assert "node cache" in r.json()["error"]


# ---------------------------------------------------------------------------
# messages: byte-equal over the object, name-only and fast paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("held", [0, 1])
def test_reject_messages_byte_equal_on_every_path(layouts, held):
    plane = TorchPlane(layouts["grid4"])
    nodes = [plane.node(pattern_name(p), p) for p in patterns(4)]
    nodes.append({"metadata": {"name": "bare"}})
    nodes.append({"metadata": {"name": "mangled", "annotations": {
        plane.constants.TOPOLOGY_ANNOTATION: "{not json"}}})
    names = [n["metadata"]["name"] for n in nodes]
    table = ReservationTable()
    if held:
        table.reserve(("default", "other"), {"a0123": 1, "a0": 1})
    cache = NodeAnnotationCache(ListClient(nodes), interval_s=3600)
    cache.refresh()
    ext_obj = TopologyExtender(reservations=table)
    ext_idx = TopologyExtender(reservations=table, node_cache=cache)
    for n in range(1, 9):
        p = pod(plane, n)
        passing, failed = ext_obj.filter(p, [dict(x) for x in nodes])
        fast = ext_idx._filter_names_fast(p, names)
        placement.force_scalar(True)
        try:
            assert ext_idx._filter_names_fast(p, names) is None
            slow = ext_idx.filter_names(p, names)
        finally:
            placement.force_scalar(False)
        want = ([x["metadata"]["name"] for x in passing], failed)
        assert slow == want, n
        if n <= 4:
            assert fast == want, n
        else:
            assert fast is None  # over one node's cards: the per-entry path owns it
        if held:
            assert any("reserved for a released gang" in m for m in failed.values())


# ---------------------------------------------------------------------------
# the node cache (nodeCacheCapable), both planes
# ---------------------------------------------------------------------------


def test_node_cache_name_only_requests_match_full_objects(plane):
    api = FakeApiServer()
    url = api.start()
    try:
        client = plane.KubeClient(url)
        free, busy = plane.node("n-free"), plane.node("n-busy", ())
        api.add_node("n-free", free)
        api.add_node("n-busy", busy)
        cache = plane.server.NodeAnnotationCache(client, interval_s=0.2).start()
        srv = plane.server.ExtenderHTTPServer(
            extender=plane.server.TopologyExtender(
                reservations=plane.reservations.ReservationTable(), node_cache=cache),
            host="127.0.0.1")
        base = srv.start()
        try:
            body = {"pod": pod(plane, 2), "nodenames": ["n-free", "n-busy", "n-ghost"]}
            r = post(base, "/filter", body)
            assert r["nodenames"] == ["n-free"] and r["nodes"] is None
            assert "n-busy" in r["failedNodes"]
            assert "topology" in r["failedNodes"]["n-ghost"]
            by_host = {s["host"]: s["score"] for s in post(base, "/prioritize", body)}
            assert by_host["n-free"] > 0 and by_host["n-busy"] == by_host["n-ghost"] == 0
            full = post_nodes(base, "/filter", pod(plane, 2), [free, busy])
            assert names_of(full) == ["n-free"]
            # The daemon republishes n-busy free; the cache catches up.
            api.add_node("n-busy", plane.node("n-busy"))
            deadline = time.time() + 5
            while time.time() < deadline:
                r2 = post(base, "/filter", body)
                if sorted(r2["nodenames"]) == ["n-busy", "n-free"]:
                    break
                time.sleep(0.1)
            assert sorted(r2["nodenames"]) == ["n-busy", "n-free"]
        finally:
            srv.stop()
            cache.stop()
    finally:
        stop_in_background(api)


def test_node_cache_negative_entries_avoid_per_rpc_fetches(plane):
    calls = {"list": 0, "get": 0}

    class StubClient:
        def list_nodes(self, label_selector=""):
            calls["list"] += 1
            return {"items": [{"metadata": {"name": "bare", "annotations": {}}}]}

        def get_node(self, name):
            calls["get"] += 1
            raise KeyError(name)

    cache = plane.server.NodeAnnotationCache(StubClient(), interval_s=3600)
    cache.refresh()
    for _ in range(5):
        assert cache.node_object("bare") is None
    assert calls["get"] == 0
    for _ in range(3):
        assert cache.node_object("ghost") is None
    assert calls["get"] == 1


class _DownClient:
    def __init__(self):
        self.gets = 0

    def list_nodes(self, label_selector=""):
        raise ConnectionError("apiserver down")

    def get_node(self, name):
        self.gets += 1
        raise ConnectionError("apiserver down")


def test_node_cache_start_survives_outage_and_never_fetch_storms(plane):
    client = _DownClient()
    errors = plane.metrics.NODE_CACHE_RELIST_ERRORS.get()
    cache = plane.server.NodeAnnotationCache(client, interval_s=3600).start()
    try:
        for i in range(50):
            assert cache.node_object(f"n{i}") is None
        assert client.gets == 0
    finally:
        cache.stop()
    assert plane.metrics.NODE_CACHE_RELIST_ERRORS.get() == errors + 1


def test_node_cache_refresh_prewarms_parse_cache(plane):
    node = plane.node("n1")

    class StubClient:
        def list_nodes(self, label_selector=""):
            return {"items": [node]}

    plane.schema._parse_template.cache_clear()
    plane.server.NodeAnnotationCache(StubClient(), interval_s=3600).refresh()
    info = plane.schema._parse_template.cache_info()
    assert info.currsize == 1
    plane.schema.parse_topology_cached(node["metadata"]["annotations"][
        plane.constants.TOPOLOGY_ANNOTATION])
    assert plane.schema._parse_template.cache_info().hits > info.hits


def test_node_cache_empty_relist_still_marks_synced(plane):
    node = plane.node("late-joiner")
    calls = {"get": 0}

    class EmptyThenGet:
        def list_nodes(self, label_selector=""):
            return {"items": []}

        def get_node(self, name):
            calls["get"] += 1
            return node

    cache = plane.server.NodeAnnotationCache(EmptyThenGet(), interval_s=3600)
    cache.refresh()
    assert cache.node_object("late-joiner") is not None and calls["get"] == 1


def test_node_cache_metrics(plane):
    node, bare = plane.node("n1"), {"metadata": {"name": "bare", "annotations": {}}}
    plane.server.NodeAnnotationCache(ListClient([node, bare]), interval_s=3600).refresh()
    m = plane.metrics
    assert m.NODE_CACHE_NODES.get(state="with_topology") == 1
    assert m.NODE_CACHE_NODES.get(state="without_topology") == 1
    assert m.NODE_CACHE_SYNCED.get() == 1


# ---------------------------------------------------------------------------
# the port's own surfaces
# ---------------------------------------------------------------------------


def test_filter_and_prioritize_join_one_trace(layouts):
    plane = TorchPlane(layouts["grid4"])
    ext = TopologyExtender(reservations=ReservationTable())
    tracing.enable(service="extender")
    try:
        tracing.COLLECTOR.clear()
        ext.filter(pod(plane, 1, name="traced"), [plane.node("n1")])
        ext.prioritize(pod(plane, 1, name="traced"), [plane.node("n1")])
        spans = [s for s in tracing.COLLECTOR.spans() if s["name"].startswith("extender.")]
    finally:
        tracing.disable()
        tracing.RECENT.clear()
    assert [s["name"] for s in spans] == ["extender.filter", "extender.prioritize"]
    assert spans[0]["trace_id"] == spans[1]["trace_id"]
    assert spans[1]["parent_span_id"] == spans[0]["span_id"]


def test_ledger_records_reject_tokens_and_score_terms(layouts):
    plane = TorchPlane(layouts["grid4"])
    ext = TopologyExtender(reservations=ReservationTable())
    was = LEDGER.enabled
    if not was:
        LEDGER.enable(service="extender")
    try:
        ext.filter(pod(plane, 2, name="led"), [plane.node("busy", (0,)), plane.node("free")])
        ext.prioritize(pod(plane, 2, name="led"), [plane.node("free")])
        recs = LEDGER.snapshot(pod="default/led")["records"]
    finally:
        if not was:
            LEDGER.disable()
    rejects = [r for r in recs if r["kind"] == "filter_reject"]
    assert [(r["node"], r["reason"]) for r in rejects] == [("busy", "insufficient_chips")]
    (pri,) = [r for r in recs if r["kind"] == "prioritize"]
    assert pri["attrs"]["best_term_set_score"] == "5.0"
    assert pri["attrs"]["best_term_nvlink_pairs"] == "1"


def test_extender_imports_no_torch_or_jax_in_a_fresh_process():
    code = ("import sys; import k8s_device_plugin_tpu_torch.extender.__main__; "
            "import k8s_device_plugin_tpu_torch.extender.server; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax') "
            "or m.startswith('k8s_device_plugin_tpu.') or m == 'k8s_device_plugin_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("flag", sorted(ext_main.UNPORTED_FLAGS))
def test_flags_of_planes_not_ported_are_refused_naming_their_slice(flag, capsys):
    with pytest.raises(SystemExit):
        ext_main.parse_args([flag])
    assert "comes with the slice of" in capsys.readouterr().err


def test_flags_take_the_jax_names_and_defaults():
    a = ext_main.parse_args([])
    assert (a.port, a.node_cache_interval_s, a.node_relist_backstop_s, a.index_warm_workers,
            a.node_event_coalesce_s, a.staleness_cap_s, a.blackbox_fsync_s) == (
        12346, 5.0, 300.0, 2, 0.25, 60.0, 2.0)
    assert not hasattr(a, "gang_admission")


def test_cli_serves_the_documented_paths_and_counts_them(layouts, tmp_path):
    """The entry point as the manifest runs it, over a fake API server:
    /readyz, name-only /filter and /prioritize, /metrics counting them,
    /debug/readyz, and SIGTERM exiting 0."""
    plane = TorchPlane(layouts["grid4"])
    api = FakeApiServer()
    url = api.start()
    api.add_node("n1", plane.node("n1"))
    kc = tmp_path / "kc.json"
    kc.write_text(('{"apiVersion": "v1", "kind": "Config", "clusters": [{"name": "c", '
                   '"cluster": {"server": "%s"}}], "users": [{"name": "u", "user": {}}], '
                   '"contexts": [{"name": "x", "context": {"cluster": "c", "user": "u"}}], '
                   '"current-context": "x"}') % url)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--host", "127.0.0.1",
         "--port", str(port), "--node-cache", "--kubeconfig", str(kc)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 30
        while True:
            try:
                r = requests.get(f"{base}/readyz", timeout=2)
                if r.status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.1)
        assert r.json()["phase"] == "ready" and r.json()["warm"] == {"parsed": 1, "total": 1}
        body = {"pod": pod(plane, 1), "nodenames": ["n1"]}
        assert post(base, "/filter", body)["nodenames"] == ["n1"]
        assert post(base, "/prioritize", body) == [{"host": "n1", "score": 0}]
        # The handler counts a request after it has answered it.
        deadline = time.time() + 5
        while True:
            text = requests.get(f"{base}/metrics", timeout=5).text
            if ('verb="prioritize"} 1' in text) or time.time() > deadline:
                break
            time.sleep(0.01)
        assert 'tpu_extender_requests_total{outcome="ok",verb="filter"} 1' in text
        assert 'tpu_extender_requests_total{outcome="ok",verb="prioritize"} 1' in text
        assert 'tpu_build_info{component="extender"' in text
        assert "tpu_plugin_" not in text
        assert requests.get(f"{base}/debug/readyz", timeout=5).json()["phase"] == "ready"
    finally:
        proc.terminate()
        rc = proc.wait(timeout=20)
        stop_in_background(api)
    assert rc == 0, proc.stdout.read().decode()[-2000:]
