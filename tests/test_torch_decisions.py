"""The decision ledger and its producers over both planes: the JAX
``tests/test_decisions.py``.

The ledger's ring, query, retrace and gang tag; the one reject-reason
builder of /filter on the object and the indexed paths; /prioritize's top-k
record with the winner's terms; the per-RPC reject cap; the capacity pool's
shortfall diagnosis; the gang-waiting record once per state; the admission
record and its SLO histogram; the release with the planes off; the
pending-gang Event; /debug/decisions on both HTTP servers; and the whole
decision chain of a starved gang under one trace id, from the gang's wait
to the controller's reconcile. Each runs on the JAX plane (v5e hosts of 4
chips, the JAX ``scale_bench._node``) and the port's (4-card H100 hosts of
the fake NVML, tests/torch_extender_planes.py), each plane's modules
throughout.

Where the planes differ by design, each is held to its own: a demand larger
than every node is ``no_matching_slice`` on JAX and the furthest step of the
port's multi-node chain (``no_slice_peers``, PR 15's GPU gang model) on the
port; the pending Event is ``TPUGangPending`` / ``GPUGangPending``; the
prioritize record's winner terms are the JAX score's (``term_links``) and the
port's (``term_nvlink_pairs``).

``test_decisions_doc_in_lockstep_with_code`` holds the port's recorded kinds
to the port's README (the JAX test reads the JAX docs through the registry
lint). ``test_ledger_overhead_probe_schema_and_restore`` runs each plane's
scale bench, and each plane's admitters are served by its own bench's
in-memory client. ``test_explain_cli_self_test``,
``test_explain_cli_node_and_gang_views`` and ``test_explain_renders_full_chain``
are in tests/test_torch_tools.py.
"""

import dataclasses
import importlib
import json
import os
import re
import shutil
import tempfile
import time

import pytest
import requests

from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.torch_extender_planes import JaxPlane, TorchPlane, gang_pod, read_layouts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "tpu-node-1"


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("dec_nvml")))
    yield f
    f.reset()


@pytest.fixture(scope="module")
def layouts(fake, tmp_path_factory):
    return read_layouts(fake, tmp_path_factory.mktemp("dec_layouts"))


def mod(plane, name):
    """The plane's own module ``name`` (e.g. ``utils.decisions``)."""
    return importlib.import_module(plane.metrics.__name__.rsplit(".", 2)[0] + "." + name)


@pytest.fixture(params=["jax", "torch"])
def plane(request, layouts):
    p = JaxPlane() if request.param == "jax" else TorchPlane(layouts["grid4"])
    p.LEDGER = mod(p, "utils.decisions").LEDGER
    p.DecisionLedger = mod(p, "utils.decisions").DecisionLedger
    p.RECORDER = mod(p, "utils.flightrecorder").RECORDER
    p.tracing = mod(p, "utils.tracing")
    p.pending_reason = "TPUGangPending" if p.name == "jax" else "GPUGangPending"
    return p


@pytest.fixture
def ledger(plane):
    """The plane's process ledger, bare-enabled and cleared after: the
    tier-1 suite shares one process."""
    led = plane.LEDGER
    led.clear()
    led.enabled = True
    try:
        yield led
    finally:
        led.disable()
        led.clear()


@pytest.fixture
def traced(plane):
    tr = plane.tracing
    collector = tr.SpanCollector()
    saved = tr.COLLECTOR
    tr.COLLECTOR = collector
    tr.RECENT.clear()
    tr.enable(service="test")
    try:
        yield collector
    finally:
        tr.disable()
        tr.COLLECTOR = saved
        tr.RECENT.clear()


def node(plane, name):
    """A whole node: the JAX ``scale_bench._node`` (v5e, 4 chips), or the
    port's 4-card host."""
    if plane.name == "jax":
        return mod(plane, "extender.scale_bench")._node(name)
    return plane.node(name)


def starve(plane, node_obj, keep):
    ann = plane.constants.TOPOLOGY_ANNOTATION
    topo = plane.schema.NodeTopology.from_json(node_obj["metadata"]["annotations"][ann])
    starved = dataclasses.replace(topo, available=topo.available[:keep])
    return {"metadata": {"name": topo.hostname, "annotations": {ann: starved.to_json()}}}


def plain_pod(plane, n):
    return {"metadata": {"name": "bench", "namespace": "default"},
            "spec": {"containers": [{"name": "main",
                                     "resources": {"requests": {plane.resource: str(n)}}}]}}


def stub(plane, nodes, pods):
    """The plane's own scale bench's in-memory client."""
    return mod(plane, "extender.scale_bench")._StubClient(nodes, pods)


# -- the ledger --------------------------------------------------------------


def test_ledger_disabled_is_noop(plane):
    led = plane.DecisionLedger(capacity=4)
    led.record("filter_reject", "no_topology", "nope", node="n1")
    assert len(led) == 0
    assert led.snapshot()["records"] == []


def test_ledger_ring_overflow_keeps_newest_and_flight_records(plane):
    rec = plane.RECORDER
    rec.clear()
    rec.enabled = True
    try:
        led = plane.DecisionLedger(capacity=3)
        led.enabled = True
        for i in range(8):
            led.record("filter", "ok", f"r{i}", pod=f"d/p{i}")
        snap = led.snapshot()
        assert len(snap["records"]) == 3
        assert snap["dropped"] == 5
        assert [r["message"] for r in snap["records"]] == ["r5", "r6", "r7"]
        kinds = [e["kind"] for e in rec.snapshot()["events"]]
        assert kinds.count("decision_overflow") == 1  # the first drop only
    finally:
        rec.enabled = False
        rec.clear()


def test_ledger_query_filters_and_limit(plane, ledger):
    ledger.record("filter_reject", "no_topology", "m", pod="ns/p1", gang="ns/g1", node="n1")
    ledger.record("filter_reject", "insufficient_chips", "m", pod="ns/p2", node="n2")
    ledger.record("gang_waiting", "capacity", "m", gang="ns/g1")
    ledger.record("gang_admitted", "admitted", "m", gang="ns/g1")
    assert len(ledger.query(pod="p1")) == 1
    assert len(ledger.query(pod="ns/p1")) == 1
    assert len(ledger.query(gang="g1")) == 3
    assert len(ledger.query(node="n2")) == 1
    assert len(ledger.query(kind="gang_waiting")) == 1
    assert ledger.query(pod="p999") == []
    assert [r["kind"] for r in ledger.query(gang="g1", limit=1)] == ["gang_admitted"]


def test_ledger_records_trace_context_retrace_and_tag_gang(plane, ledger, traced):
    with plane.tracing.span("plugin.Allocate", service="plugin") as sp:
        ledger.record("allocate_substitution", "substituted", "m")
        provisional = sp.trace_id
    ledger.record("gang_waiting", "capacity", "m", gang="ns/g")  # no span
    assert ledger.query(kind="allocate_substitution")[0]["trace_id"] == provisional
    assert "trace_id" not in ledger.query(kind="gang_waiting")[0]
    assert ledger.retrace(provisional, "ab" * 16) == 1
    rec = ledger.query(kind="allocate_substitution")[0]
    assert rec["trace_id"] == "ab" * 16
    assert rec["attrs"]["retraced_from"] == provisional
    assert ledger.tag_gang("ns/g", "cd" * 16, "12" * 8) == 1
    assert ledger.query(kind="gang_waiting")[0]["trace_id"] == "cd" * 16
    assert ledger.query(kind="allocate_substitution")[0]["trace_id"] == "ab" * 16


# -- /filter's reasons and /prioritize's record ------------------------------


def test_reject_reasons_identical_on_object_and_indexed_paths(plane, ledger):
    """The one reason builder serves both paths: the same failed-node
    messages and the same ledger tokens across no topology, no free card,
    some free cards, and a request over several nodes, with a reservation
    note mixed in."""
    nodes = [node(plane, "full-free"), starve(plane, node(plane, "starved"), 1),
             starve(plane, node(plane, "empty"), 0), {"metadata": {"name": "no-topo"}},
             node(plane, "reserved-node")]
    names = [n["metadata"].get("name", "") for n in nodes]
    table = plane.reservations.ReservationTable()
    table.reserve(("default", "other-gang"), {"reserved-node": 3}, demands=(3,))
    for n_chips in (2, 8):
        ext_obj = plane.server.TopologyExtender(reservations=table)
        cache = plane.server.NodeAnnotationCache(stub(plane, nodes, []), interval_s=3600)
        cache.refresh()
        ext_idx = plane.server.TopologyExtender(reservations=table, node_cache=cache)
        p = plain_pod(plane, n_chips)
        ledger.clear()
        passing_obj, failed_obj = ext_obj.filter(p, nodes)
        codes_obj = {r["node"]: r["reason"] for r in ledger.query(kind="filter_reject")}
        ledger.clear()
        fast = ext_idx.filter_names(p, names)
        assert fast is not None
        passing_idx, failed_idx = fast
        codes_idx = {r["node"]: r["reason"] for r in ledger.query(kind="filter_reject")}
        assert failed_obj == failed_idx, f"messages drifted at n={n_chips}"
        assert codes_obj == codes_idx, f"reason codes drifted at n={n_chips}"
        assert [n["metadata"].get("name") for n in passing_obj] == passing_idx
        if n_chips == 2:
            assert codes_obj["empty"] == "insufficient_chips"
            assert "reserved for a released gang" in failed_obj["reserved-node"]
        assert codes_obj["no-topo"] == "no_topology"


def test_prioritize_records_top_k_with_term_breakdown(plane, ledger):
    nodes = [node(plane, f"n{i}") for i in range(3)]
    names = [f"n{i}" for i in range(3)]
    cache = plane.server.NodeAnnotationCache(stub(plane, nodes, []), interval_s=3600)
    cache.refresh()
    ext = plane.server.TopologyExtender(reservations=plane.reservations.ReservationTable(),
                                        node_cache=cache)
    p = plain_pod(plane, 2)
    assert ext.prioritize_names(p, names) is not None
    (rec,) = ledger.query(kind="prioritize")
    assert rec["attrs"]["candidates"] == "3"
    assert rec["attrs"]["path"] == "indexed"
    assert "=" in rec["attrs"]["top"]
    assert "best_score" in rec["attrs"]
    # The winner's terms: the JAX score's ICI links, the port's NVLink pairs.
    assert ("best_term_links" if plane.name == "jax" else "best_term_nvlink_pairs") in rec["attrs"]
    ext.prioritize(p, nodes)
    assert any(r["attrs"]["path"] == "object" for r in ledger.query(kind="prioritize"))


def test_filter_reject_records_capped_per_rpc(plane, ledger):
    ext_cls = plane.server.TopologyExtender
    n = ext_cls._MAX_REJECT_RECORDS + 20
    ext = ext_cls(reservations=plane.reservations.ReservationTable())
    ext.filter(plain_pod(plane, 1), [{"metadata": {"name": f"bare-{i}"}} for i in range(n)])
    assert len(ledger.query(kind="filter_reject")) == ext_cls._MAX_REJECT_RECORDS
    (summary,) = ledger.query(kind="filter")
    assert summary["reason"] == "all_rejected"
    assert summary["attrs"]["rejects_truncated"] == "20"


# -- the gang's waiting state ------------------------------------------------


def test_capacity_pool_diagnoses_single_host_shortfall(plane):
    ann = plane.constants.TOPOLOGY_ANNOTATION
    topo = plane.schema.NodeTopology.from_json(node(plane, "n1")["metadata"]["annotations"][ann])
    starved = dataclasses.replace(topo, available=topo.available[:1])
    pool = plane.gang._CapacityPool([starved])
    assert pool.fits([2, 2]) is None
    diag = pool.last_reject
    assert diag["blocking"] == "single_host"
    assert diag["best_free_chips"] == 1
    assert diag["shortfall_chips"] == 1
    # A demand of 8 over 4-chip (4-card) nodes.
    pool = plane.gang._CapacityPool([topo])
    assert pool.fits([8]) is None
    assert pool.last_reject["blocking"] == (
        "no_matching_slice" if plane.name == "jax" else "no_slice_peers")


def test_gang_waiting_record_once_per_state_and_on_demand_edit(plane, ledger):
    nodes = [starve(plane, node(plane, "n1"), 1)]
    pods = [gang_pod(plane, f"w{i}", "g", 2, 2) for i in range(2)]
    adm = plane.gang.GangAdmission(stub(plane, nodes, pods),
                                   reservations=plane.reservations.ReservationTable())
    assert adm.tick() == []
    assert adm.tick() == []
    waits = ledger.query(kind="gang_waiting")
    assert len(waits) == 1  # once per state, not per resync
    assert waits[0]["attrs"]["shortfall_chips"] == "1"
    assert "short 1" in waits[0]["message"]
    # The demand is edited in place: a new record, the marker replaced.
    for p in pods:
        p["spec"]["containers"][0]["resources"]["requests"][plane.resource] = "3"
        adm.note_pod_event(p)
    assert adm.tick() == []
    assert len(ledger.query(kind="gang_waiting")) == 2
    assert len(adm._waiting_reported) == 1
    assert adm._waiting_reported[("default", "g")] == (3, 3)


def test_gang_admitted_clears_waiting_and_observes_slo(plane, ledger):
    nodes = [starve(plane, node(plane, "n1"), 1)]
    pods = [gang_pod(plane, f"w{i}", "g", 2, 2) for i in range(2)]
    client = stub(plane, nodes, pods)
    adm = plane.gang.GangAdmission(client, reservations=plane.reservations.ReservationTable())
    before = plane.metrics.GANG_TIME_TO_ADMIT.count()
    assert adm.tick() == []
    client.nodes[:] = [node(plane, "n1")]  # capacity arrives
    assert adm.tick() == [("default", "g")]
    assert plane.metrics.GANG_TIME_TO_ADMIT.count() == before + 1
    (admit,) = ledger.query(kind="gang_admitted")
    assert admit["attrs"]["hosts"] == "n1=4"
    assert "waited_s" in admit["attrs"]
    assert adm._waiting_reported == {}
    assert adm._waiting_since == {}
    for p in pods:
        assert plane.constants.ADMIT_TS_ANNOTATION in p["metadata"]["annotations"]


def test_release_with_plane_off_makes_no_extra_patch(plane):
    """With tracing and the ledger off (the default), a release costs the
    gate patches alone: no admission-stamp patch per pod."""
    assert not plane.LEDGER.enabled and not plane.tracing.enabled()
    pods = [gang_pod(plane, f"off-w{i}", "off-g", 2, 2) for i in range(2)]
    client = stub(plane, [node(plane, "n1")], pods)
    patches = []
    client.patch_pod_annotations = lambda ns, name, ann: patches.append((ns, name, ann))
    adm = plane.gang.GangAdmission(client, reservations=plane.reservations.ReservationTable())
    assert adm.tick() == [("default", "off-g")]
    assert patches == []
    for p in pods:
        assert plane.constants.ADMIT_TS_ANNOTATION not in (p["metadata"].get("annotations") or {})


# -- the pending-gang Event --------------------------------------------------


@pytest.fixture
def api(plane):
    s = FakeApiServer()
    url = s.start()
    s.add_node(NODE)
    yield s, plane.KubeClient(url)
    s.stop()


def test_pending_gang_event_posted_deduped_and_budgeted(plane, api, ledger):
    server, client = api
    server.add_node(NODE, starve(plane, node(plane, NODE), 1))
    for i in range(2):
        p = gang_pod(plane, f"pend-w{i}", "pend", 2, 2)
        p["metadata"]["uid"] = f"uid-pend-{i}"
        server.add_pod(p)
    adm = plane.gang.GangAdmission(client, reservations=plane.reservations.ReservationTable(),
                                   pending_event_threshold_s=0.01, pending_event_repost_s=30.0)
    rec = plane.RECORDER
    rec.clear()
    rec.enabled = True
    try:
        assert adm.tick() == []  # starts the wait clock: too young
        assert not server.events
        time.sleep(0.05)
        assert adm.tick() == []  # past the threshold: one Event a member
        assert len(server.events) == 2
        ev = server.events[0]
        assert ev["reason"] == plane.pending_reason
        assert ev["type"] == "Warning"
        assert ev["involvedObject"]["kind"] == "Pod"
        assert re.search(r"waiting for (TPU|GPU) capacity", ev["message"])
        assert "short 1" in ev["message"]
        assert adm.tick() == []  # inside the repost window: deduped
        assert len(server.events) == 2
        assert "slo_breach" in [e["kind"] for e in rec.snapshot()["events"]]
        assert ledger.query(kind="slo_breach")
    finally:
        rec.enabled = False
        rec.clear()


# -- /debug/decisions --------------------------------------------------------


def test_debug_decisions_on_both_servers(plane, ledger):
    ledger.record("filter_reject", "no_topology", "m", pod="d/p1", node="n1")
    ledger.record("gang_waiting", "capacity", "m", gang="d/g1")
    for srv in (plane.metrics.MetricsServer(host="127.0.0.1"),
                plane.server.ExtenderHTTPServer(host="127.0.0.1")):
        url = srv.start()
        try:
            doc = requests.get(f"{url}/debug/decisions", timeout=5).json()
            assert len(doc["records"]) == 2
            assert doc["dropped"] == 0
            by_pod = requests.get(f"{url}/debug/decisions?pod=p1", timeout=5).json()
            assert [r["kind"] for r in by_pod["records"]] == ["filter_reject"]
            by_kind = requests.get(f"{url}/debug/decisions?kind=gang_waiting", timeout=5).json()
            assert len(by_kind["records"]) == 1
            assert len(requests.get(f"{url}/debug/decisions?limit=1",
                                    timeout=5).json()["records"]) == 1
            assert requests.get(f"{url}/debug/decisions?node=nope",
                                timeout=5).json()["records"] == []
        finally:
            srv.stop()


# -- the whole chain ---------------------------------------------------------


class _DaemonPlane:
    """The node side of the chain: each plane's plugin, controller and
    explain CLI over a 4-card host."""

    def __init__(self, plane, root, fake):
        self.plane = plane
        self.info = None
        if plane.name == "jax":
            from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
            from tests import fakes

            accel, dev = fakes.make_fake_tpu_node(str(root), "v5e", 4)
            self.chips = PyTpuInfo().scan(accel, dev)
        else:
            from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
            from tests.torch_kube_planes import EDGES

            fake.reset()
            sysfs, self.dev = os.path.join(str(root), "sys"), os.path.join(str(root), "dev")
            fk.grid_node(fake, sysfs, 4, EDGES)
            self.info = NvmlInfo(fake.path)
            self.chips = self.info.scan(sysfs, self.dev)

    def make_plugin(self, dp_dir, substitute=True):
        if self.plane.name == "jax":
            from k8s_device_plugin_tpu.server.plugin import PluginConfig, TpuDevicePlugin
            from k8s_device_plugin_tpu.topology.mesh import IciMesh

            p = TpuDevicePlugin(IciMesh(self.chips),
                                config=PluginConfig(libtpu_host_path="", device_plugin_dir=dp_dir,
                                                    substitute_on_allocate=substitute))
            return p, p.mesh.ids
        from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin, PluginConfig
        from k8s_device_plugin_tpu_torch.topology.links import LinkTopology

        p = GpuDevicePlugin(LinkTopology(self.chips, self.info),
                            config=PluginConfig(
                                device_plugin_dir=dp_dir, substitute_on_allocate=substitute,
                                extra_device_paths=(os.path.join(self.dev, "nvidiactl"),)))
        return p, p.topology.ids

    def close(self):
        if self.info is not None:
            self.info.close()


def test_e2e_decision_chain_one_trace(plane, api, ledger, traced, fake, tmp_path):
    """A starved gang's whole chain — gang_waiting with its shortfall, the
    admission, the pod's filter rejection, the plugin's Allocate
    substitution and the controller's reconcile — lands in the plane's
    ledger under one trace id, the SLO histograms observe both legs, and the
    plane's explain CLI renders it."""
    from tests.fake_kubelet import FakeKubelet, FakePodResources

    server, client = api
    pbm = mod(plane, "api.deviceplugin_pb2")
    Controller = mod(plane, "controller.controller").Controller
    explain_cli = mod(plane, "tools.explain")
    tr = plane.tracing
    full_node = node(plane, NODE)
    server.add_node(NODE, starve(plane, full_node, 1))
    for i in range(2):
        p = gang_pod(plane, f"chain-w{i}", "chain-gang", 2, 2)
        p["metadata"]["uid"] = f"uid-chain-{i}"
        server.add_pod(p)
    table = plane.reservations.ReservationTable()
    adm = plane.gang.GangAdmission(client, reservations=table)
    # 1) Starved: the gang waits, its shortfall recorded.
    assert adm.tick() == []
    (wait,) = ledger.query(kind="gang_waiting")
    assert wait["attrs"]["shortfall_chips"] == "1"
    # 2) Capacity arrives: admitted, and the wait joins the admission trace.
    server.add_node(NODE, full_node)
    before_admit = plane.metrics.GANG_TIME_TO_ADMIT.count()
    assert adm.tick() == [("default", "chain-gang")]
    assert plane.metrics.GANG_TIME_TO_ADMIT.count() == before_admit + 1
    live = client.get_pod("default", "chain-w0")
    carrier = tr.extract(live)
    assert carrier is not None
    trace_id = carrier.trace_id
    assert plane.constants.ADMIT_TS_ANNOTATION in live["metadata"]["annotations"]
    assert ledger.query(kind="gang_waiting")[0]["trace_id"] == trace_id
    assert ledger.query(kind="gang_admitted")[0]["trace_id"] == trace_id
    # 3) The scheduler filters the released pod: a topology-less candidate
    #    is rejected in the pod's trace.
    ext = plane.server.TopologyExtender(reservations=table)
    passing, failed = ext.filter(live, [server.nodes[NODE], {"metadata": {"name": "no-topo"}}])
    assert [p["metadata"]["name"] for p in passing] == [NODE]
    assert "no-topo" in failed
    (reject,) = ledger.query(kind="filter_reject")
    assert reject["trace_id"] == trace_id and reject["node"] == "no-topo"
    assert ext.prioritize(live, [server.nodes[NODE]])
    # 4) The kubelet's Allocate in substitution mode, under a provisional
    #    trace until the controller adopts it.
    short = tempfile.mkdtemp(prefix="dec", dir="/tmp")
    dp_dir = os.path.join(short, "dp")
    os.makedirs(dp_dir)
    kubelet = FakeKubelet(dp_dir)
    kubelet.start()
    podres = FakePodResources(os.path.join(short, "podres.sock"))
    podres.start()
    daemon = _DaemonPlane(plane, tmp_path, fake)
    plugin = None
    try:
        plugin, ids = daemon.make_plugin(dp_dir)
        plugin.serve()
        assert kubelet.registered.wait(10)
        kubelet_ids = [ids[0], ids[3]]
        req = pbm.AllocateRequest()
        req.container_requests.add(devicesIDs=kubelet_ids)
        kubelet.plugin_stub().Allocate(req)
        (sub,) = ledger.query(kind="allocate_substitution")
        assert sub["trace_id"] != trace_id
        # 5) Bind and reconcile: the controller adopts the Allocate span and
        #    retraces its records; the allocation SLO leg is observed.
        live["spec"]["nodeName"] = NODE
        server.update_pod(live)
        podres.set_pod("default", "chain-w0", plane.resource, kubelet_ids)
        controller = Controller(client, plugin, node_name=NODE,
                                checkpoint_path=str(tmp_path / "no-checkpoint"),
                                podresources_socket=podres.socket_path)
        before_alloc = plane.metrics.POD_TIME_TO_ALLOCATE.count()
        controller._handle_update(client.get_pod("default", "chain-w0"))
        assert plane.metrics.POD_TIME_TO_ALLOCATE.count() == before_alloc + 1
        (sub,) = ledger.query(kind="allocate_substitution")
        assert sub["trace_id"] == trace_id
        (rec,) = ledger.query(kind="reconcile")
        assert rec["trace_id"] == trace_id
        assert "time_to_allocate_s" in rec["attrs"]
        assert {"filter_reject", "filter", "prioritize", "gang_waiting", "gang_admitted",
                "allocate_substitution", "reconcile"} <= {
                    r["kind"] for r in ledger.query(trace_id=trace_id)}
        # 6) The explain CLI renders the chain from the artifacts.
        dec_path = tmp_path / "decisions.json"
        dec_path.write_text(json.dumps(ledger.snapshot()))
        tr_path = tmp_path / "traces.json"
        tr_path.write_text(json.dumps(traced.otlp_json()))
        assert explain_cli.main(["--pod", "chain-w0", "--decisions", str(dec_path),
                                 "--traces", str(tr_path)]) == 0
    finally:
        if plugin is not None:
            plugin.stop()
        podres.stop()
        kubelet.stop()
        daemon.close()
        shutil.rmtree(short, ignore_errors=True)


# -- bench probe ---------------------------------------------------------------


def test_ledger_overhead_probe_schema_and_restore(plane):
    """The plane's ledger-overhead probe at toy scale: both arms measured,
    records collected in the enabled arm only, and the process ledger
    disabled and cleared afterwards (the tier-1 suite shares one
    process)."""
    r = mod(plane, "extender.scale_bench").ledger_overhead(n_nodes=30, filter_calls=4)
    assert r["nodes"] == 30
    assert r["disabled"]["filter"]["samples"] == 4
    assert r["enabled"]["filter"]["samples"] == 4
    # One filter summary and one prioritize record per enabled call.
    assert r["records_collected"] == 8
    assert "filter_p99_overhead_pct" in r
    assert not plane.LEDGER.enabled
    assert len(plane.LEDGER) == 0


# -- the docs ------------------------------------------------------------------


def test_decisions_doc_in_lockstep_with_code():
    """Every decision kind the port's code records (its ``LEDGER.record``
    call sites) is named in the port's README, with /debug/decisions and
    the admission-stamp annotation: a renamed kind breaks this test, not
    the doc. The JAX test reads the JAX docs through the registry lint."""
    pkg = os.path.join(REPO, "k8s_device_plugin_tpu_torch")
    kinds = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                kinds |= set(re.findall(r"LEDGER\.record\(\s*\"([a-z_]+)\"", src))
    assert {"filter_reject", "gang_waiting", "gang_admitted", "reconcile"} <= kinds, kinds
    readme = open(os.path.join(REPO, "README.md")).read()
    missing = sorted(k for k in kinds if f"`{k}`" not in readme)
    assert not missing, f"decision kinds the README does not name: {missing}"
    assert "/debug/decisions" in readme
    constants = importlib.import_module("k8s_device_plugin_tpu_torch.api.constants")
    assert constants.ADMIT_TS_ANNOTATION in readme
