"""The kube client and the pod controller under a hostile API server and
kubelet: the client and controller cases of the JAX ``tests/test_chaos.py``
(5xx storms, connection resets, hangs, truncated JSON, semantic errors,
the breaker, dropped watches and 410 resyncs, outage-queued annotation
patches, a kubelet mid-restart), each parametrised over the two planes of
tests/torch_kube_planes.py against the same fault-injecting
tests/fake_apiserver.FakeApiServer. The lease and extender cases come with
the scheduler extender.
"""

import time

import pytest

from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakePodResources
from tests.test_torch_controller import make_controller, wait_for, write_checkpoint
from tests.torch_kube_planes import NODE, make_plane, pod_dict, stop_in_background


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture(params=["jax", "torch"])
def plane(request, tmp_path):
    p = make_plane(request.param, tmp_path, lambda: request.getfixturevalue("fake"))
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


def fast_resilience(
    plane, max_attempts=3, deadline_s=2.0, threshold=5, reset_timeout_s=0.3,
    metrics_set=None,
):
    """Test-speed policy: millisecond backoff, sub-second deadlines."""
    rz = plane.resilience
    return rz.Resilience(
        policy=rz.RetryPolicy(
            max_attempts=max_attempts,
            base_delay_s=0.01,
            max_delay_s=0.05,
            deadline_s=deadline_s,
        ),
        breaker=rz.CircuitBreaker(
            failure_threshold=threshold, reset_timeout_s=reset_timeout_s
        ),
        metrics=metrics_set,
    )


# ---------------------------------------------------------------------------
# Resilience layer unit behavior against injected faults
# ---------------------------------------------------------------------------

def test_transient_5xx_is_retried_to_success(plane, api):
    server, client = api
    client.resilience = fast_resilience(plane)
    server.faults.add(kind="status", status=503, times=2)
    node = client.get_node(NODE)  # two 503s absorbed, third attempt lands
    assert node["metadata"]["name"] == NODE
    assert plane.metrics.KUBE_RETRIES.get(verb="GET") >= 2


def test_connection_reset_is_retried(plane, api):
    server, client = api
    client.resilience = fast_resilience(plane)
    server.faults.add(kind="reset", times=1)
    assert client.get_node(NODE)["metadata"]["name"] == NODE


def test_truncated_json_is_retried(plane, api):
    server, client = api
    client.resilience = fast_resilience(plane)
    server.faults.add(kind="truncate_json", times=1)
    pods = client.list_pods(node_name=NODE)
    assert pods["kind"] == "PodList"
    assert server.faults.count("truncate_json") == 1


def test_semantic_errors_pass_through_without_retry(plane, api):
    server, client = api
    client.resilience = fast_resilience(plane)
    before = plane.metrics.KUBE_RETRIES.get(verb="GET")
    with pytest.raises(plane.KubeError) as err:
        client.get_node("no-such-node")
    assert err.value.status_code == 404
    assert plane.metrics.KUBE_RETRIES.get(verb="GET") == before  # zero retries


def test_hang_is_bounded_by_deadline(plane, api):
    server, client = api
    client.timeout = 0.3  # per-attempt read timeout
    client.resilience = fast_resilience(plane, max_attempts=2, deadline_s=1.0)
    server.faults.add(kind="hang", delay_s=1.0, times=-1)
    t0 = time.monotonic()
    with pytest.raises(plane.resilience.UnavailableError):
        client.get_node(NODE)
    assert time.monotonic() - t0 < 3.0  # deadline, not attempts*hang


def test_5xx_storm_trips_and_recovers_circuit_breaker(plane, api):
    """Acceptance: a 5xx storm opens the breaker (fail-fast, visible in
    metrics) and the half-open probe closes it once the storm ends."""
    server, client = api
    res = fast_resilience(plane, max_attempts=2, threshold=3, reset_timeout_s=0.3)
    client.resilience = res
    server.faults.add(kind="status", status=500, times=-1)
    for _ in range(4):
        with pytest.raises(OSError):
            client.get_node(NODE)
        if res.breaker.state == plane.resilience.OPEN:
            break
    assert res.breaker.state == plane.resilience.OPEN
    assert "tpu_plugin_kube_circuit_state 1" in plane.metrics.REGISTRY.render()
    # Open circuit: fail fast without touching the network.
    injected_before = server.faults.count()
    with pytest.raises(plane.resilience.CircuitOpenError):
        client.get_node(NODE)
    assert server.faults.count() == injected_before
    # Storm ends; after the reset timeout the half-open probe closes it.
    server.faults.clear()
    time.sleep(0.35)
    assert client.get_node(NODE)["metadata"]["name"] == NODE
    assert res.breaker.state == plane.resilience.CLOSED
    assert "tpu_plugin_kube_circuit_state 0" in plane.metrics.REGISTRY.render()
    assert plane.metrics.KUBE_RETRIES.get(verb="GET") > 0


def test_all_client_calls_flow_through_resilience(plane, api):
    """Acceptance: no raw unretried request site remains in
    kube/client.py — every HTTP request the session sends must happen
    inside Resilience.call (thread-local marker)."""
    server, client = api
    server.add_pod(pod_dict(plane, "p1", "u1", cards=1))
    server.add_pod(pod_dict(plane, "p2", "u2", cards=1))
    orig = client._session.request
    raw_sites = []

    def spy(method, url, **kw):
        if not plane.resilience.in_resilient_call():
            raw_sites.append((method, url))
        return orig(method, url, **kw)

    client._session.request = spy
    # Every public request-making method on the plane's KubeClient:
    called = {"get_node", "patch_node_annotations", "patch_node_labels",
              "patch_node_condition", "list_pods", "get_pod", "patch_pod_annotations",
              "create_event", "evict_pod", "create", "get", "delete", "watch_pods",
              "patch", "replace"}
    client.get_node(NODE)
    client.patch_node_annotations(NODE, {"k": "v"})
    client.patch_node_labels(NODE, {"l": "v"})
    client.patch_node_condition(NODE, {"type": "T", "status": "True"})
    client.list_pods(node_name=NODE)
    client.get_pod("default", "p1")
    client.patch_pod_annotations("default", "p1", {"a": "1"})
    client.create_event("default", {"kind": "Pod", "name": "p1"}, "R", "m")
    client.evict_pod("default", "p1")
    client.create(
        "/apis/coordination.k8s.io/v1/namespaces/ns/leases",
        {"metadata": {"name": "l", "namespace": "ns"}, "spec": {}},
    )
    lease = client.get("/apis/coordination.k8s.io/v1/namespaces/ns/leases/l")
    client.replace("/apis/coordination.k8s.io/v1/namespaces/ns/leases/l", lease)
    # The extender's node calls, which both clients have.
    client.list_nodes()
    client.list_nodes(label_selector="a=b")
    # Fleet discovery's lease list, which both clients have.
    client.list_leases(namespace="ns")
    # The preemption plane's PriorityClass listing, which both clients have.
    client.list_priority_classes()
    for _ in client.watch_nodes(timeout_seconds=1):
        break
    # Gang admission's gate removal, which both clients have.
    server.pods[("default", "p2")]["spec"]["schedulingGates"] = [{"name": "g"}]
    client.remove_pod_scheduling_gate("default", "p2", "g", [{"name": "g"}])
    # The rescue plane's cordon and maintenance taint, which both clients have.
    client.set_node_unschedulable(NODE, True)
    client.set_node_taint(NODE, "tpu.google.com/maintenance", value="drain")
    client.set_node_taint(NODE, "tpu.google.com/maintenance", remove=True)
    if plane.name == "torch":
        client.delete_pod("default", "p2")
        called |= {"delete_pod", "list_nodes", "watch_nodes", "remove_pod_scheduling_gate",
                   "list_leases", "list_priority_classes", "set_node_unschedulable",
                   "set_node_taint"}
        public = {n for n in dir(client) if not n.startswith("_") and callable(getattr(client, n))}
        assert public - called == {"from_env", "from_kubeconfig", "in_cluster",
                                   "interrupt_watches"}
    with pytest.raises(plane.KubeError):
        client.delete("/apis/resource.k8s.io/v1/resourceslices/none")
    for _ in client.watch_pods(node_name=NODE, timeout_seconds=1):
        break
    assert not raw_sites, f"raw unretried request sites: {raw_sites}"


# ---------------------------------------------------------------------------
# Controller chaos: watch drops, 410 resync, outage-queued patches
# ---------------------------------------------------------------------------

def test_watch_drop_and_410_resync_converge_controller(plane, api, plugin, tmp_path):
    """Acceptance: dropped watch streams plus a stale-resourceVersion
    (410) resync converge the controller — the pod annotation lands and
    the daemon never crash-loops."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    ctrl.client.resilience = fast_resilience(plane)
    ctrl.resync_interval_s = 1.0
    ctrl._watch_backoff = plane.resilience.Backoff(base=0.05, max_delay=0.2)
    server.faults.add(kind="watch_drop", times=2)
    server.faults.add(kind="watch_410", times=1)
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches, timeout=10)
        ns, name, body = server.pod_patches[0]
        assert (ns, name) == ("default", "jax-pod")
        got = body["metadata"]["annotations"][
            plane.constants.POD_DEVICES_ANNOTATION
        ]
        assert got == ",".join(sorted(ids[:2]))
        # The faults actually fired (the convergence wasn't a clean
        # run). The counts can trail the patch: each dropped stream
        # now resumes with a brief pause instead of reconnecting hot,
        # so the later watch attempts — including the one the 410
        # rule hits — may land after the annotation already converged.
        assert wait_for(
            lambda: server.faults.count("watch_drop") == 2, timeout=10
        )
        assert wait_for(
            lambda: server.faults.count("watch_410") == 1, timeout=10
        )
    finally:
        ctrl.stop()


def test_outage_queues_pod_annotation_and_drains_on_reconnect(plane, api, plugin, tmp_path):
    """Acceptance: no pod annotation is lost. While every PATCH answers
    503, the computed annotation parks in the pending-write queue
    (visible in the gauge); once the apiserver recovers, the next relist
    drains it."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    ctrl.client.resilience = fast_resilience(plane, max_attempts=2, threshold=100)
    ctrl.resync_interval_s = 0.5
    server.faults.add(kind="status", status=503, times=-1, method="PATCH")
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl.start()
    try:
        assert wait_for(lambda: len(ctrl._pending_writes) == 1, timeout=10)
        assert plane.metrics.KUBE_QUEUED_WRITES.get() == 1
        assert not server.pod_patches  # nothing landed during the outage
        # Local state proceeded: the kubelet already handed chips over.
        assert set(ids[:2]).issubset(plugin.state.allocated)
        server.faults.clear()  # apiserver recovers
        assert wait_for(lambda: server.pod_patches, timeout=10)
        _, _, body = server.pod_patches[0]
        got = body["metadata"]["annotations"][
            plane.constants.POD_DEVICES_ANNOTATION
        ]
        assert got == ",".join(sorted(ids[:2]))
        assert wait_for(lambda: len(ctrl._pending_writes) == 0, timeout=5)
        assert plane.metrics.KUBE_QUEUED_WRITES.get() == 0
    finally:
        ctrl.stop()


def test_controller_survives_apiserver_outage_at_start(plane, api, plugin, tmp_path):
    """The daemon must not crash-loop when it boots into an outage:
    start() succeeds with every request answered 500, and the informer
    converges once the apiserver comes back."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    ctrl.client.resilience = fast_resilience(plane, max_attempts=2, threshold=100)
    ctrl.resync_interval_s = 0.5
    ctrl._watch_backoff = plane.resilience.Backoff(base=0.05, max_delay=0.2)
    server.faults.add(kind="status", status=500, times=-1)
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl.start()  # must not raise despite the storm
    try:
        time.sleep(0.3)
        server.faults.clear()
        assert wait_for(lambda: server.pod_patches, timeout=10)
    finally:
        ctrl.stop()


def test_kubelet_podresources_transient_failure_converges(plane, api, plugin, tmp_path):
    """A kubelet mid-restart (PodResources RPCs transiently UNAVAILABLE)
    degrades to the checkpoint file and later resyncs converge."""
    ids = plane.ids(plugin)
    server, client = api
    podres = FakePodResources(
        str(tmp_path / "pod-resources" / "kubelet.sock")
    )
    podres.fail_times = 3  # every early RPC aborts, then recovery
    podres.set_pod("default", "jax-pod", plane.resource, ids[:2])
    podres.start()
    path = write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl = plane.Controller(
        client, plugin, node_name=NODE, checkpoint_path=path,
        podresources_socket=podres.socket_path, watch_timeout_s=2,
        resync_interval_s=0.5,
    )
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    ctrl.start()
    try:
        assert wait_for(lambda: server.pod_patches, timeout=10)
        got = server.pod_patches[0][2]["metadata"]["annotations"][
            plane.constants.POD_DEVICES_ANNOTATION
        ]
        assert got == ",".join(sorted(ids[:2]))
    finally:
        ctrl.stop()
        podres.stop()


# ---------------------------------------------------------------------------
# Pending writes
# ---------------------------------------------------------------------------

def test_queued_annotation_not_stamped_on_reincarnated_pod(plane, api, plugin, tmp_path):
    """A patch queued during an outage belongs to one pod INCARNATION:
    if the pod is deleted and recreated under the same namespace/name
    while the apiserver is unreachable (the DELETED event lost with the
    dropped watch), the drain must DROP the stale write instead of
    stamping the old incarnation's chips onto the new pod."""
    ids = plane.ids(plugin)
    ctrl, server = make_controller(plane, api, plugin, tmp_path)
    ctrl.client.resilience = fast_resilience(plane, max_attempts=2, threshold=100)
    ctrl.resync_interval_s = 0.5
    server.faults.add(kind="status", status=503, times=-1, method="PATCH")
    server.add_pod(pod_dict(plane, "jax-pod", "uid-1", cards=2))
    write_checkpoint(plane, tmp_path, {"uid-1": ids[:2]})
    ctrl.start()
    try:
        assert wait_for(lambda: len(ctrl._pending_writes) == 1, timeout=10)
        # The pod is replaced under the same name mid-outage (a
        # StatefulSet recreation the watch never saw).
        with server._lock:
            server.pods[("default", "jax-pod")]["metadata"]["uid"] = "uid-2"
        server.faults.clear()
        # The drain (after the next relist) drops the entry on the uid
        # mismatch — and nothing ever patches uid-1's chips onto uid-2.
        assert wait_for(lambda: len(ctrl._pending_writes) == 0, timeout=10)
        assert not server.pod_patches
    finally:
        ctrl.stop()


def test_pending_writes_drain_preserves_newer_entry_queued_mid_drain(plane):
    """'Newest wins' must hold ACROSS a drain: a write re-queued for
    the same key while drain() delivers the older snapshot must survive
    (unconditional post-deliver discard would silently drop it)."""
    pw = plane.resilience.PendingWrites()
    delivered = []

    def new_fn():
        delivered.append("new")

    def old_fn():
        # While the drain delivers the old value, the workqueue thread
        # queues a NEWER value for the same key.
        pw.put("k", new_fn, "new")
        delivered.append("old")

    pw.put("k", old_fn, "old")
    pw.drain()
    assert delivered == ["old"]
    assert len(pw) == 1, "newer write queued mid-drain was lost"
    pw.drain()
    assert delivered == ["old", "new"]
    assert len(pw) == 0


def test_pending_writes_drop_for_vanished_target(plane, api):
    """A queued write whose target is gone (404 at drain) is dropped,
    not retried forever — the queue cannot wedge."""
    server, client = api
    client.resilience = fast_resilience(plane)
    pw = plane.resilience.PendingWrites()
    pw.put(
        ("pod-ann", "default", "ghost"),
        lambda: client.patch_pod_annotations("default", "ghost", {"a": "1"}),
    )
    delivered, kept = pw.drain()
    assert delivered == 0 and kept == 0


# ---------------------------------------------------------------------------
# The port client's declared dependencies (torch plane only: the JAX client
# reads watches with iter_lines and declares nothing)
# ---------------------------------------------------------------------------


def test_port_client_refuses_a_urllib3_without_read1():
    """The port's watch reads with ``HTTPResponse.read1``; a urllib3 before
    2.0 has none and is refused by name, never left to fail each watch."""
    import urllib3

    from k8s_device_plugin_tpu_torch.kube import client

    client.require_read1()  # the urllib3 installed here
    assert hasattr(urllib3.response.HTTPResponse, "read1")
    with pytest.raises(ImportError, match=r"urllib3>=2"):
        client.require_read1(type("HTTPResponse", (), {}))


def test_requirements_name_every_third_party_import():
    """``requirements.txt`` names the distribution of every third-party
    module the port imports, and pins the urllib3 the watch needs."""
    import ast
    import pathlib
    import re
    import sys

    pkg = pathlib.Path(__file__).resolve().parent.parent / "k8s_device_plugin_tpu_torch"
    reqs = {}
    for line in (pkg / "requirements.txt").read_text().splitlines():
        line = line.split("#")[0].strip()
        if line:
            name, spec = re.match(r"([A-Za-z0-9_.-]+)(.*)", line).groups()
            reqs[name.lower()] = spec.strip()
    distribution = {"google": "protobuf", "grpc": "grpcio", "yaml": "pyyaml"}
    imported = set()
    for f in pkg.rglob("*.py"):
        for n in ast.walk(ast.parse(f.read_text())):
            if isinstance(n, ast.Import):
                imported |= {a.name.split(".")[0] for a in n.names}
            elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
                imported.add(n.module.split(".")[0])
    third_party = {m for m in imported
                   if m not in sys.stdlib_module_names and m != "k8s_device_plugin_tpu_torch"}
    assert {"grpc", "requests", "urllib3", "yaml", "torch"} <= third_party
    missing = {distribution.get(m, m) for m in third_party} - set(reqs)
    assert not missing, missing
    assert reqs["urllib3"] == ">=2"
