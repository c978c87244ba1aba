"""The port's manifests (deploy/nvidia-device-plugin-torch.yml,
deploy/pod-torch-smoke.yml, deploy/dra-example-torch.yml,
deploy/nvidia-extender-torch.yml), parsed with PyYAML and held to the code:
the DaemonSet's args to the port's ``parse_args``, its liveness probe to the
metrics port, its mounts to the daemon's default dirs, the smoke pod to the
port's resource and smoke module, the DRA example to the DRA driver's names,
and the ClusterRole to exactly the (API group, verb, resource) triples the
port's kube client was seen to send a fake API server, through the CLI
daemon's end to end run (tests/test_torch_e2e.py), one call of each client
method and the DRA plane's calls. The extender's manifest is held the same
way, after the JAX ``test_shipped_manifest_matches_served_protocol``: its
args to the extender's ``parse_args``, its probes, Service and scheduler
stanza to the paths the server routes, and its ClusterRole to the calls the
extender's process was seen to send.
"""

import importlib.util
import json
import re
import socket
import subprocess
import sys
import time
import urllib.parse
from pathlib import Path

import pytest
import requests
import yaml

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.discovery.chips import GpuChip
from k8s_device_plugin_tpu_torch.dra import slices
from k8s_device_plugin_tpu_torch.dra.driver import DraDriver
from k8s_device_plugin_tpu_torch.extender import __main__ as ext_main
from k8s_device_plugin_tpu_torch.kube.client import KubeClient
from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from tests.fake_apiserver import FakeApiServer
from tests.test_torch_e2e import system  # noqa: F401 - the e2e run's fixture
from tests.test_torch_e2e import test_full_lifecycle as full_lifecycle
from tests.torch_kube_planes import stop_in_background

ROOT = Path(__file__).resolve().parents[1]
DAEMONSET = ROOT / "deploy" / "nvidia-device-plugin-torch.yml"
SMOKE_POD = ROOT / "deploy" / "pod-torch-smoke.yml"
DRA_EXAMPLE = ROOT / "deploy" / "dra-example-torch.yml"
EXTENDER = ROOT / "deploy" / "nvidia-extender-torch.yml"


def docs(path):
    return {d["kind"]: d for d in yaml.safe_load_all(path.read_text())}


def container():
    (c,) = docs(DAEMONSET)["DaemonSet"]["spec"]["template"]["spec"]["containers"]
    return c


def test_daemonset_runs_the_port_with_args_its_parse_args_takes():
    c = container()
    assert c["command"] == ["python", "-m", "k8s_device_plugin_tpu_torch"]
    cfg = main.parse_args(c["args"])  # an unknown flag exits
    assert (cfg.metrics_port, cfg.telemetry_interval_s, cfg.audit_interval_s) == (2112, 10.0, 60.0)
    assert cfg.node_name == "$(NODE_NAME)"
    (env,) = [e for e in c["env"] if e["name"] == "NODE_NAME"]
    assert env["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName"


def test_liveness_probe_reads_healthz_on_the_metrics_port():
    c = container()
    probe = c["livenessProbe"]["httpGet"]
    port = main.parse_args(c["args"]).metrics_port
    assert probe == {"path": "/healthz", "port": port}
    assert [p["containerPort"] for p in c["ports"]] == [port]


def test_daemonset_mounts_the_kubelet_dirs_and_targets_nvidia_nodes():
    ds = docs(DAEMONSET)
    spec = ds["DaemonSet"]["spec"]["template"]["spec"]
    mounts = {m["mountPath"] for m in container()["volumeMounts"]}
    assert constants.DEVICE_PLUGIN_PATH.rstrip("/") in mounts
    assert str(Path(constants.POD_RESOURCES_SOCKET).parent) in mounts
    # The DRA plane's dirs (--dra) and the watcher registration's.
    cfg = main.parse_args([])
    for d in (cfg.plugins_dir, cfg.plugins_registry_dir, cfg.cdi_dir):
        assert d.rstrip("/") in mounts, d
    host = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"] if "hostPath" in v}
    for m in container()["volumeMounts"]:
        if m["name"] != "captures":  # the one emptyDir, held below
            assert host[m["name"]] == m["mountPath"]
    assert any(t["key"] == constants.RESOURCE_NAME for t in spec["tolerations"])
    assert all(k.startswith(constants.RESOURCE_NAME) for k in spec["nodeSelector"])
    account = ds["ServiceAccount"]["metadata"]
    assert spec["serviceAccountName"] == account["name"]
    binding = ds["ClusterRoleBinding"]
    assert binding["roleRef"]["name"] == ds["ClusterRole"]["metadata"]["name"]
    assert binding["subjects"] == [{"kind": "ServiceAccount", "name": account["name"],
                                    "namespace": account["namespace"]}]


def test_daemonset_keeps_its_evidence_on_the_captures_volume():
    """The profiler, the SLO capture and the black box as the JAX
    DaemonSet runs them, the capture bundles and the black box's segments
    on an emptyDir that outlives a container restart."""
    c = container()
    cfg = main.parse_args(c["args"])
    assert (cfg.profile_hz, cfg.capture_dir, cfg.capture_p99_ms, cfg.blackbox_dir) == (
        19.0, "/var/lib/tpu-plugin/captures", 250.0, "/var/lib/tpu-plugin/blackbox")
    jax = yaml.safe_load_all((ROOT / "deploy" / "tpu-device-plugin.yml").read_text())
    (jax_c,) = [d for d in jax if d and d["kind"] == "DaemonSet"][0][
        "spec"]["template"]["spec"]["containers"]
    for flag in ("--profile-hz=19", "--capture-dir=/var/lib/tpu-plugin/captures",
                 "--capture-p99-ms=250", "--blackbox-dir=/var/lib/tpu-plugin/blackbox"):
        assert flag in c["args"] and flag in jax_c["args"], flag
    (mount,) = [m for m in c["volumeMounts"] if m["name"] == "captures"]
    assert mount["mountPath"] == "/var/lib/tpu-plugin"
    for d in (cfg.capture_dir, cfg.blackbox_dir):
        assert Path(d).parent == Path(mount["mountPath"])
    spec = docs(DAEMONSET)["DaemonSet"]["spec"]["template"]["spec"]
    (vol,) = [v for v in spec["volumes"] if v["name"] == "captures"]
    assert vol == {"name": "captures", "emptyDir": {"sizeLimit": "256Mi"}}


def test_smoke_pod_requests_the_resource_and_runs_the_port_smoke():
    (c,) = docs(SMOKE_POD)["Pod"]["spec"]["containers"]
    assert c["resources"]["limits"] == {constants.RESOURCE_NAME: 1}
    assert c["command"][:2] == ["python", "-m"]
    assert c["command"][2] == "k8s_device_plugin_tpu_torch.workload.smoke"
    assert importlib.util.find_spec(c["command"][2]) is not None


def kube_call(method: str, raw_path: str):
    """(API group, verb, resource) of one recorded request, as RBAC names
    them; None for an API group's discovery document, which every
    authenticated user may read."""
    parsed = urllib.parse.urlparse(raw_path)
    parts = parsed.path.strip("/").split("/")
    if parts[0] == "api":
        group, parts = "", parts[2:]  # past "api/v1"
    elif len(parts) < 4:
        return None  # /apis/<group>[/<version>]: discovery
    else:
        group, parts = parts[1], parts[3:]  # past "apis/<group>/<version>"
    if parts[0] == "namespaces" and len(parts) > 2:
        parts = parts[2:]
    resource, rest = parts[0], parts[1:]
    if len(rest) > 1:
        resource += "/" + rest[1]
    if method == "GET":
        if rest:
            verb = "get"
        else:
            verb = "watch" if "watch=true" in parsed.query else "list"
    else:
        verb = {"POST": "create", "PATCH": "patch", "PUT": "update", "DELETE": "delete"}[method]
    return group, verb, resource


def kube_calls(requests) -> set:
    return {c for c in (kube_call(m, p) for m, p in requests) if c is not None}


def every_client_call(url: str) -> None:
    """One call of each of the port client's API methods, and the DRA
    plane's calls: its ResourceSlice made, read, replaced and deleted, a
    claim read and the claims listed (the legacy references' lookup)."""
    api_client = KubeClient(url)
    card = GpuChip(index=0, uuid="GPU-0", name="card", dev_path="/dev/nvidia0", pci_addr="",
                   numa_node=-1, chip_type="H100", hbm_bytes=1)
    dra = DraDriver(GpuDevicePlugin(LinkTopology([card], None)), kube_client=api_client,
                    node_name="n")
    dra.publish()
    dra.publish()
    assert dra._slice_exists()
    dra._resolve_missing_refs(["uid"])
    assert slices.get_resource_claim(api_client, "default", "c") is None
    dra.stop(unpublish=True)
    api_client.get_node("n")
    api_client.patch_node_annotations("n", {"a": "1"})
    api_client.patch_node_labels("n", {"l": "1"})
    api_client.patch_node_condition("n", {"type": "GPUsHealthy", "status": "True"})
    api_client.list_pods(node_name="n")
    for _ in api_client.watch_pods(node_name="n", timeout_seconds=1):
        pass
    api_client.get_pod("default", "p")
    api_client.patch_pod_annotations("default", "p", {"a": "1"})
    api_client.create_event("default", {"kind": "Pod", "name": "p", "namespace": "default"},
                            "GPUUnhealthy", "a card broke")
    api_client.evict_pod("default", "p")
    api_client.delete_pod("default", "p2")


def test_cluster_role_grants_exactly_what_the_client_sends(system):  # noqa: F811
    full_lifecycle(system)
    e2e = kube_calls(system["api"].requests)
    api = FakeApiServer()
    url = api.start()
    try:
        api.add_node("n")
        for name in ("p", "p2"):
            api.add_pod({"metadata": {"name": name, "namespace": "default", "uid": name},
                         "spec": {"nodeName": "n", "containers": []}, "status": {}})
        every_client_call(url)
        calls = kube_calls(api.requests)
    finally:
        stop_in_background(api)
    role = docs(DAEMONSET)["ClusterRole"]
    granted = set()
    for rule in role["rules"]:
        granted |= {(g, v, r) for g in rule["apiGroups"] for v in rule["verbs"]
                    for r in rule["resources"]}
    assert e2e <= granted, sorted(e2e - granted)
    assert granted == e2e | calls, (sorted(granted - e2e - calls), sorted(e2e | calls - granted))
    # The run exercises the controller's path: reconcile, evict, publish.
    assert {("", "patch", "pods"), ("", "create", "pods/eviction"), ("", "patch", "nodes"),
            ("", "patch", "nodes/status"), ("", "watch", "pods"), ("", "create", "events")} <= e2e
    # ... and the DRA plane's: its slice and claims in resource.k8s.io.
    assert {("resource.k8s.io", v, "resourceslices") for v in (
        "get", "create", "update", "delete")} | {("resource.k8s.io", v, "resourceclaims")
                                                 for v in ("get", "list")} <= calls


@pytest.mark.parametrize("path", [DAEMONSET, SMOKE_POD, DRA_EXAMPLE, EXTENDER],
                         ids=lambda p: p.name)
def test_manifests_name_no_tpu_resource(path):
    text = path.read_text()
    assert "google.com/tpu" not in text and "libtpu" not in text


def test_dra_example_names_the_drivers_devices():
    """The example's DeviceClass is the driver the daemon serves by default,
    its claim template asks that class for one card, its CEL names only
    attributes the ResourceSlice publishes, and its pod runs the port's
    smoke on the claim."""
    d = docs(DRA_EXAMPLE)
    name = d["DeviceClass"]["metadata"]["name"]
    assert name == slices.DEFAULT_DRIVER == main.parse_args([]).dra_driver_name
    (sel,) = d["DeviceClass"]["spec"]["selectors"]
    assert sel["cel"]["expression"] == f'device.driver == "{name}"'
    template = d["ResourceClaimTemplate"]
    (req,) = template["spec"]["spec"]["devices"]["requests"]
    assert req["exactly"] == {"deviceClassName": name, "count": 1}
    pod = d["Pod"]["spec"]
    (c,) = pod["containers"]
    assert c["command"] == ["python", "-m", "k8s_device_plugin_tpu_torch.workload.smoke"]
    (ref,) = pod["resourceClaims"]
    assert ref["resourceClaimTemplateName"] == template["metadata"]["name"]
    assert c["resources"]["claims"] == [{"name": ref["name"]}]
    card = GpuChip(index=0, uuid="GPU-0", name="card", dev_path="/dev/nvidia0", pci_addr="",
                   numa_node=0, chip_type="H100", hbm_bytes=1)
    attrs = slices.build_resource_slice(LinkTopology([card], None), "n")["spec"]["devices"][0][
        "attributes"]
    named = re.findall(rf'device\.attributes\["{re.escape(name)}"\]\.(\w+)',
                       DRA_EXAMPLE.read_text())
    assert named and set(named) <= set(attrs), named


# ---------------------------------------------------------------------------
# the scheduler extender's manifest
# ---------------------------------------------------------------------------


def extender_container():
    (c,) = docs(EXTENDER)["Deployment"]["spec"]["template"]["spec"]["containers"]
    return c


def test_extender_manifest_matches_the_served_protocol():
    d = docs(EXTENDER)
    assert set(d) == {"Deployment", "Service", "ConfigMap", "ServiceAccount", "ClusterRole",
                      "ClusterRoleBinding"}
    c = extender_container()
    assert c["command"] == ["python", "-m", "k8s_device_plugin_tpu_torch.extender"]
    a = ext_main.parse_args(c["args"])  # a flag it does not take exits
    port = c["ports"][0]["containerPort"]
    assert a.port == port == d["Service"]["spec"]["ports"][0]["port"]
    assert d["Service"]["spec"]["ports"][0]["targetPort"] == port
    assert a.node_cache and a.index_snapshot_dir == "/var/lib/nvidia-extender"
    assert c["livenessProbe"]["httpGet"] == {"path": "/healthz", "port": port}
    assert c["readinessProbe"]["httpGet"] == {"path": "/readyz", "port": port}
    mounts = {m["mountPath"] for m in c["volumeMounts"]}
    for path in (a.index_snapshot_dir, a.capture_dir, a.blackbox_dir):
        assert any(path == m or path.startswith(m + "/") for m in mounts), path
    spec = d["Deployment"]["spec"]["template"]["spec"]
    assert spec["serviceAccountName"] == d["ServiceAccount"]["metadata"]["name"]
    binding = d["ClusterRoleBinding"]
    assert binding["roleRef"]["name"] == d["ClusterRole"]["metadata"]["name"]
    assert binding["subjects"][0]["name"] == spec["serviceAccountName"]
    sched = yaml.safe_load(d["ConfigMap"]["data"]["config.yaml"])
    (ext,) = sched["extenders"]
    assert ext["urlPrefix"] == (f"http://{d['Service']['metadata']['name']}."
                                f"{d['Service']['metadata']['namespace']}:{port}")
    # The verbs are path segments under urlPrefix: the paths the server routes.
    assert (ext["filterVerb"], ext["prioritizeVerb"]) == ("filter", "prioritize")
    assert "preemptVerb" not in ext  # no preemption plane in this slice
    assert ext["managedResources"] == [{"name": constants.RESOURCE_NAME,
                                        "ignoredByScheduler": False}]
    assert ext["nodeCacheCapable"] is True and a.node_cache


def test_extender_manifest_paths_are_served(tmp_path):
    """The probe and verb paths the manifest names answer on a live server."""
    from k8s_device_plugin_tpu_torch.extender.server import ExtenderHTTPServer

    srv = ExtenderHTTPServer(host="127.0.0.1")
    url = srv.start()
    try:
        c = extender_container()
        for probe in ("livenessProbe", "readinessProbe"):
            path = c[probe]["httpGet"]["path"]
            assert requests.get(f"{url}{path}", timeout=5).status_code == 200
        sched = yaml.safe_load(docs(EXTENDER)["ConfigMap"]["data"]["config.yaml"])
        for verb in (sched["extenders"][0]["filterVerb"],
                     sched["extenders"][0]["prioritizeVerb"]):
            r = requests.post(f"{url}/{verb}", json={"pod": {}, "nodes": {"items": []}},
                              timeout=5)
            assert r.status_code == 200, verb
    finally:
        srv.stop()


def test_extender_cluster_role_grants_exactly_what_the_plane_calls(tmp_path):
    """The extender's process run as the manifest runs it, over a fake API
    server: its relist, its watch and the fetch of a node that joined after
    the relist are every call it sends, and all the role grants."""
    api = FakeApiServer()
    url = api.start()
    proc = None
    try:
        api.add_node("n1")
        kc = tmp_path / "kc.json"
        kc.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "c", "cluster": {"server": url}}],
            "users": [{"name": "u", "user": {}}],
            "contexts": [{"name": "x", "context": {"cluster": "c", "user": "u"}}],
            "current-context": "x"}))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        args = [a for a in extender_container()["args"]]
        args[args.index("--port") + 1] = str(port)
        for flag in ("--index-snapshot-dir", "--capture-dir", "--blackbox-dir"):
            args[args.index(flag) + 1] = str(tmp_path / flag.strip("-"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--host", "127.0.0.1",
             "--kubeconfig", str(kc), *args], cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 30
        while True:
            try:
                if requests.get(f"{base}/readyz", timeout=2).status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.1)
        api.add_node("late")  # joins between relists: one fetch by name
        pod = {"metadata": {"name": "p"}, "spec": {"containers": [{"name": "c", "resources": {
            "requests": {constants.RESOURCE_NAME: "1"}}}]}}
        r = requests.post(f"{base}/filter", json={"pod": pod, "nodenames": ["n1", "late"]},
                          timeout=10)
        assert r.status_code == 200
        deadline = time.time() + 10
        while time.time() < deadline and ("", "watch", "nodes") not in kube_calls(api.requests):
            time.sleep(0.1)
    finally:
        if proc is not None:
            proc.terminate()
            assert proc.wait(timeout=20) == 0
        stop_in_background(api)
    calls = kube_calls(api.requests)
    role = docs(EXTENDER)["ClusterRole"]
    granted = {(g, v, r) for rule in role["rules"] for g in rule["apiGroups"]
               for v in rule["verbs"] for r in rule["resources"]}
    assert calls == granted == {("", "get", "nodes"), ("", "list", "nodes"),
                                ("", "watch", "nodes")}
