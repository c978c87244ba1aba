"""The port's manifests (deploy/nvidia-device-plugin-torch.yml,
deploy/pod-torch-smoke.yml), parsed with PyYAML and held to the code: the
DaemonSet's args to the port's ``parse_args``, its liveness probe to the
metrics port, the smoke pod to the port's resource and smoke module, and
the ClusterRole to exactly the (verb, resource) pairs the port's kube
client was seen to send a fake API server, through the CLI daemon's end
to end run (tests/test_torch_e2e.py) and one call of each client method.
"""

import importlib.util
import urllib.parse
from pathlib import Path

import pytest
import yaml

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.kube.client import KubeClient
from k8s_device_plugin_tpu_torch.supervisor import main
from tests.fake_apiserver import FakeApiServer
from tests.test_torch_e2e import system  # noqa: F401 - the e2e run's fixture
from tests.test_torch_e2e import test_full_lifecycle as full_lifecycle
from tests.torch_kube_planes import stop_in_background

ROOT = Path(__file__).resolve().parents[1]
DAEMONSET = ROOT / "deploy" / "nvidia-device-plugin-torch.yml"
SMOKE_POD = ROOT / "deploy" / "pod-torch-smoke.yml"


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
    host = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"] if "hostPath" in v}
    for m in container()["volumeMounts"]:
        assert host[m["name"]] == m["mountPath"]
    assert any(t["key"] == constants.RESOURCE_NAME for t in spec["tolerations"])
    assert all(k.startswith(constants.RESOURCE_NAME) for k in spec["nodeSelector"])
    account = ds["ServiceAccount"]["metadata"]
    assert spec["serviceAccountName"] == account["name"]
    binding = ds["ClusterRoleBinding"]
    assert binding["roleRef"]["name"] == ds["ClusterRole"]["metadata"]["name"]
    assert binding["subjects"] == [{"kind": "ServiceAccount", "name": account["name"],
                                    "namespace": account["namespace"]}]


def test_smoke_pod_requests_the_resource_and_runs_the_port_smoke():
    (c,) = docs(SMOKE_POD)["Pod"]["spec"]["containers"]
    assert c["resources"]["limits"] == {constants.RESOURCE_NAME: 1}
    assert c["command"][:2] == ["python", "-m"]
    assert c["command"][2] == "k8s_device_plugin_tpu_torch.workload.smoke"
    assert importlib.util.find_spec(c["command"][2]) is not None


def kube_pair(method: str, raw_path: str) -> tuple:
    """(verb, resource) of one recorded request, as RBAC names them."""
    parsed = urllib.parse.urlparse(raw_path)
    parts = parsed.path.strip("/").split("/")[2:]  # past "api/v1"
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
    return verb, resource


def every_client_call(url: str) -> None:
    """One call of each of the port client's API methods."""
    api_client = KubeClient(url)
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
    e2e = {kube_pair(m, p) for m, p in system["api"].requests}
    api = FakeApiServer()
    url = api.start()
    try:
        api.add_node("n")
        for name in ("p", "p2"):
            api.add_pod({"metadata": {"name": name, "namespace": "default", "uid": name},
                         "spec": {"nodeName": "n", "containers": []}, "status": {}})
        every_client_call(url)
        calls = {kube_pair(m, p) for m, p in api.requests}
    finally:
        stop_in_background(api)
    role = docs(DAEMONSET)["ClusterRole"]
    granted = set()
    for rule in role["rules"]:
        assert rule["apiGroups"] == [""]
        granted |= {(v, r) for v in rule["verbs"] for r in rule["resources"]}
    assert e2e <= granted, sorted(e2e - granted)
    assert granted == e2e | calls, (sorted(granted - e2e - calls), sorted(e2e | calls - granted))
    # The run exercises the controller's path: reconcile, evict, publish.
    assert {("patch", "pods"), ("create", "pods/eviction"), ("patch", "nodes"),
            ("patch", "nodes/status"), ("watch", "pods"), ("create", "events")} <= e2e


@pytest.mark.parametrize("path", [DAEMONSET, SMOKE_POD], ids=lambda p: p.name)
def test_manifests_name_no_tpu_resource(path):
    text = path.read_text()
    assert "google.com/tpu" not in text and "libtpu" not in text
