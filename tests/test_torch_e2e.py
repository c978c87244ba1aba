"""The port's node daemon end to end: the twin of the JAX
``tests/test_e2e.py``. ``python -m k8s_device_plugin_tpu_torch`` runs as
its own process over the fake NVML (tests/fake_nvml.c, first on
``LD_LIBRARY_PATH``, four H100s scripted through ``FAKE_NVML_SCRIPT``),
against a fake kubelet (gRPC) and a fake API server (HTTP), and is driven
through register → ListAndWatch → GetPreferredAllocation → Allocate →
reconciliation from the kubelet checkpoint → the live republish → a
hardware XID (appended to the script's XID file) → Unhealthy,
``GPUUnhealthy``, ``GPUsHealthy`` False and the holding pod evicted → the
pod's delete frees the cards → SIGTERM exiting 0; and a restart that
rebuilds the allocation from the checkpoint. A hardware XID withdraws its
card until the daemon restarts, so the broken card does not come back.
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time

import pytest

from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakeKubelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "gpu-node-1"


def wait_for(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return False


@pytest.fixture
def system(tmp_path):
    dp_dir = tmp_path / "dp"
    dp_dir.mkdir()
    lib = fk.build(tmp_path)
    script = fk.NodeScript()
    uuids = fk.hgx_node(script, tmp_path / "sys", 4)
    xids = tmp_path / "xids.txt"
    xids.write_text("")
    script.xid_file(xids)
    api = FakeApiServer()
    url = api.start()
    api.add_node(NODE)
    # JSON is a subset of YAML: the kube config as the card run writes it.
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "cl", "user": "u"}}],
        "clusters": [{"name": "cl", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    kubelet = FakeKubelet(str(dp_dir))
    kubelet.start()
    env = dict(os.environ, FAKE_NVML_SCRIPT=script.write(tmp_path / "node.txt"),
               LD_LIBRARY_PATH=os.pathsep.join(
                   [os.path.dirname(lib)]
                   + [p for p in [os.environ.get("LD_LIBRARY_PATH")] if p]))
    argv = [
        sys.executable, "-m", "k8s_device_plugin_tpu_torch",
        "--device-plugin-dir", str(dp_dir),
        "--sysfs-pci-dir", str(tmp_path / "sys"),
        "--dev-dir", str(tmp_path / "dev"),
        "--node-name", NODE,
        "--kubeconfig", str(kubeconfig),
        "--health-interval", "0.2",
        "--resync-interval", "1",
        "--podresources-socket", "",
        "--metrics-port", "0",
    ]
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    # Drain the daemon's output so it can't block on a full pipe buffer;
    # keep it for diagnostics on failure.
    daemon_log: list = []
    threading.Thread(target=lambda: daemon_log.extend(iter(proc.stdout.readline, b"")),
                     daemon=True).start()
    procs = [proc]
    try:
        yield {"proc": proc, "procs": procs, "argv": argv, "env": env, "api": api,
               "kubelet": kubelet, "dp_dir": str(dp_dir), "uuids": uuids, "xids": xids,
               "daemon_log": daemon_log}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        proc.stdout.close()
        kubelet.stop()
        api.stop()


def annotation(api):
    raw = api.nodes[NODE]["metadata"].get("annotations", {}).get(constants.TOPOLOGY_ANNOTATION)
    return json.loads(raw) if raw else None


def condition(api):
    conds = (api.nodes[NODE].get("status") or {}).get("conditions") or []
    return next((c for c in conds if c["type"] == "GPUsHealthy"), None)


def write_checkpoint(dp_dir, uid, ids):
    with open(os.path.join(dp_dir, "kubelet_internal_checkpoint"), "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [
            {"PodUID": uid, "ContainerName": "m", "ResourceName": constants.RESOURCE_NAME,
             "DeviceIDs": ids}], "RegisteredDevices": {}}, "Checksum": 1}, f)


def gpu_pod(name, uid, n):
    return {
        "metadata": {"name": name, "namespace": "default", "uid": uid, "annotations": {}},
        "spec": {"nodeName": NODE, "containers": [
            {"name": "m", "resources": {"requests": {constants.RESOURCE_NAME: str(n)}}}]},
        "status": {"phase": "Running"},
    }


def test_full_lifecycle(system):
    proc, api, kubelet = system["proc"], system["api"], system["kubelet"]
    uuids = system["uuids"]

    # 1. Registration and the device list.
    assert kubelet.registered.wait(20), b"".join(system["daemon_log"])[-3000:]
    stub = kubelet.plugin_stub()
    out: queue.Queue = queue.Queue()
    stop = threading.Event()

    def recv():
        try:
            for r in stub.ListAndWatch(pb.Empty()):
                out.put(r)
                if stop.is_set():
                    break
        except Exception:
            pass

    threading.Thread(target=recv, daemon=True).start()
    first = out.get(timeout=10)
    ids = [d.ID for d in first.devices]
    assert sorted(ids) == sorted(uuids)

    # 2. The topology published with every card available, the labels and
    # the condition.
    assert wait_for(lambda: annotation(api) is not None)
    assert sorted(annotation(api)["available"]) == sorted(uuids)
    assert annotation(api)["product"] == fk.H100
    assert len(annotation(api)["pairs"]) == 6
    # The labels are the publish's next patch after the annotation.
    assert wait_for(lambda: api.nodes[NODE]["metadata"].get("labels") == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3", "nvidia.com/gpu.count": "4"})
    assert wait_for(lambda: condition(api) is not None)
    assert condition(api)["status"] == "True"

    # 3. Preferred allocation and Allocate.
    req = pb.PreferredAllocationRequest()
    req.container_requests.add(available_deviceIDs=ids, allocation_size=4)
    pref = list(stub.GetPreferredAllocation(req).container_responses[0].deviceIDs)
    areq = pb.AllocateRequest()
    areq.container_requests.add(devicesIDs=pref)
    cresp = stub.Allocate(areq).container_responses[0]
    assert cresp.envs[constants.NVIDIA_VISIBLE_DEVICES] == ",".join(pref)

    # 4. Availability republished as empty.
    assert wait_for(lambda: annotation(api)["available"] == [])

    # 5. The controller reconciles the kubelet checkpoint onto the pod.
    api.add_pod(gpu_pod("torch-pod", "uid-1", 4))
    write_checkpoint(system["dp_dir"], "uid-1", pref)
    assert wait_for(lambda: api.pod_patches)
    _, _, body = api.pod_patches[0]
    patched = body["metadata"]["annotations"][constants.POD_DEVICES_ANNOTATION]
    assert sorted(patched.split(",")) == sorted(pref)

    # 6. A hardware XID on one card (NVML index 1) → Unhealthy
    # re-advertised, the node's Event and condition, and the holding pod
    # evicted.
    bad = uuids[1]
    with open(system["xids"], "a") as f:
        f.write("1 79\n")
    resp = out.get(timeout=10)
    assert {d.ID: d.health for d in resp.devices}[bad] == constants.UNHEALTHY
    assert wait_for(lambda: any(e["reason"] == "GPUUnhealthy"
                                and e["involvedObject"]["kind"] == "Node" for e in api.events))
    assert wait_for(lambda: condition(api)["status"] == "False")
    assert bad in condition(api)["message"]
    assert wait_for(lambda: ("default", "torch-pod") in api.evictions)
    assert any(e["reason"] == "GPUUnhealthy" and e["involvedObject"]["kind"] == "Pod"
               for e in api.events)

    # 7. The eviction's delete freed the cards: the three healthy ones are
    # available again, the broken one is published as failed.
    assert wait_for(lambda: sorted(annotation(api)["available"]) ==
                    sorted(set(uuids) - {bad}))
    assert annotation(api)["failed"] == [bad]

    # 8. Clean shutdown.
    stop.set()
    proc.terminate()
    assert proc.wait(timeout=15) == 0


def test_daemon_restart_rebuilds_from_checkpoint(system):
    """Kill the daemon mid-allocation; the restarted daemon rebuilds the
    allocated state from the kubelet checkpoint, and its first publish
    leaves the held cards out."""
    proc, api, kubelet = system["proc"], system["api"], system["kubelet"]
    assert kubelet.registered.wait(20), b"".join(system["daemon_log"])[-3000:]
    stub = kubelet.plugin_stub()
    first = next(iter(stub.ListAndWatch(pb.Empty())))
    ids = sorted(d.ID for d in first.devices)

    api.add_pod(gpu_pod("p", "uid-9", 2))
    write_checkpoint(system["dp_dir"], "uid-9", ids[:2])

    proc.kill()
    proc.wait()

    kubelet.registered.clear()
    proc2 = subprocess.Popen(system["argv"], cwd=REPO, env=system["env"],
                             stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    system["procs"].append(proc2)
    assert kubelet.registered.wait(20)
    assert wait_for(lambda: annotation(api) is not None
                    and sorted(annotation(api)["available"]) == ids[2:])
    proc2.terminate()
    assert proc2.wait(timeout=15) == 0
