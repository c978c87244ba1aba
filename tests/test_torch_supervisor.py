"""The port's node daemon (supervisor/main.py, supervisor/watchers.py,
``python -m k8s_device_plugin_tpu_torch``) against the JAX one.

The JAX ``tests/test_supervisor.py`` scenarios, each parametrised over the
two planes where both have it: ``jax`` (a fake TPU sysfs tree,
tests/fakes.py) and ``torch`` (the fake NVML library, tests/fake_nvml.c).
The restart loop runs in-process, driven through its event queue; the CLI
runs end to end as its own process with the fake library first on
``LD_LIBRARY_PATH``. Every daemon start names its kube config (a
tests/fake_apiserver.FakeApiServer's) or turns the kube plane off, so no
start reaches an in-cluster API server. Every wait has a deadline.
"""

import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from k8s_device_plugin_tpu.api import constants as jax_constants
from k8s_device_plugin_tpu.api import deviceplugin_pb2 as jax_pb
from k8s_device_plugin_tpu.api import pluginregistration_pb2 as jax_regpb
from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.supervisor import main as jax_main
from k8s_device_plugin_tpu.supervisor import watchers as jax_watchers
from k8s_device_plugin_tpu_torch.api import constants
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
from k8s_device_plugin_tpu_torch.api import pluginregistration_pb2 as regpb
from k8s_device_plugin_tpu_torch.discovery.scanner import NoCards, NvmlInfo
from k8s_device_plugin_tpu_torch.supervisor import main, watchers
from tests import fakes
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakeKubelet

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 10


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture
def dp_dir(tmp_path):
    d = tmp_path / "dp"
    d.mkdir()
    return d


@pytest.fixture
def kubelet(dp_dir):
    k = FakeKubelet(str(dp_dir))
    k.start()
    yield k
    k.stop()


class JaxNode:
    """A TPU host in a fake sysfs tree, and the JAX daemon over it."""

    constants = jax_constants

    def __init__(self, root, dp_dir):
        self.root, self.dp_dir = str(root), str(dp_dir)

    def add_cards(self, n=4):
        fakes.make_fake_tpu_node(self.root, "v5p", n)

    def break_card(self, i):
        """Chip i's sysfs health reads bad; returns its id."""
        accel = os.path.join(self.root, "sys", "class", "accel")
        fakes.set_chip_health(accel, i, False)
        return PyTpuInfo().scan(accel, os.path.join(self.root, "dev"))[i].device_id_str

    def daemon(self, **kw):
        return jax_main.Daemon(jax_main.DaemonConfig(
            device_plugin_dir=self.dp_dir,
            sysfs_accel_dir=os.path.join(self.root, "sys", "class", "accel"),
            dev_dir=os.path.join(self.root, "dev"),
            libtpu_host_path="", enable_controller=False, prefer_native_backend=False, **kw))

    @staticmethod
    def ids(daemon):
        return daemon.plugin.mesh.ids

    def close(self):
        pass


class TorchNode:
    """H100s of the fake NVML, and the port's daemon over them."""

    constants = constants

    def __init__(self, root, dp_dir, fake):
        self.root, self.dp_dir, self.fake = str(root), str(dp_dir), fake
        self.sysfs, self.dev = os.path.join(self.root, "sys"), os.path.join(self.root, "dev")
        fake.reset()

    def add_cards(self, n=4):
        self.uuids = fk.hgx_node(self.fake, self.sysfs, n)

    def break_card(self, i):
        """Card i (NVML's index) falls off the bus; returns its UUID."""
        self.fake.set_lost(i)
        return self.uuids[i]

    def daemon(self, **kw):
        kw.setdefault("nvml_library", self.fake.path)
        kw.setdefault("enable_controller", False)
        return main.Daemon(main.DaemonConfig(
            device_plugin_dir=self.dp_dir, sysfs_pci_dir=self.sysfs, dev_dir=self.dev, **kw))

    @staticmethod
    def ids(daemon):
        return daemon.plugin.topology.ids

    def close(self):
        self.fake.reset()


@pytest.fixture(params=["jax", "torch"])
def node(request, tmp_path, dp_dir):
    if request.param == "jax":
        n = JaxNode(tmp_path, dp_dir)
    else:
        n = TorchNode(tmp_path, dp_dir, request.getfixturevalue("fake"))
    yield n
    n.close()


def run_daemon_thread(daemon):
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    return t


def stop_daemon(daemon, thread):
    daemon.events.put(("signal", signal.SIGTERM))
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive()


def first_list(kubelet):
    return next(iter(kubelet.plugin_stub().ListAndWatch(pb.Empty(), timeout=WAIT_S)))


def wait_for(predicate, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        time.sleep(0.05)


def test_port_pb2_descriptors_equal_jax_byte_for_byte():
    assert pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert regpb.DESCRIPTOR.serialized_pb == jax_regpb.DESCRIPTOR.serialized_pb
    for name in ("deviceplugin_pb2.py", "pluginregistration_pb2.py", "podresources_pb2.py"):
        assert (ROOT / "k8s_device_plugin_tpu_torch" / "api" / name).read_bytes() == \
            (ROOT / "k8s_device_plugin_tpu" / "api" / name).read_bytes()


@pytest.mark.parametrize("how", ["no_nvml", "nvml_without_cards"])
def test_node_without_cards_serves_zero_devices(tmp_path, dp_dir, kubelet, fake, how):
    """No NVML library (NoCards), or NVML that lists no card: the plugin
    registers and reports 0 devices instead of blocking, as the JAX
    daemon does on a node without an accel tree."""
    node = TorchNode(tmp_path, dp_dir, fake)
    lib = str(tmp_path / "missing" / "libnvidia-ml.so.1") if how == "no_nvml" else fake.path
    daemon = node.daemon(nvml_library=lib)
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        assert len(first_list(kubelet).devices) == 0
        assert isinstance(daemon.backend, NoCards if how == "no_nvml" else NvmlInfo)
        assert daemon.health is None
    finally:
        stop_daemon(daemon, t)
        node.close()


def test_jax_node_without_cards_serves_zero_devices(tmp_path, dp_dir, kubelet):
    daemon = JaxNode(tmp_path, dp_dir).daemon()
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        assert len(first_list(kubelet).devices) == 0
    finally:
        stop_daemon(daemon, t)


def test_node_serves_its_cards_and_watches_health(node, kubelet):
    node.add_cards(4)
    daemon = node.daemon()
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        assert kubelet.registrations[-1].resource_name == node.constants.RESOURCE_NAME
        resp = first_list(kubelet)
        assert [d.ID for d in resp.devices] == node.ids(daemon)
        wait_for(lambda: daemon.health is not None)
    finally:
        stop_daemon(daemon, t)


def test_card_broken_at_start_never_advertised_healthy(node, kubelet):
    """A card already broken when the daemon starts is never Healthy in the
    first advertisement, even at an hour's poll interval: the JAX chip
    whose sysfs health reads bad is Unhealthy (the first sweep runs before
    serving); the H100 fallen off the bus cannot be identified by NVML and
    is not listed at all. The other three are Healthy."""
    node.add_cards(4)
    broken = node.break_card(1)
    daemon = node.daemon(health_interval_s=3600.0)
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        health = {d.ID: d.health for d in first_list(kubelet).devices}
        assert health.pop(broken, node.constants.UNHEALTHY) == node.constants.UNHEALTHY
        assert list(health.values()) == [node.constants.HEALTHY] * 3
    finally:
        stop_daemon(daemon, t)


def test_hardware_xid_before_a_rebuild_keeps_its_card_withdrawn(tmp_path, dp_dir, kubelet,
                                                                fake):
    """NVML delivers no XID from before its event set was registered, so a
    hardware XID is remembered by the backend, which lives across plugin
    generations: after a rebuild (SIGHUP) the card is Unhealthy in the new
    generation's first advertisement. An application XID withdraws
    nothing."""
    node = TorchNode(tmp_path, dp_dir, fake)
    node.add_cards(4)
    daemon = node.daemon(health_interval_s=3600.0)
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        first = daemon.plugin
        bad = node.ids(daemon)[2]
        index = next(c.index for c in first.topology.chips if c.uuid == bad)
        fake.push_xid(index, 79)
        fake.push_xid(0, 31)
        wait_for(lambda: first.state.unhealthy == {bad})
        kubelet.registered.clear()
        daemon.events.put(("signal", signal.SIGHUP))
        assert kubelet.registered.wait(WAIT_S)
        assert daemon.plugin is not first
        health = {d.ID: d.health for d in first_list(kubelet).devices}
        assert [i for i, h in health.items() if h == constants.UNHEALTHY] == [bad]
    finally:
        stop_daemon(daemon, t)
        node.close()


def test_kubelet_socket_recreate_triggers_restart(node, kubelet):
    node.add_cards(4)
    daemon = node.daemon()
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        first_plugin = daemon.plugin
        kubelet.registered.clear()
        daemon.events.put(("create", constants.KUBELET_SOCKET_NAME))
        assert kubelet.registered.wait(WAIT_S)
        assert daemon.plugin is not first_plugin
        assert len(kubelet.registrations) == 2
    finally:
        stop_daemon(daemon, t)


def test_sighup_triggers_rediscovery(node, kubelet):
    """Start with no card, add 4, SIGHUP: the rebuild finds them."""
    daemon = node.daemon()
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        assert node.ids(daemon) == []
        node.add_cards(4)
        kubelet.registered.clear()
        daemon.events.put(("signal", signal.SIGHUP))
        assert kubelet.registered.wait(WAIT_S)
        assert len(node.ids(daemon)) == 4
        assert len(first_list(kubelet).devices) == 4
    finally:
        stop_daemon(daemon, t)


def test_sighup_finds_nvml_installed_after_start(tmp_path, dp_dir, kubelet, fake,
                                                 monkeypatch):
    """A node that had no NVML (NoCards) looks for it again on SIGHUP: the
    NVIDIA driver installed later is picked up without a restart."""
    node = TorchNode(tmp_path, dp_dir, fake)
    lib = tmp_path / "nvidia" / "libnvidia-ml.so.1"
    daemon = node.daemon(nvml_library=str(lib))
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        assert isinstance(daemon.backend, NoCards)
        # The NVIDIA driver's install: a library that scripts itself (a second
        # copy, so a state of its own) with one card.
        script = fk.NodeScript()
        fk.hgx_node(script, node.sysfs, 1)
        monkeypatch.setenv("FAKE_NVML_SCRIPT", script.write(tmp_path / "node.txt"))
        lib.parent.mkdir()
        shutil.copy(fake.path, lib)
        kubelet.registered.clear()
        daemon.events.put(("signal", signal.SIGHUP))
        assert kubelet.registered.wait(WAIT_S)
        assert isinstance(daemon.backend, NvmlInfo)
        assert [d.ID for d in first_list(kubelet).devices] == [fk.hgx_uuid(0)]
    finally:
        stop_daemon(daemon, t)
        node.close()


@pytest.mark.parametrize("plane", ["jax", "torch"])
@pytest.mark.parametrize("mode", ["inotify", "polling"])
def test_fs_watcher_sees_socket_recreate(tmp_path, monkeypatch, plane, mode):
    module = jax_watchers if plane == "jax" else watchers
    if mode == "polling":
        def no_inotify(self):
            raise OSError(38, "inotify_init1")
        monkeypatch.setattr(module.FsWatcher, "_init_inotify", no_inotify)
    out: queue.Queue = queue.Queue()
    w = module.FsWatcher(str(tmp_path), out)
    w.start()
    try:
        time.sleep(0.2)
        p = tmp_path / "kubelet.sock"
        p.write_text("")
        assert out.get(timeout=WAIT_S) == ("create", "kubelet.sock")
        p.unlink()
        assert out.get(timeout=WAIT_S) == ("delete", "kubelet.sock")
    finally:
        w.stop()


def test_parse_args_defaults_and_flags():
    cfg = main.parse_args([])
    # The command line's metrics port is the JAX 2112; a DaemonConfig built
    # in a process (as the tests do) serves none.
    assert cfg == main.DaemonConfig(metrics_port=2112)
    assert (cfg.resource_name, cfg.device_plugin_dir) == ("nvidia.com/gpu",
                                                         "/var/lib/kubelet/device-plugins/")
    cfg = main.parse_args([
        "--device-plugin-dir", "/dp", "--sysfs-pci-dir", "/pci", "--dev-dir", "/d",
        "--resource-name", "nvidia.com/gpu-topo", "--substitute-on-allocate",
        "--health-interval", "0.5", "--cdi-kind", "nvidia.com/gpu",
        "--registration-mode", "both", "--plugins-registry-dir", "/reg", "-v",
    ])
    assert cfg == main.DaemonConfig(
        device_plugin_dir="/dp", sysfs_pci_dir="/pci", dev_dir="/d",
        resource_name="nvidia.com/gpu-topo", substitute_on_allocate=True,
        health_interval_s=0.5, cdi_kind="nvidia.com/gpu", registration_mode="both",
        plugins_registry_dir="/reg", metrics_port=2112)


def test_parse_args_takes_the_kube_planes_flags(monkeypatch):
    """The kube plane's flags, under the JAX names and defaults, are
    parsed and refused no longer."""
    monkeypatch.delenv("KUBECONFIG", raising=False)
    monkeypatch.delenv("NODE_NAME", raising=False)
    monkeypatch.delenv("TPU_STALENESS_CAP_S", raising=False)
    jax = jax_main.parse_args([])
    cfg = main.parse_args([])
    for field in ("node_name", "kubeconfig", "enable_controller", "resync_interval_s",
                  "evict_on_unhealthy", "staleness_cap_s", "numa_dir", "proc_dir"):
        assert getattr(cfg, field) == getattr(jax, field), field
    assert cfg.podresources_socket == jax.podresources_socket == \
        "/var/lib/kubelet/pod-resources/kubelet.sock"
    monkeypatch.setenv("KUBECONFIG", "/etc/kc")
    monkeypatch.setenv("NODE_NAME", "node-a")
    cfg = main.parse_args([])
    assert (cfg.kubeconfig, cfg.node_name) == ("/etc/kc", "node-a")
    cfg = main.parse_args([
        "--node-name", "n1", "--kubeconfig", "/kc", "--no-controller",
        "--resync-interval", "2.5", "--podresources-socket", "", "--no-evict-on-unhealthy",
        "--staleness-cap-s", "7",
    ])
    assert (cfg.node_name, cfg.kubeconfig, cfg.enable_controller, cfg.resync_interval_s,
            cfg.podresources_socket, cfg.evict_on_unhealthy, cfg.staleness_cap_s) == (
        "n1", "/kc", False, 2.5, "", False, 7.0)


@pytest.mark.parametrize("flag", ["--profile-hz=10", "--blackbox-dir=/bb", "--lockdep",
                                  "--libtpu-path=", "--accelerator-type=v5e", "--dra",
                                  "--registration-mode=bogus"])
def test_parse_args_refuses_flags_of_planes_not_ported(flag):
    """A flag of a plane this daemon does not have is refused, never
    accepted and then ignored."""
    with pytest.raises(SystemExit):
        main.parse_args([flag])


def test_daemon_imports_no_torch():
    code = ("import sys; import k8s_device_plugin_tpu_torch.__main__; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, check=True).stdout
    assert out.strip() == "[]"


def test_cli_end_to_end_subprocess(tmp_path, dp_dir, kubelet):
    """The real daemon process over the fake NVML (first on
    LD_LIBRARY_PATH, scripted through FAKE_NVML_SCRIPT): register, the
    devices, a SIGHUP re-registration, and SIGTERM exiting 0 with its
    socket removed."""
    lib = fk.build(tmp_path)
    script = fk.NodeScript()
    uuids = fk.hgx_node(script, tmp_path / "sys", 4)
    env = dict(os.environ, LD_LIBRARY_PATH=os.pathsep.join(
        [os.path.dirname(lib)] + [p for p in [os.environ.get("LD_LIBRARY_PATH")] if p]),
        FAKE_NVML_SCRIPT=script.write(tmp_path / "node.txt"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch",
         "--device-plugin-dir", str(dp_dir), "--sysfs-pci-dir", str(tmp_path / "sys"),
         "--dev-dir", str(tmp_path / "dev"), "--health-interval", "0.2", "--no-controller",
         "--metrics-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        assert kubelet.registered.wait(15)
        req = kubelet.registrations[-1]
        assert (req.resource_name, req.endpoint) == (constants.RESOURCE_NAME,
                                                     constants.PLUGIN_SOCKET_NAME)
        resp = first_list(kubelet)
        # PCI order (slot order); NVML lists the fake's cards in reverse.
        assert [d.ID for d in resp.devices] == [fk.hgx_uuid(s) for s in range(4)] == uuids[::-1]
        assert all(d.health == constants.HEALTHY for d in resp.devices)
        assert [d.topology.nodes[0].ID for d in resp.devices] == [0, 0, 1, 1]
        kubelet.registered.clear()
        proc.send_signal(signal.SIGHUP)
        assert kubelet.registered.wait(15)
        proc.terminate()
        assert proc.wait(timeout=15) == 0
        assert not os.path.exists(dp_dir / constants.PLUGIN_SOCKET_NAME)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


@pytest.mark.cuda
def test_daemon_leaves_cuda_uninitialised_on_card():
    """On a machine with a card: importing the daemon and discovering the
    cards through the real NVML creates no CUDA context."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and its NVML")
    code = ("import sys, torch; from k8s_device_plugin_tpu_torch.supervisor.main import "
            "Daemon, DaemonConfig; d = Daemon(DaemonConfig()); chips = d.discover(); "
            "print(len(chips), torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, check=True).stdout.split()
    assert int(out[0]) >= 1 and out[1] == "False"


def write_kubeconfig(path, url) -> str:
    """A kube config naming ``url``, written as JSON (a subset of YAML)."""
    path.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "cl", "user": "u"}}],
        "clusters": [{"name": "cl", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    return str(path)


KUBE_THREADS = {"pod-informer", "pod-worker", "topology-publisher"}


@pytest.mark.parametrize("controller", [False, True], ids=["no_controller", "kube_plane"])
def test_kube_plane_threads_start_only_when_asked(tmp_path, dp_dir, kubelet, fake, controller):
    """``--no-controller`` starts no kube thread and makes no API call; with
    the plane on, the node annotation is published, and each generation's
    teardown joins the controller's and the publisher's threads."""
    api = FakeApiServer()
    url = api.start()
    api.add_node("node-a")
    node = TorchNode(tmp_path, dp_dir, fake)
    node.add_cards(4)
    daemon = node.daemon(enable_controller=controller, node_name="node-a",
                         kubeconfig=write_kubeconfig(tmp_path / "kc.json", url),
                         podresources_socket="")
    t = run_daemon_thread(daemon)
    try:
        assert kubelet.registered.wait(WAIT_S)
        first_list(kubelet)
        names = lambda: {th.name for th in threading.enumerate()}  # noqa: E731
        if controller:
            wait_for(lambda: "nvidia.com/gpu-topology"
                     in api.nodes["node-a"]["metadata"].get("annotations", {}))
            assert KUBE_THREADS <= names()
            kubelet.registered.clear()
            daemon.events.put(("signal", signal.SIGHUP))
            assert kubelet.registered.wait(WAIT_S)
            wait_for(lambda: daemon.controller is not None)
        else:
            time.sleep(0.3)
            assert daemon.controller is None and not KUBE_THREADS & names()
            assert not api.node_patches and not api.node_status_patches
    finally:
        stop_daemon(daemon, t)
        node.close()
        api.stop()
    assert not KUBE_THREADS & {th.name for th in threading.enumerate()}


def test_node_without_a_kube_config_serves_its_cards(tmp_path, dp_dir, kubelet, fake, caplog):
    """As in JAX, a kube config that cannot be read is a logged warning:
    the cards are served and no controller runs."""
    import logging

    node = TorchNode(tmp_path, dp_dir, fake)
    node.add_cards(4)
    daemon = node.daemon(enable_controller=True, kubeconfig=str(tmp_path / "missing.yaml"))
    t = run_daemon_thread(daemon)
    try:
        with caplog.at_level(logging.WARNING):
            assert kubelet.registered.wait(WAIT_S)
            assert len(first_list(kubelet).devices) == 4
        assert daemon.controller is None
        assert "kube client unavailable pre-serve" in caplog.text
        assert not KUBE_THREADS & {th.name for th in threading.enumerate()}
    finally:
        stop_daemon(daemon, t)
        node.close()


def test_daemon_with_the_kube_plane_loads_no_torch(tmp_path):
    """The daemon's process, its kube plane running against a fake API
    server (the node annotation published), has loaded no torch or JAX."""
    api = FakeApiServer()
    url = api.start()
    api.add_node("node-a")
    lib = fk.build(tmp_path)
    script = fk.NodeScript()
    fk.hgx_node(script, tmp_path / "sys", 2)
    code = (
        "import sys, time\n"
        "from k8s_device_plugin_tpu_torch.supervisor.main import Daemon, DaemonConfig\n"
        f"d = Daemon(DaemonConfig(device_plugin_dir={str(tmp_path / 'dp')!r}, "
        f"sysfs_pci_dir={str(tmp_path / 'sys')!r}, dev_dir={str(tmp_path / 'dev')!r}, "
        f"nvml_library={lib!r}, node_name='node-a', podresources_socket='', "
        f"kubeconfig={write_kubeconfig(tmp_path / 'kc.json', url)!r}, "
        "registration_mode='watcher', "
        f"plugins_registry_dir={str(tmp_path / 'reg')!r}))\n"
        "d.build_and_serve()\n"
        "assert d.controller is not None\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n"
        "d.teardown()\n"
    )
    (tmp_path / "dp").mkdir()
    env = dict(os.environ, FAKE_NVML_SCRIPT=script.write(tmp_path / "node.txt"))
    try:
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120, cwd=ROOT, env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == "[]"
        assert "nvidia.com/gpu-topology" in api.nodes["node-a"]["metadata"]["annotations"]
    finally:
        api.stop()
