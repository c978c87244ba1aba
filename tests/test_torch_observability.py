"""The port's metrics endpoint (utils/metrics.py ``MetricsServer``,
``render_scrape``, ``debug_payload``), JSON logging and the daemon's
observability flags, against the JAX package's.

The JAX ``tests/test_observability.py`` cases for the server, each run on
both planes' server where both have it: ``/metrics``, ``/healthz`` from a
liveness check (200, 503, a raising check reading 503), the ``/debug``
index and a 404. One registry's operations, driven on each plane's
``Registry`` and rendered by each ``render_scrape``, give equal bodies.
Then the CLI daemon end to end on the fake NVML with every observability
flag on.
"""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import requests

from k8s_device_plugin_tpu import telemetry as jax_telemetry
from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.server.plugin import PluginConfig as JaxPluginConfig
from k8s_device_plugin_tpu.server.plugin import TpuDevicePlugin
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu_torch import telemetry
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin, PluginConfig
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.utils import logging as tpulog
from k8s_device_plugin_tpu_torch.utils import metrics, profiling
from tests import fakes
from tests import torch_fake_nvml as fk
from tests.fake_apiserver import FakeApiServer
from tests.fake_kubelet import FakeKubelet
from tests.torch_kube_planes import stop_in_background

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 15
# The surfaces the port serves; the extender's come with the extender.
PORT_DEBUG = {"/debug/traces", "/debug/events", "/debug/decisions", "/debug/telemetry",
              "/debug/audit", "/debug/resilience", "/debug/profile", "/debug/lockdep",
              "/debug/blackbox", "/debug/readyz"}


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


def plane_metrics(plane):
    return jax_metrics if plane == "jax" else metrics


def make_plugin(plane, tmp_path, fake):
    """Four cards of the plane: a fake v5p host, or four H100s."""
    if plane == "jax":
        accel, dev = fakes.make_fake_tpu_node(str(tmp_path), "v5p", 4)
        return TpuDevicePlugin(IciMesh(PyTpuInfo().scan(accel, dev)),
                               config=JaxPluginConfig(libtpu_host_path=""))
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 4)
    with NvmlInfo(fake.path) as info:
        topo = LinkTopology(info.scan(str(tmp_path / "sys"), str(tmp_path / "dev")), info)
    return GpuDevicePlugin(topo, config=PluginConfig(device_plugin_dir=str(tmp_path)))


def ids_of(plugin):
    return plugin.mesh.ids if hasattr(plugin, "mesh") else plugin.topology.ids


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_metrics_registry_rendering(plane):
    reg = plane_metrics(plane).Registry()
    c = reg.counter("test_total", "a counter")
    g = reg.gauge("test_gauge", "a gauge")
    c.inc()
    c.inc(2, method="Allocate")
    g.set(4, state="available")
    text = reg.render()
    assert "# TYPE test_total counter" in text
    assert 'test_total{method="Allocate"} 2' in text
    assert 'test_gauge{state="available"} 4' in text
    assert "tpu_plugin_uptime_seconds" in text


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_metrics_server_scrape(plane, tmp_path, fake):
    m = plane_metrics(plane)
    plugin = make_plugin(plane, tmp_path, fake)
    plugin.state.allocate(ids_of(plugin)[:2])
    plugin._availability_changed()
    srv = m.MetricsServer(host="127.0.0.1")
    url = srv.start()
    try:
        text = requests.get(f"{url}/metrics", timeout=5).text
        assert 'tpu_plugin_chips{state="total"} 4' in text
        assert 'tpu_plugin_chips{state="allocated"} 2' in text
        assert 'tpu_plugin_chips{state="available"} 2' in text
        assert requests.get(f"{url}/healthz", timeout=5).text == "ok\n"
        assert requests.get(f"{url}/nope", timeout=5).status_code == 404
    finally:
        srv.stop()
        plugin.free_devices(ids_of(plugin)[:2])


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_healthz_reflects_liveness_check(plane):
    """A stale liveness check answers 503 so the kubelet's probe restarts
    the daemon; a check that raises reads as not live, never a 500."""
    state = {"live": True}

    def check():
        if state["live"] is None:
            raise RuntimeError("check broke")
        return state["live"]

    srv = plane_metrics(plane).MetricsServer(host="127.0.0.1", liveness_check=check)
    url = srv.start()
    try:
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 200
        state["live"] = False
        r = requests.get(f"{url}/healthz", timeout=5)
        assert r.status_code == 503 and "stalled" in r.text
        state["live"] = None
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 503
        state["live"] = True
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 200
    finally:
        srv.stop()


def test_daemon_heartbeat_backs_healthz(tmp_path, fake):
    """The daemon's /healthz reads its supervisor loop's heartbeat: 503 once
    the heartbeat is older than the threshold."""
    port = free_port()
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(tmp_path), nvml_library=fake.path, enable_controller=False,
        metrics_port=port))
    hb = profiling.HEARTBEATS.register("supervisor", interval_s=1.0,
                                       max_silence_s=daemon.heartbeat_stale_s)
    try:
        assert daemon.metrics_server is not None
        url = f"http://127.0.0.1:{port}"
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 200
        # A wedged loop: the heartbeat frozen past the threshold.
        hb._last = time.monotonic() - daemon.heartbeat_stale_s - 1
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 503
        hb.beat()
        assert requests.get(f"{url}/healthz", timeout=5).status_code == 200
    finally:
        profiling.HEARTBEATS.unregister("supervisor")
        daemon.metrics_server.stop()


def test_debug_index_lists_the_port_surfaces_and_404s_others():
    srv = metrics.MetricsServer(host="127.0.0.1")
    url = srv.start()
    try:
        idx = requests.get(f"{url}/debug", timeout=5).json()
        assert set(idx["endpoints"]) == PORT_DEBUG
        assert set(idx["endpoints"]) < set(jax_metrics.DEBUG_ENDPOINTS)
        for path in sorted(PORT_DEBUG):
            r = requests.get(f"{url}{path}", timeout=5)
            assert r.status_code == 200 and r.headers["Content-Type"] == "application/json"
            assert isinstance(r.json(), dict), path
        for path in ("/debug/nope",):
            assert requests.get(f"{url}{path}", timeout=5).status_code == 404, path
    finally:
        srv.stop()


@pytest.mark.parametrize("plane", ["jax", "torch"])
def test_broken_debug_provider_degrades_to_error_field(plane, monkeypatch):
    def boom():
        raise RuntimeError("telemetry backend exploded")

    monkeypatch.setattr(jax_telemetry if plane == "jax" else telemetry, "debug_snapshot", boom)
    srv = plane_metrics(plane).MetricsServer(host="127.0.0.1")
    url = srv.start()
    try:
        r = requests.get(f"{url}/debug/telemetry", timeout=5)
        assert r.status_code == 200
        assert "RuntimeError" in r.json()["error"]
        # The sibling surfaces are unaffected.
        assert requests.get(f"{url}/debug/events", timeout=5).status_code == 200
        assert "endpoints" in requests.get(f"{url}/debug", timeout=5).json()
    finally:
        srv.stop()


@pytest.mark.parametrize("accept", ["", "text/plain",
                                    "application/openmetrics-text; version=1.0.0"])
def test_one_registry_renders_equal_bodies_on_both_planes(accept):
    """The same operations on each plane's Registry, each rendered by its
    plane's render_scrape: equal content types and bodies (the uptime
    sample aside), OpenMetrics with its ``# EOF``."""
    bodies = {}
    for plane in ("jax", "torch"):
        m = plane_metrics(plane)
        reg = m.Registry()
        c = reg.counter("ops_total", "operations")
        g = reg.gauge("cards", "cards by state")
        h = reg.histogram("rpc_seconds", "latency", buckets=(0.001, 0.01, 0.1))
        c.inc(3, verb="GET")
        c.inc(verb="PATCH")
        g.set(4, state="total")
        g.set(0.5, state="ratio")
        g.remove(state="ratio")
        for v in (0.0005, 0.02, 0.5):
            h.observe(v, method="Allocate")
        body, ctype = m.render_scrape(reg, accept)
        bodies[plane] = ([ln for ln in body.decode().splitlines()
                          if not ln.startswith("tpu_plugin_uptime_seconds ")], ctype)
    assert bodies["torch"] == bodies["jax"]
    lines, ctype = bodies["torch"]
    assert (lines[-1] == "# EOF") == ("openmetrics" in accept)
    assert ctype.startswith("application/openmetrics-text" if "openmetrics" in accept
                            else "text/plain")
    assert 'rpc_seconds_bucket{method="Allocate",le="0.01"} 1' in lines


def test_json_log_lines_carry_the_service():
    import io

    root = tpulog.setup(json=True, service="plugin")
    handler = next(h for h in root.handlers if getattr(h, tpulog._MARKER, False))
    stream = io.StringIO()
    handler.setStream(stream)
    try:
        logging.getLogger("k8s_device_plugin_tpu_torch.test").warning("hello %s", "card")
        line = json.loads(stream.getvalue().splitlines()[-1])
        assert (line["level"], line["message"], line["service"]) == (
            "WARNING", "hello card", "plugin")
    finally:
        tpulog.setup()


def test_parse_args_takes_the_observability_flags_with_no_env_alias(monkeypatch):
    for name in ("TPU_TELEMETRY_INTERVAL_S", "TPU_AUDIT_INTERVAL_S", "TPU_TRACE",
                 "TPU_DECISIONS", "TPU_LOG_JSON", "TPU_METRICS_PORT"):
        monkeypatch.setenv(name, "7")
    def formatter():
        root = logging.getLogger()
        return next(h for h in root.handlers if getattr(h, tpulog._MARKER, False)).formatter

    cfg = main.parse_args([])
    assert (cfg.metrics_port, cfg.trace, cfg.decisions, cfg.telemetry_interval_s,
            cfg.audit_interval_s) == (2112, False, False, 0.0, 0.0)
    assert isinstance(formatter(), tpulog.PlainFormatter)
    cfg = main.parse_args(["--metrics-port", "0", "--trace", "--decisions", "--log-json",
                           "--telemetry-interval-s", "0.5", "--audit-interval-s", "2"])
    assert (cfg.metrics_port, cfg.trace, cfg.decisions, cfg.telemetry_interval_s,
            cfg.audit_interval_s) == (0, True, True, 0.5, 2.0)
    assert isinstance(formatter(), tpulog.JsonFormatter)
    tpulog.setup()


def test_cli_daemon_serves_the_observability_plane(tmp_path):
    """``python -m k8s_device_plugin_tpu_torch`` with every observability flag
    on, over the fake NVML, a fake kubelet and a fake API server: /metrics
    carries the card, capacity, audit and build families, /healthz is 200,
    /debug and its surfaces answer JSON, the logs are JSON lines, and
    SIGTERM exits 0."""
    lib = fk.build(tmp_path)
    script = fk.NodeScript()
    fk.hgx_node(script, tmp_path / "sys", 2)
    dp_dir = tmp_path / "dp"
    dp_dir.mkdir()
    kubelet = FakeKubelet(str(dp_dir))
    kubelet.start()
    api = FakeApiServer()
    url = api.start()
    api.add_node("obs-node")
    kubeconfig = tmp_path / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "cl", "user": "u"}}],
        "clusters": [{"name": "cl", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t"}}],
    }))
    port = free_port()
    env = dict(os.environ, FAKE_NVML_SCRIPT=script.write(tmp_path / "node.txt"),
               LD_LIBRARY_PATH=os.pathsep.join(
                   [os.path.dirname(lib)] + [p for p in [os.environ.get("LD_LIBRARY_PATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch",
         "--device-plugin-dir", str(dp_dir), "--sysfs-pci-dir", str(tmp_path / "sys"),
         "--dev-dir", str(tmp_path / "dev"), "--node-name", "obs-node",
         "--kubeconfig", str(kubeconfig), "--podresources-socket", "",
         "--metrics-port", str(port), "--telemetry-interval-s", "0.2",
         "--audit-interval-s", "0.2", "--trace", "--decisions", "--log-json"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out: list = []
    threading.Thread(target=lambda: out.extend(iter(proc.stdout.readline, b"")),
                     daemon=True).start()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        return requests.get(base + path, timeout=5)

    try:
        assert kubelet.registered.wait(WAIT_S), b"".join(out)[-3000:]
        deadline = time.monotonic() + WAIT_S
        while True:
            scrape = get("/metrics").text
            audit = get("/debug/audit").json()
            tel = get("/debug/telemetry").json()
            if audit.get("sweeps", 0) >= 2 and tel.get("ticks", 0) >= 1:
                break
            assert time.monotonic() < deadline, (audit, tel)
            time.sleep(0.1)
        for family in ("tpu_chip_duty_cycle{", "tpu_chip_power_watts{", "tpu_chip_ici_link_up{",
                       "tpu_node_free_chips 2", 'tpu_node_best_set_score{size="2"}',
                       'tpu_audit_sweeps_total{outcome="clean"}',
                       "tpu_audit_last_clean_sweep_timestamp ", "tpu_build_info{",
                       'tpu_telemetry_ticks_total{outcome="ok"}'):
            assert family in scrape, family
        assert get("/healthz").status_code == 200
        assert audit["enabled"] and audit["findings"] == [] and audit["errors"] == {}
        assert {i["name"] for i in audit["invariants"]} == {
            "checkpoint_vs_podresources", "annotation_vs_kubelet", "attribution_vs_kubelet",
            "gauge_vs_state", "orphaned_chip", "thread_liveness", "lock_order",
            "degraded_consistency"}
        assert len(tel["chips"]) == 2 and tel["node"]["free"] == 2
        assert set(get("/debug").json()["endpoints"]) == PORT_DEBUG
        resilience = get("/debug/resilience").json()
        assert resilience["call_outcomes"] and len(resilience["degraded"]) == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
        logs = [json.loads(line) for line in b"".join(out).decode().splitlines()
                if line.startswith("{")]
        assert logs and all(line["service"] == "plugin" for line in logs)
        assert any("metrics at" in line["message"] for line in logs)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        kubelet.stop()
        stop_in_background(api)
