"""The port's crash-durable black box (utils/blackbox.py), its record grammar
(utils/statestore.py), the plane taps and the flight recorder's dumps,
against the JAX package's.

The JAX ``tests/test_blackbox.py`` cases, each run on both planes where both
have it: recorder-off parity, rotation under a byte budget, the flight
export as the one drain seam, the taps of the three planes, segment
metadata and ``/debug/blackbox``. Segments written by either plane decode in
the other, byte for byte. Then the port's daemon as its own process over the
fake NVML: a SIGKILL mid-traffic leaves a torn-tail directory that the
port's ``read_dir`` (and the JAX ``tpu-doctor postmortem``) reads, whose last
decision names the last ``Allocate``; a SIGTERM leaves the ``shutdown``
flight dump and the ``stop`` marker. The ``tpu-doctor`` fleet cases wait for
the port's doctor.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import requests

from k8s_device_plugin_tpu.tools import doctor
from k8s_device_plugin_tpu.utils import blackbox as jax_blackbox
from k8s_device_plugin_tpu.utils import decisions as jax_decisions
from k8s_device_plugin_tpu.utils import flightrecorder as jax_flight
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import profiling as jax_profiling
from k8s_device_plugin_tpu.utils import resilience as jax_resilience
from k8s_device_plugin_tpu.utils import statestore as jax_statestore
from k8s_device_plugin_tpu.utils import tracing as jax_tracing
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.utils import blackbox, decisions, flightrecorder, metrics
from k8s_device_plugin_tpu_torch.utils import profiling, resilience, statestore, tracing
from tests import torch_fake_nvml as fk
from tests.fake_kubelet import FakeKubelet

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 15
PLANES = {
    "jax": types.SimpleNamespace(
        blackbox=jax_blackbox, statestore=jax_statestore, metrics=jax_metrics,
        recorder=jax_flight.RECORDER, ledger=jax_decisions.LEDGER, tracing=jax_tracing,
        profiling=jax_profiling, resilience=jax_resilience),
    "torch": types.SimpleNamespace(
        blackbox=blackbox, statestore=statestore, metrics=metrics,
        recorder=flightrecorder.RECORDER, ledger=decisions.LEDGER, tracing=tracing,
        profiling=profiling, resilience=resilience),
}
BOTH = pytest.mark.parametrize("plane", ["jax", "torch"])


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture(autouse=True)
def _planes_off():
    """The recorders, ledgers and collectors are process-global: every test
    leaves them off and empty on both planes."""
    yield
    for p in PLANES.values():
        p.recorder.disable()
        p.recorder.clear()
        p.ledger.disable()
        p.ledger.clear()
        p.tracing.disable()
        p.tracing.COLLECTOR.clear()
        p.profiling.HEARTBEATS.unregister("blackbox_writer")


def wait_for(pred, timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while not (value := pred()):
        assert time.monotonic() < deadline, "condition not met before the deadline"
        time.sleep(interval)
    return value


def _start(p, d, **kw):
    bb = p.blackbox.BlackBoxRecorder()
    cfg = dict(drain_interval_s=0.01, fsync_interval_s=0.0, snapshot_interval_s=3600)
    cfg.update(kw)
    assert bb.start(d, "plugin", **cfg)
    return bb


# -- the record grammar, across the planes -------------------------------------


RECORDS = [{"seq": 1, "ts": 1.5, "kind": "meta", "data": {"pid": 7, "service": "plugin"}},
           {"seq": 2, "ts": 2.25, "kind": "decision",
            "data": {"kind": "allocate_substitution", "attrs": {"assigned": "GPU-a"},
                     "message": "kept ü"}}]


def test_record_grammar_is_byte_identical_on_both_planes():
    for rec in RECORDS:
        assert statestore.encode_record(rec) == jax_statestore.encode_record(rec)
    whole = b"".join(statestore.encode_record(r) for r in RECORDS)
    line2 = statestore.encode_record(RECORDS[1])
    cases = {
        "clean": whole,
        "empty": b"",
        "torn": whole[:-4],
        "blank_line": whole + b"\n",
        "corrupt_mid": whole.replace(line2, b"deadbeef" + line2[8:]) + line2,
        "bad_json": whole + statestore._crc(b"{nope").encode() + b" {nope\n",
    }
    for name, data in cases.items():
        assert statestore._decode_journal(data) == jax_statestore._decode_journal(data), name
    assert statestore._decode_journal(cases["torn"])[1] == statestore.TORN_TAIL
    assert statestore._decode_journal(cases["corrupt_mid"])[1] == statestore.CORRUPT
    for name in ("CLEAN", "EMPTY", "TORN_TAIL", "CORRUPT"):
        assert getattr(statestore, name) == getattr(jax_statestore, name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_segment_written_by_either_plane_decodes_in_the_other(writer, tmp_path):
    """The writer plane's recorder fills a directory through its real taps;
    both planes' readers return the same records and statuses, clean and
    after a torn tail."""
    p = PLANES[writer]
    d = str(tmp_path / "bb")
    p.recorder.enable("plugin")
    p.ledger.enable("plugin")
    p.tracing.enable("plugin")
    bb = _start(p, d, snapshot_interval_s=0.05)
    try:
        with p.tracing.span("plugin.Allocate", containers=1):
            p.recorder.record("allocate", "chips handed to a container", chips="GPU-a")
            p.ledger.record("allocate_substitution", "kubelet_choice", "kept",
                            assigned="GPU-a")
        wait_for(lambda: {"flight", "decision", "span", "heartbeats", "metrics"}
                 <= {r["kind"] for r in p.blackbox.read_dir(d)[0]})
    finally:
        bb.stop()
    reads = {name: q.blackbox.read_dir(d) for name, q in PLANES.items()}
    assert reads["torch"] == reads["jax"]
    records, meta = reads["torch"]
    assert records[0]["kind"] == "meta" and records[-1]["kind"] == "stop"
    assert {s["status"] for s in meta["segments"]} == {statestore.CLEAN}
    seg = blackbox.list_segments(d)[-1]
    assert seg == jax_blackbox.list_segments(d)[-1]
    with open(seg["path"], "rb+") as f:
        f.truncate(seg["size_bytes"] - 3)
    reads = {name: q.blackbox.read_dir(d) for name, q in PLANES.items()}
    assert reads["torch"] == reads["jax"]
    assert reads["torch"][1]["segments"][-1]["status"] == statestore.TORN_TAIL


# -- the recorder ---------------------------------------------------------------


@BOTH
def test_recorder_off_leaves_directory_untouched(plane, tmp_path):
    """A recorder never started is an exact no-op: start("") refuses
    without touching the file system, and put() writes nothing."""
    off = PLANES[plane].blackbox.BlackBoxRecorder()
    assert off.start("", "plugin") is False
    off.put("flight", {"kind": "ignored"})
    assert off.records_written == 0 and not off.drops and not off.enabled
    assert os.listdir(tmp_path) == []


def test_recorder_off_daemon_leaves_directory_untouched(tmp_path, fake):
    """The port's daemon without --blackbox-dir serves, answers
    /debug/blackbox disabled and stops without a segment anywhere."""
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 2)
    dp_dir = tmp_path / "dp"
    dp_dir.mkdir()
    kubelet = FakeKubelet(str(dp_dir))
    kubelet.start()
    port = free_port()
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(dp_dir), sysfs_pci_dir=str(tmp_path / "sys"),
        dev_dir=str(tmp_path / "dev"), nvml_library=fake.path, enable_controller=False,
        trace=True, decisions=True, metrics_port=port))
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        assert kubelet.registered.wait(WAIT_S)
        snap = requests.get(f"http://127.0.0.1:{port}/debug/blackbox", timeout=5).json()
        assert (snap["enabled"], snap["dir"], snap["records_written"]) == (False, "", 0)
    finally:
        daemon.events.put(("signal", signal.SIGTERM))
        t.join(timeout=WAIT_S)
        kubelet.stop()
    assert not t.is_alive()
    assert not [p for p in tmp_path.rglob("blackbox-*")]
    assert not [th for th in threading.enumerate() if th.name == "blackbox-writer"]


@BOTH
def test_rotation_respects_byte_budget_under_sustained_load(plane, tmp_path):
    """Segments rotate at segment_bytes and the directory is pruned oldest
    first past total_bytes while records stream in, not only afterwards."""
    p = PLANES[plane]
    d = str(tmp_path / "rot")
    budget, slack = 16384, 4096 + 512  # one in-flight segment past the prune point
    bb = _start(p, d, segment_bytes=4096, total_bytes=budget)
    before = p.metrics.BLACKBOX_ROTATIONS.get()
    try:
        for i in range(900):
            bb.put("flight", {"kind": "x", "message": "y" * 64, "i": i})
            if i % 60 == 0:
                time.sleep(0.03)
                sizes = [s["size_bytes"] for s in p.blackbox.list_segments(d)]
                assert sum(sizes) <= budget + slack, (i, sizes)
        wait_for(lambda: not len(bb._queue))
    finally:
        bb.stop()
    segs = p.blackbox.list_segments(d)
    assert bb.rotations >= 3
    assert p.metrics.BLACKBOX_ROTATIONS.get() == before + bb.rotations
    assert sum(s["size_bytes"] for s in segs) <= budget + slack
    present = {s["segment"] for s in segs}
    assert 1 not in present and max(present) == bb._segment_seq
    for seg in segs:
        recs, status, _ = p.blackbox.read_segment(seg["path"])
        assert status == statestore.CLEAN and recs and recs[0]["kind"] == "meta"


@BOTH
def test_full_queue_drops_and_counts_never_blocks(plane, tmp_path):
    p = PLANES[plane]
    bb = p.blackbox.BlackBoxRecorder()
    bb.queue_max = 16
    bb.enabled = True  # producer side only: no writer drains
    if plane == "jax":
        bb._m = {"dropped": p.metrics.BLACKBOX_DROPPED}  # bound by start() there
    before = p.metrics.BLACKBOX_DROPPED.get(reason="queue_full")
    t0 = time.monotonic()
    for i in range(100):
        bb.put("flight", {"i": i})
    assert time.monotonic() - t0 < 1.0
    assert len(bb._queue) == 16 and bb.drops == {"queue_full": 84}
    assert p.metrics.BLACKBOX_DROPPED.get(reason="queue_full") == before + 84


@BOTH
def test_blackbox_metadata_reports_statuses(plane, tmp_path):
    """Per-segment name, service, pid, size and read status: a torn segment
    reads torn_tail with its intact-record count, never an error (the JAX
    plane's bundle metadata, the port's read_dir)."""
    p = PLANES[plane]
    d = str(tmp_path / "bb")
    bb = _start(p, d)
    bb.put("flight", {"kind": "a", "message": "one"})
    bb.put("flight", {"kind": "b", "message": "two"})
    wait_for(lambda: bb.records_written >= 3)
    bb.stop()

    def segments():
        if plane == "jax":
            return doctor._blackbox_metadata(d)["segments"]
        (seg,) = blackbox.list_segments(d)
        return [dict(s, service=seg["service"], pid=seg["pid"])
                for s in blackbox.read_dir(d)[1]["segments"]]

    (seg,) = segments()
    assert (seg["service"], seg["pid"], seg["status"]) == ("plugin", os.getpid(),
                                                            statestore.CLEAN)
    assert seg["records"] >= 4  # meta, two flight records, stop
    with open(os.path.join(d, seg["name"]), "rb+") as f:
        f.truncate(seg["size_bytes"] - 3)
    (seg2,) = segments()
    assert seg2["status"] == statestore.TORN_TAIL
    assert seg2["records"] == seg["records"] - 1


@BOTH
def test_debug_blackbox_endpoint_serves_snapshot(plane, tmp_path):
    p = PLANES[plane]
    srv = p.metrics.MetricsServer(host="127.0.0.1")
    url = srv.start()
    try:
        assert "/debug/blackbox" in requests.get(f"{url}/debug", timeout=5).json()["endpoints"]
        snap = requests.get(f"{url}/debug/blackbox", timeout=5).json()
        assert snap["enabled"] is False and snap["records_written"] == 0
        assert "queue_depth" in snap and "drops" in snap
        if plane == "torch":
            d = str(tmp_path / "bb")
            bb = blackbox.BLACKBOX
            assert bb.start(d, "plugin", drain_interval_s=0.01)
            try:
                wait_for(lambda: requests.get(f"{url}/debug/blackbox", timeout=5).json()
                         .get("segments"))
                snap = requests.get(f"{url}/debug/blackbox", timeout=5).json()
                assert snap["enabled"] is True and snap["dir"] == d
                assert "path" not in snap["segments"][0]  # metadata, never bodies
            finally:
                bb.stop()
    finally:
        srv.stop()


# -- the one drain seam and the taps ------------------------------------------


@BOTH
def test_flight_export_is_the_one_drain_seam(plane, tmp_path):
    """/debug/events, dump_on and the capture bundles all read the ring
    through export(); snapshot() is export() without a reason."""
    p = PLANES[plane]
    p.recorder.enable("plugin", dump_dir=str(tmp_path))
    p.recorder.record("allocate", "chips handed", chips="c0")
    exp = p.recorder.export()
    assert p.recorder.snapshot() == exp and "reason" not in exp
    stamped = p.recorder.export("capture")
    assert stamped["reason"] == "capture" and stamped["events"] == exp["events"]
    body = json.loads(p.metrics.debug_payload("/debug/events"))
    assert body["events"] == exp["events"] and "reason" not in body
    path = p.recorder.dump_on("sigterm")
    assert path is not None
    dumped = json.load(open(path))
    assert dumped["reason"] == "sigterm" and dumped["events"] == exp["events"]


@BOTH
def test_plane_taps_roundtrip_copies_and_isolation(plane):
    """add_tap on the three planes: every append delivered once, ledger and
    span taps get copies, a removed tap goes quiet, a raising tap never
    takes the recording path down."""
    p = PLANES[plane]
    got = {"flight": [], "decision": [], "span": []}
    p.recorder.enable("plugin")
    p.ledger.enable("plugin")
    p.tracing.enable("plugin")
    f_tap, d_tap, s_tap = got["flight"].append, got["decision"].append, got["span"].append

    def bomb(_):
        raise RuntimeError("broken subscriber")

    try:
        p.recorder.add_tap(f_tap)
        p.recorder.add_tap(bomb)
        p.recorder.add_tap(f_tap)  # a second add is no second delivery
        p.ledger.add_tap(d_tap)
        p.ledger.add_tap(bomb)
        p.tracing.COLLECTOR.add_tap(s_tap)
        p.tracing.COLLECTOR.add_tap(bomb)
        with p.tracing.span("plugin.Allocate") as sp:
            p.recorder.record("allocate", "m", chips="c0")
            p.ledger.record("allocate_substitution", "kubelet_choice", "ok", assigned="c0")
        assert [e["kind"] for e in got["flight"]] == ["allocate"]
        assert len(got["decision"]) == 1 and len(got["span"]) == 1
        assert got["span"][0]["trace_id"] == sp.trace_id
        got["decision"][0]["attrs"]["injected"] = True
        got["span"][0]["attrs"]["injected"] = True
        assert "injected" not in p.ledger.query(kind="allocate_substitution")[0]["attrs"]
        assert all("injected" not in (s.get("attrs") or {})
                   for s in p.tracing.COLLECTOR.spans())
        p.recorder.remove_tap(f_tap)
        p.ledger.remove_tap(d_tap)
        p.tracing.COLLECTOR.remove_tap(s_tap)
        p.recorder.record("allocate", "m2")
        p.ledger.record("allocate_substitution", "kubelet_choice", "x")
        assert len(got["flight"]) == 1 and len(got["decision"]) == 1
    finally:
        for remove in (p.recorder.remove_tap, p.ledger.remove_tap,
                       p.tracing.COLLECTOR.remove_tap):
            remove(bomb)


# -- the flight recorder's dumps ----------------------------------------------


@BOTH
def test_flight_recorder_dump_on_fault(plane, tmp_path):
    rec = type(PLANES[plane].recorder)(capacity=16)
    assert rec.dump_on("sigterm") is None  # off: no dump
    rec.enable(service="plugin", dump_dir=str(tmp_path))
    try:
        assert rec.dump_on("sigterm") is None  # an empty ring: no dump
        rec.record("health_transition", "card died", chip="c0")
        doc = json.load(open(rec.dump_on("sigterm")))
        assert (doc["reason"], doc["service"]) == ("sigterm", "plugin")
        assert doc["events"][0]["kind"] == "health_transition"
    finally:
        rec.disable()
    assert [f.name.split(f"-{os.getpid()}-")[1] for f in tmp_path.iterdir()] == [
        "sigterm.json"]


@BOTH
def test_circuit_break_dumps_flight_recorder(plane, tmp_path):
    """The kube breaker's move to OPEN records an event and dumps the ring,
    on a thread of its own (never under the breaker's lock)."""
    p = PLANES[plane]
    r = p.resilience
    p.recorder.enable(service="plugin", dump_dir=str(tmp_path))
    try:
        res = r.Resilience(breaker=r.CircuitBreaker(failure_threshold=2), sleep=lambda s: None)

        def die():
            raise OSError("down")

        with pytest.raises(r.UnavailableError):
            res.call(die, verb="GET", max_attempts=3)
        assert "circuit_state" in [e["kind"] for e in p.recorder.export()["events"]]
        (dump,) = wait_for(lambda: list(tmp_path.glob("flight-plugin-*circuit-break.json")))
        doc = json.load(open(dump))
        assert doc["reason"] == "circuit-break"
        assert any(e["kind"] == "circuit_state" and e["attrs"]["state"] == "open"
                   for e in doc["events"])
    finally:
        r.TRACKER.reset()


# -- the port's daemon as its own process -------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class DaemonProcess:
    """``python -m k8s_device_plugin_tpu_torch`` over the fake NVML's four
    cards, a fake kubelet and no kube plane, with ``extra`` flags."""

    def __init__(self, tmp_path, *extra):
        lib = fk.build(tmp_path)
        script = fk.NodeScript()
        fk.hgx_node(script, tmp_path / "sys", 4)
        self.dp_dir = tmp_path / "dp"
        self.dp_dir.mkdir()
        self.kubelet = FakeKubelet(str(self.dp_dir))
        self.kubelet.start()
        self.port = free_port()
        env = dict(os.environ, FAKE_NVML_SCRIPT=script.write(tmp_path / "node.txt"),
                   LD_LIBRARY_PATH=os.pathsep.join(
                       [os.path.dirname(lib)]
                       + [v for v in [os.environ.get("LD_LIBRARY_PATH")] if v]))
        self.log = open(tmp_path / "daemon.log", "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch",
             "--device-plugin-dir", str(self.dp_dir), "--sysfs-pci-dir", str(tmp_path / "sys"),
             "--dev-dir", str(tmp_path / "dev"), "--no-controller",
             "--metrics-port", str(self.port), *extra],
            cwd=ROOT, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.log_path = tmp_path / "daemon.log"

    def allocate(self, n: int) -> list:
        """n Allocates of one card each, round the node's cards; the cards
        in the order they were asked for."""
        assert self.kubelet.registered.wait(WAIT_S), self.log_path.read_text()[-3000:]
        stub = self.kubelet.plugin_stub()
        lw = stub.ListAndWatch(pb.Empty(), timeout=WAIT_S)
        ids = sorted(d.ID for d in next(iter(lw)).devices)
        lw.cancel()
        asked = []
        for i in range(n):
            req = pb.AllocateRequest()
            req.container_requests.add(devicesIDs=[ids[i % len(ids)]])
            stub.Allocate(req, timeout=WAIT_S)
            asked.append(ids[i % len(ids)])
        return asked

    def get(self, path):
        return requests.get(f"http://127.0.0.1:{self.port}{path}", timeout=5)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.kubelet.stop()
        self.log.close()


def _decisions(records):
    return [r["data"] for r in records if r["kind"] == "decision"]


def test_sigkill_leaves_a_torn_tail_directory_that_read_dir_reads(tmp_path):
    """kill -9 of the port's daemon under Allocate traffic: with no live
    process, read_dir reconstructs its final records, the last decision
    names the last Allocate's card, and no stop marker is there. The JAX
    ``tpu-doctor postmortem`` reads the same directory as a death
    mid-flight. A cut final line on top (a kill during a write) still reads
    up to the damage."""
    bb_dir = tmp_path / "bb"
    d = DaemonProcess(tmp_path, "--trace", "--decisions", "--blackbox-dir", str(bb_dir),
                      "--blackbox-fsync-s", "0")
    calls = 12
    try:
        asked = d.allocate(calls)
        # The writer drains every 0.25 s and fsyncs every drain: wait until
        # the last Allocate's decision is on disk, then kill.
        wait_for(lambda: len(_decisions(blackbox.read_dir(str(bb_dir))[0])) == calls,
                 interval=0.05)
        os.kill(d.proc.pid, signal.SIGKILL)
        d.proc.wait(timeout=WAIT_S)
    finally:
        d.close()
    records, meta = blackbox.read_dir(str(bb_dir))
    assert records[0]["kind"] == "meta" and records[0]["data"]["pid"] == d.proc.pid
    assert "stop" not in {r["kind"] for r in records}
    assert {s["status"] for s in meta["segments"]} <= {statestore.CLEAN, statestore.TORN_TAIL}
    last = _decisions(records)[-1]
    assert last["kind"] == "allocate_substitution"
    assert last["attrs"]["assigned"] == asked[-1]
    assert last["trace_id"]  # --trace: stamped with the Allocate span
    assert any(r["kind"] == "span" and r["data"]["name"] == "plugin.Allocate"
               and r["data"]["trace_id"] == last["trace_id"] for r in records)
    report = doctor.build_postmortem(str(bb_dir), minutes=10.0)
    assert (report["exit_code"], report["clean_stop"]) == (1, False)
    assert report["last_decision"]["attrs"]["assigned"] == asked[-1]
    seg = blackbox.list_segments(str(bb_dir))[-1]
    with open(seg["path"], "rb+") as f:
        f.truncate(seg["size_bytes"] - 3)
    records, meta = blackbox.read_dir(str(bb_dir))
    assert meta["segments"][-1]["status"] == statestore.TORN_TAIL
    assert _decisions(records)[-1]["kind"] == "allocate_substitution"
    out = subprocess.run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.utils.blackbox",
                          str(bb_dir)], capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert lines[len(meta["segments"]) - 1]["segment"]["status"] == statestore.TORN_TAIL
    assert lines[len(meta["segments"]):] == records


def test_sigterm_leaves_the_shutdown_dump_and_the_stop_marker(tmp_path):
    """SIGTERM of the port's daemon with --flight-dir and --blackbox-dir:
    exit 0, a ``shutdown`` flight dump holding the Allocate events, and a
    black box whose segments all read clean, the newest ending in stop."""
    flight_dir, bb_dir = tmp_path / "flight", tmp_path / "bb"
    d = DaemonProcess(tmp_path, "--trace", "--flight-dir", str(flight_dir),
                      "--blackbox-dir", str(bb_dir), "--blackbox-fsync-s", "0.5")
    try:
        asked = d.allocate(3)
        snap = d.get("/debug/blackbox").json()
        assert snap["enabled"] is True and snap["dir"] == str(bb_dir)
        d.proc.send_signal(signal.SIGTERM)
        assert d.proc.wait(timeout=WAIT_S) == 0, d.log_path.read_text()[-3000:]
    finally:
        d.close()
    (dump,) = flight_dir.glob(f"flight-plugin-*-{d.proc.pid}-shutdown.json")
    doc = json.load(open(dump))
    assert doc["reason"] == "shutdown"
    assert [e["attrs"]["chips"] for e in doc["events"] if e["kind"] == "allocate"] == asked
    records, meta = blackbox.read_dir(str(bb_dir))
    assert {s["status"] for s in meta["segments"]} == {statestore.CLEAN}
    assert records[-1]["kind"] == "stop" and records[-1]["data"]["reason"] == "clean_stop"
    assert [r["data"]["attrs"]["chips"] for r in records
            if r["kind"] == "flight" and r["data"]["kind"] == "allocate"] == asked
    assert doctor.build_postmortem(str(bb_dir))["exit_code"] == 0


def test_blackbox_cli_self_test_and_usage():
    out = subprocess.run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.utils.blackbox",
                          "--self-test"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.splitlines()[0])
    assert summary["last_decision"] == "allocate_substitution" and summary["rotations"] > 0
    assert out.stdout.splitlines()[-1] == "blackbox self-test: OK"
    bare = subprocess.run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.utils.blackbox"],
                          capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert bare.returncode == 2 and "--self-test" in bare.stdout
