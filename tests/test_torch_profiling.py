"""The port's runtime-performance plane (utils/profiling.py: the stall
watchdog, the GC monitor, lockdep and ``TimedLock``, the SLO capture;
utils/stackprof.py: the sampling profiler) against the JAX package's.

The JAX ``tests/test_profiling.py`` and ``tests/test_analysis.py`` lockdep
cases, each run on both planes where both have it, and cross-plane checks
that the same synthetic stack folds to the same key, the same latency
series crosses the capture threshold at the same observation, and the same
bundle sections come out. Then the capture–stall–audit acceptance scenario
on the port's daemon: a slowed ``Allocate`` over gRPC writes one SLO bundle
whose hottest serving-path stack names the injected frame, and a wedged
telemetry sampler trips the watchdog (a stall bundle) and the
``thread_liveness`` finding, which clears once the loop resumes.

The process-global state (the capture manager, the installed profiler, the
GC callback, the heartbeats) is put back by every test. The port's
``LOCKDEP`` is on for this file (the fixture below) and must end every test
without a cycle; seeded inversions use a private ``LockdepGraph``.
"""

import gc
import json
import os
import signal
import threading
import time
import types

import pytest

from k8s_device_plugin_tpu import audit as jax_audit
from k8s_device_plugin_tpu import telemetry as jax_telemetry
from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.tools import flame
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu.utils import decisions as jax_decisions
from k8s_device_plugin_tpu.utils import flightrecorder as jax_flight
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import profiling as jax_profiling
from k8s_device_plugin_tpu.utils import stackprof as jax_stackprof
from k8s_device_plugin_tpu.utils.metrics import Histogram as JaxHistogram
from k8s_device_plugin_tpu_torch import audit, telemetry
from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin
from k8s_device_plugin_tpu_torch.supervisor import main
from k8s_device_plugin_tpu_torch.utils import decisions, flightrecorder, metrics, profiling
from k8s_device_plugin_tpu_torch.utils import stackprof
from k8s_device_plugin_tpu_torch.utils.metrics import Histogram
from tests import fakes
from tests import torch_fake_nvml as fk
from tests.fake_kubelet import FakeKubelet

WAIT_S = 10
PLANES = {
    "jax": types.SimpleNamespace(
        profiling=jax_profiling, stackprof=jax_stackprof, metrics=jax_metrics, audit=jax_audit,
        recorder=jax_flight.RECORDER, ledger=jax_decisions.LEDGER, Histogram=JaxHistogram),
    "torch": types.SimpleNamespace(
        profiling=profiling, stackprof=stackprof, metrics=metrics, audit=audit,
        recorder=flightrecorder.RECORDER, ledger=decisions.LEDGER, Histogram=Histogram),
}
BOTH = pytest.mark.parametrize("plane", ["jax", "torch"])
BUNDLE_KEYS = {"v", "service", "reason", "message", "ts", "attrs", "profile", "flight",
               "decisions", "heartbeats", "windows", "metrics"}


@pytest.fixture(autouse=True)
def _port_lockdep_on_and_acyclic():
    """The port's global lock-order graph is on for every test of this file
    and must hold no cycle at its end (the JAX suite's session gate, for
    the port's graph)."""
    was = profiling.LOCKDEP.enabled
    profiling.LOCKDEP.enable()
    yield
    try:
        assert profiling.LOCKDEP.cycles() == []
    finally:
        if not was:
            profiling.LOCKDEP.disable()


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


def wait_for(pred, timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not met before the deadline"
        time.sleep(interval)


# -- the sampling profiler ----------------------------------------------------


def _busy_thread():
    """A busy loop with a stable, greppable hot frame."""
    stop = threading.Event()

    def _profiling_test_hotspot():
        while not stop.is_set():
            sum(i * i for i in range(300))

    t = threading.Thread(target=_profiling_test_hotspot, name="prof-busy", daemon=True)
    t.start()
    return stop, t


@BOTH
def test_sampler_start_stop_lifecycle(plane):
    sp = PLANES[plane].stackprof
    stop, t = _busy_thread()
    prof = sp.SamplingProfiler(hz=199, service="plugin")
    assert not prof.running
    prof.start()
    try:
        assert prof.running
        wait_for(lambda: prof.snapshot()["samples"] >= 10)
        assert prof.snapshot()["stacks"] >= 1
    finally:
        prof.stop()
        stop.set()
        t.join(timeout=2)
    assert not prof.running
    frozen = prof.snapshot()["samples"]
    time.sleep(0.05)
    assert prof.snapshot()["samples"] == frozen  # the thread is really gone
    col = prof.export_collapsed()
    assert "_profiling_test_hotspot" in col
    assert "stack-sampler" not in col  # the sampler never profiles itself
    assert PLANES[plane].profiling.HEARTBEATS.get("stack_sampler") is None


def _prof_leaf_c(entered, release):
    entered.set()
    release.wait(10)


def _prof_mid_b(entered, release):
    _prof_leaf_c(entered, release)


def _prof_root_a(entered, release):
    _prof_mid_b(entered, release)


def _parked_synthetic_stack():
    """A thread parked inside the module-level a→b→c nesting (so that both
    planes fold the same frames, file and first lines)."""
    entered, release = threading.Event(), threading.Event()
    t = threading.Thread(target=_prof_root_a, args=(entered, release),
                         name="synthetic-stack", daemon=True)
    t.start()
    assert entered.wait(5)
    return release, t


def _synthetic_key(sp) -> str:
    prof = sp.SamplingProfiler(hz=50, service="plugin")
    prof.sample_once()  # synchronous: no sampler thread
    match = [s for s in prof.folded_counts() if "thread:synthetic-stack" in s]
    assert len(match) == 1, match
    return match[0]


@BOTH
def test_folded_stack_correctness_on_known_synthetic_stack(plane):
    release, t = _parked_synthetic_stack()
    try:
        stack = _synthetic_key(PLANES[plane].stackprof)
    finally:
        release.set()
        t.join(timeout=2)
    ia, ib, ic = (stack.index(n) for n in ("_prof_root_a", "_prof_mid_b", "_prof_leaf_c"))
    assert ia < ib < ic, stack  # root first, call order kept
    assert stack.startswith("thread:synthetic-stack;")
    assert "_prof_leaf_c (test_torch_profiling.py:" in stack


def test_one_parked_stack_folds_to_the_same_key_on_both_planes():
    release, t = _parked_synthetic_stack()
    try:
        keys = {plane: _synthetic_key(p.stackprof) for plane, p in PLANES.items()}
    finally:
        release.set()
        t.join(timeout=2)
    assert keys["torch"] == keys["jax"], keys


@BOTH
def test_bounded_table_overflow_counts_and_caps(plane):
    sp = PLANES[plane].stackprof
    prof = sp.SamplingProfiler(hz=10, max_stacks=16)
    for i in range(40):
        prof._record([f"thread:x;frame_{i} (f.py:1)"], ts=time.time())
    counts = prof.folded_counts()
    assert len(counts) == 17  # 16 distinct stacks and the overflow bucket
    assert counts[sp.OVERFLOW_KEY] == 40 - 16
    assert prof.snapshot()["dropped_stacks"] == 40 - 16
    prof._record(["thread:x;frame_0 (f.py:1)"], ts=time.time())
    assert prof.folded_counts()["thread:x;frame_0 (f.py:1)"] == 2
    assert prof.snapshot()["dropped_stacks"] == 40 - 16


@BOTH
def test_ring_window_export_keeps_only_recent_seconds(plane):
    prof = PLANES[plane].stackprof.SamplingProfiler(hz=10, ring_s=300)
    now = time.time()
    prof._record(["thread:x;old (f.py:1)"], ts=now - 120)
    prof._record(["thread:x;recent (f.py:1)"], ts=now - 2)
    assert len(prof.folded_counts()) == 2
    assert list(prof.folded_counts(seconds=30)) == ["thread:x;recent (f.py:1)"]
    assert "old" not in prof.export_collapsed(seconds=30)
    assert "old" in prof.export_collapsed()


def _recorded(sp):
    prof = sp.SamplingProfiler(hz=10)
    for _ in range(3):
        prof._record(["thread:x;a (f.py:1);b (f.py:2)", "thread:y;c (g.py:3)"], ts=time.time())
    return prof


@BOTH
def test_speedscope_and_collapsed_exports_agree(plane):
    prof = _recorded(PLANES[plane].stackprof)
    col = flame.parse_collapsed(prof.export_collapsed())
    assert col == flame.from_speedscope(prof.export_speedscope())
    assert col[("thread:x", "a (f.py:1)", "b (f.py:2)")] == 3


def test_both_planes_export_the_same_documents():
    jax_prof, port = _recorded(jax_stackprof), _recorded(stackprof)
    assert port.export_collapsed() == jax_prof.export_collapsed()
    j, t = jax_prof.export_speedscope(), port.export_speedscope()
    assert t["profiles"] == j["profiles"] and t["shared"] == j["shared"]


@BOTH
def test_debug_profile_payload_modes(plane):
    p = PLANES[plane]
    saved = p.stackprof.PROFILER
    p.stackprof.install_profiler(None)
    try:
        t0 = time.monotonic()
        out = p.stackprof.debug_profile("")
        assert time.monotonic() - t0 < 0.5  # a bare GET never blocks
        assert out["enabled"] is False
        stop, t = _busy_thread()
        try:
            out = p.stackprof.debug_profile("seconds=0.3&format=collapsed&hz=97")
        finally:
            stop.set()
            t.join(timeout=2)
        assert out["enabled"] and out["burst"]
        assert "_profiling_test_hotspot" in out["folded"]
        prof = p.stackprof.SamplingProfiler(hz=97)
        p.stackprof.install_profiler(prof)
        prof.start()
        try:
            wait_for(lambda: prof.snapshot()["samples"] >= 3)
            payload = json.loads(p.metrics.debug_payload("/debug/profile"))
            assert payload["enabled"] is True and payload["profile"]["profiles"]
            payload = json.loads(p.metrics.debug_payload(
                "/debug/profile?seconds=0.2&format=collapsed"))
            assert payload["burst"] is False and payload["folded"]
        finally:
            prof.stop()
    finally:
        p.stackprof.install_profiler(saved)
    assert "/debug/profile" in p.metrics.DEBUG_ENDPOINTS


def test_profile_samples_count_into_their_family():
    before = metrics.PROFILE_SAMPLES.get()
    stop, t = _busy_thread()
    try:
        n = stackprof.SamplingProfiler(hz=50).sample_once()
    finally:
        stop.set()
        t.join(timeout=2)
    assert n >= 1 and metrics.PROFILE_SAMPLES.get() == before + n


def test_burst_is_capped_at_sixty_seconds(monkeypatch):
    seen = {}

    def fake_burst(seconds, hz=stackprof.DEFAULT_HZ, service="plugin"):
        seen["seconds"] = seconds
        return stackprof.SamplingProfiler(hz=hz)

    monkeypatch.setattr(stackprof, "profile_burst", fake_burst)
    monkeypatch.setattr(stackprof, "PROFILER", None)
    assert stackprof.debug_profile("seconds=3600")["seconds"] == 60.0
    assert seen["seconds"] == stackprof.MAX_BURST_SECONDS == 60.0


# -- GC pauses, lock waits ----------------------------------------------------


@BOTH
def test_gc_callback_records_pauses(plane):
    """The callback only buffers; flush_gc_pauses() drains into the
    histogram (the watchdog's tick does it in a daemon)."""
    p = PLANES[plane]
    before = p.metrics.GC_PAUSE.count(generation="2")
    p.profiling.enable_gc_monitor()
    p.profiling.enable_gc_monitor()  # idempotent: one callback
    try:
        assert gc.callbacks.count(p.profiling._gc_callback) == 1
        gc.collect()
        gc.collect()
        assert p.profiling.flush_gc_pauses() >= 2
    finally:
        p.profiling.disable_gc_monitor()
    after = p.metrics.GC_PAUSE.count(generation="2")
    assert after >= before + 2
    gc.collect()
    p.profiling.flush_gc_pauses()
    assert p.metrics.GC_PAUSE.count(generation="2") == after


@BOTH
def test_timed_lock_records_contended_waits_only(plane):
    p = PLANES[plane]
    h = p.Histogram("test_lock_wait_seconds", "t", buckets=(0.001, 1.0))
    lock = p.profiling.TimedLock("test_lock", h)
    with lock:
        pass
    assert h.count(lock="test_lock") == 0  # uncontended: no sample
    holder_in, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            holder_in.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert holder_in.wait(5)
    waited = {}

    def contender():
        t0 = time.perf_counter()
        with lock:
            waited["s"] = time.perf_counter() - t0

    t2 = threading.Thread(target=contender, daemon=True)
    t2.start()
    time.sleep(0.05)
    release.set()
    t.join(timeout=2)
    t2.join(timeout=2)
    assert h.count(lock="test_lock") == 1
    assert waited["s"] > 0.02


# -- heartbeats, the watchdog, supervised loops -------------------------------


@BOTH
def test_heartbeat_registry_register_beat_revive_unregister(plane):
    reg = PLANES[plane].profiling.HeartbeatRegistry()
    hb = reg.register("loop_a", interval_s=0.5)
    assert hb.max_silence_s == 15.0  # the generous floor
    hb.beat()
    assert hb.age_s() < 1.0 and hb.beats == 1
    hb.mark_dead("died")
    assert hb.dead and reg.snapshot()[0]["dead"]
    hb2 = reg.register("loop_a", interval_s=0.5)  # a restarted loop revives it
    assert hb2 is hb and not hb.dead
    reg.unregister("loop_a")
    assert reg.get("loop_a") is None and reg.snapshot() == []


@BOTH
def test_watchdog_detects_hung_loop_and_recovery(plane):
    """A hung fake loop: the watchdog exports its age, counts the stall once
    per excursion, fires the capture hook and records the recovery."""
    p = PLANES[plane]
    hang, stop, beating = threading.Event(), threading.Event(), threading.Event()
    name = f"fake_hung_loop_{plane}"

    def fake_loop():
        hb = p.profiling.HEARTBEATS.register(name, interval_s=0.05, max_silence_s=0.2)
        while not stop.is_set():
            hb.beat()
            beating.set()
            while hang.is_set() and not stop.is_set():
                time.sleep(0.02)  # wedged: no beats
            time.sleep(0.02)

    captured = []
    t = threading.Thread(target=fake_loop, daemon=True)
    t.start()
    dog = p.profiling.StallWatchdog(check_interval_s=0.05, service="plugin",
                                    on_stall=captured.append)
    before = p.metrics.LOOP_STALLS.get(loop=name, reason="stalled")
    try:
        assert beating.wait(5)
        assert dog.check_once() == []
        hang.set()
        wait_for(lambda: name in dog.check_once(), interval=0.05)
        assert p.metrics.HEARTBEAT_AGE.get(loop=name) > 0.2
        assert p.metrics.LOOP_STALLS.get(loop=name, reason="stalled") == before + 1
        assert captured == [name]
        dog.check_once()  # still stalled: no second count, no second capture
        assert p.metrics.LOOP_STALLS.get(loop=name, reason="stalled") == before + 1
        assert captured == [name]
        hang.clear()
        wait_for(lambda: name not in dog.check_once(), interval=0.05)
    finally:
        stop.set()
        t.join(timeout=2)
        p.profiling.HEARTBEATS.unregister(name)
        dog.check_once()  # prunes the gauge series
    assert p.metrics.HEARTBEAT_AGE.get(loop=name) == 0.0


@BOTH
def test_watchdog_thread_is_supervised_and_heartbeated(plane):
    p = PLANES[plane]
    dog = p.profiling.StallWatchdog(check_interval_s=0.05, service="plugin").start()
    try:
        wait_for(lambda: (hb := p.profiling.HEARTBEATS.get("stall_watchdog")) is not None
                 and hb.beats >= 2)
        assert [th for th in threading.enumerate() if th.name == "stall-watchdog"]
    finally:
        dog.stop()
    assert p.profiling.HEARTBEATS.get("stall_watchdog") is None  # a clean stop


@BOTH
def test_supervised_loop_death_fires_thread_liveness_then_clears(plane):
    p = PLANES[plane]
    name = f"doomed_loop_{plane}"
    before = p.metrics.LOOP_STALLS.get(loop=name, reason="died")

    def doomed():
        p.profiling.HEARTBEATS.register(name, interval_s=0.1).beat()
        raise RuntimeError("boom")

    t = threading.Thread(target=p.profiling.supervised(name, doomed), daemon=True)
    t.start()
    t.join(timeout=5)
    try:
        hb = p.profiling.HEARTBEATS.get(name)
        assert hb is not None and hb.dead and hb.dead_reason == "died"
        assert p.metrics.LOOP_STALLS.get(loop=name, reason="died") == before + 1
        mine = [f for f in p.audit.check_thread_liveness() if f.chip == name]
        assert len(mine) == 1
        assert (mine[0].severity, mine[0].invariant) == (p.audit.CRITICAL, "thread_liveness")
        stop = threading.Event()

        def healthy():
            hb = p.profiling.HEARTBEATS.register(name, interval_s=0.1)
            while not stop.is_set():
                hb.beat()
                time.sleep(0.02)

        t2 = threading.Thread(target=p.profiling.supervised(name, healthy), daemon=True)
        t2.start()
        wait_for(lambda: not [f for f in p.audit.check_thread_liveness() if f.chip == name])
        stop.set()
        t2.join(timeout=5)
        assert p.profiling.HEARTBEATS.get(name) is None
    finally:
        p.profiling.HEARTBEATS.unregister(name)


def _sampler(plane, tmp_path, fake):
    """A telemetry sampler of the plane over two cards, and its closer."""
    if plane == "jax":
        accel, dev = fakes.make_fake_tpu_node(str(tmp_path), "v5e", 4)
        mesh = IciMesh(PyTpuInfo().scan(accel, dev))
        return (lambda: jax_telemetry.TelemetrySampler(PyTpuInfo(), accel, mesh,
                                                       interval_s=0.05)), lambda: None
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 2)
    info = NvmlInfo(fake.path)
    chips = info.scan(str(tmp_path / "sys"), str(tmp_path / "dev"))
    return (lambda: telemetry.TelemetrySampler(info, str(tmp_path / "sys"), chips,
                                               interval_s=0.05)), info.close


@BOTH
def test_supervised_real_sampler_thread_death_is_reported(plane, tmp_path, fake):
    """A real wired loop (the telemetry sampler) dies on an unhandled
    exception: the death is visible, and a restarted sampler clears it."""
    p = PLANES[plane]
    tele = jax_telemetry if plane == "jax" else telemetry
    make, close = _sampler(plane, tmp_path, fake)
    sampler = make()
    sampler._stop.wait = lambda *_a, **_k: (_ for _ in ()).throw(
        RuntimeError("induced sampler death"))
    before = p.metrics.LOOP_STALLS.get(loop="telemetry_sampler", reason="died")
    sampler.start()
    try:
        wait_for(lambda: (hb := p.profiling.HEARTBEATS.get("telemetry_sampler")) is not None
                 and hb.dead)
        assert p.metrics.LOOP_STALLS.get(loop="telemetry_sampler", reason="died") == before + 1
        assert [f for f in p.audit.check_thread_liveness() if f.chip == "telemetry_sampler"]
        sampler2 = make()
        sampler2.start()
        try:
            wait_for(lambda: not [f for f in p.audit.check_thread_liveness()
                                  if f.chip == "telemetry_sampler"])
        finally:
            sampler2.stop()
    finally:
        p.profiling.HEARTBEATS.unregister("telemetry_sampler")
        for fam in tele.CHIP_FAMILIES:
            fam.remove_matching()
        close()


# -- the SLO capture ----------------------------------------------------------


def _fresh_capture(p, tmp_path, **kw):
    cm = p.profiling.CaptureManager()
    cfg = dict(capture_dir=str(tmp_path / "captures"), p99_ms=20.0, service="plugin",
               window_s=30.0, min_samples=5, budget=3, budget_window_s=60.0)
    cfg.update(kw)
    cm.configure(**cfg)
    return cm


@BOTH
def test_capture_disabled_observe_is_noop(plane):
    cm = PLANES[plane].profiling.CaptureManager()
    cm.observe("allocate", 10.0)  # unconfigured: one bool read, no state
    assert cm.snapshot()["windows"] == {}
    assert cm.capture("manual") is None


@BOTH
def test_capture_fires_once_per_crossing_and_rearms(plane, tmp_path):
    cm = _fresh_capture(PLANES[plane], tmp_path)
    for _ in range(16):
        cm.observe("allocate", 0.050)
    files = os.listdir(tmp_path / "captures")
    assert len(files) == 1 and "slo_allocate" in files[0], files
    for _ in range(16):
        cm.observe("allocate", 0.050)  # still over: de-duplicated
    assert len(os.listdir(tmp_path / "captures")) == 1
    for _ in range(600):
        cm.observe("allocate", 0.001)
    for _ in range(600):
        cm.observe("allocate", 0.050)  # under, then over again: re-armed
    assert len(os.listdir(tmp_path / "captures")) == 2


def test_one_latency_series_crosses_at_the_same_observation_on_both_planes(tmp_path):
    """The same Allocate latencies, fed one by one to both planes' capture
    managers: the bundles appear after the same observations, with the same
    windowed p99 and the same reasons."""
    series = [0.001] * 40 + [0.050] * 24 + [0.001] * 700 + [0.080] * 40
    seen = {}
    for plane, p in PLANES.items():
        cm = _fresh_capture(p, tmp_path / plane, budget=10)
        crossings = []
        for i, s in enumerate(series):
            before = len(os.listdir(tmp_path / plane / "captures")) if (
                tmp_path / plane / "captures").is_dir() else 0
            cm.observe("allocate", s)
            after = len(os.listdir(tmp_path / plane / "captures")) if (
                tmp_path / plane / "captures").is_dir() else 0
            if after > before:
                crossings.append((i, cm.snapshot()["windows"]["allocate"]["p99_ms"]))
        reasons = sorted(json.load(open(tmp_path / plane / "captures" / f))["reason"]
                         for f in os.listdir(tmp_path / plane / "captures"))
        seen[plane] = (crossings, reasons)
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"][0]) == 2, seen


@BOTH
def test_capture_bundle_contents_and_atomicity(plane, tmp_path):
    """The bundle carries every section and parses with the JAX package's
    flamegraph reader; no tmp file survives (the atomic replace)."""
    p = PLANES[plane]
    saved = p.stackprof.PROFILER
    stop, t = _busy_thread()
    prof = p.stackprof.SamplingProfiler(hz=97, service="plugin")
    p.stackprof.install_profiler(prof)
    prof.start()
    p.recorder.enable(service="plugin")
    p.ledger.enable(service="plugin")
    try:
        p.recorder.record("reconcile", "pre-incident context")
        p.ledger.record("allocate_substitution", "kubelet_choice", "context")
        wait_for(lambda: prof.snapshot()["samples"] >= 5)
        cm = _fresh_capture(p, tmp_path)
        p.profiling.HEARTBEATS.register("capture_test_loop", 0.1)
        path = cm.capture("stall_capture_test_loop", "test stall")
        assert path and os.path.exists(path)
        assert not [f for f in os.listdir(tmp_path / "captures") if f.endswith(".tmp")]
        bundle = json.load(open(path))
        assert set(bundle) == BUNDLE_KEYS
        assert (bundle["service"], bundle["reason"]) == ("plugin", "stall_capture_test_loop")
        assert bundle["profile"]["enabled"] is True
        folded = flame.load_path(path)
        assert any("_profiling_test_hotspot" in fr for stack in folded for fr in stack)
        kinds = [e["kind"] for e in bundle["flight"]["events"]]
        assert "reconcile" in kinds and "profile_capture" not in kinds
        assert bundle["flight"]["reason"] == "capture"
        assert any(r["kind"] == "allocate_substitution"
                   for r in bundle["decisions"]["records"])
        assert any(h["name"] == "capture_test_loop" for h in bundle["heartbeats"])
        assert "tpu_plugin_uptime_seconds" in bundle["metrics"]
        assert any(e["kind"] == "profile_capture" for e in p.recorder.export()["events"])
        assert p.ledger.query(kind="profile_capture")
        assert p.metrics.PROFILE_CAPTURES.get(reason="stall_capture_test_loop",
                                              outcome="ok") >= 1
    finally:
        prof.stop()
        p.stackprof.install_profiler(saved)
        stop.set()
        t.join(timeout=2)
        p.recorder.disable()
        p.recorder.clear()
        p.ledger.disable()
        p.ledger.clear()
        p.profiling.HEARTBEATS.unregister("capture_test_loop")


@BOTH
def test_capture_without_profiler_says_so(plane, tmp_path):
    p = PLANES[plane]
    saved = p.stackprof.PROFILER
    p.stackprof.install_profiler(None)
    try:
        bundle = json.load(open(_fresh_capture(p, tmp_path).capture("stall_x")))
    finally:
        p.stackprof.install_profiler(saved)
    assert set(bundle) == BUNDLE_KEYS and bundle["profile"]["enabled"] is False


@BOTH
def test_capture_budget_limits_bundles(plane, tmp_path):
    p = PLANES[plane]
    cm = _fresh_capture(p, tmp_path, budget=2)
    assert cm.capture("stall_a") is not None
    assert cm.capture("stall_b") is not None
    assert cm.capture("stall_c") is None  # a budget of 2 spent
    assert len(os.listdir(tmp_path / "captures")) == 2
    assert p.metrics.PROFILE_CAPTURES.get(reason="stall_c", outcome="budget") >= 1


@BOTH
def test_capture_alternating_ops_both_evaluate(plane, tmp_path):
    """The evaluation tick is per window: a strictly alternating op mix
    still evaluates the breaching op."""
    cm = _fresh_capture(PLANES[plane], tmp_path, budget=10)
    for _ in range(16):
        cm.observe("allocate", 0.050)  # breaching
        cm.observe("get_preferred_allocation", 0.001)  # healthy
    files = os.listdir(tmp_path / "captures")
    assert any("slo_allocate" in f for f in files), files
    assert not any("slo_get_preferred_allocation" in f for f in files), files


@BOTH
def test_capture_retention_keeps_newest_bundles(plane, tmp_path):
    cm = _fresh_capture(PLANES[plane], tmp_path, budget=10, keep=3)
    paths = []
    for i in range(5):
        paths.append(cm.capture(f"stall_loop{i}"))
        # Distinct mtimes: retention orders by them.
        os.utime(paths[-1], (time.time() - 10 + i, time.time() - 10 + i))
    assert all(paths)
    left = os.listdir(tmp_path / "captures")
    assert len(left) == 3
    assert any("stall_loop4" in f for f in left)  # the newest kept
    assert not any("stall_loop0" in f for f in left)  # the oldest pruned


# -- the capture–stall–audit acceptance scenario on the port's daemon ---------


def _injected_slow_allocate():
    """The frame the acceptance scenario expects as the hottest stack on the
    serving path: a sleep standing in for a regressed Allocate."""
    time.sleep(0.05)


def test_acceptance_slo_capture_stall_and_audit_on_the_port_daemon(tmp_path, fake,
                                                                    monkeypatch):
    """The port's daemon in-process over the fake NVML and a fake kubelet,
    with ``--profile-hz 97 --capture-dir --capture-p99-ms 20 --trace``, a
    sleep injected into Allocate and a wedged telemetry sampler: (1) one SLO
    bundle lands whose hottest serving-path stack names the injected frame,
    carrying the flight ring and the ledger tail; (2) the sampler's
    heartbeat age passes its threshold, the watchdog counts the stall and
    writes a stall bundle, and the thread_liveness finding fires, then
    clears once the loop resumes."""
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 2)
    dp_dir = tmp_path / "dp"
    dp_dir.mkdir()
    kubelet = FakeKubelet(str(dp_dir))
    kubelet.start()
    cap_dir = tmp_path / "captures"
    resume = threading.Event()
    real_allocate = GpuDevicePlugin._allocate
    real_poll = telemetry.TelemetrySampler.poll_once

    def slow_allocate(self, request, context):
        _injected_slow_allocate()
        return real_allocate(self, request, context)

    def wedged_poll(self):
        resume.wait()
        return real_poll(self)

    monkeypatch.setattr(GpuDevicePlugin, "_allocate", slow_allocate)
    monkeypatch.setattr(telemetry.TelemetrySampler, "poll_once", wedged_poll)
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(dp_dir), sysfs_pci_dir=str(tmp_path / "sys"),
        dev_dir=str(tmp_path / "dev"), nvml_library=fake.path, enable_controller=False,
        trace=True, profile_hz=97, capture_dir=str(cap_dir), capture_p99_ms=20.0,
        telemetry_interval_s=0.05))
    daemon._watchdog.check_interval_s = 0.1
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    engine = None
    try:
        assert kubelet.registered.wait(WAIT_S)
        wait_for(lambda: daemon.plugin is not None and daemon.telemetry_sampler is not None)
        stub = kubelet.plugin_stub()
        card = daemon.plugin.topology.ids[0]
        req = pb.AllocateRequest()
        req.container_requests.add(devicesIDs=[card])
        for _ in range(24):
            stub.Allocate(req, timeout=WAIT_S)
        wait_for(lambda: cap_dir.is_dir() and any("slo_allocate" in f
                                                  for f in os.listdir(cap_dir)))
        for _ in range(16):  # still over: no second SLO bundle
            stub.Allocate(req, timeout=WAIT_S)
        slo = [f for f in os.listdir(cap_dir) if "slo_allocate" in f]
        assert len(slo) == 1, slo
        bundle = json.load(open(cap_dir / slo[0]))
        assert set(bundle) == BUNDLE_KEYS and bundle["profile"]["enabled"] is True
        folded = flame.load_any(bundle)
        serving = {s: c for s, c in folded.items()
                   if any(fr.startswith("Allocate (plugin.py:") for fr in s)}
        assert serving, folded
        hottest = max(serving.items(), key=lambda kv: kv[1])[0]
        assert any("_injected_slow_allocate" in fr for fr in hottest), hottest
        assert any(e["kind"] == "allocate" for e in bundle["flight"]["events"])
        assert any(r["kind"] == "allocate_substitution" for r in bundle["decisions"]["records"])
        assert bundle["windows"]["allocate"]["p99_ms"] > 20.0
        assert metrics.PROFILE_CAPTURES.get(reason="slo_allocate", outcome="ok") >= 1

        # The wedged sampler: its heartbeat goes silent past a test-speed
        # threshold.
        wait_for(lambda: profiling.HEARTBEATS.get("telemetry_sampler") is not None)
        profiling.HEARTBEATS.get("telemetry_sampler").max_silence_s = 0.5
        # One watchdog check sets the age, then counts the crossing.
        wait_for(lambda: metrics.LOOP_STALLS.get(loop="telemetry_sampler", reason="stalled") >= 1)
        assert metrics.HEARTBEAT_AGE.get(loop="telemetry_sampler") > 0.5
        wait_for(lambda: any("stall_telemetry_sampler" in f for f in os.listdir(cap_dir)))
        engine = audit.AuditEngine("plugin", audit.shared_invariants(), interval_s=3600)

        def liveness():
            return [f for f in engine.sweep_once()
                    if f.invariant == "thread_liveness" and f.chip == "telemetry_sampler"]

        assert liveness(), engine.snapshot()
        resume.set()
        wait_for(lambda: not liveness(), interval=0.1)
    finally:
        resume.set()
        daemon.events.put(("signal", signal.SIGTERM))
        t.join(timeout=WAIT_S)
        kubelet.stop()
        metrics.AUDIT_FINDINGS.remove_matching()
        flightrecorder.RECORDER.clear()
        decisions.LEDGER.clear()
        from k8s_device_plugin_tpu_torch.utils import tracing

        tracing.disable()
        tracing.COLLECTOR.clear()
        flightrecorder.RECORDER.disable()
        decisions.LEDGER.disable()
    assert not t.is_alive()
    # The run's end put the process-wide state back.
    assert stackprof.PROFILER is None and not profiling.CAPTURE.enabled
    assert profiling._gc_callback not in gc.callbacks
    assert profiling.HEARTBEATS.get("stall_watchdog") is None
    assert profiling.HEARTBEATS.get("stack_sampler") is None


def test_sighup_stacks_no_second_gc_callback_watchdog_or_sampler(tmp_path, fake):
    """The profiler, the watchdog and the GC monitor belong to the process,
    not to a plugin generation: three SIGHUPs leave one of each, and SIGTERM
    none."""
    fake.reset()
    fk.hgx_node(fake, tmp_path / "sys", 2)
    dp_dir = tmp_path / "dp"
    dp_dir.mkdir()
    kubelet = FakeKubelet(str(dp_dir))
    kubelet.start()
    daemon = main.Daemon(main.DaemonConfig(
        device_plugin_dir=str(dp_dir), sysfs_pci_dir=str(tmp_path / "sys"),
        dev_dir=str(tmp_path / "dev"), nvml_library=fake.path, enable_controller=False,
        profile_hz=19, lockdep=True))
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()

    def alive(name):
        return [th for th in threading.enumerate() if th.name == name and th.is_alive()]

    try:
        for _ in range(3):
            assert kubelet.registered.wait(WAIT_S)
            kubelet.registered.clear()
            assert gc.callbacks.count(profiling._gc_callback) == 1
            wait_for(lambda: len(alive("stall-watchdog")) == 1
                     and len(alive("stack-sampler")) == 1)
            daemon.events.put(("signal", signal.SIGHUP))
        assert kubelet.registered.wait(WAIT_S)
        assert len(alive("stall-watchdog")) == 1 and len(alive("stack-sampler")) == 1
    finally:
        daemon.events.put(("signal", signal.SIGTERM))
        t.join(timeout=WAIT_S)
        kubelet.stop()
    assert not t.is_alive()
    assert not alive("stall-watchdog") and not alive("stack-sampler")
    assert profiling._gc_callback not in gc.callbacks
    assert stackprof.PROFILER is None
    # --lockdep found the graph on already (this file's fixture): it stays on.
    assert profiling.LOCKDEP.enabled


def test_daemon_turns_lockdep_off_only_when_it_turned_it_on():
    """A daemon's end puts lockdep back as it found it: off when its
    --lockdep turned it on, on when another owner had."""
    profiling.LOCKDEP.disable()
    try:
        daemon = main.Daemon(main.DaemonConfig(lockdep=True))
        assert profiling.LOCKDEP.enabled
        daemon._stop_process_planes()
        assert not profiling.LOCKDEP.enabled
    finally:
        profiling.LOCKDEP.enable()
    daemon = main.Daemon(main.DaemonConfig(lockdep=True))
    daemon._stop_process_planes()
    assert profiling.LOCKDEP.enabled


# -- lockdep ------------------------------------------------------------------


def _nest(a, b):
    with a:
        with b:
            pass


def _run(target, args=(), name=None):
    t = threading.Thread(target=target, args=args, name=name)
    t.start()
    t.join()


@BOTH
def test_lockdep_inversion_two_threads_with_witness_stacks(plane):
    """Two TimedLocks taken in opposite orders on two (sequential) threads
    fire exactly one cycle carrying both witness stacks."""
    pr = PLANES[plane].profiling
    g = pr.LockdepGraph().enable()
    a = pr.TimedLock("lock_a", lockdep=g)
    b = pr.TimedLock("lock_b", lockdep=g)
    _run(_nest, (a, b), "t-ab")
    assert g.cycles() == []  # one order alone is fine
    _run(_nest, (b, a), "t-ba")
    cycles = g.cycles()
    assert len(cycles) == 1, cycles
    nodes = " ".join(cycles[0]["nodes"])
    assert "lock_a@" in nodes and "lock_b@" in nodes
    assert {w["thread"] for w in cycles[0]["witnesses"]} == {"t-ab", "t-ba"}
    assert all("_nest" in w["stack"] for w in cycles[0]["witnesses"])
    _run(_nest, (b, a))
    assert len(g.cycles()) == 1  # the same inversion does not fire again


def test_one_inversion_gives_the_same_cycle_on_both_planes():
    shapes = {}
    for plane, p in PLANES.items():
        g = p.profiling.LockdepGraph().enable()
        a = p.profiling.TimedLock("lock_a", lockdep=g)
        b = p.profiling.TimedLock("lock_b", lockdep=g)
        _run(_nest, (a, b), "t-ab")
        _run(_nest, (b, a), "t-ba")
        (cyc,) = g.cycles()
        shapes[plane] = ([n.split("@")[0] for n in cyc["nodes"]],
                         sorted((w["edge"].replace(f"@{a._serial:x}", "@A")
                                 .replace(f"@{b._serial:x}", "@B"), w["thread"])
                                for w in cyc["witnesses"]))
    assert shapes["torch"] == shapes["jax"], shapes


@BOTH
def test_lockdep_consistent_order_stays_clean(plane):
    pr = PLANES[plane].profiling
    g = pr.LockdepGraph().enable()
    a, b = pr.TimedLock("idx", lockdep=g), pr.TimedLock("res", lockdep=g)
    for _ in range(3):
        _run(_nest, (a, b))
    assert g.cycles() == []
    snap = g.snapshot()
    assert len(snap["edges"]) == 1 and snap["edges"][0]["count"] == 3


@BOTH
def test_lockdep_self_deadlock_is_a_one_edge_cycle(plane):
    g = PLANES[plane].profiling.LockdepGraph().enable()
    g.note_acquire("table", 1)
    g.note_acquire("table", 1)  # re-acquiring a held Lock is the deadlock
    (cyc,) = g.cycles()
    assert cyc["nodes"] == ["table@1", "table@1"]


@BOTH
def test_lockdep_disabled_is_free_and_default_graph_is_global(plane):
    pr = PLANES[plane].profiling
    assert pr.TimedLock("plain")._dep() is pr.LOCKDEP
    g = pr.LockdepGraph()  # disabled
    with pr.TimedLock("off", lockdep=g):
        pass
    assert g.snapshot()["edges"] == []


@BOTH
def test_lockdep_release_out_of_order_keeps_held_set_sane(plane):
    pr = PLANES[plane].profiling
    g = pr.LockdepGraph().enable()
    a, b, c = (pr.TimedLock(n, lockdep=g) for n in ("a", "b", "c"))
    a.acquire()
    b.acquire()
    a.release()  # an out-of-LIFO release is legal for a Lock
    c.acquire()  # the held set is [b]: the edge b→c only
    c.release()
    b.release()
    edges = {(e["from"].split("@")[0], e["to"].split("@")[0]) for e in g.snapshot()["edges"]}
    assert edges == {("a", "b"), ("b", "c")}


@BOTH
def test_lockdep_cycle_overflow_is_counted_not_silent(plane):
    p = PLANES[plane]
    g = p.profiling.LockdepGraph().enable()
    g.MAX_CYCLES = 1
    before = p.metrics.LOCKDEP_CYCLES.get()
    g.note_acquire("a", 1)
    g.note_acquire("a", 1)  # stored cycle 1
    g.note_acquire("b", 2)
    g.note_acquire("b", 2)  # a distinct cycle 2: retention is full
    snap = g.snapshot()
    assert len(snap["cycles"]) == 1 and snap["dropped_cycles"] == 1
    assert p.metrics.LOCKDEP_CYCLES.get() == before + 2


@BOTH
def test_lockdep_edge_cap_counts_overflow(plane):
    g = PLANES[plane].profiling.LockdepGraph().enable()
    g.MAX_EDGES = 3
    g.note_acquire("root", 0)
    for i in range(1, 6):
        g.note_acquire("leaf", i)
        g.note_release("leaf", i)
    snap = g.snapshot()
    assert len(snap["edges"]) == 3 and snap["dropped_edges"] == 2


@BOTH
def test_lockdep_cross_thread_release_leaves_no_phantom_hold(plane):
    pr = PLANES[plane].profiling
    g = pr.LockdepGraph().enable()
    a, b = pr.TimedLock("handoff", lockdep=g), pr.TimedLock("other", lockdep=g)
    a.acquire()  # this thread acquires...
    _run(a.release)  # ...another releases
    with b:  # a phantom hold would record handoff→other
        pass
    assert g.snapshot()["edges"] == []


def test_port_lockdep_always_on_in_this_file():
    """The fixture enables the port's graph for every test here and
    asserts it acyclic at each end (the JAX conftest does so for JAX's)."""
    assert profiling.LOCKDEP.enabled and jax_profiling.LOCKDEP.enabled


@BOTH
def test_debug_lockdep_payload(plane):
    doc = json.loads(PLANES[plane].metrics.debug_payload("/debug/lockdep"))
    assert doc["enabled"] is True
    assert {"edges", "cycles", "dropped_edges", "dropped_cycles"} <= set(doc)


@BOTH
def test_timed_lock_feeds_the_global_graph_and_its_gauge(plane):
    p = PLANES[plane]
    outer, inner = p.profiling.TimedLock("outer_g"), p.profiling.TimedLock("inner_g")
    _run(_nest, (outer, inner))
    pair = (f"outer_g@{outer._serial:x}", f"inner_g@{inner._serial:x}")
    assert pair in {(e["from"], e["to"]) for e in p.profiling.LOCKDEP.snapshot()["edges"]}
    assert p.metrics.LOCKDEP_EDGES.get() >= 1


def test_port_daemon_builds_no_timed_lock_so_lockdep_reads_zero_edges():
    """The JAX node daemon builds no TimedLock (only its extender does), and
    neither does the port's: the only modules of the package that construct
    one are the extender's (its topology index and reservation table), so
    with --lockdep on the daemon's graph holds no edge."""
    import k8s_device_plugin_tpu_torch as pkg

    root = os.path.dirname(pkg.__file__)
    users = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and "TimedLock(" in open(os.path.join(dirpath, f)).read():
                users.append(os.path.relpath(os.path.join(dirpath, f), root))
    assert sorted(users) == ["extender/index.py", "extender/reservations.py"], users
