"""The port's health watcher (health/watcher.py) against the JAX package's,
each over the port's NvmlInfo on the same fake NVML script (tests/
fake_nvml.c): the same callbacks, the same decision-ledger records and the
same ``APP_FAULTS`` counts, under every ``DP_DISABLE_HEALTHCHECKS`` class
and under an event source that dies."""

import threading
import time

import pytest

from k8s_device_plugin_tpu.health import watcher as jax_watcher
from k8s_device_plugin_tpu.utils import decisions as jax_decisions
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.health import watcher
from k8s_device_plugin_tpu_torch.utils import decisions, flightrecorder, metrics, profiling
from tests import torch_fake_nvml as fk

TOKENS = ("app_error", "app_abort", "preempted", "client_terminated")
# (card by NVML index or -1 for none, XID), in the order the events arrive.
SCRIPT = [(0, 31), (1, 79), (0, 43), (-1, 45), (3, 74), (-1, 48)]
LOST = 2  # falls off the bus after the scan
SIDES = {
    "jax": (jax_watcher.HealthWatcher, jax_decisions.LEDGER, jax_metrics.APP_FAULTS),
    "port": (watcher.HealthWatcher, decisions.LEDGER, metrics.APP_FAULTS),
}


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


@pytest.fixture(scope="module", autouse=True)
def ledgers():
    """Both ledgers on for the module, as a daemon with --decisions runs
    them; each is put back as it was."""
    was = [(led, led.enabled, led.service) for _, led, _ in SIDES.values()]
    for led, _, _ in was:
        led.enable("plugin")
    yield
    for led, enabled, service in was:
        led.clear()
        if enabled:
            led.enable(service)
        else:
            led.disable()


class Recording:
    """The backend, with a log of every event wait's outcome and every
    probe, so a test can tell when the watcher has acted on the script."""

    def __init__(self, backend):
        self._backend = backend
        self.log = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def _note(self, entry):
        with self._lock:
            self.log.append(entry)

    def chip_health_detail(self, *args):
        self._note("probe")
        return self._backend.chip_health_detail(*args)

    def health_events_wait(self, handle, timeout_ms):
        try:
            got = self._backend.health_events_wait(handle, timeout_ms)
        except OSError:
            self._note("error")
            raise
        self._note(got)
        return got

    def snapshot(self):
        with self._lock:
            return list(self.log)


def _settled(log, n_events, breaks, mode, n_chips):
    """True once the watcher has acted on every scripted event (and on the
    event source's failure) and swept every card at least once after."""
    if mode == "all":
        return True
    if mode in ("events", "xids"):  # no event wait: two full sweeps
        return log.count("probe") >= 2 * n_chips
    if breaks:
        if "error" not in log:
            return False
        return log[log.index("error"):].count("probe") >= n_chips
    if log.count(True) < n_events:
        return False
    last = len(log) - 1 - log[::-1].index(True)
    return False in log[last:]


def drive(side, fake, sysfs, script, mode="", breaks_after=None):
    """Run one side's watcher over a fresh NvmlInfo on ``script``; returns
    (callbacks, ledger records without their time stamps, APP_FAULTS
    counts added, the backend's log, the UUIDs by NVML index)."""
    cls, ledger, app_faults = SIDES[side]
    fake.reset()
    uuids = fk.hgx_node(fake, sysfs)
    for i, (dev, xid) in enumerate(script):
        if breaks_after == i:
            fake.break_events()
        fake.push_xid(dev, xid)
    if breaks_after is not None and breaks_after >= len(script):
        fake.break_events()
    before = {t: app_faults.get(reason=t) for t in TOKENS}
    ledger.clear()
    calls = []
    with NvmlInfo(fake.path) as info:
        chips = info.scan(str(sysfs), "/dev")
        fake.set_lost(LOST)
        backend = Recording(info)
        w = cls(backend, str(sysfs), "/dev", chips, lambda cid, ok: calls.append((cid, ok)),
                interval_s=0.1)
        w.start()
        try:
            deadline = time.monotonic() + 20
            n_events = len(script) if breaks_after is None else min(breaks_after, len(script))
            while not _settled(backend.snapshot(), n_events, breaks_after is not None, mode,
                               len(chips)):
                assert time.monotonic() < deadline, backend.snapshot()
                time.sleep(0.01)
        finally:
            w.stop()
    records = [{k: v for k, v in r.items() if k != "ts"} for r in ledger.query()]
    counts = {t: app_faults.get(reason=t) - before[t] for t in TOKENS}
    return calls, records, counts, backend.snapshot(), uuids


@pytest.mark.parametrize("mode, breaks_after", [
    ("", None), ("all", None), ("events", None), ("xids", None), ("interval", None),
    ("", 2), ("interval", 2),
], ids=["default", "all", "events", "xids", "interval", "dies", "dies-interval"])
def test_port_watcher_matches_the_jax_watcher(fake, tmp_path, monkeypatch, mode, breaks_after):
    monkeypatch.setenv("DP_DISABLE_HEALTHCHECKS", mode)
    monkeypatch.delenv("DP_APP_FAULT_REASONS", raising=False)
    jax_side = drive("jax", fake, tmp_path / "jax", SCRIPT, mode, breaks_after)
    port_side = drive("port", fake, tmp_path / "port", SCRIPT, mode, breaks_after)
    assert port_side[:3] == jax_side[:3]
    calls, records, counts, log, uuids = port_side
    withdrawn = [c for c, _ in calls]
    if mode == "all":
        assert calls == [] and records == [] and log == []
        return
    lost = uuids[LOST]
    assert (lost, False) in calls  # caught by the first sweep
    assert all(not ok for _, ok in calls) and len(withdrawn) == len(set(withdrawn))
    if mode in ("events", "xids"):
        assert calls == [(lost, False)] and records == []  # no XID is read
    elif breaks_after is None:
        # 79 on card 1, 74 on card 3, then 48 on every card: all withdrawn;
        # 31 and 43 on card 0 and 45 on cards 0 and 3 (card 1 stays at XID
        # 79, card 2 is lost) skipped and ledgered, never a transition
        assert len(calls) == 4
        assert counts == {"app_error": 1, "app_abort": 1, "preempted": 2,
                          "client_terminated": 0}
        assert {r["kind"] for r in records} == {"app_fault"}
    else:
        assert "error" in log and len(calls) == 2  # the lost card, then XID 79


def test_link_fault_is_corroborated_against_the_nvlinks(fake, tmp_path):
    """XID 74 (NVLink error) withdraws the card after the link telemetry was
    read: one ``ici_link_fault`` flight record naming the link that is
    down."""
    fake.reset()
    fk.hgx_node(fake, tmp_path)
    rec = flightrecorder.RECORDER
    was = rec.enabled
    rec.enable("plugin")
    rec.clear()
    try:
        with NvmlInfo(fake.path) as info:
            chips = info.scan(str(tmp_path), "/dev")
            fake.set_link(0, 5, active=False)
            h = info.health_events_open("", "/dev")
            fake.push_xid(0, 74)
            assert info.health_events_wait(h, 100)
            calls = []
            watcher.HealthWatcher(info, str(tmp_path), "/dev", chips,
                                  lambda c, ok: calls.append((c, ok))).poll_once()
        events = rec.export()["events"]
    finally:
        rec.clear()
        if not was:
            rec.disable()
    card0 = next(c for c in chips if c.index == 0)
    assert calls == [(card0.uuid, False)]
    assert [e["kind"] for e in events] == ["ici_link_fault"]
    assert events[0]["attrs"]["down_links"] == "5"
    assert events[0]["attrs"]["corroborated"] == "True"


@pytest.mark.parametrize("value", ["", "all", "Events", "xids, interval", "bogus"])
def test_disabled_classes_and_app_reasons_read_like_jax(monkeypatch, value):
    monkeypatch.setenv("DP_DISABLE_HEALTHCHECKS", value)
    monkeypatch.setenv("DP_APP_FAULT_REASONS", value)
    assert watcher.disabled_health_classes() == jax_watcher.disabled_health_classes()
    assert watcher.healthchecks_disabled() == jax_watcher.healthchecks_disabled()
    assert watcher.app_fault_reasons() == jax_watcher.app_fault_reasons()
    assert watcher.DEFAULT_APP_FAULT_REASONS == jax_watcher.DEFAULT_APP_FAULT_REASONS


def test_a_dying_loop_is_counted_and_its_heartbeat_marked():
    before = metrics.LOOP_STALLS.get(loop="t_loop", reason="died")

    def body():
        profiling.HEARTBEATS.register("t_loop", interval_s=1.0)
        raise RuntimeError("boom")

    t = threading.Thread(target=profiling.supervised("t_loop", body))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert metrics.LOOP_STALLS.get(loop="t_loop", reason="died") == before + 1
    hb = profiling.HEARTBEATS.get("t_loop")
    assert hb.dead and hb.stalled()
    profiling.HEARTBEATS.unregister("t_loop")
    profiling.run_supervised("t_clean", lambda: None)
    assert profiling.HEARTBEATS.get("t_clean") is None


def test_metrics_render_like_jax():
    """The copied registry renders the JAX text format for the same
    series."""
    ours, theirs = metrics.Registry(), jax_metrics.Registry()
    for reg in (ours, theirs):
        c = reg.counter("tpu_plugin_app_faults_total", "help")
        c.inc(reason="app_error")
        c.inc(2, reason="preempted")
        reg.gauge("g", "gauge help").set(1.5)
    strip = lambda text: [l for l in text.splitlines() if "uptime" not in l]  # noqa: E731
    assert strip(ours.render()) == strip(theirs.render())
    assert strip(ours.render(openmetrics=True)) == strip(theirs.render(openmetrics=True))
