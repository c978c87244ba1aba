"""Card health watcher: a copy of the JAX package's ``health/watcher.py``
over the port's NVML backend (``discovery/scanner.NvmlInfo``).

The reference registers for NVML XidCriticalError events and waits on
them in a loop (nvidia.go:51-102); here the backend's event source is that
same NVML event set (``health_events_open``/``_wait``/``_close``), and the
interval sweep reads each card's state (``chip_health_detail``): lost from
the bus, a hardware XID seen (sticky until the daemon restarts, as in the
reference), or an application-level XID.

Fault classification: the reference skips application-level XIDs 31, 43
and 45 so that an application's crash does not mark the GPU unhealthy
(nvidia.go:84-86). The backend reports those XIDs as the JAX watcher's
app-fault tokens (``app_error``, ``app_abort``, ``preempted``), so this
watcher skips them unchanged: the card stays advertised Healthy (counted
in metrics and ledgered), while any other XID (``xid_<n>``) or a lost card
(``gpu_lost``) is hardware-grade Unhealthy.

The behaviour is the JAX watcher's, line for line: one callback per
transition, the app-fault skip and its ledger record, the link-fault
corroboration (keyed here also on XID 74, NVIDIA's NVLink error, and read
against the NVLinks' states), ``DP_DISABLE_HEALTHCHECKS`` with the classes
``all``, ``events`` (alias ``xids``) and ``interval``,
``DP_APP_FAULT_REASONS``, the event wait in 500 ms slices, and interval
sweeps coming back on when the event source dies.

Differences from the reference, both deliberate (and both the JAX
watcher's): transitions are reported in both directions, and a card whose
event registration is not supported is polled, not marked unhealthy.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, FrozenSet, Optional, Sequence

from ..api import constants
from ..discovery.chips import GpuChip
from ..utils import metrics, profiling
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.logging import get_logger

log = get_logger(__name__)

HealthCallback = Callable[[str, bool], None]  # (chip_id, healthy)

# Fault-reason tokens classified as *application-level*: transient faults
# caused by the workload (or its teardown), not the card: the reference's
# skip list of XIDs 31 (GPU memory page fault, app), 43 (GPU stopped
# processing, app) and 45 (preemptive cleanup, app) (nvidia.go:84-86),
# which the NVML backend reports as the first three tokens. Overridable
# via DP_APP_FAULT_REASONS.
DEFAULT_APP_FAULT_REASONS = frozenset(
    {
        "app_error",          # workload accessed HBM out of bounds (XID 31)
        "app_abort",          # workload aborted mid-step (XID 43)
        "preempted",          # runtime preempted the program (XID 45)
        "client_terminated",  # the runtime client went away mid-execution
    }
)

# Fault reasons that name a broken link, corroborated against the link
# telemetry before the withdrawal propagates: the JAX token, and XID 74
# (NVLink error) as the NVML backend reports it.
LINK_FAULT_REASONS = frozenset({"ici_link_down", "xid_74"})


def disabled_health_classes() -> FrozenSet[str]:
    v = os.environ.get(constants.ENV_DISABLE_HEALTHCHECKS, "")
    classes = {c.strip().lower() for c in v.split(",") if c.strip()}
    if "xids" in classes:  # reference spelling of its event class
        classes.add("events")
    return frozenset(classes)


def healthchecks_disabled() -> bool:
    return "all" in disabled_health_classes()


def app_fault_reasons() -> FrozenSet[str]:
    v = os.environ.get(constants.ENV_APP_FAULT_REASONS)
    if v is None:
        return DEFAULT_APP_FAULT_REASONS
    return frozenset(t.strip().lower() for t in v.split(",") if t.strip())


class HealthWatcher:
    """Polls chip health and reports transitions to a callback.

    The callback contract is the JAX plugin's notify_health: it is
    invoked once per chip per transition (not per poll), from the watcher
    thread (or the caller's thread for an explicit poll_once()).
    """

    def __init__(
        self,
        backend,
        sysfs_accel_dir: str,
        dev_dir: str,
        chips: Sequence[GpuChip],
        callback: HealthCallback,
        interval_s: float = 5.0,
    ):
        self._backend = backend
        self._sysfs = sysfs_accel_dir
        self._dev = dev_dir
        self._chips = list(chips)
        self._callback = callback
        self._interval = interval_s
        self._last: Dict[str, bool] = {c.device_id_str: True for c in self._chips}
        # chip id → last app-level fault reason seen (dedups the log/metric
        # while the same transient fault persists across sweeps).
        self._app_fault: Dict[str, str] = {}
        self._app_reasons = app_fault_reasons()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if healthchecks_disabled():
            log.warning(
                "%s contains 'all'; health checks disabled",
                constants.ENV_DISABLE_HEALTHCHECKS,
            )
            return
        self._stop.clear()
        # Supervised (utils/profiling.py): a dead health watcher means
        # broken chips stay advertised Healthy — loud, not silent.
        self._thread = threading.Thread(
            target=profiling.supervised("health_watcher", self._run),
            name="tpu-health-watcher",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 2)
            self._thread = None

    def _probe(self, chip: GpuChip) -> "tuple[bool, str]":
        if hasattr(self._backend, "chip_health_detail"):
            return self._backend.chip_health_detail(
                self._sysfs, self._dev, chip.index
            )
        return (
            bool(self._backend.chip_health(self._sysfs, self._dev, chip.index)),
            "",
        )

    def poll_once(self) -> None:
        """One health sweep; called synchronously by the supervisor before
        the first ListAndWatch advertisement (a chip already broken at
        daemon start must never be advertised Healthy), and by the watcher
        thread."""
        for chip in self._chips:
            cid = chip.device_id_str
            try:
                healthy, reason = self._probe(chip)
            except (OSError, ValueError) as e:
                # Whole-tree failure (or chip directory gone): unhealthy.
                log.error("health probe failed for %s: %s", cid, e)
                healthy, reason = False, "probe_error"
            if not healthy and reason in self._app_reasons:
                # Application-level fault: skip the transition entirely —
                # the reference's XID 31/43/45 'continue' (nvidia.go:84-86).
                # Skipping (not asserting Healthy) matters: a chip already
                # hardware-Unhealthy whose attribute later shows an
                # app-class token must STAY withdrawn until a genuinely
                # healthy probe.
                if self._app_fault.get(cid) != reason:
                    self._app_fault[cid] = reason
                    log.info(
                        "chip %s reported app-level fault %r; not marking "
                        "unhealthy",
                        cid,
                        reason,
                    )
                    metrics.APP_FAULTS.inc(reason=reason)
                    # The skip IS a health decision (the XID 31/43/45
                    # analog): ledger it so "why wasn't this chip
                    # withdrawn?" has a queryable answer.
                    LEDGER.record(
                        "app_fault", reason,
                        f"chip {cid} reported app-level fault "
                        f"{reason!r}; NOT marked unhealthy",
                        chip=cid,
                    )
                continue
            self._app_fault.pop(cid, None)
            if healthy != self._last[cid]:
                self._last[cid] = healthy
                if not healthy and reason in LINK_FAULT_REASONS:
                    # The fault reason and the per-link telemetry (each
                    # NVLink's state) must tell one story: corroborate before
                    # the withdrawal propagates, so "which link, how
                    # many errors" rides the transition instead of
                    # waiting for the next sampler tick — and a
                    # DISAGREEMENT (health says link down, every link
                    # reads up) is flagged as its own fault.
                    self._corroborate_link_fault(chip, cid, reason)
                self._callback(cid, healthy)

    def _corroborate_link_fault(self, chip: GpuChip, cid: str, reason: str) -> None:
        """Cross-check a link-fault health reason against the backend's
        per-link telemetry. Flight-records the evidence (``ici_link_fault``)
        either way; warns when the two readings disagree. Never blocks or
        fails the transition — corroboration is evidence, not a veto."""
        if not hasattr(self._backend, "chip_telemetry"):
            return
        try:
            tel = self._backend.chip_telemetry(self._sysfs, chip.index)
        except (OSError, ValueError) as e:
            log.warning("link telemetry read failed for %s: %s", cid, e)
            return
        down = [l.link for l in tel.links if not l.up]
        corroborated = bool(down)
        RECORDER.record(
            "ici_link_fault",
            f"chip {cid} health reads {reason}; telemetry shows "
            + (
                f"link(s) {','.join(str(k) for k in down)} down"
                if down
                else "no link down"
            ),
            chip=cid,
            down_links=",".join(str(k) for k in down),
            link_errors=sum(l.errors for l in tel.links),
            corroborated=corroborated,
        )
        if tel.links and not corroborated:
            log.warning(
                "chip %s: health reports %s but every link reads up — "
                "the two surfaces disagree; trust the withdrawal, suspect "
                "the driver",
                cid,
                reason,
            )

    def _run(self) -> None:
        disabled = disabled_health_classes()
        events_fd = None
        if "events" not in disabled and hasattr(
            self._backend, "health_events_open"
        ):
            try:
                events_fd = self._backend.health_events_open(
                    self._sysfs, self._dev
                )
            except OSError as e:
                log.warning(
                    "health event source unavailable (%s); interval "
                    "polling only",
                    e,
                )
        interval_sweeps = "interval" not in disabled
        if not interval_sweeps and events_fd is None:
            log.warning(
                "%s disables interval sweeps and no event source is "
                "available: health checking is inert",
                constants.ENV_DISABLE_HEALTHCHECKS,
            )
        log.info(
            "health watcher started: %d chips, %.1fs interval%s, events=%s",
            len(self._chips),
            self._interval,
            "" if interval_sweeps else " (interval sweeps disabled)",
            events_fd is not None,
        )
        # Warm-up sweep, deliberately run even when the supervisor's
        # synchronous pre-serve sweep just happened: it executes AFTER the
        # event source opened, so a health flip landing in the window
        # between that sync sweep and the event set's registration is
        # caught here rather than one full interval later.
        if not self._stop.is_set():
            self.poll_once()
        hb = profiling.HEARTBEATS.register(
            "health_watcher", interval_s=self._interval
        )
        try:
            while not self._stop.is_set():
                hb.beat()
                woke = False
                if events_fd is not None:
                    # Wait for an event OR one full interval (the fallback
                    # sweep), in sub-second slices so stop() is prompt.
                    try:
                        waited = 0.0
                        while waited < self._interval and not self._stop.is_set():
                            if self._backend.health_events_wait(
                                events_fd, 500
                            ):
                                woke = True
                                break
                            waited += 0.5
                    except OSError as e:
                        log.warning("health event wait failed (%s)", e)
                        self._backend.health_events_close(events_fd)
                        events_fd = None
                        if not interval_sweeps:
                            # The event source died and interval sweeps are
                            # disabled by config: going inert would silently
                            # end all health monitoring — fall back to
                            # interval sweeps instead (loudly).
                            log.warning(
                                "event source lost with 'interval' in %s; "
                                "re-enabling interval sweeps so health "
                                "checking stays live",
                                constants.ENV_DISABLE_HEALTHCHECKS,
                            )
                            interval_sweeps = True
                elif self._stop.wait(self._interval):
                    break
                if self._stop.is_set():
                    break
                if woke or interval_sweeps:
                    self.poll_once()
        finally:
            if events_fd is not None:
                self._backend.health_events_close(events_fd)
