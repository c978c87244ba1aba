"""Per-card telemetry exporter with pod attribution: the counterpart of the
JAX package's ``telemetry.py`` over NVIDIA cards.

The DCGM-exporter idiom, in-process: the reference leaves hardware
telemetry to a sidecar that polls NVML and joins each GPU's series to the
pod holding it through the kubelet's PodResources API. Here the daemon
owns both halves: the NVML backend reads each card's runtime counters
(``NvmlInfo.chip_telemetry``: utilization, device memory in use,
temperature, power, NVLink states) and the pod controller keeps the
card→pod map (``Controller.chip_attribution``). One sampler thread joins
them and publishes the ``tpu_chip_*`` families, labeled by ``chip`` (the
card's UUID) and, when the card is attributed, ``pod``/``namespace``/
``container``/``gang``.

The rules are the JAX design's:

* **Off costs nothing**: the sampler exists only when
  ``--telemetry-interval-s > 0``; no thread, no reads otherwise.
* **No invented zeros**: a counter NVML does not give removes its series
  rather than exporting 0.
* **Stale series are pruned**: when a card's attribution changes, its read
  fails or it leaves the node, every series it exported under the old
  label set is dropped before anything new is written.
* **Link-error deltas** count from a first-sight baseline, and a card's
  counter that went backwards restarts the delta from its new value.
* **Thresholds flight-record**: temperature and memory-pressure crossings
  land in the flight recorder once each way.

The node's capacity gauges share this module: ``update_node_gauges``
publishes the free cards, which request sizes place and the best set score
per size (``topology/placement.capacity_stats``, a placement search for
every size). The plugin only marks its state changed on every allocate,
free and health transition (``capacity_changed``); the search runs when the
gauges are read (``refresh_node_gauges``, on every ``/metrics`` scrape
and ``/debug/telemetry``), so no RPC waits for it. ``GET
/debug/telemetry`` serves both (``utils/metrics.debug_payload``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence

from .discovery.chips import GpuChip
from .topology.placement import capacity_stats
from .utils import metrics, profiling
from .utils.flightrecorder import RECORDER
from .utils.logging import get_logger

log = get_logger(__name__)

# Attribution labels joined from the controller's allocation map; empty
# values are omitted (an unattributed card exports chip-only series).
ATTRIBUTION_LABELS = ("pod", "namespace", "container", "gang")

# Every family that carries a per-card label set: the prune list for "this
# card's attribution changed / this card is gone".
CHIP_FAMILIES = (
    metrics.CHIP_DUTY_CYCLE,
    metrics.CHIP_HBM_USED,
    metrics.CHIP_HBM_RATIO,
    metrics.CHIP_TEMP,
    metrics.CHIP_POWER,
    metrics.CHIP_LINK_UP,
    metrics.CHIP_LINK_ERRORS,
)

# Flight-recorder thresholds: an H100 slows its clocks near 90 °C, so 90 °C
# is "look now"; memory above 95% is one allocation away from an
# out-of-memory error.
TEMP_THRESHOLD_C = 90.0
HBM_PRESSURE_RATIO = 0.95

# Process-global surface for /debug/telemetry (one daemon per process).
SAMPLER: Optional["TelemetrySampler"] = None
# The last capacity stats update_node_gauges wrote.
NODE_STATS: Optional[dict] = None
# () -> dict: the scheduler extender's cluster capacity aggregate (its
# topology index's ``placeable_snapshot``), served under "cluster" by
# /debug/telemetry; the latest-constructed index installs it.
CLUSTER_PROVIDER: Optional[Callable[[], dict]] = None
# The placement state whose capacity changed since the gauges were last
# computed, or None; the lock keeps two readers from computing at once.
_CHANGED = None
_REFRESH_LOCK = threading.Lock()


def capacity_changed(state) -> None:
    """Mark placement state ``state``'s capacity changed: the next read of
    the gauges recomputes them. Called by the plugin on every allocate,
    free and health transition."""
    global _CHANGED
    _CHANGED = state


def refresh_node_gauges() -> Optional[dict]:
    """Recompute the capacity gauges if ``capacity_changed`` marked a state
    since the last time; returns the node's capacity stats. A change that
    lands during the search marks the state again."""
    global _CHANGED
    with _REFRESH_LOCK:
        state, _CHANGED = _CHANGED, None
        if state is not None:
            update_node_gauges(state, state.available())
        return NODE_STATS


def update_node_gauges(state, free_ids) -> dict:
    """Publish the node's capacity gauges for the healthy-and-free card set
    ``free_ids`` of placement state ``state``."""
    global NODE_STATS
    stats = capacity_stats(state, free_ids)
    metrics.NODE_FREE_CHIPS.set(stats["free"])
    for fam, values in ((metrics.NODE_BOX_PLACEABLE, stats["placeable"]),
                        (metrics.NODE_BEST_SET_SCORE, stats["best_score"])):
        current = {str(n) for n in values}
        for labels, _ in fam.series():
            # A size the node cannot reach now (fewer cards after a
            # rebuild, fewer free for a score) must not linger.
            if labels.get("size") not in current:
                fam.remove(**labels)
        for n, value in values.items():
            fam.set(float(value), size=str(n))
    NODE_STATS = stats
    return stats


def gang_duty_cycles() -> Dict[str, float]:
    """gang label -> mean duty cycle (%) over the cards attributed to it on
    the sampler's last pass: the work-in-flight signal of the preemption
    planner's victim ranking (extender/preemption.py), where an idle gang is
    a cheaper victim than one at 95%. Empty when no sampler runs in this
    process, the extender's normal case (the attribution join and the duty
    series live on the node daemon)."""
    sampler = SAMPLER
    if sampler is None:
        return {}
    sums: Dict[str, list] = {}
    for chip in sampler.snapshot().get("chips", []):
        gang = chip.get("gang")
        duty = chip.get("duty_cycle_pct")
        if gang and duty is not None:
            sums.setdefault(gang, []).append(float(duty))
    return {g: sum(v) / len(v) for g, v in sums.items()}


def debug_snapshot() -> dict:
    """The /debug/telemetry payload: sampler state and the last per-card
    readings with attribution, the node's capacity stats, and the
    extender's cluster aggregate when this process keeps one."""
    out: dict = {"enabled": SAMPLER is not None}
    sampler = SAMPLER
    if sampler is not None:
        out.update(sampler.snapshot())
    out["node"] = refresh_node_gauges()
    provider = CLUSTER_PROVIDER
    if provider is not None:
        try:
            out["cluster"] = provider()
        except Exception:  # noqa: BLE001 - a debug surface must not 500
            log.exception("cluster telemetry provider failed")
            out["cluster"] = None
    return out


class TelemetrySampler:
    """Samples every card's runtime counters off the gRPC hot path.

    One thread, ``interval_s`` cadence (plus an immediate first pass at
    start), reading ``backend.chip_telemetry(scan_root, chip.index)`` for
    each of ``chips`` and joining ``attribution()``, the controller's
    card→{pod,namespace,container,gang} map, into the label sets.
    """

    def __init__(
        self,
        backend,
        scan_root: str,
        chips: Sequence[GpuChip],
        interval_s: float = 10.0,
        attribution: Optional[Callable[[], Dict[str, dict]]] = None,
    ):
        self._backend = backend
        self._scan_root = scan_root
        self.chips = list(chips)
        self.interval_s = interval_s
        self._attribution = attribution
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # card id → the label tuple its series carry now (the prune key).
        self._last_labels: Dict[str, tuple] = {}
        # card id → links seen on the last pass, so a link NVML stops
        # reporting prunes its series (absent is not frozen).
        self._last_links: Dict[str, set] = {}
        # (card id, link) → last cumulative error count, the delta base; it
        # survives attribution changes (the card's counter does not reset
        # when a pod does).
        self._err_base: Dict[tuple, int] = {}
        # (card id, condition) → above threshold now (dedups the flight
        # events while the condition persists).
        self._over: Dict[tuple, bool] = {}
        self._last_chips: list = []
        self._ticks = 0
        self._last_pass_ms = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        # Supervised: a sampler thread that dies on an unhandled exception
        # is counted, flight-recorded and trips thread_liveness, instead of
        # freezing every tpu_chip_* series at its last value.
        self._thread = threading.Thread(
            target=profiling.supervised("telemetry_sampler", self._run),
            name="tpu-telemetry-sampler",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 2)
            self._thread = None

    def _run(self) -> None:
        log.info("telemetry sampler started: %d cards, %.1fs interval",
                 len(self.chips), self.interval_s)
        hb = profiling.HEARTBEATS.register("telemetry_sampler", interval_s=self.interval_s)
        while not self._stop.is_set():
            hb.beat()
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the sampler must survive
                log.exception("telemetry sample pass failed")
                metrics.TELEMETRY_TICKS.inc(outcome="error")
            if self._stop.wait(self.interval_s):
                return

    # -- one pass ----------------------------------------------------------

    def _labels_for(self, chip_id: str, attr: dict) -> dict:
        labels = {"chip": chip_id}
        for k in ATTRIBUTION_LABELS:
            v = attr.get(k, "")
            if v:
                labels[k] = v
        return labels

    def _set_or_remove(self, fam, value, **labels) -> None:
        if value is None:
            fam.remove(**labels)
        else:
            fam.set(value, **labels)

    def _prune(self, chip_id: str) -> None:
        """Drop every series the card exported and its link bookkeeping."""
        for fam in CHIP_FAMILIES:
            fam.remove_matching(chip=chip_id)
        self._last_labels.pop(chip_id, None)
        self._last_links.pop(chip_id, None)
        for key in [k for k in self._err_base if k[0] == chip_id]:
            del self._err_base[key]

    def _threshold(self, chip_id: str, cond: str, over: bool, message: str, **attrs) -> None:
        """Record a flight event on each threshold crossing (either
        direction), never per sample while the condition persists."""
        was = self._over.get((chip_id, cond), False)
        if over == was:
            return
        self._over[(chip_id, cond)] = over
        kind = "chip_thermal" if cond == "thermal" else "chip_hbm_pressure"
        RECORDER.record(kind, message, chip=chip_id, state="over" if over else "cleared", **attrs)
        if over:
            log.warning("%s", message)

    def poll_once(self) -> None:
        """One sample pass; also callable synchronously (tests, tools).
        Never raises on a card's read failure: a broken card costs its own
        series, not the pass."""
        t0 = time.perf_counter()
        attribution: Dict[str, dict] = {}
        if self._attribution is not None:
            try:
                attribution = self._attribution() or {}
            except Exception:  # noqa: BLE001 - a failed join is not no telemetry
                log.exception("chip attribution lookup failed")
        ok = True
        chips_out = []
        seen = set()
        for chip in self.chips:
            cid = chip.device_id_str
            seen.add(cid)
            try:
                tel = self._backend.chip_telemetry(self._scan_root, chip.index)
            except (OSError, ValueError) as e:
                log.warning("telemetry read failed for %s: %s", cid, e)
                ok = False
                # Values hours old, still attributed to a pod, would read
                # as a healthy card to anyone triaging from a dashboard.
                if cid in self._last_labels:
                    self._prune(cid)
                continue
            attr = attribution.get(cid) or {}
            labels = self._labels_for(cid, attr)
            key = tuple(sorted(labels.items()))
            prev = self._last_labels.get(cid)
            if prev is not None and prev != key:
                # Attribution changed (pod freed or replaced): drop every
                # series the card exported under the old labels first.
                for fam in CHIP_FAMILIES:
                    fam.remove_matching(chip=cid)
            self._last_labels[cid] = key
            ratio = tel.hbm_used_ratio(chip.hbm_bytes)
            self._set_or_remove(metrics.CHIP_DUTY_CYCLE, tel.duty_cycle_pct, **labels)
            self._set_or_remove(metrics.CHIP_HBM_USED, tel.hbm_used_bytes, **labels)
            self._set_or_remove(metrics.CHIP_HBM_RATIO, ratio, **labels)
            self._set_or_remove(metrics.CHIP_TEMP, tel.temp_c, **labels)
            self._set_or_remove(metrics.CHIP_POWER, tel.power_w, **labels)
            current_links = {link.link for link in tel.links}
            for gone in self._last_links.get(cid, set()) - current_links:
                metrics.CHIP_LINK_UP.remove_matching(chip=cid, link=str(gone))
                metrics.CHIP_LINK_ERRORS.remove_matching(chip=cid, link=str(gone))
                self._err_base.pop((cid, gone), None)
            self._last_links[cid] = current_links
            for link in tel.links:
                llabels = dict(labels, link=str(link.link))
                metrics.CHIP_LINK_UP.set(1 if link.up else 0, **llabels)
                base_key = (cid, link.link)
                base = self._err_base.get(base_key)
                if base is None:
                    delta = 0  # first sight: the baseline, no history imported
                elif link.errors >= base:
                    delta = link.errors - base
                else:
                    delta = link.errors  # the card's counter reset
                self._err_base[base_key] = link.errors
                if delta or base is not None:
                    metrics.CHIP_LINK_ERRORS.inc(delta, **llabels)
            if tel.temp_c is not None:
                self._threshold(
                    cid, "thermal", tel.temp_c >= TEMP_THRESHOLD_C,
                    f"chip {cid} at {tel.temp_c:.1f}C (threshold {TEMP_THRESHOLD_C:.0f}C)",
                    temp_c=round(tel.temp_c, 1), pod=attr.get("pod", ""),
                )
            if ratio is not None:
                self._threshold(
                    cid, "hbm", ratio >= HBM_PRESSURE_RATIO,
                    f"chip {cid} HBM at {ratio * 100:.0f}% "
                    f"(threshold {HBM_PRESSURE_RATIO * 100:.0f}%)",
                    hbm_used_ratio=round(ratio, 3), pod=attr.get("pod", ""),
                )
            entry = tel.to_dict(chip.hbm_bytes)
            entry["chip"] = cid
            for k in ATTRIBUTION_LABELS:
                if attr.get(k):
                    entry[k] = attr[k]
            chips_out.append(entry)
        # Cards no longer among ``chips``: a full prune.
        for cid in [c for c in self._last_labels if c not in seen]:
            self._prune(cid)
        metrics.TELEMETRY_TICKS.inc(outcome="ok" if ok else "error")
        with self._lock:
            self._ticks += 1
            self._last_chips = chips_out
            self._last_pass_ms = (time.perf_counter() - t0) * 1e3

    def snapshot(self) -> dict:
        """The sampler's state: cadence, passes, the last pass's wall time
        (the sampler's own cost) and the last readings."""
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "ticks": self._ticks,
                "last_pass_ms": self._last_pass_ms,
                "chips": [dict(c) for c in self._last_chips],
            }


def install_sampler(sampler: Optional[TelemetrySampler]) -> None:
    """Register (or clear, with None) the process's sampler for the
    /debug/telemetry surface. The supervisor calls this around each plugin
    generation, so a SIGHUP rebuild swaps the snapshot source with the
    cards."""
    global SAMPLER
    SAMPLER = sampler
