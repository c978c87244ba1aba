"""The sampling wall-clock profiler of the JAX package's
``utils/stackprof.py``, for the port's node daemon.

* One sampler thread (``stack-sampler``) wakes at ``--profile-hz`` (off by
  default) and walks every live thread's stack through
  ``sys._current_frames()``: a wall-clock profiler, so a thread blocked in
  a lock, a socket read or a wedged loop shows where it is stuck.
* Samples aggregate into a bounded folded-stack table. A frame is
  ``name (basename:firstline)``, so which statement runs inside a function
  mints no new key; past ``max_stacks`` new stacks fold into an
  ``(overflow)`` bucket and are counted.
* A ring of recent passes keeps the last ``ring_s`` seconds of raw samples,
  from which the SLO capture (``utils/profiling.CaptureManager``) takes
  "the profile of the last minute".
* The exports are collapsed stacks (Brendan Gregg's folded format) and
  speedscope JSON, served at ``GET /debug/profile`` (``?seconds=N`` waits
  for that trailing window, or runs a one-shot burst when no sampler runs;
  ``?format=`` picks the rendering). Samples count into
  ``tpu_profile_samples_total``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import metrics, profiling
from .logging import get_logger

log = get_logger(__name__)

# Default sampling rate for one-shot bursts (?seconds= with no running
# sampler). A prime, like py-spy's default reasoning: a rate that
# shares no harmonic with common loop cadences (10 Hz ticks, 1 s
# heartbeats) can't alias onto them and systematically miss/overcount
# a periodic stack.
DEFAULT_HZ = 19.0
# /debug/profile?seconds= is served inline on an HTTP handler thread;
# cap it so a typo'd query can't pin a handler for an hour.
MAX_BURST_SECONDS = 60.0
OVERFLOW_KEY = "(overflow)"


def _frame_label(frame) -> str:
    code = frame.f_code
    return (
        f"{code.co_name} "
        f"({os.path.basename(code.co_filename)}:{code.co_firstlineno})"
    )


def fold_frame(frame, thread_name: str = "") -> str:
    """One thread's stack as a collapsed-stack key, root first:
    ``thread;outer (file:line);...;leaf (file:line)``. Frame identity
    is (function, file, first line) — stable across which statement
    is executing, so the aggregation table stays small."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < 128:
        parts.append(_frame_label(frame))
        frame = frame.f_back
        depth += 1
    parts.reverse()
    head = [f"thread:{thread_name}"] if thread_name else []
    return ";".join(head + parts)


class SamplingProfiler:
    """Low-overhead wall-clock sampler over every thread in the process.

    ``start()`` spawns the sampler thread (daemon, named
    ``stack-sampler``); ``sample_once()`` is the direct entry tests and
    the burst path drive. ``pause()``/``resume()`` gate sampling
    without tearing the thread down."""

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        max_stacks: int = 4096,
        ring_s: float = 300.0,
        service: str = "plugin",
    ):
        self.hz = max(0.5, min(float(hz), 500.0))
        self.interval_s = 1.0 / self.hz
        self.max_stacks = max(16, int(max_stacks))
        self.ring_s = float(ring_s)
        self.service = service
        self._lock = threading.Lock()
        # folded stack -> sample count (bounded; overflow folds into
        # OVERFLOW_KEY and is counted in _dropped_stacks).
        self._folded: Dict[str, int] = {}
        self._dropped_stacks = 0
        # (wall ts, tuple of folded stacks from one pass) — the
        # last-N-seconds source for SLO-triggered captures.
        self._ring: "deque[Tuple[float, tuple]]" = deque(
            maxlen=max(8, int(self.hz * self.ring_s))
        )
        self._samples = 0  # passes taken
        self._started_ts = 0.0
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SamplingProfiler":
        self._stop.clear()
        self._started_ts = time.time()
        self._thread = threading.Thread(
            target=profiling.supervised("stack_sampler", self._run),
            name="stack-sampler",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._pause.clear()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 2)
            self._thread = None

    def pause(self) -> None:
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    def _run(self) -> None:
        log.info(
            "sampling profiler started: %.1f Hz, %d-stack table, "
            "%.0fs ring", self.hz, self.max_stacks, self.ring_s,
        )
        hb = profiling.HEARTBEATS.register(
            "stack_sampler", interval_s=self.interval_s
        )
        while not self._stop.wait(self.interval_s):
            hb.beat()
            if self._pause.is_set():
                continue
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the profiler must never
                # take a daemon down; one failed pass is one lost sample
                log.exception("stack sample pass failed")

    # -- sampling ----------------------------------------------------------

    def sample_once(self) -> int:
        """Walk every OTHER thread's stack once and record the pass.
        Returns how many stacks were captured. Callable from any
        thread (the sampler thread, a burst loop, a test) — the
        calling thread is excluded so the profiler never profiles its
        own bookkeeping."""
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        folded: List[str] = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            folded.append(fold_frame(frame, names.get(tid, str(tid))))
        self._record(folded, time.time())
        if folded:
            metrics.family("PROFILE_SAMPLES", self.service).inc(len(folded))
        return len(folded)

    def _record(self, folded: List[str], ts: float) -> None:
        """One pass into the bounded table + the ring (factored so the
        bounded-overflow tests can inject synthetic stacks)."""
        with self._lock:
            for key in folded:
                if key in self._folded:
                    self._folded[key] += 1
                elif len(self._folded) < self.max_stacks:
                    self._folded[key] = 1
                else:
                    self._dropped_stacks += 1
                    self._folded[OVERFLOW_KEY] = (
                        self._folded.get(OVERFLOW_KEY, 0) + 1
                    )
            self._ring.append((ts, tuple(folded)))
            self._samples += 1

    # -- export ------------------------------------------------------------

    def folded_counts(self, seconds: float = 0.0) -> Dict[str, int]:
        """Aggregated stack -> count. ``seconds > 0`` aggregates only
        the ring passes from the trailing window (the black-box
        capture's "last N seconds"); 0 returns the whole bounded
        table since start."""
        with self._lock:
            if seconds <= 0:
                return dict(self._folded)
            cutoff = time.time() - seconds
            out: Dict[str, int] = {}
            for ts, stacks in self._ring:
                if ts < cutoff:
                    continue
                for key in stacks:
                    out[key] = out.get(key, 0) + 1
            return out

    def export_collapsed(
        self, seconds: float = 0.0, counts: Optional[Dict[str, int]] = None
    ) -> str:
        """Brendan Gregg collapsed-stack text: one ``stack count`` line
        per distinct folded stack, hottest first. ``counts`` skips the
        ring scan when the caller already aggregated (bundle_section
        renders both formats from one scan)."""
        if counts is None:
            counts = self.folded_counts(seconds)
        return "\n".join(
            f"{stack} {n}"
            for stack, n in sorted(
                counts.items(), key=lambda kv: (-kv[1], kv[0])
            )
        )

    def export_speedscope(
        self, seconds: float = 0.0, counts: Optional[Dict[str, int]] = None
    ) -> dict:
        """A https://speedscope.app 'sampled' profile document. One
        sample entry per distinct stack with its count as the weight
        in seconds (count / hz) — the aggregation loses ordering, which
        a sampled profile never promises anyway."""
        if counts is None:
            counts = self.folded_counts(seconds)
        frames: List[dict] = []
        frame_idx: Dict[str, int] = {}
        samples: List[List[int]] = []
        weights: List[float] = []
        for stack, n in sorted(
            counts.items(), key=lambda kv: (-kv[1], kv[0])
        ):
            idxs = []
            for part in stack.split(";"):
                if part not in frame_idx:
                    frame_idx[part] = len(frames)
                    frames.append({"name": part})
                idxs.append(frame_idx[part])
            samples.append(idxs)
            weights.append(round(n / self.hz, 6))
        total = round(sum(weights), 6)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": [
                {
                    "type": "sampled",
                    "name": f"tpu-{self.service} wall clock",
                    "unit": "seconds",
                    "startValue": 0,
                    "endValue": total,
                    "samples": samples,
                    "weights": weights,
                    # Non-standard, ignored by the speedscope app: a
                    # reader recovers exact sample counts (count =
                    # weight × hz) instead of guessing a scale from the
                    # smallest weight.
                    "hz": self.hz,
                }
            ],
            "exporter": "k8s_device_plugin_tpu_torch stackprof",
        }

    def snapshot(self) -> dict:
        """Profiler state for /debug/profile and the capture bundle."""
        with self._lock:
            return {
                "hz": self.hz,
                "running": self.running,
                "samples": self._samples,
                "stacks": len(self._folded),
                "max_stacks": self.max_stacks,
                "dropped_stacks": self._dropped_stacks,
                "ring_seconds": self.ring_s,
                "ring_passes": len(self._ring),
                "started_ts": self._started_ts,
            }


# Process-global profiler (one daemon per process, the telemetry.SAMPLER
# idiom). None = --profile-hz is 0; /debug/profile then answers bursts
# only and the capture bundle's profile section reads enabled: false.
PROFILER: Optional[SamplingProfiler] = None


def install_profiler(profiler: Optional[SamplingProfiler]) -> None:
    global PROFILER
    PROFILER = profiler


def profile_burst(
    seconds: float, hz: float = DEFAULT_HZ, service: str = "plugin"
) -> SamplingProfiler:
    """One-shot inline profile: sample every thread at ``hz`` for
    ``seconds`` on the CALLING thread (no sampler thread involved) —
    the /debug/profile?seconds=N path when no continuous profiler is
    running. The calling thread excludes itself, so an HTTP handler
    burst profiles the daemon, not the burst loop."""
    seconds = max(0.05, min(float(seconds), MAX_BURST_SECONDS))
    prof = SamplingProfiler(hz=hz, ring_s=seconds + 1.0, service=service)
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        prof.sample_once()
        time.sleep(prof.interval_s)
    return prof


def bundle_section(window_s: float = 60.0) -> dict:
    """The capture bundle's profile section: the last ``window_s``
    seconds of samples from the installed profiler, in BOTH export
    formats (collapsed for flamegraph tools and grep, speedscope for the
    app), plus the profiler's own stats. ``enabled: false`` when no
    profiler is installed — a capture without a profile is still a
    capture (flight ring + ledger + metrics carry the story)."""
    prof = PROFILER
    if prof is None:
        return {
            "enabled": False,
            "note": "no sampling profiler installed (--profile-hz 0); "
            "the capture carries flight/ledger/metrics only",
        }
    counts = prof.folded_counts(window_s)
    seconds = window_s
    if not counts:
        # Fall back to the whole table when the window is empty (a
        # breach can fire within the first sampler interval of a
        # quiet start).
        counts = prof.folded_counts(0.0)
        seconds = 0.0
    # One ring scan, both renderings — capture time is mid-incident.
    return {
        "enabled": True,
        "seconds": seconds,
        "stats": prof.snapshot(),
        "folded": prof.export_collapsed(counts=counts),
        "speedscope": prof.export_speedscope(counts=counts),
    }


def debug_profile(query: str = "", service: str = "") -> dict:
    """The ``GET /debug/profile`` payload (metrics.debug_payload).

    Query params:

    * ``seconds=N`` — with a running profiler: block N seconds, then
      export exactly that trailing window (a fresh capture of "what is
      the daemon doing right now"); without one: run a one-shot
      inline burst of N seconds. Clamped to ``MAX_BURST_SECONDS``.
    * ``format=collapsed|speedscope`` — the export rendering
      (default speedscope; collapsed is wrapped in JSON as the
      ``folded`` string).
    * ``hz=H`` — burst-only sampling rate override.

    With no profiler and no ``seconds`` the payload reports
    ``enabled: false`` fast: a bare GET of every registered debug
    endpoint must not block."""
    import urllib.parse as _up

    q = dict(_up.parse_qsl(query or ""))
    try:
        seconds = float(q.get("seconds", "0") or 0)
    except ValueError:
        seconds = 0.0
    seconds = max(0.0, min(seconds, MAX_BURST_SECONDS))
    fmt = q.get("format", "speedscope")
    if fmt not in ("speedscope", "collapsed"):
        fmt = "speedscope"
    try:
        hz = float(q.get("hz", str(DEFAULT_HZ)) or DEFAULT_HZ)
    except ValueError:
        hz = DEFAULT_HZ
    prof = PROFILER
    burst = False
    if prof is not None and prof.running:
        if seconds > 0:
            time.sleep(seconds)
    elif seconds > 0:
        prof = profile_burst(seconds, hz=hz, service=service or "plugin")
        burst = True
    else:
        return {
            "enabled": False,
            "note": "no sampling profiler running (--profile-hz 0); "
            "pass ?seconds=N for a one-shot burst",
        }
    out = {
        "enabled": True,
        "service": service or prof.service,
        "burst": burst,
        "seconds": seconds,
        "format": fmt,
        "stats": prof.snapshot(),
    }
    window = seconds if not burst else 0.0
    if fmt == "collapsed":
        out["folded"] = prof.export_collapsed(window)
    else:
        out["profile"] = prof.export_speedscope(window)
    return out
