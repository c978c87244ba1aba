"""The crash-durable black box of the JAX package's ``utils/blackbox.py``,
for the port's node daemon.

The flight ring, the decision ledger, the span collector, the heartbeat
table and the metric registry are in memory: a SIGKILL, an OOM or a node
reboot destroys the evidence that explains it. The black box keeps a
continuous, bounded, append-only tail of them on disk, so a ``kill -9``
loses at most the last unflushed drain interval.

* **Hot paths never block**: producers (``put``, through the flight,
  ledger and span taps) append to a bounded ``collections.deque``; past
  ``queue_max`` the record is dropped and counted
  (``tpu_blackbox_dropped_total``), never waited on.
* **Crash-safe on disk**: one supervised, heartbeated writer thread
  (``blackbox_writer``) drains the queue into segment files framed by
  ``utils/statestore.py``'s checksummed record grammar, so the reader
  keeps the intact prefix of a torn tail. The stream is flushed every
  drain and fsynced every ``fsync_interval_s``.
* **Bounded on disk**: segments rotate at ``segment_bytes`` and the
  directory is pruned oldest first past ``total_bytes``, a dead
  predecessor's segments included.

Record envelope (one statestore line each)::

    {"seq": n, "ts": epoch, "kind": K, "data": {...}}

with kinds ``meta`` (segment header: service, pid, build), ``flight``,
``decision``, ``span`` (one event, record or finished span, verbatim),
``heartbeats`` and ``metrics`` (periodic snapshots every
``snapshot_interval_s``), and ``stop`` (the clean-shutdown marker, whose
absence tells a crash from a clean exit).

``--blackbox-dir`` turns it on. ``python -m
k8s_device_plugin_tpu_torch.utils.blackbox <dir>`` prints a directory's
segments and records through :func:`read_dir`; the bytes are the JAX
plane's, so its ``tpu-doctor postmortem`` reads them too.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics, statestore

# Segment file grammar: blackbox-<service>-<pid>-<seq>.seg — pid keeps
# a restarted daemon from appending into its dead predecessor's
# segment (the predecessor's torn tail must stay readable evidence).
SEGMENT_RE = re.compile(
    r"^blackbox-(?P<service>[a-z0-9_-]+?)-(?P<pid>\d+)-"
    r"(?P<seq>\d{6})\.seg$"
)


def _segment_name(service: str, pid: int, seq: int) -> str:
    return f"blackbox-{service or 'daemon'}-{pid}-{seq:06d}.seg"


class BlackBoxRecorder:
    """One per process, like the flight recorder. Inert until
    :meth:`start`; every producer-facing method is a single attribute
    read when the recorder is off."""

    def __init__(self):
        self.enabled = False
        self.dir = ""
        self.service = ""
        self.segment_bytes = 4 * 1024 * 1024
        self.total_bytes = 64 * 1024 * 1024
        self.queue_max = 8192
        self.fsync_interval_s = 2.0
        self.drain_interval_s = 0.25
        self.snapshot_interval_s = 10.0
        # Producer side: appends are GIL-atomic; the length check is
        # approximate by design (an over-admit of a few records under
        # a race is fine, blocking an Allocate is not).
        self._queue: "collections.deque" = collections.deque()
        self.drops: Dict[str, int] = {}
        # Writer-thread-owned state (no lock: single owner).
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fh = None
        self._seq = 0
        self._segment_seq = 0
        self._segment_size = 0
        self._last_fsync = 0.0
        self._last_snapshot = 0.0
        self.records_written = 0
        self.bytes_written = 0
        self.rotations = 0
        self._degraded_reported = False

    # -- lifecycle -----------------------------------------------------------

    def start(
        self,
        directory: str,
        service: str = "plugin",
        segment_bytes: Optional[int] = None,
        total_bytes: Optional[int] = None,
        fsync_interval_s: Optional[float] = None,
        drain_interval_s: Optional[float] = None,
        snapshot_interval_s: Optional[float] = None,
        queue_max: Optional[int] = None,
    ) -> bool:
        """Configure, install the plane taps, and spawn the writer.
        Returns False (and stays inert) when ``directory`` is empty —
        the recorder-off parity contract: no directory, no file I/O,
        not even a mkdir."""
        if not directory or self.enabled:
            return False
        self.dir = directory
        self.service = service
        if segment_bytes is not None:
            self.segment_bytes = max(4096, int(segment_bytes))
        if total_bytes is not None:
            self.total_bytes = max(self.segment_bytes, int(total_bytes))
        if fsync_interval_s is not None:
            self.fsync_interval_s = max(0.0, float(fsync_interval_s))
        if drain_interval_s is not None:
            self.drain_interval_s = max(0.01, float(drain_interval_s))
        if snapshot_interval_s is not None:
            self.snapshot_interval_s = max(
                0.05, float(snapshot_interval_s)
            )
        if queue_max is not None:
            self.queue_max = max(16, int(queue_max))
        self._stop_ev = threading.Event()
        self.enabled = True
        self._install_taps()
        from . import profiling

        self._thread = threading.Thread(
            target=profiling.supervised("blackbox_writer", self._loop),
            name="blackbox-writer",
            daemon=True,
        )
        self._thread.start()
        return True

    def stop(self, timeout: float = 5.0) -> None:
        """Detach the taps, write the clean-shutdown ``stop`` marker,
        flush + fsync, and join the writer. Idempotent; never raises
        (a failed flush on the way down must not mask the original
        shutdown cause)."""
        if not self.enabled:
            return
        self.enabled = False  # producers gate off immediately
        self._remove_taps()
        self._stop_ev.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
        self._thread = None

    # -- producer side (hot paths; never block) ------------------------------

    def put(self, kind: str, data: dict) -> None:
        """Enqueue one record. First line is the enabled gate — one
        attribute read when the recorder is off. Past ``queue_max`` the
        record is dropped and counted: the black box absorbs pressure
        by losing tail records, never by making an Allocate wait."""
        if not self.enabled:
            return
        if len(self._queue) >= self.queue_max:
            self._drop("queue_full")
            return
        self._queue.append((round(time.time(), 3), kind, data))

    # The three plane taps (bound methods so remove_tap can find them).

    def _tap_flight(self, ev: dict) -> None:
        self.put("flight", ev)

    def _tap_decision(self, rec: dict) -> None:
        self.put("decision", rec)

    def _tap_span(self, span: dict) -> None:
        self.put("span", span)

    def _install_taps(self) -> None:
        from . import tracing
        from .decisions import LEDGER
        from .flightrecorder import RECORDER

        RECORDER.add_tap(self._tap_flight)
        LEDGER.add_tap(self._tap_decision)
        tracing.COLLECTOR.add_tap(self._tap_span)

    def _remove_taps(self) -> None:
        from . import tracing
        from .decisions import LEDGER
        from .flightrecorder import RECORDER

        RECORDER.remove_tap(self._tap_flight)
        LEDGER.remove_tap(self._tap_decision)
        tracing.COLLECTOR.remove_tap(self._tap_span)

    def _drop(self, reason: str) -> None:
        self.drops[reason] = self.drops.get(reason, 0) + 1
        metrics.family("BLACKBOX_DROPPED", self.service).inc(reason=reason)

    # -- writer thread -------------------------------------------------------

    def _loop(self) -> None:
        from . import profiling

        hb = profiling.HEARTBEATS.register(
            "blackbox_writer",
            interval_s=self.drain_interval_s,
            max_silence_s=max(10.0, self.drain_interval_s * 40),
        )
        self._last_fsync = time.time()
        self._last_snapshot = time.time()
        self._open_segment()
        while not self._stop_ev.wait(self.drain_interval_s):
            hb.beat()
            self._drain()
            self._periodic_snapshots()
            self._flush(force=False)
        # Shutdown: final drain, the clean-stop marker, a forced fsync
        # — everything enqueued before stop() was called survives.
        hb.beat()
        self._drain()
        self._write_record(
            "stop", {"reason": "clean_stop", "pid": os.getpid()}
        )
        self._flush(force=True)
        self._close_segment()

    def _open_segment(self) -> None:
        self._segment_seq += 1
        name = _segment_name(
            self.service, os.getpid(), self._segment_seq
        )
        try:
            os.makedirs(self.dir, exist_ok=True)
            self._fh = open(os.path.join(self.dir, name), "ab")
        except OSError:
            self._fh = None
            self._drop("write_error")
            self._report_degraded()
            return
        self._segment_size = 0
        self._degraded_reported = False
        self._write_record("meta", {
            "service": self.service,
            "pid": os.getpid(),
            "segment": self._segment_seq,
            "build": metrics.build_info(),
            "segment_bytes": self.segment_bytes,
            "total_bytes": self.total_bytes,
        })

    def _close_segment(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    def _drain(self) -> None:
        q = self._queue
        n = len(q)
        for _ in range(n):
            try:
                ts, kind, data = q.popleft()
            except IndexError:
                break
            self._write_record(kind, data, ts=ts)
        metrics.family("BLACKBOX_QUEUE", self.service).set(float(len(q)))

    def _write_record(
        self, kind: str, data: dict, ts: Optional[float] = None
    ) -> None:
        if self._fh is None:
            # A failed segment open degrades to counted drops; retried
            # at the next rotation boundary attempt below.
            self._open_segment()
            if self._fh is None:
                self._drop("write_error")
                return
        self._seq += 1
        buf = statestore.encode_record({
            "seq": self._seq,
            "ts": ts if ts is not None else round(time.time(), 3),
            "kind": kind,
            "data": data,
        })
        try:
            self._fh.write(buf)
        except OSError:
            self._drop("write_error")
            self._report_degraded()
            self._close_segment()
            return
        self._segment_size += len(buf)
        self.bytes_written += len(buf)
        self.records_written += 1
        metrics.family("BLACKBOX_RECORDS", self.service).inc(kind=kind)
        metrics.family("BLACKBOX_BYTES", self.service).inc(len(buf))
        if self._segment_size >= self.segment_bytes and kind != "meta":
            self._rotate()

    def _rotate(self) -> None:
        self._flush(force=True)
        self._close_segment()
        self.rotations += 1
        metrics.family("BLACKBOX_ROTATIONS", self.service).inc()
        self._open_segment()
        self._prune()

    def _prune(self) -> None:
        """Drop the oldest segments (any pid — a dead predecessor's
        too) until the directory is back under ``total_bytes``. The
        just-opened current segment is never a victim."""
        current = (
            os.path.basename(self._fh.name)
            if self._fh is not None else ""
        )
        segs = list_segments(self.dir, service=self.service)
        total = sum(s["size_bytes"] for s in segs)
        for s in segs:  # oldest first
            if total <= self.total_bytes:
                break
            if os.path.basename(s["path"]) == current:
                continue
            try:
                os.remove(s["path"])
            except OSError:
                continue
            total -= s["size_bytes"]

    def _flush(self, force: bool) -> None:
        if self._fh is None:
            return
        try:
            self._fh.flush()
            now = time.time()
            if force or (
                self.fsync_interval_s >= 0
                and now - self._last_fsync >= self.fsync_interval_s
            ):
                os.fsync(self._fh.fileno())
                self._last_fsync = now
        except OSError:
            self._drop("write_error")
            self._report_degraded()
            self._close_segment()

    def _periodic_snapshots(self) -> None:
        now = time.time()
        if now - self._last_snapshot < self.snapshot_interval_s:
            return
        self._last_snapshot = now
        from . import profiling

        self._write_record(
            "heartbeats", {"beats": profiling.HEARTBEATS.snapshot()}
        )
        self._write_record(
            "metrics", {"families": _family_totals(metrics.registry_for(self.service))}
        )

    def _report_degraded(self) -> None:
        """Flight-record the first write failure (throttled to one per
        degradation episode) — the black box reporting that it is
        lossy is itself evidence worth keeping in the ring."""
        if self._degraded_reported:
            return
        self._degraded_reported = True
        from .flightrecorder import RECORDER

        RECORDER.record(
            "blackbox_degraded",
            "black-box recorder cannot write its segment; records "
            "are being dropped (counted in tpu_blackbox_dropped_total)",
            dir=self.dir,
            drops=self.drops.get("write_error", 0),
        )

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/blackbox payload: config, counters and on-disk
        segment metadata (never record bodies: those are read from the
        files)."""
        snap = {
            "enabled": self.enabled,
            "dir": self.dir,
            "service": self.service,
            "segment_bytes": self.segment_bytes,
            "total_bytes": self.total_bytes,
            "fsync_interval_s": self.fsync_interval_s,
            "queue_depth": len(self._queue),
            "queue_max": self.queue_max,
            "records_written": self.records_written,
            "bytes_written": self.bytes_written,
            "rotations": self.rotations,
            "drops": dict(self.drops),
        }
        if self.dir:
            try:
                snap["segments"] = [
                    {k: v for k, v in s.items() if k != "path"}
                    for s in list_segments(self.dir)
                ]
            except OSError:
                snap["segments"] = []
        return snap


def _family_totals(registry) -> Dict[str, float]:
    """Compact per-family totals (labels summed) — the periodic
    ``metrics`` snapshot record. Totals, not series: the black box
    wants rate-of-change evidence at minimal byte cost, not a second
    scrape pipeline."""
    out: Dict[str, float] = {}
    for name, m in list(registry._metrics.items()):
        series = getattr(m, "series", None)
        if series is None:
            continue
        try:
            out[name] = round(sum(v for _, v in series()), 6)
        except Exception:  # noqa: BLE001 — best-effort snapshot
            continue
    return out


# -- readers -------------------------------------------------------------------


def list_segments(
    directory: str, service: str = ""
) -> List[dict]:
    """Segment metadata in the directory, oldest first (mtime then
    name). Never raises on a missing directory — an empty black box
    reads as zero segments, like an empty journal."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = SEGMENT_RE.match(name)
        if m is None:
            continue
        if service and m.group("service") != service:
            continue
        path = os.path.join(directory, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        out.append({
            "path": path,
            "name": name,
            "service": m.group("service"),
            "pid": int(m.group("pid")),
            "segment": int(m.group("seq")),
            "size_bytes": st.st_size,
            "mtime": round(st.st_mtime, 3),
        })
    out.sort(key=lambda s: (s["mtime"], s["pid"], s["segment"]))
    return out


def read_segment(path: str) -> Tuple[List[dict], str, int]:
    """(records, status, dropped_lines) for one segment, through the
    statestore journal grammar: a torn tail is the expected crash
    shape (status ``torn_tail``, the intact prefix returned), mid-file
    corruption stops at the damage. Never raises on an unreadable
    file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], statestore.CORRUPT, 0
    records, status, dropped, _ = statestore._decode_journal(data)
    return records, status, dropped


def read_dir(
    directory: str, service: str = ""
) -> Tuple[List[dict], dict]:
    """Every record across every segment (oldest segment first, file
    order within), plus per-segment read statuses."""
    records: List[dict] = []
    meta: dict = {"segments": []}
    for seg in list_segments(directory, service=service):
        recs, status, dropped = read_segment(seg["path"])
        records.extend(recs)
        meta["segments"].append({
            "name": seg["name"],
            "status": status,
            "records": len(recs),
            "dropped_lines": dropped,
            "size_bytes": seg["size_bytes"],
        })
    return records, meta


# One per process, like the metrics registry: a daemon is one process.
BLACKBOX = BlackBoxRecorder()


# -- CLI and self-test ---------------------------------------------------------


def _self_test() -> dict:
    """Drive the real chain: planes → taps → queue → writer →
    statestore-framed segments → a SIGKILL-shaped torn tail → read back
    through :func:`read_dir`. Raises on any drift; returns a summary."""
    import shutil
    import tempfile

    from . import profiling, tracing
    from .decisions import LEDGER
    from .flightrecorder import RECORDER

    tmp = tempfile.mkdtemp(prefix="blackbox-selftest-")
    d = os.path.join(tmp, "bb")
    bb = BlackBoxRecorder()
    try:
        RECORDER.enable("plugin")
        LEDGER.enable("plugin")
        tracing.enable("plugin")
        assert bb.start("", "plugin") is False  # no dir: inert
        assert bb.start(d, "plugin", fsync_interval_s=0.0, drain_interval_s=0.02,
                        snapshot_interval_s=0.05)
        # Traffic through the real planes, joined on one trace.
        with tracing.span("plugin.Allocate", containers=1) as sp:
            trace_id = sp.trace_id
            RECORDER.record("allocate", "1 container", chips="GPU-a")
            LEDGER.record("allocate_substitution", "preferred_unavailable",
                          "allocated GPU-a", node="node-a")
        kinds: set = set()
        deadline = time.time() + 10.0
        while time.time() < deadline:
            kinds = {r["kind"] for r in read_dir(d)[0]}
            if {"decision", "flight", "span", "heartbeats", "metrics"} <= kinds:
                break
            time.sleep(0.02)
        else:
            raise AssertionError(f"the taps never drained: {kinds}")
        bb.stop()
        recs, meta = read_dir(d)
        assert recs[0]["kind"] == "meta" and recs[-1]["kind"] == "stop", (recs[0], recs[-1])
        assert all(s["status"] == statestore.CLEAN for s in meta["segments"]), meta
        # A SIGKILL mid-write: cut the newest segment inside its last record;
        # the stop marker dies, the prefix stays readable.
        segs = list_segments(d)
        with open(segs[-1]["path"], "rb+") as f:
            f.truncate(segs[-1]["size_bytes"] - 5)
        recs, meta = read_dir(d)
        assert meta["segments"][-1]["status"] == statestore.TORN_TAIL, meta
        assert recs[-1]["kind"] != "stop"
        last = [r for r in recs if r["kind"] == "decision"][-1]["data"]
        assert last["kind"] == "allocate_substitution" and last["trace_id"] == trace_id, last
        # Rotation keeps to the byte budget under sustained load.
        rot = os.path.join(tmp, "rot")
        bb2 = BlackBoxRecorder()
        assert bb2.start(rot, "plugin", segment_bytes=4096, total_bytes=16384,
                         drain_interval_s=0.01, fsync_interval_s=0.0,
                         snapshot_interval_s=3600)
        for i in range(600):
            bb2.put("flight", {"kind": "x", "message": "y" * 64, "i": i})
            if i % 100 == 0:
                time.sleep(0.03)
        deadline = time.time() + 10.0
        while time.time() < deadline and len(bb2._queue):
            time.sleep(0.02)
        bb2.stop()
        sizes = [s["size_bytes"] for s in list_segments(rot)]
        assert bb2.rotations > 0, bb2.rotations
        assert sum(sizes) <= 16384 + 4096 + 512, sizes  # one segment in flight
        # A recorder never started touches nothing.
        off = BlackBoxRecorder()
        off.put("flight", {"kind": "ignored"})
        assert not os.path.exists(os.path.join(tmp, "never"))
        return {"records": len(recs), "trace_id": trace_id, "last_decision": last["kind"],
                "torn_segment": meta["segments"][-1]["name"], "rotations": bb2.rotations}
    finally:
        bb.stop()
        RECORDER.disable()
        RECORDER.clear()
        LEDGER.disable()
        LEDGER.clear()
        tracing.disable()
        tracing.COLLECTOR.clear()
        profiling.HEARTBEATS.unregister("blackbox_writer")
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    import json

    p = argparse.ArgumentParser(
        prog="blackbox",
        description="crash-durable black-box recorder (utils/blackbox.py): print a "
        "directory's segments and records, or run the self-test",
    )
    p.add_argument("dir", nargs="?", default="",
                   help="a --blackbox-dir to read: one JSON line per segment's read "
                   "status, then one per record, oldest first")
    p.add_argument(
        "--self-test", action="store_true",
        help="record through the real planes, cut a SIGKILL-shaped torn tail and "
        "read it back through read_dir (exits non-zero on drift). The JAX "
        "package's self-test reads back through tpu-doctor postmortem instead, "
        "which the port does not have yet",
    )
    a = p.parse_args(argv)
    if a.self_test:
        print(json.dumps(_self_test()))
        print("blackbox self-test: OK")
        return 0
    if a.dir:
        records, meta = read_dir(a.dir)
        for seg in meta["segments"]:
            print(json.dumps({"segment": seg}))
        for rec in records:
            print(json.dumps(rec))
        return 0 if meta["segments"] else 2
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
