"""Filesystem and signal watchers for the supervisor loop, copied from the
JAX package's ``supervisor/watchers.py``.

The reference's watchers (watchers.go:10-32): an fsnotify watch on the
kubelet's device-plugins directory (a kubelet restart re-creates
kubelet.sock, main.go:93-97) and a buffered signal channel. Here inotify
is driven through ctypes (``utils/inotify.py``), with a stat-polling
fallback for filesystems without inotify.
"""

from __future__ import annotations

import errno
import os
import queue
import select
import signal
import struct
import threading
from typing import Callable, Iterable, Optional

from ..utils.inotify import (
    IN_CREATE,
    IN_DELETE,
    IN_MOVED_TO,
    add_watch,
    init_nonblocking,
    load_libc,
)
from ..utils import profiling
from ..utils.logging import get_logger

log = get_logger(__name__)

_EVENT_FMT = "iIII"
_EVENT_SIZE = struct.calcsize(_EVENT_FMT)


class FsWatcher:
    """Watches a directory; emits created/deleted file names to a queue.

    Events are (event_type, filename) tuples with event_type in
    {"create", "delete"}.
    """

    def __init__(self, path: str, out: "queue.Queue"):
        self.path = path
        self.out = out
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fd = -1

    def start(self) -> None:
        self._stop.clear()
        try:
            self._init_inotify()
            target = self._run_inotify
            log.info("inotify watch on %s", self.path)
        except OSError as e:
            log.warning("inotify unavailable (%s); polling %s", e, self.path)
            target = self._run_polling
        self._thread = threading.Thread(
            target=profiling.supervised("fs_watcher", target),
            name="fs-watcher",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    # -- inotify path ------------------------------------------------------

    def _init_inotify(self) -> None:
        libc = load_libc()
        fd = init_nonblocking(libc)
        wd = add_watch(
            libc, fd, self.path, IN_CREATE | IN_DELETE | IN_MOVED_TO
        )
        if wd < 0:
            os.close(fd)
            raise OSError(-wd, f"inotify_add_watch({self.path})")
        self._fd = fd

    def _run_inotify(self) -> None:
        hb = profiling.HEARTBEATS.register("fs_watcher", interval_s=0.5)
        while not self._stop.is_set():
            hb.beat()
            r, _, _ = select.select([self._fd], [], [], 0.5)
            if not r:
                continue
            try:
                data = os.read(self._fd, 4096)
            except OSError as e:
                if e.errno == errno.EAGAIN:
                    continue
                if not self._stop.is_set():
                    log.error("inotify read failed: %s", e)
                return
            off = 0
            while off + _EVENT_SIZE <= len(data):
                _wd, mask, _cookie, name_len = struct.unpack_from(
                    _EVENT_FMT, data, off
                )
                name = data[
                    off + _EVENT_SIZE : off + _EVENT_SIZE + name_len
                ].rstrip(b"\x00").decode()
                off += _EVENT_SIZE + name_len
                if mask & (IN_CREATE | IN_MOVED_TO):
                    self.out.put(("create", name))
                elif mask & IN_DELETE:
                    self.out.put(("delete", name))

    # -- polling fallback --------------------------------------------------

    def _snapshot(self):
        try:
            return {
                name: os.stat(os.path.join(self.path, name)).st_ino
                for name in os.listdir(self.path)
            }
        except OSError:
            return {}

    def _run_polling(self, interval: float = 1.0) -> None:
        prev = self._snapshot()
        hb = profiling.HEARTBEATS.register(
            "fs_watcher", interval_s=interval
        )
        while not self._stop.wait(interval):
            hb.beat()
            cur = self._snapshot()
            for name in cur:
                # A recreated file (new inode) counts as a create: that is
                # exactly the kubelet-restart signal we watch for.
                if name not in prev or prev[name] != cur[name]:
                    self.out.put(("create", name))
            for name in prev:
                if name not in cur:
                    self.out.put(("delete", name))
            prev = cur


class SignalWatcher:
    """Routes signals into the same event queue (the reference's buffered
    channel, watchers.go:25-32)."""

    def __init__(self, out: "queue.Queue", signals: Iterable[int] = ()):
        self.out = out
        self.signals = list(signals) or [
            signal.SIGHUP,
            signal.SIGINT,
            signal.SIGTERM,
        ]
        self._previous = {}

    def start(self) -> None:
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._handler)
        except ValueError:
            # Not the main thread (tests drive the event queue directly);
            # signals stay with the default handlers.
            log.debug("signal handlers unavailable off the main thread")
            self._previous.clear()

    def stop(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handler(self, signum, _frame) -> None:
        self.out.put(("signal", signum))
