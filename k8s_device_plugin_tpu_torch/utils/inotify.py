"""ctypes inotify primitives, copied from the JAX package's
``utils/inotify.py``: the supervisor's fs-watcher (``supervisor/
watchers.py``) watches the kubelet's device-plugins directory with them.
No third-party watcher package is needed; Go's fsnotify (the reference's
watchers.go:10-32) is these few syscalls.
"""

from __future__ import annotations

import ctypes
import os

# Event masks (linux/inotify.h).
IN_ACCESS = 0x00000001
IN_MODIFY = 0x00000002
IN_ATTRIB = 0x00000004
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200

# Entries appearing/disappearing (device nodes, sockets). Safe on busy
# shared dirs like /dev — never fires on mere writes to children.
PRESENCE_MASK = IN_CREATE | IN_DELETE | IN_MOVED_TO | IN_MOVED_FROM
# Presence plus content/attribute writes (sysfs attribute dirs).
MUTATION_MASK = PRESENCE_MASK | IN_MODIFY | IN_CLOSE_WRITE | IN_ATTRIB


def load_libc() -> ctypes.CDLL:
    return ctypes.CDLL("libc.so.6", use_errno=True)


def init_nonblocking(libc: ctypes.CDLL) -> int:
    """inotify_init1(IN_NONBLOCK); raises OSError when unavailable."""
    fd = libc.inotify_init1(os.O_NONBLOCK)  # IN_NONBLOCK == O_NONBLOCK
    if fd < 0:
        raise OSError(ctypes.get_errno(), "inotify_init1")
    return fd


def add_watch(libc: ctypes.CDLL, fd: int, path: str, mask: int) -> int:
    """Add a watch. Returns the watch descriptor (>= 0), or -errno when the
    path is unwatchable (ENOENT, ENOSPC watch limit, ...) — callers count
    successes, decide whether zero watches is fatal, and keep the real
    errno for the error they raise."""
    wd = libc.inotify_add_watch(fd, path.encode(), mask)
    return wd if wd >= 0 else -ctypes.get_errno()
