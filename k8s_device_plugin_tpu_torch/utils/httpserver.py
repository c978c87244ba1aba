"""The background HTTP server of the JAX package's ``utils/httpserver.py``,
copied: a ``ThreadingHTTPServer`` on a daemon thread with start, stop and
port. The node daemon's ``MetricsServer`` (``utils/metrics.py``) stands on
it."""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Optional, Type

from . import profiling
from .logging import get_logger

log = get_logger(__name__)


class BackgroundHTTPServer:
    """A ThreadingHTTPServer run on a daemon thread with start/stop/port."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._address = (host, port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def handler_class(self) -> Type:
        raise NotImplementedError

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    def start(self) -> str:
        self._httpd = ThreadingHTTPServer(self._address, self.handler_class())
        # Supervised so a serve_forever that dies (a raising socketserver
        # internal) marks a dead heartbeat and trips thread_liveness
        # instead of leaving a silently connection-refusing daemon.
        self._thread = threading.Thread(
            target=profiling.supervised(
                f"http_{type(self).__name__}",
                self._httpd.serve_forever,
            ),
            name=type(self).__name__,
            daemon=True,
        )
        self._thread.start()
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
