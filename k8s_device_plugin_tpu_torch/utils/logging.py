"""The logging bootstrap of the JAX package's ``utils/logging.py``, plain
format: every module takes its logger from ``get_logger``, and the node
daemon's entry point calls ``setup`` once (level from ``-v`` or
``TPU_LOG_LEVEL``; each line carries the open span's trace id when tracing
is on). The JSON-lines format comes with the observability plane."""

from __future__ import annotations

import logging
import os
import time


def get_logger(name: str) -> logging.Logger:
    """The module-logger constructor every package module uses (in
    place of bare ``logging.getLogger``)."""
    return logging.getLogger(name)


class TraceContextFilter(logging.Filter):
    """Stamps trace_id/span_id from the active span onto each record
    (empty strings when no span is open or tracing is disabled)."""

    def filter(self, record: logging.LogRecord) -> bool:
        from . import tracing

        ctx = tracing.current()
        record.trace_id = ctx.trace_id if ctx else ""
        record.span_id = ctx.span_id if ctx else ""
        return True


class PlainFormatter(logging.Formatter):
    """The human format, plus a trailing trace marker when a span is
    active."""

    def __init__(self):
        super().__init__("%(asctime)s %(levelname)s %(name)s: %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            base += f" trace={trace_id[:16]}"
        return base


def resolve_level(verbose: int = 0) -> int:
    """flag > TPU_LOG_LEVEL env > INFO."""
    if verbose:
        return logging.DEBUG
    name = os.environ.get("TPU_LOG_LEVEL", "")
    if name:
        resolved = logging.getLevelName(name.upper())
        if isinstance(resolved, int):
            return resolved
    return logging.INFO


_MARKER = "_tpu_logging_bootstrap"


def setup(verbose: int = 0) -> logging.Logger:
    """Configure the root logger once per process (a second call replaces
    the handler this bootstrap installed, never stacks a duplicate).
    Returns the root logger."""
    root = logging.getLogger()
    root.setLevel(resolve_level(verbose))
    for h in list(root.handlers):
        if getattr(h, _MARKER, False):
            root.removeHandler(h)
    handler = logging.StreamHandler()
    setattr(handler, _MARKER, True)
    handler.addFilter(TraceContextFilter())
    handler.setFormatter(PlainFormatter())
    root.addHandler(handler)
    # asctime in UTC like the apiserver's own stamps.
    logging.Formatter.converter = time.gmtime
    return root
