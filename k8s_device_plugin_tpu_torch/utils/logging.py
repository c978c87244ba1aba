"""The logging bootstrap of the JAX package's ``utils/logging.py``: every
module takes its logger from ``get_logger``, and the node daemon's entry
point calls ``setup`` once (level from ``-v`` or ``TPU_LOG_LEVEL``; the
plain format by default, one JSON object a line with ``json=True``, the
daemon's ``--log-json``). Each record carries the open span's trace id when
tracing is on."""

from __future__ import annotations

import json as jsonlib
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


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts (epoch seconds), level, logger,
    message, service, trace_id/span_id when a span is active, and the
    exception text when present."""

    def __init__(self, service: str = ""):
        super().__init__()
        self.service = service

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if self.service:
            out["service"] = self.service
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            out["trace_id"] = trace_id
            out["span_id"] = getattr(record, "span_id", "")
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return jsonlib.dumps(out)


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


def setup(verbose: int = 0, json: bool = False, service: str = "") -> logging.Logger:
    """Configure the root logger once per process (a second call replaces
    the handler this bootstrap installed, never stacks a duplicate): JSON
    lines stamped with ``service`` when ``json``, else the plain format.
    Returns the root logger."""
    root = logging.getLogger()
    root.setLevel(resolve_level(verbose))
    for h in list(root.handlers):
        if getattr(h, _MARKER, False):
            root.removeHandler(h)
    handler = logging.StreamHandler()
    setattr(handler, _MARKER, True)
    handler.addFilter(TraceContextFilter())
    handler.setFormatter(JsonFormatter(service=service) if json else PlainFormatter())
    root.addHandler(handler)
    # asctime in UTC like the apiserver's own stamps.
    logging.Formatter.converter = time.gmtime
    return root
