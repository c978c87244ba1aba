"""The one function of the JAX package's ``utils/tracing.py`` that the
decision ledger and the flight recorder call: ``current()``. Spans, their
collector and the carriers come with the plugin server; until then no span
is ever open, so every record goes out untraced."""

from __future__ import annotations

import collections
import threading
from typing import Optional


class SpanContext(collections.namedtuple("SpanContext", "trace_id span_id")):
    """The propagatable part of a span: (trace_id, span_id)."""

    __slots__ = ()


_enabled = False
_tls = threading.local()


def current() -> Optional[SpanContext]:
    """The innermost open span's context on this thread, or None.
    Cheap when disabled (one bool read)."""
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    return stack[-1].context
