"""The workload half of the JAX package's ``utils/profiling.py``: a
profiler trace of a block (``trace``) and named regions inside it
(``annotate``). The control plane's heartbeat, lockdep and GC machinery of
that module has no counterpart here.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(trace_dir: str | None) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (host, and the card's
    kernels when CUDA is up) and write the trace into ``trace_dir`` as a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin and Chrome's
    trace viewer load. No-op when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(trace_dir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler):
        yield


def annotate(name: str) -> torch.profiler.record_function:
    """A named region inside an active trace (``record_function``); costs
    next to nothing outside one."""
    return torch.profiler.record_function(name)
