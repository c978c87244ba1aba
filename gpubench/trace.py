"""The traced window: what ran on the card, read from ``torch.profiler``.

On the card the profiler records the card's activity alone (kernels,
copies, fills, and the host's CUDA runtime and driver calls), not
PyTorch's host operators, whose recording slows the host enough to idle
the card (a quarter of gpt2-xl's step, against about 1% without it). The
traced window is marked on the card itself: it opens at the end of one
``MARKER`` kernel, launched on an idle card, and closes at the start of a
second, launched right after the last traced step. Every device operation
between them counts towards ``busy_s``, the union of their intervals;
``window_s`` is the window's length. Kernels are summed by the frozen
groups of ``arith.py``, the four flash kernels apart, and each idle gap
between device operations is named by the innermost host event running at
its middle: a CUDA call, or none (the host in Python and PyTorch). Every
operation of the window is kept as an ``Event`` for metrics that read
kernels or host ranges of their own. On the CPU, which has no device
activity, a host range named ``WINDOW`` marks the window instead.

The profiler has been seen to drop a marker; a trace of the card with a
count of markers other than two raises ``MarkerLost``, which the run
answers by tracing the window once more (``run._traced``).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

from . import arith

WINDOW = "gpubench.window"
# The marker kernel's name: ``torch.cuda._sleep``'s spin kernel, which the
# program never launches.
MARKER = "spin_kernel"
# Idle gaps shorter than this are summed under one name rather than looked
# up one by one.
GAP_LOOKUP_US = 5.0
TOP = 10


class MarkerLost(RuntimeError):
    """The card's trace holds some ``MARKER`` kernels, but not two."""


@dataclasses.dataclass(frozen=True)
class Event:
    """One operation of the traced window, its times in seconds from the
    window's opening, clipped to the window."""

    name: str
    on_card: bool  # a device operation; else a host range
    start_s: float
    end_s: float


@dataclasses.dataclass
class Summary:
    steps: int
    window_s: float
    busy_s: float
    group_s: dict[str, float]  # device seconds by kernel group, all steps
    flash: dict[str, tuple[float, int]]  # kind -> (device seconds, launches)
    device_ops: list  # [[name, seconds], ...], the longest first
    idle_gaps: list  # [[host operation, seconds], ...], the longest first
    events: list  # every ``Event`` of the window, for readers of their own


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("gpubench.")


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_namer(cpu_events):
    """A function from a time (us) to the innermost host operation running
    then: the latest-starting CPU range that covers it."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu_events)
    starts = [s[0] for s in spans]

    def name(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 2000), -1):
            if spans[j][1] > t:
                return spans[j][2]
        return "(no CUDA call: the host in Python and PyTorch)"

    return name


def _window(events, device_type):
    """(start, end) of the traced window, in the trace's microseconds."""
    markers = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == device_type.CUDA and MARKER in e.name)
    if markers:
        if len(markers) != 2:
            raise MarkerLost(f"the trace holds {len(markers)} {MARKER} markers, not 2")
        return markers[0][1], markers[1][0]
    window = [e for e in events if e.name == WINDOW and e.device_type == device_type.CPU]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} {WINDOW} ranges, not 1")
    return window[0].time_range.start, window[0].time_range.end


def summarize(prof, steps: int) -> Summary:
    from torch.autograd import DeviceType

    events = prof.events()
    w0, w1 = _window(events, DeviceType)
    device, cpu = [], []
    for e in events:
        if _is_annotation(e) or MARKER in e.name:
            continue
        if e.device_type == DeviceType.CUDA:
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                device.append((a, b, e.name))
        elif e.device_type == DeviceType.CPU and e.time_range.start < w1 and e.time_range.end > w0:
            cpu.append(e)

    group_s: dict[str, float] = collections.defaultdict(float)
    flash: dict[str, list] = {}
    by_name: dict[str, float] = collections.defaultdict(float)
    for a, b, name in device:
        seconds = (b - a) / 1e6
        group_s[arith.group(name)] += seconds
        by_name[name] += seconds
        kind = arith.flash_kernel(name)
        if kind is not None:
            entry = flash.setdefault(kind, [0.0, 0])
            entry[0] += seconds
            entry[1] += 1

    busy = _union((a, b) for a, b, _ in device)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    host = _host_namer(cpu)
    gaps: dict[str, float] = collections.defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = host((a + b) / 2) if b - a >= GAP_LOOKUP_US else f"(gaps under {GAP_LOOKUP_US:g} us)"
        gaps[label] += (b - a) / 1e6

    def top(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    def rel(t: float) -> float:
        return (min(max(t, w0), w1) - w0) / 1e6

    events = [Event(name, True, rel(a), rel(b)) for a, b, name in device]
    events += [Event(e.name, False, rel(e.time_range.start), rel(e.time_range.end)) for e in cpu]

    return Summary(
        steps=steps,
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        group_s=dict(group_s),
        flash={k: (v[0], v[1]) for k, v in flash.items()},
        device_ops=top(by_name),
        idle_gaps=top(gaps),
        events=sorted(events, key=lambda e: e.start_s),
    )
