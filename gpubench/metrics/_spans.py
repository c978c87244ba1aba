"""The port's training-step spans placed on the traced window's clock.

``utils.tracing`` stamps a span with the host's epoch nanoseconds
(``time.time_ns``); ``trace.Summary`` gives each event in seconds from the
window's opening. One offset moves the spans onto the window, found from
an anchor the host reaches right after the last ``train.step`` ends: the
window's last kernel launch, which is the closing marker's
(``trace.MARKER``). The placement is then checked: a ``train.step`` for
each of the trace's steps, and at least ``INSIDE`` of the window's kernel
launches, the markers' left out, inside one. Where either fails, or the
trace holds no activity of the card (a run on the CPU), ``place`` gives
None, so a bad placement reads as missing rather than wrong.

The readers split the card's idle time by the innermost of the port's
spans open on the host (``idle_ms``) and read the host's own time inside
a step (``host_issue_ms``); all are ms a traced step. They exist only
under the trace, whose own cost on the host they carry (PERF.md §3)."""

from __future__ import annotations

import bisect
import dataclasses

from gpubench import trace

STEP = "train.step"
PHASES = ("train.forward", "train.backward", "train.optimizer")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
INSIDE = 0.99


@dataclasses.dataclass
class Placed:
    """``train.step`` intervals and, by phase, their children's, in seconds
    from the window's opening, clipped to it, each list sorted."""

    steps: list
    phases: dict
    inside: float  # the share of the checked launches inside a step


def _overlap_s(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(steps, events) -> float:
    """The share of ``events`` that start and end inside one of ``steps``."""
    starts = [a for a, _ in steps]
    n = 0
    for e in events:
        k = bisect.bisect_right(starts, e.start_s) - 1
        n += k >= 0 and e.end_s <= steps[k][1]
    return n / len(events)


def place(ctx):
    """The placed spans of ``ctx``, or None (see the module's docstring)."""
    s, spans = ctx.summary, ctx.spans
    steps = sorted((sp for sp in spans if sp["name"] == STEP), key=lambda sp: sp["start_ns"])
    if s is None or s.busy_s == 0 or not steps or len(steps) != s.steps:
        return None
    # The last launch is the closing marker's; one that started before the
    # window opened (clipped to 0), the opening marker's.
    launches = sorted((e for e in s.events if not e.on_card and e.name in LAUNCHES),
                      key=lambda e: e.start_s)
    checked = [e for e in launches[:-1] if e.start_s > 0.0]
    if not checked:
        return None
    anchor_s = launches[-1].start_s
    end_ns = max(sp["end_ns"] for sp in steps)

    def at(ns: int) -> float:
        return min(max(anchor_s + (ns - end_ns) / 1e9, 0.0), s.window_s)

    placed = [(at(sp["start_ns"]), at(sp["end_ns"])) for sp in steps]
    inside = _inside(placed, checked)
    if inside < INSIDE:
        return None
    ids = {sp["span_id"] for sp in steps}
    phases = {p: [] for p in PHASES}
    for sp in spans:
        if sp["name"] in phases and sp["parent_span_id"] in ids:
            phases[sp["name"]].append((at(sp["start_ns"]), at(sp["end_ns"])))
    return Placed(placed, {p: sorted(v) for p, v in phases.items()}, inside)


def _idle_gaps(s) -> list:
    """The card's idle intervals of the window of at least
    ``trace.GAP_LOOKUP_US``: the complement of its busy union, as
    ``trace.summarize`` splits it."""
    busy = trace._union((e.start_s, e.end_s) for e in s.events if e.on_card)
    edges = [0.0] + [x for ab in busy for x in ab] + [s.window_s]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2])
            if (b - a) * 1e6 >= trace.GAP_LOOKUP_US - 1e-6]


def idle_ms(ctx, phase: str | None):
    """The card's idle ms a traced step in gaps of at least
    ``trace.GAP_LOOKUP_US`` while ``phase`` (one of ``PHASES``) was the
    innermost open span on the host; ``None`` for the rest of them.
    Untraced, the card's idle is nearly all gaps under that, so this reads
    mostly the trace's own cost on the host (PERF.md §3)."""
    placed = place(ctx)
    if placed is None:
        return None
    gaps = _idle_gaps(ctx.summary)
    if phase is None:
        seconds = sum(b - a for a, b in gaps) - sum(_overlap_s(gaps, v)
                                                    for v in placed.phases.values())
    else:
        seconds = _overlap_s(gaps, placed.phases[phase])
    return seconds * 1e3 / ctx.summary.steps


def host_issue_ms(ctx):
    """The host's ms a traced step inside ``train.step`` and outside every
    host event of the card's trace: the CUDA runtime and driver calls, and
    CUPTI's records of the waits inside them."""
    placed = place(ctx)
    if placed is None:
        return None
    calls = trace._union((e.start_s, e.end_s) for e in ctx.summary.events if not e.on_card)
    inside = sum(b - a for a, b in placed.steps)
    return (inside - _overlap_s(placed.steps, calls)) * 1e3 / ctx.summary.steps
