"""Which of the card's kernels the host launched inside which of the
program's spans.

The traced window holds the card's kernels and the host's CUDA calls, but
no link between a launch and its kernel. On one stream the card runs
kernels in the order the host launched them, so the i-th kernel launch
call from the end of the window (the closing marker's left out) is the
i-th kernel from the end: the two lists are matched from their ends, since
the window's opening may cut host calls at its start but no kernel. The
launch calls are ``_spans.LAUNCHES`` and CUDA's ``cuLaunchKernel`` (a
routed layer's step makes one, seen on the card); copies and fills
(``Memcpy``, ``Memset``) come from other calls and are left out of both.
The program's spans are put on the window's clock as ``_spans.place`` puts
them (one offset: the closing marker's launch at the last ``train.step``'s
end), after ``_spans.place`` has checked the placement. A match that leaves
more than ``UNMATCHED`` of the kernels without a launch reads as None."""

from __future__ import annotations

import bisect
import itertools

from . import _spans

OTHER_OPS = ("Memcpy", "Memset")
KERNEL_CALLS = _spans.LAUNCHES + ("cuLaunchKernel",)
UNMATCHED = 0.01


def kernels(summary) -> list:
    """The window's kernels on the card, by start."""
    return sorted((e for e in summary.events if e.on_card and not e.name.startswith(OTHER_OPS)),
                  key=lambda e: e.start_s)


def launched_in(ctx, wanted) -> float | None:
    """Device seconds of the window's kernels whose launch started inside a
    span of the program whose name ``wanted(name)`` accepts; None (see the
    module's docstring)."""
    s = ctx.summary
    if s is None or s.busy_s == 0 or _spans.place(ctx) is None:
        return None
    launches = sorted((e for e in s.events if not e.on_card and e.name in KERNEL_CALLS),
                      key=lambda e: e.start_s)
    steps = [sp for sp in ctx.spans if sp["name"] == _spans.STEP]
    # The closing marker's launch, the last of the window's (``_spans``).
    anchor_s = launches[-1].start_s
    end_ns = max(sp["end_ns"] for sp in steps)
    spans = sorted((anchor_s + (sp["start_ns"] - end_ns) / 1e9,
                    anchor_s + (sp["end_ns"] - end_ns) / 1e9)
                   for sp in ctx.spans if wanted(sp["name"]))
    if not spans:
        return None
    ks = kernels(s)
    calls = launches[:-1]
    n = min(len(ks), len(calls))
    if not ks or len(ks) - n > UNMATCHED * len(ks):
        return None
    starts = [a for a, _ in spans]
    # Spans may nest: a call is inside one where any span that started
    # before it ends after it, so the running latest end decides.
    latest = list(itertools.accumulate((b for _, b in spans), max))
    total = 0.0
    for kernel, call in zip(ks[len(ks) - n:], calls[len(calls) - n:]):
        j = bisect.bisect_right(starts, call.start_s) - 1
        if j >= 0 and latest[j] > call.start_s:
            total += kernel.end_s - kernel.start_s
    return total
