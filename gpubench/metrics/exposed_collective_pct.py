"""The share of the first rank's card's time in NCCL kernels (the union of
their intervals in the traced window, ``collective_ms``'s kernels) during
which no kernel of another group runs on that card: the collectives'
time that nothing hides. None where no NCCL kernel ran."""

from gpubench import arith, trace

from ._spans import _overlap_s


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    card = [e for e in s.events if e.on_card]
    sums = trace._union((e.start_s, e.end_s) for e in card if arith.group(e.name) == "collective")
    total = sum(b - a for a, b in sums)
    if total == 0:
        return None
    others = trace._union((e.start_s, e.end_s) for e in card
                          if arith.group(e.name) != "collective")
    return 100.0 * (total - _overlap_s(sums, others)) / total
