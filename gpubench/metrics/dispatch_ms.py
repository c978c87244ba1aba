"""The host's ms from a timed step's call to its return, the median over
the untraced window's steps: the benchmark's own span around the call,
with no synchronise inside the step."""

import statistics


def read(ctx):
    if not ctx.window["dispatch_s"]:
        return None
    return statistics.median(ctx.window["dispatch_s"]) * 1e3
