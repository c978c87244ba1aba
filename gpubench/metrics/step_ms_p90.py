"""The 90th percentile of the untraced window's steps, each the interval
between consecutive CUDA events recorded on the stream at step ends (on
the CPU, the host clock's)."""

import statistics


def read(ctx):
    return statistics.quantiles(ctx.window["step_s"], n=10, method="inclusive")[8] * 1e3
