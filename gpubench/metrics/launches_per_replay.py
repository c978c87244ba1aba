"""Device kernels a graph replay, one training step, in the traced
window: the card's kernels (copies and fills, such as the token stack's
copy into the graph's buffer and each loss's copy out, left out) over the
traced calls times the traffic's ``inner_steps``. None without a trace of
the card."""

from ._launched import kernels


def read(ctx):
    s = ctx.summary
    if s is None or s.busy_s == 0:
        return None
    return len(kernels(s)) / (s.steps * ctx.traffic["inner_steps"])
