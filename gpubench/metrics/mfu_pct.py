"""The whole step's share of the cards' bf16 peak: the step's analytic
FLOPs (``families/<family>.flops_per_step``, frozen) over 989 TFLOP/s x
the cell's cards x the seconds a step of the untraced window (all its
steps over all its time, on the host clock), which the profiler does not
slow."""

from gpubench import arith


def read(ctx):
    s = ctx.summary
    if s is None or s.busy_s == 0:
        return None
    flops = ctx.family.flops_per_step(ctx.sizes, ctx.traffic["batch"])
    step_s = ctx.window["seconds"] / ctx.window["steps"]
    return 100.0 * flops / (arith.PEAK_BF16_FLOPS * ctx.chips * step_s)
