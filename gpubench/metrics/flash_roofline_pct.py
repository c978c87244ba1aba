"""The four flash kernels' share of their roofline: the sum over their
launches in the traced window of each launch's least time
(``arith.flash_bound_s`` at the step's flash shape on the traced card:
its rows of the batch and its share of the heads on the traffic's
``mesh``) over the sum of their device times. None where no flash kernel
ran."""

from gpubench import arith


def read(ctx):
    s = ctx.summary
    if s is None or not s.flash:
        return None
    shape = ctx.family.flash_shape(ctx.sizes, ctx.traffic["batch"],
                                   ctx.traffic.get("mesh", (1, 1, 1)))
    bound = sum(n * arith.flash_bound_s(kind, *shape) for kind, (_, n) in s.flash.items())
    return 100.0 * bound / sum(t for t, _ in s.flash.values())
