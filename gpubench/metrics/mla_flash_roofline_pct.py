"""The four flash kernels' share of their roofline at multi-head latent
attention's head widths: the sum over their launches in the traced window
of each launch's least time (``arith_mla.flash_bound_s`` at the family's
``mla_flash_shape``: q.k heads of 192, v heads of 128 in DeepSeek-V3) over
the sum of their device times. None where no flash kernel ran or the
family has no such shape."""

from gpubench import arith_mla


def read(ctx):
    s = ctx.summary
    shape_of = getattr(ctx.family, "mla_flash_shape", None)
    if s is None or not s.flash or shape_of is None:
        return None
    shape = shape_of(ctx.sizes, ctx.traffic["batch"])
    bound = sum(n * arith_mla.flash_bound_s(kind, *shape) for kind, (_, n) in s.flash.items())
    return 100.0 * bound / sum(t for t, _ in s.flash.values())
