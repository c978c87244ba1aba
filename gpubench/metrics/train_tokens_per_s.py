"""Every token of every step of the untraced window over the window's
seconds on the host clock, from its opening to the synchronise that ends
it."""


def read(ctx):
    w = ctx.window
    return w["steps"] * ctx.units_per_step / w["seconds"]
