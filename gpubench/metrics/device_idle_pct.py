"""The share of the traced window in which no operation ran on the card:
100 x (1 - the union of device operations' intervals / the window)."""


def read(ctx):
    s = ctx.summary
    if s is None or s.busy_s == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
