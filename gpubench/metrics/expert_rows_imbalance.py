"""The held experts' most rows over their mean, a routed layer's forward,
averaged over the untraced window's layer-steps in which the held
experts got any row (where they got none the ratio has no value): from
the program's routed-layer counters (``kinds/train_moe.py``), the change
of their sum over the change of the count of such layer-steps. 1 is an
even split; lower is better. None where no held expert got a row."""


def read(ctx):
    c = ctx.window["counters"]
    steps = c.get("moe.routed_layer_steps", 0)
    if not steps or "moe.rows_max_over_mean" not in c:
        return None
    return c["moe.rows_max_over_mean"] / steps
