"""Device ms a traced step of the routed layers' kernels, forward and
backward: each kernel launched while one of the program's ``moe.*`` spans
was open on the host (``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine`` in the forward, ``moe.backward`` around a layer's
backward), found as ``_launched.launched_in`` finds it. None without a
trace of the card, without those spans, or where the launches cannot be
matched to the kernels."""

from ._launched import launched_in


def read(ctx):
    seconds = launched_in(ctx, lambda name: name.startswith("moe."))
    if seconds is None:
        return None
    return seconds * 1e3 / ctx.summary.steps
