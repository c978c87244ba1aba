"""``max_memory_allocated`` over the untraced window, after
``reset_peak_memory_stats`` at its opening; None off the card."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
