"""Device milliseconds a traced step of kernel groups (``arith.GROUPS``)."""


def ms_per_step(ctx, *groups: str):
    """The groups' device ms a step; None without a trace of the card or
    where none of the groups ran."""
    s = ctx.summary
    if s is None or s.busy_s == 0 or not any(g in s.group_s for g in groups):
        return None
    return sum(s.group_s.get(g, 0.0) for g in groups) * 1e3 / s.steps
