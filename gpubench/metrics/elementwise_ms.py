"""Device ms a traced step of the kernels no pattern names: casts, adds, GELU, norms, copies."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "other")
