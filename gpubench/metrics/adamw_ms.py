"""Device ms a traced step of AdamW's multi-tensor kernels."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "optimizer")
