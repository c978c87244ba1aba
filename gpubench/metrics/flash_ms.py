"""Device ms a traced step of the four flash kernels (K1, delta, K2, K3)."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "flash_fwd", "flash_bwd")
