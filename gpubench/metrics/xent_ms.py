"""Device ms a traced step of softmax, log-softmax and NLL kernels of the full-logits loss."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "softmax_xent")
