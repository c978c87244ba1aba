"""The host's ms a traced step inside the port's ``train.step`` span and
outside every CUDA runtime or driver call made there: its own Python,
dispatcher and autograd work, which ``dispatch_ms`` cannot part from
blocking on a full launch queue (``_spans.host_issue_ms``)."""

from ._spans import host_issue_ms


def read(ctx):
    return host_issue_ms(ctx)
