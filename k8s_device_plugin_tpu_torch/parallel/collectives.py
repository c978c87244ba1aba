"""Collectives with the gradients that a split computation needs.

JAX's GSPMD places every collective of a sharded program and transposes
it for the backward. Here each one is written by hand, after Megatron's
rule: everything outside a split region is replicated over the group's
mesh axis and computes the whole gradient on every rank. A split region
is entered through ``enter_split`` (the identity; its backward sums the
gradient over the group, since each rank backpropagates through its own
part only) and left through ``leave_split`` (the sum of the ranks' partial
results; its backward is the identity, since every rank of the group
computes the same loss and so already holds the whole gradient of the
sum). ``gather_split`` leaves a region split along a dim.

The model axis (tensor parallelism), the seq axis (ring attention), the
expert axis (MoE) and the pipe axis (the pipeline) all enter and leave
their split regions this way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _LeaveSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, ctx.dim)[rank].contiguous(), None, None


def enter_split(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; the backward sums its gradient over ``group``."""
    return _EnterSplit.apply(x, group)


def leave_split(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward is the identity."""
    return _LeaveSplit.apply(x, group)


def gather_split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole tensor of which each rank of ``group`` holds a slice along
    ``dim``, in rank order; the backward keeps this rank's slice of the
    (replicated) gradient."""
    return _GatherSplit.apply(x, group, dim)


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, each rank adding a term of its own
    (rows of the batch, not a split of one computation); the backward sums
    the gradient too. With FSDP2's mean of the ranks' gradients, that
    gives each term the gradient of the global value."""
    return leave_split(enter_split(x, group), group)
