"""GPipe pipeline parallelism over the mesh's ``pipe`` axis: the
counterpart of the JAX package's ``parallel/pipeline.py``.

The layers are cut into contiguous stages (``stack_stages``), one a rank
of the pipe group, and the batch into microbatches. ``pipeline_apply``
runs the JAX tick schedule: T = M + S - 1 ticks; at tick t stage s works
on microbatch t - s when there is one (stage 0 feeds microbatch t), sends
its output to stage s + 1, and the last stage banks microbatch t - (S - 1).
JAX computes every stage at every tick and throws the ticks without a
microbatch away; here those are skipped, which changes no value. The
banked outputs are broadcast back over the pipe group, so the caller's
activations stay replicated over pipe, as they were on entry.

The backward is autograd through a differentiable send/receive pair:
``_Receive`` sends the gradient of what it received back to the stage it
came from, and ``_Send`` returns a token that the broadcast-back takes as
an input, so that the backward reaches the send on every stage and
receives there the gradient of what was sent. Each rank's autograd
engine takes the microbatches in reverse order (the later nodes first),
so the sends and receives of the backward pair up across ranks in the
same order. The input enters through ``enter_split`` over the pipe group
(only stage 0 reads it) and the broadcast-back is a sum whose backward is
the identity (only the last stage holds the output).

The JAX function casts to f32 at its ``shard_map`` boundary to avoid a
crash of XLA's CPU backend; a bf16 value summed with zeros in f32 and cast
back is exact, so the activations cross here in their own dtype.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist

from .collectives import enter_split


def stack_stages(layers: Sequence, n_stages: int) -> list[list]:
    """``layers`` cut into ``n_stages`` contiguous stages of equal size."""
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return [list(layers[i * per:(i + 1) * per]) for i in range(n_stages)]


class _Send(torch.autograd.Function):
    """Send ``out`` to global rank ``dst``; the token it returns carries,
    in the backward, the receipt of ``out``'s gradient from ``dst``."""

    @staticmethod
    def forward(ctx, out, dst, group):
        ctx.dst, ctx.group, ctx.shape, ctx.dtype = dst, group, out.shape, out.dtype
        dist.send(out.contiguous(), dst, group=group)
        return out.new_zeros(())

    @staticmethod
    def backward(ctx, _token_grad):
        grad = torch.empty(ctx.shape, dtype=ctx.dtype, device=_token_grad.device)
        dist.recv(grad, ctx.dst, group=ctx.group)
        return grad, None, None


class _Receive(torch.autograd.Function):
    """A tensor like ``like`` received from global rank ``src``; the
    backward sends its gradient back to ``src``. ``like`` only ties the
    received tensor into the autograd graph (its gradient is zero)."""

    @staticmethod
    def forward(ctx, like, src, group):
        ctx.src, ctx.group = src, group
        buf = torch.empty_like(like)
        dist.recv(buf, src, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.src, group=ctx.group)
        return torch.zeros_like(grad), None, None


class _Broadcast(torch.autograd.Function):
    """The sum of ``y`` over the pipe group (the last stage's output, zeros
    elsewhere); the backward is the identity for ``y`` and a zero for
    each send token, which runs the sends' backward."""

    @staticmethod
    def forward(ctx, y, group, *tokens):
        ctx.n_tokens = len(tokens)
        out = y.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        zero = grad.new_zeros(())
        return (grad, None) + (zero,) * ctx.n_tokens


def pipeline_apply(stage_fn: Callable, stage, x: torch.Tensor, pipe_group,
                   n_microbatches: int) -> torch.Tensor:
    """``x`` through every stage of the pipe group, microbatched.

    ``stage``: this rank's stage (``stack_stages(...)[rank]``);
    ``stage_fn(stage, x_mb) -> y_mb`` applies it and keeps the
    microbatch's shape and dtype. ``x`` (batch, ...), replicated over the
    group, with batch divisible by ``n_microbatches``. Returns the last
    stage's output on every rank of the group. A group of one applies the
    stage to the whole batch."""
    n_stages = dist.get_world_size(pipe_group)
    if n_stages == 1:
        return stage_fn(stage, x)
    m = n_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} microbatches")
    rank = dist.get_rank(pipe_group)
    if torch.is_grad_enabled() and not x.requires_grad:
        # Every rank's backward must reach its sends and receives.
        x = x.detach().requires_grad_()
    x_mb = enter_split(x, pipe_group).chunk(m)
    prev = dist.get_global_rank(pipe_group, rank - 1) if rank > 0 else None
    last = rank == n_stages - 1
    nxt = None if last else dist.get_global_rank(pipe_group, rank + 1)
    banked, tokens = [], []
    for t in range(m + n_stages - 1):
        mb = t - rank  # the microbatch this stage works on at tick t
        if not 0 <= mb < m:
            continue
        inp = x_mb[mb] if prev is None else _Receive.apply(x_mb[mb], prev, pipe_group)
        out = stage_fn(stage, inp)
        if last:
            banked.append(out)
        else:
            tokens.append(_Send.apply(out, nxt, pipe_group))
    y = torch.cat(banked) if last else torch.zeros_like(x)
    return _Broadcast.apply(y, pipe_group, *tokens)
