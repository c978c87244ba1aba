"""Single-device training step for the smoke workload: the counterpart of
the JAX package's ``workload/train.py`` (full-logits or chunked-vocab
loss, AdamW), with its multi-step dispatch.

``make_multi_train_step`` takes ``inner_steps`` real, sequential AdamW
updates per call, as the JAX ``lax.scan`` does. On the card the step is a
CUDA graph, captured once and replayed for every step; on the CPU it is
the eager loop of ``train_step``.

Sharding over a mesh is not carried by this port yet (ROADMAP.md, Queue 1:
'Mesh + fsdp/tp sharding').
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from ..ops import LAUNCHES, chunked_softmax_xent
from .model import ModelConfig, TransformerLM, init_model, unembed

# optax.adamw(lr)'s defaults, which the JAX step uses (train.py:104):
# decay 1e-4 on every parameter. torch's AdamW defaults to decay 1e-2, so
# every value is set explicitly.
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

# Eager steps before a capture, as PyTorch's whole-network capture recipe
# takes them: they initialise the optimizer's state and warm the
# allocator and cuBLAS outside the graph.
WARMUP_STEPS = 3


def loss_fn(model: TransformerLM, tokens: torch.Tensor,
            xent_chunk: int | None = None) -> torch.Tensor:
    """Next-token cross-entropy; the last position predicts nothing.

    ``xent_chunk`` (default: the model's ``cfg.xent_chunk``) > 0 folds the
    tied unembedding into the chunked-vocab CE (``ops/xent.py``): the
    (rows, vocab) logits are never materialised. 0 is the full-logits
    loss."""
    chunk = model.cfg.xent_chunk if xent_chunk is None else xent_chunk
    hidden = model.hidden_states(tokens)
    targets = tokens[:, 1:]
    if chunk > 0:
        return chunked_softmax_xent(hidden[:, :-1], model.embed, targets, chunk)
    logp = F.log_softmax(unembed(hidden, model.embed)[:, :-1], dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    return -ll.mean()


def make_optimizer(model: TransformerLM, lr: float = 1e-3) -> torch.optim.AdamW:
    """AdamW at optax's constants. On the card its state and step counts
    live on the device (``capturable``), so a CUDA graph can hold the
    update; on the CPU it is the plain AdamW."""
    capturable = next(model.parameters()).is_cuda
    return torch.optim.AdamW(model.parameters(), lr=lr, capturable=capturable, **ADAMW)


def make_train_state(
    cfg: ModelConfig, device, seed: int = 0, lr: float = 1e-3
) -> tuple[TransformerLM, torch.optim.AdamW]:
    """A model with random weights from ``seed`` on ``device`` and its
    optimizer."""
    model = init_model(cfg, seed, device)
    return model, make_optimizer(model, lr)


def _loss_and_update(model, optimizer, tokens, xent_chunk) -> torch.Tensor:
    loss = loss_fn(model, tokens, xent_chunk)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step(
    model: TransformerLM, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
    xent_chunk: int | None = None,
) -> torch.Tensor:
    """One optimizer step; returns the (detached) loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    return _loss_and_update(model, optimizer, tokens, xent_chunk)


def make_multi_train_step(
    model: TransformerLM, optimizer: torch.optim.Optimizer, inner_steps: int,
    xent_chunk: int | None = None,
):
    """A callable ``stack[inner_steps, batch, seq] -> losses[inner_steps]``
    (a tensor on the stack's device) that takes ``inner_steps`` sequential
    AdamW updates, one per batch of the stack, each from the previous
    one's parameters: the JAX ``make_multi_train_step``. ``xent_chunk``
    picks the loss as in ``loss_fn``.

    On the card the step is a CUDA graph (``GraphedTrainStep``); a capture
    or replay that fails raises. On the CPU it is the eager loop."""
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be at least 1, got {inner_steps}")
    if next(model.parameters()).is_cuda:
        return GraphedTrainStep(model, optimizer, inner_steps, xent_chunk)

    def eager(stack: torch.Tensor) -> torch.Tensor:
        _check_stack(stack, inner_steps)
        return torch.stack([train_step(model, optimizer, t, xent_chunk) for t in stack])

    return eager


def _check_stack(stack: torch.Tensor, inner_steps: int) -> None:
    if stack.dim() != 3 or stack.shape[0] != inner_steps:
        raise ValueError(f"expected a stack of {inner_steps} token batches "
                         f"(inner_steps, batch, seq), got {tuple(stack.shape)}")


class GraphedTrainStep:
    """``inner_steps`` train steps a call, replayed from one CUDA graph of
    the step (forward, backward, ``optimizer.step()``).

    The first call follows PyTorch's whole-network capture recipe: up to
    ``WARMUP_STEPS`` eager steps on a side stream (real updates, taken from
    the stack, counted among the call's steps), then
    ``zero_grad(set_to_none=True)`` and the capture, which moves no state
    (nothing runs while a graph is captured). The rest of that call and
    every later call replay the graph: each batch is copied into the
    static token buffer the graph reads, the graph is replayed, and its
    loss is copied out. No call waits for the card, apart from the first,
    whose capture synchronises on entry.

    The capture runs in PyTorch's default (global) capture mode. The host
    work of each flash launch (``cudaFuncSetAttribute``, the SM-count
    query, the tensor maps' encoding) is allowed under it and runs once,
    at capture; a replay skips it. Every address the kernels read is
    fixed across replays, as it must be: the tensor maps are kernel
    parameters, frozen at capture. The tokens are the static buffer;
    parameters and optimizer state are updated in place; activations and
    gradients live in the graph's private memory pool.

    Two graphs over one model and optimizer (the smoke's chunked-CE A/B)
    each hold their own gradients and their own pool: the
    ``zero_grad(set_to_none=True)`` before a capture drops the gradient
    tensors the model pointed at, so the backward under capture allocates
    new ones in that graph's pool. A dropped gradient's memory goes back
    to the pool of the graph that allocated it and no other allocation can
    take it, so each graph keeps writing its own gradients and reading
    them in its own ``optimizer.step()``. The price is memory: both pools
    are held at once. Parameters and the optimizer's state (allocated by
    the warm-up, outside any pool) are shared.

    Kernel launches: the wrappers count their launches in Python, which
    runs once, at capture. The capture's counts are taken back and kept
    as the graph's launches per step, and every replay adds them to
    ``LAUNCHES``, so the table counts what ran on the card."""

    def __init__(self, model: TransformerLM, optimizer: torch.optim.Optimizer,
                 inner_steps: int, xent_chunk: int | None = None):
        self.model = model
        self.optimizer = optimizer
        self.inner_steps = inner_steps
        self.xent_chunk = xent_chunk
        self.graph: torch.cuda.CUDAGraph | None = None
        self.tokens: torch.Tensor | None = None  # the static token buffer
        self.loss: torch.Tensor | None = None  # the static loss
        self.launches: dict[str, int] = {}  # kernel launches of one replay
        self.capture_s: float | None = None  # host time of the capture

    def __call__(self, stack: torch.Tensor) -> torch.Tensor:
        _check_stack(stack, self.inner_steps)
        if not stack.is_cuda:
            raise ValueError("a graphed train step reads its token stack on the card")
        losses = torch.empty(self.inner_steps, dtype=torch.float32, device=stack.device)
        start = 0 if self.graph is not None else self._warm_up_and_capture(stack, losses)
        for i in range(start, self.inner_steps):
            self.tokens.copy_(stack[i])
            self.graph.replay()
            losses[i].copy_(self.loss)
            for name, n in self.launches.items():
                LAUNCHES[name] += n
        return losses

    def _warm_up_and_capture(self, stack: torch.Tensor, losses: torch.Tensor) -> int:
        """Run the warm-up steps into ``losses`` and capture the graph;
        returns the number of steps taken."""
        warm = min(WARMUP_STEPS, self.inner_steps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(warm):
                losses[i] = train_step(self.model, self.optimizer, stack[i], self.xent_chunk)
        torch.cuda.current_stream().wait_stream(side)

        self.tokens = stack[0].clone()
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        t0 = time.monotonic()
        try:
            with torch.cuda.graph(graph):
                self.loss = _loss_and_update(self.model, self.optimizer, self.tokens,
                                             self.xent_chunk)
        finally:
            self.launches = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
            LAUNCHES.update(before)
        self.capture_s = time.monotonic() - t0
        self.graph = graph
        return warm
