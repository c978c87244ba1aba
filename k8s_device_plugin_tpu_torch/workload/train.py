"""The training step of the smoke workload, on one device or sharded over
a mesh: the counterpart of the JAX package's ``workload/train.py``
(full-logits or chunked-vocab loss, AdamW), with its multi-step dispatch.

Sharding follows the JAX ``param_shardings``: each parameter's logical
axes map to mesh axes through ``LOGICAL_AXIS_RULES``, a mesh axis that
does not divide its dim is dropped, and ``shard_model`` applies, in order,
the pipeline over ``pipe`` (``apply_pipe``: this rank keeps its stage's
blocks), expert parallelism over ``expert`` (``apply_ep``), tensor
parallelism over ``model`` (``apply_tp``), then FSDP2 over ``fsdp``, with
``data`` as the replicated dim of HSDP (``apply_fsdp``). Each applies only
over an axis larger than 1, so a size-1 mesh leaves the parameters as they
are. Ring attention needs no parameter layout, only the seq axis's group,
which ``shard_model`` hands to a ring model (and the pipe axis's to a
pipelined one) whatever its size. ``train_step`` returns the loss's global
mean over the batch.

``make_multi_train_step`` takes ``inner_steps`` real, sequential AdamW
updates per call, as the JAX ``lax.scan`` does. On the card the step of an
unsharded model is a CUDA graph, captured once and replayed for every
step; a sharded model and the CPU take the eager loop of ``train_step``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.fsdp import FSDPModule, fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor, Shard

from ..ops import LAUNCHES, chunked_softmax_xent
from ..parallel.collectives import gather_split
from ..parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, LOGICAL_AXIS_RULES, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
    axis_sizes,
)
from ..parallel.pipeline import stack_stages
from .model import Block, ElsewhereStage, ModelConfig, TransformerLM, init_model, param_axes, unembed

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
    """Next-token cross-entropy; the last position predicts nothing. A MoE
    model adds ``moe_aux_weight`` times its layers' load-balance terms.

    ``xent_chunk`` (default: the model's ``cfg.xent_chunk``) > 0 folds the
    tied unembedding into the chunked-vocab CE (``ops/xent.py``): the
    (rows, vocab) logits are never materialised. 0 is the full-logits
    loss."""
    chunk = model.cfg.xent_chunk if xent_chunk is None else xent_chunk
    hidden, aux = model.hidden_states(tokens)
    targets = tokens[:, 1:]
    embed = model.tied_embedding()
    if chunk > 0:
        loss = chunked_softmax_xent(hidden[:, :-1], embed, targets, chunk)
    else:
        logp = F.log_softmax(unembed(hidden, embed)[:, :-1], dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    if aux is not None:
        loss = loss + model.cfg.moe_aux_weight * aux
    return loss


def make_optimizer(model: TransformerLM, lr: float = 1e-3) -> torch.optim.AdamW:
    """AdamW at optax's constants. On the card its state and step counts
    live on the device (``capturable``), so a CUDA graph can hold the
    update; a sharded model keeps the same update (its losses on a size-1
    mesh equal the unsharded model's bit for bit), though it is not
    graphed. On the CPU it is the plain AdamW."""
    capturable = next(model.parameters()).is_cuda
    return torch.optim.AdamW(model.parameters(), lr=lr, capturable=capturable, **ADAMW)


def _mesh_axes(cfg: ModelConfig, sizes: dict[str, int]) -> dict[str, tuple]:
    """Each parameter's mesh axis per dim (None: not split) for a mesh of
    these axis sizes (an axis not named has size 1)."""
    rules = dict(LOGICAL_AXIS_RULES)
    shapes = {name: p.shape for name, p in TransformerLM(cfg, device="meta").named_parameters()}
    out = {}
    for name, shape in shapes.items():
        logical = param_axes(cfg, name)
        if logical is None:
            out[name] = ()  # replicated, the JAX P()
            continue
        spec = []
        for dim, axis in zip(shape, (rules.get(a) for a in logical)):
            size = sizes.get(axis, 1) if axis is not None else 1
            spec.append(axis if dim % size == 0 else None)
        out[name] = tuple(spec)
    return out


def param_shardings(cfg: ModelConfig, mesh) -> dict[str, tuple]:
    """Each parameter's mesh axis per dim, by name: the JAX
    ``param_shardings`` PartitionSpecs (``("fsdp", "model")`` for ``w1``).
    A mesh axis whose size does not divide its dim is dropped, as the JAX
    one drops it (train.py:62-66); a parameter without logical axes is
    replicated (``()``)."""
    return _mesh_axes(cfg, axis_sizes(mesh))


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, attr = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, attr, nn.Parameter(value))


def _split_params(model: TransformerLM, axis: str, axis_mesh, dims: dict) -> None:
    """Keep this rank's slice, over ``axis_mesh`` (the mesh's 1-D ``axis``),
    of each parameter that ``param_shardings`` splits over ``axis``,
    recording its dim in ``dims``."""
    size, rank = axis_mesh.size(), axis_mesh.get_local_rank()
    specs = _mesh_axes(model.cfg, {axis: size})
    for name, p in list(model.named_parameters()):
        if axis in specs[name]:
            dim = specs[name].index(axis)
            _set_param(model, name, p.detach().chunk(size, dim)[rank].clone())
            dims[name] = dim


def _blocks(model: TransformerLM):
    """(global index, block) of each block this rank holds."""
    return [(i, b) for i, b in enumerate(model.blocks) if isinstance(b, Block)]


def apply_pipe(model: TransformerLM, pipe_mesh) -> TransformerLM:
    """The pipeline's layout over ``pipe_mesh`` (the mesh's 1-D ``pipe``
    axis), in place: this rank keeps the blocks of its stage (contiguous,
    ``stack_stages``), and each other block's place holds an
    ``ElsewhereStage``, so the block names stay global."""
    stages = stack_stages(range(len(model.blocks)), pipe_mesh.size())
    mine = set(stages[pipe_mesh.get_local_rank()])
    for i in range(len(model.blocks)):
        if i not in mine:
            model.blocks[i] = ElsewhereStage()
    return model


def apply_ep(model: TransformerLM, ep_mesh) -> TransformerLM:
    """Expert parallelism over ``ep_mesh`` (the mesh's 1-D ``expert``
    axis), in place: each rank keeps its experts' slices of every MoE
    layer's ``w1`` and ``w2`` and runs their share of the layer between
    Megatron's pair (``workload/moe.py``). An axis that does not divide
    the experts is dropped, as the JAX rule drops it."""
    _split_params(model, EXPERT_AXIS, ep_mesh, model.ep_dims)
    size, rank, group = ep_mesh.size(), ep_mesh.get_local_rank(), ep_mesh.get_group()
    for i, block in _blocks(model):
        if f"blocks.{i}.moe.w1" in model.ep_dims:
            per = model.cfg.n_experts // size
            block.moe.experts = slice(rank * per, (rank + 1) * per)
            block.moe.split_groups += (group,)
    model.ep_group = group
    return model


def apply_tp(model: TransformerLM, tp_mesh) -> TransformerLM:
    """Tensor parallelism over ``tp_mesh`` (the mesh's 1-D ``model`` axis),
    in place: each parameter that ``param_shardings`` splits over ``model``
    keeps this rank's slice, and each block whose heads or ``mlp`` columns
    (the experts' too) are split runs between Megatron's pair
    (``workload/model.py``); a block the axis does not divide keeps its
    weights whole. Over an axis of size 1 nothing is split, but the sums
    still run."""
    _split_params(model, MODEL_AXIS, tp_mesh, model.tp_dims)
    group = tp_mesh.get_group()
    for i, block in _blocks(model):
        if f"blocks.{i}.attn.wq" in model.tp_dims:
            block.attn.tp_group = group
        if f"blocks.{i}.mlp.w1" in model.tp_dims:
            block.mlp.tp_group = group
        if f"blocks.{i}.moe.w1" in model.tp_dims:
            block.moe.split_groups += (group,)
    model.tp_group = group
    return model


def apply_fsdp(model: TransformerLM, mesh) -> TransformerLM:
    """FSDP2 over the mesh's ``fsdp`` axis, in place, with ``data`` as
    HSDP's replicated dim when it is larger than 1. Each parameter's shard
    is on the dim where ``param_shardings`` puts ``fsdp`` (the JAX ``embed``
    dim: dim 1 of ``w2``, ``embed`` and ``pos``, dim 2 of ``wo``), and on
    dim 0, FSDP2's default, where it puts none (flax's norm scales, or a
    dim the axis does not divide). One unit per block and one for the
    root (embedding, positions, final norm), which keeps its parameters
    gathered after ``hidden_states``, since the loss reads the tied
    embedding after it returns."""
    specs = param_shardings(model.cfg, mesh)
    dims = {id(p): specs[name].index(FSDP_AXIS) if FSDP_AXIS in specs[name] else 0
            for name, p in model.named_parameters()}
    dp_mesh = mesh[(DATA_AXIS, FSDP_AXIS)] if mesh[DATA_AXIS].size() > 1 else mesh[FSDP_AXIS]

    def placement(p: nn.Parameter) -> Shard:
        return Shard(dims[id(p)])

    for _, block in _blocks(model):
        fully_shard(block, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement, reshard_after_forward=False)
    register_fsdp_forward_method(model, "hidden_states")
    return model


def shard_model(model: TransformerLM, mesh) -> TransformerLM:
    """The model laid out on ``mesh`` as the JAX ``param_shardings`` lays
    it: ``apply_pipe`` over ``pipe`` (a pipelined model), ``apply_ep``
    over ``expert``, ``apply_tp`` over ``model``, then ``apply_fsdp`` over
    (data, fsdp), each only where its axes are larger than 1. A ring model
    gets the seq axis's group and a pipelined one the pipe axis's, at any
    size; a MoE model whose batch is split over (data, fsdp) gets those
    axes' groups for its load-balance loss. ``train_step`` then averages
    the loss over the mesh."""
    cfg, sizes = model.cfg, axis_sizes(mesh)
    if cfg.pipeline_microbatches > 0:
        model.pipe_group = mesh[PIPE_AXIS].get_group()
        if sizes[PIPE_AXIS] > 1:
            apply_pipe(model, mesh[PIPE_AXIS])
    if cfg.use_ring_attention:
        model.seq_group = mesh[SEQ_AXIS].get_group()
        for _, block in _blocks(model):
            block.attn.seq_group = model.seq_group
    if cfg.n_experts > 0:
        batch_groups = tuple(mesh[a].get_group() for a in (DATA_AXIS, FSDP_AXIS) if sizes[a] > 1)
        for _, block in _blocks(model):
            block.moe.batch_groups = batch_groups
        if sizes[EXPERT_AXIS] > 1:
            apply_ep(model, mesh[EXPERT_AXIS])
    if sizes[MODEL_AXIS] > 1:
        apply_tp(model, mesh[MODEL_AXIS])
    if sizes[DATA_AXIS] * sizes[FSDP_AXIS] > 1:
        apply_fsdp(model, mesh)
    model.mesh = mesh
    return model


def is_sharded(model: TransformerLM) -> bool:
    """Whether ``shard_model`` gave the model a collective to run: tensor
    or expert parallelism, FSDP2, the ring's seq group or the pipeline's
    pipe group (over an axis of any size)."""
    return (bool(model.tp_dims or model.ep_dims) or isinstance(model, FSDPModule)
            or model.seq_group is not None or model.pipe_group is not None)


def full_state_dict(model: TransformerLM) -> dict[str, torch.Tensor]:
    """Every parameter whole and detached, by name: FSDP2's shards
    gathered, tensor- and expert-parallel slices gathered over their axes,
    and the other pipeline stages' blocks broadcast from the ranks that
    hold them; one that nothing splits is the live parameter, detached (as
    ``state_dict`` gives it). A collective where the model is sharded:
    every rank calls it."""
    out = {}
    for name, p in model.named_parameters():
        t = (p.full_tensor() if isinstance(p, DTensor) else p).detach()
        if name in model.tp_dims:
            t = gather_split(t, model.tp_group, model.tp_dims[name])
        if name in model.ep_dims:
            t = gather_split(t, model.ep_group, model.ep_dims[name])
        out[name] = t
    group = model.pipe_group
    if group is not None and dist.get_world_size(group) > 1:
        rank = dist.get_rank(group)
        stages = stack_stages(range(model.cfg.n_layers), dist.get_world_size(group))
        first = f"blocks.{stages[rank][0]}."
        inner = [name[len(first):] for name in out if name.startswith(first)]
        for r, layers in enumerate(stages):
            for j, layer in enumerate(layers):
                for rel in inner:
                    mine = out[f"blocks.{stages[rank][j]}.{rel}"]
                    buf = mine.clone() if r == rank else torch.empty_like(mine)
                    dist.broadcast(buf, dist.get_global_rank(group, r), group=group)
                    out[f"blocks.{layer}.{rel}"] = buf
    return out


def make_train_state(
    cfg: ModelConfig, device, seed: int = 0, lr: float = 1e-3, mesh=None,
) -> tuple[TransformerLM, torch.optim.AdamW]:
    """A model with random weights from ``seed`` on ``device`` and its
    optimizer. With a ``mesh`` every rank draws the same whole weights and
    keeps its shards (``shard_model``)."""
    model = init_model(cfg, seed, device)
    if mesh is not None:
        shard_model(model, mesh)
    return model, make_optimizer(model, lr)


def _loss_and_update(model, optimizer, tokens, xent_chunk) -> torch.Tensor:
    loss = loss_fn(model, tokens, xent_chunk)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _global_mean(model: TransformerLM, loss: torch.Tensor) -> torch.Tensor:
    """The mean over the mesh of each rank's loss over its rows: the loss
    of the global batch, since every (data, fsdp) shard has as many rows
    and as many ranks feeding it."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.size() == 1:
        return loss
    dist.all_reduce(loss)
    return loss / mesh.size()


def train_step(
    model: TransformerLM, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
    xent_chunk: int | None = None,
) -> torch.Tensor:
    """One optimizer step on this rank's rows ``tokens``; returns the
    (detached) loss of the global batch before the update."""
    optimizer.zero_grad(set_to_none=True)
    return _global_mean(model, _loss_and_update(model, optimizer, tokens, xent_chunk))


def make_multi_train_step(
    model: TransformerLM, optimizer: torch.optim.Optimizer, inner_steps: int,
    xent_chunk: int | None = None,
):
    """A callable ``stack[inner_steps, batch, seq] -> losses[inner_steps]``
    (a tensor on the stack's device) that takes ``inner_steps`` sequential
    AdamW updates, one per batch of the stack, each from the previous
    one's parameters: the JAX ``make_multi_train_step``. ``xent_chunk``
    picks the loss as in ``loss_fn``.

    On the card the step of an unsharded model is a CUDA graph
    (``GraphedTrainStep``); a capture or replay that fails raises. A
    sharded model (``is_sharded``) takes the eager loop on the card, by
    this rule and not by catching a failed capture: FSDP2's collectives
    are not captured. The CPU takes the eager loop."""
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be at least 1, got {inner_steps}")
    if next(model.parameters()).is_cuda and not is_sharded(model):
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
