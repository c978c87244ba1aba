"""What the port's multi-rank tests run on each gloo rank.

The ranks are processes of ``parallel.distributed.RankPool``: they import
this module (not a test module, and not ``conftest.py``) and so import no
JAX. The tests run the JAX side in their own process and hand numpy
arrays to these functions.
"""

import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from k8s_device_plugin_tpu_torch.parallel.distributed import local_device
from k8s_device_plugin_tpu_torch.parallel.mesh import axis_sizes, batch_shard, make_mesh
from k8s_device_plugin_tpu_torch.workload import smoke, train
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model


def _state_on(cfg_kw: dict, shape, state: dict | None, device: str = "cpu"):
    """A model (weights from seed 0, or ``state``) sharded on a mesh of
    ``shape`` over every rank, and its optimizer."""
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh(shape=shape, device=device)
    model = init_model(cfg, 0, local_device(device))
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    train.shard_model(model, mesh)
    return mesh, model, train.make_optimizer(model)


def _numpy_state(model) -> dict:
    """Copies: a parameter no collective gathered is a view of the live one."""
    return {k: v.numpy().copy() for k, v in train.full_state_dict(model).items()}


def mesh_report(shape) -> dict:
    """The mesh's axis sizes and which batch shard this rank feeds."""
    mesh = make_mesh(shape=shape, device="cpu")
    rows = batch_shard(torch.arange(8), mesh)
    return {"sizes": axis_sizes(mesh), "rows": rows.tolist()}


def mesh_refusal(shape) -> str:
    """``make_mesh``'s error for a shape that does not fit the world."""
    try:
        make_mesh(shape=shape, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def layout(cfg_kw: dict, shape) -> dict:
    """Each parameter's table entry, FSDP2 placement and local shape."""
    mesh, model, _ = _state_on(cfg_kw, shape, None)
    out = {}
    for name, p in model.named_parameters():
        local = p.to_local() if isinstance(p, DTensor) else p
        fsdp_dim = p.placements[0].dim if isinstance(p, DTensor) else None
        out[name] = {"local_shape": tuple(local.shape), "fsdp_dim": fsdp_dim,
                     "tp_dim": model.tp_dims.get(name)}
    return {"table": train.param_shardings(model.cfg, mesh), "params": out}


def train_steps(cfg_kw: dict, shape, tokens: np.ndarray, steps: int,
                state: dict | None = None, keep_after=(), device: str = "cpu") -> dict:
    """``steps`` sharded steps on the global batch ``tokens`` (each rank
    trains its rows): the losses, each step's host time (synchronised on
    the card), and the whole parameters after each step in
    ``keep_after``."""
    mesh, model, optimizer = _state_on(cfg_kw, shape, state, device)
    dev = local_device(device)
    rows = batch_shard(torch.from_numpy(tokens).long(), mesh).to(dev)
    losses, times, params = [], [], {}
    for i in range(1, steps + 1):
        t0 = time.monotonic()
        losses.append(float(train.train_step(model, optimizer, rows)))
        times.append(time.monotonic() - t0)  # float() waited for the card
        if i in keep_after:
            params[i] = _numpy_state(model)
    return {"losses": losses, "step_s": times, "params": params}


def multi_step(cfg_kw: dict, shape, stack: np.ndarray, state: dict) -> dict:
    """One call of the multi-step dispatch over the global ``stack``
    (inner_steps, batch, seq): the losses and the whole parameters after."""
    mesh, model, optimizer = _state_on(cfg_kw, shape, state)
    rows = batch_shard(torch.from_numpy(stack).long(), mesh, dim=1)
    step = train.make_multi_train_step(model, optimizer, stack.shape[0])
    losses = step(rows)
    return {"losses": losses.tolist(), "params": _numpy_state(model),
            "eager": not isinstance(step, train.GraphedTrainStep)}


def run_smoke(kwargs: dict) -> dict:
    """``run_smoke`` on the CPU over every rank: the report and the
    snapshots this rank emitted."""
    streamed = []
    report = smoke.run_smoke(device="cpu", emit=streamed.append, **kwargs)
    return {"report": report, "streamed": [s["partial"] for s in streamed]}


def fail_on_rank(rank: int, wait_s: float) -> int:
    """Raise on ``rank``; every other rank waits ``wait_s`` seconds."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    time.sleep(wait_s)
    return dist.get_rank()


def _mesh_coords(mesh) -> dict:
    """This rank's (batch shard, heads shard, seq shard) as (index, of)."""
    from k8s_device_plugin_tpu_torch.parallel.mesh import batch_index

    return {"batch": batch_index(mesh),
            "heads": (mesh.get_local_rank("model"), mesh["model"].size()),
            "seq": (mesh.get_local_rank("seq"), mesh["seq"].size())}


def _part(t: torch.Tensor, coords: dict) -> torch.Tensor:
    """The (batch, heads, seq) block of a (b, h, s, d) tensor at ``coords``."""
    for dim, key in enumerate(("batch", "heads", "seq")):
        i, n = coords[key]
        t = t.chunk(n, dim)[i]
    return t


def ring_shard(shape, q: np.ndarray, k: np.ndarray, v: np.ndarray, q_chunk: int = 0,
               dtype: str = "float32", grads: bool = False) -> dict:
    """``ring_attention`` on this rank's (batch, heads, seq) block of the
    global q, k, v (b, h, s, d), batch over (data, fsdp), heads over model
    and seq over seq, as the JAX ``ring_attention`` shards them: the
    block's place, its output and, with ``grads``, its share of the
    gradients of sum(out ** 2) (f32)."""
    from k8s_device_plugin_tpu_torch.parallel.ring import ring_attention

    mesh = make_mesh(shape=shape, device="cpu")
    coords = _mesh_coords(mesh)
    dt = getattr(torch, dtype)
    local = [_part(torch.from_numpy(a), coords).to(dt).requires_grad_(grads) for a in (q, k, v)]
    out = ring_attention(*local, mesh["seq"].get_group(), q_chunk)
    result = {"coords": coords, "out": out.detach().float().numpy()}
    if grads:
        (out.float() ** 2).sum().backward()
        result["grads"] = [t.grad.float().numpy() for t in local]
    return result


def ring_refusal(shape, q: np.ndarray, q_chunk: int) -> str:
    """``ring_attention``'s error for a ``q_chunk`` that does not divide
    the local shard."""
    from k8s_device_plugin_tpu_torch.parallel.ring import ring_attention

    mesh = make_mesh(shape=shape, device="cpu")
    local = _part(torch.from_numpy(q), _mesh_coords(mesh))
    try:
        ring_attention(local, local, local, mesh["seq"].get_group(), q_chunk)
    except ValueError as e:
        return str(e)
    return ""


def model_logits(cfg_kw: dict, shape, state: dict, tokens: np.ndarray) -> dict:
    """The sharded model's output (logits) for this rank's rows of the
    global batch, and which (data, fsdp) shard those rows are."""
    from k8s_device_plugin_tpu_torch.parallel.mesh import batch_index

    mesh, model, _ = _state_on(cfg_kw, shape, state)
    rows = batch_shard(torch.from_numpy(tokens).long(), mesh)
    with torch.no_grad():
        out = model(rows)
    return {"batch": batch_index(mesh), "logits": out.float().numpy()}


def _whole_grads(cfg_kw: dict, shape, state: dict | None, tokens: np.ndarray,
                 device: str = "cpu"):
    """The global loss of the sharded model on ``tokens`` and every
    parameter's whole gradient, by name (gathered as ``full_state_dict``
    gathers the parameters)."""
    mesh, model, _ = _state_on(cfg_kw, shape, state, device)
    rows = batch_shard(torch.from_numpy(tokens).long(), mesh).to(local_device(device))
    loss = train.loss_fn(model, rows)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    return float(train._global_mean(model, loss.detach())), train.full_state_dict(model)


def loss_and_grads(cfg_kw: dict, shape, state: dict, tokens: np.ndarray) -> dict:
    """``_whole_grads`` on the CPU, the gradients as numpy copies."""
    loss, grads = _whole_grads(cfg_kw, shape, state, tokens)
    return {"loss": loss, "grads": {k: v.numpy().copy() for k, v in grads.items()}}


def grad_gaps(cfg_kw: dict, shape, tokens: np.ndarray, reference: str,
              device: str = "cpu") -> dict | None:
    """``_whole_grads`` from seed 0's weights, held on rank 0 against the
    gradients saved at ``reference`` (``torch.save`` of a dict by name):
    the loss and, for each parameter, the largest gap over the reference's
    largest magnitude (``gap``), the cosine of the two gradients (``cos``)
    and the ratio of their norms (``norm``). None on the other ranks."""
    loss, grads = _whole_grads(cfg_kw, shape, None, tokens, device)
    if torch.distributed.get_rank() != 0:
        return None
    want = torch.load(reference)
    stats = {}
    for name, got in grads.items():
        got, ref = got.double(), want[name].to(got.device, torch.float64)
        stats[name] = {"gap": float((got - ref).abs().max() / ref.abs().max()),
                       "cos": float((got * ref).sum() / (got.norm() * ref.norm())),
                       "norm": float(got.norm() / ref.norm())}
    return {"loss": loss, "stats": stats}


def pipeline_toy(shape, ws: np.ndarray, x: np.ndarray, n_microbatches: int) -> dict:
    """The JAX pipeline test's toy (each layer tanh(h @ w)) through
    ``pipeline_apply`` over the mesh's pipe axis, one stage a rank: the
    output, and this stage's layers' gradients of sum(y ** 2) by layer."""
    from k8s_device_plugin_tpu_torch.parallel.pipeline import pipeline_apply, stack_stages

    mesh = make_mesh(shape=shape, device="cpu")
    group = mesh["pipe"].get_group()
    layers = [torch.from_numpy(w).requires_grad_() for w in ws]
    stages = stack_stages(list(enumerate(layers)), mesh["pipe"].size())
    stage = stages[mesh.get_local_rank("pipe")]

    def stage_fn(stage, h):
        for _, w in stage:
            h = torch.tanh(h @ w)
        return h

    y = pipeline_apply(stage_fn, stage, torch.from_numpy(x), group, n_microbatches)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "grads": {i: w.grad.numpy() for i, w in stage}}


def pipeline_refusal(shape, x: np.ndarray, n_microbatches: int) -> str:
    """``pipeline_apply``'s error for a batch the microbatches do not
    divide."""
    from k8s_device_plugin_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh(shape=shape, device="cpu")
    try:
        pipeline_apply(lambda _, h: h, None, torch.from_numpy(x), mesh["pipe"].get_group(),
                       n_microbatches)
    except ValueError as e:
        return str(e)
    return ""


def _whole_moments(model, optimizer) -> dict:
    """AdamW's moments of each parameter this rank holds, whole (FSDP2's
    shards and the tensor- and expert-parallel slices gathered, as
    ``full_state_dict`` gathers the parameters), and its step counts."""
    from k8s_device_plugin_tpu_torch.parallel.collectives import gather_split

    out = {"mu": {}, "nu": {}, "steps": set()}
    for name, p in model.named_parameters():
        state = optimizer.state[p]
        out["steps"].add(float(state["step"]))
        for key, moment in (("mu", state["exp_avg"]), ("nu", state["exp_avg_sq"])):
            t = moment.full_tensor() if isinstance(moment, DTensor) else moment
            if name in model.tp_dims:
                t = gather_split(t, model.tp_group, model.tp_dims[name])
            if name in model.ep_dims:
                t = gather_split(t, model.ep_group, model.ep_dims[name])
            out[key][name] = t.detach().cpu().numpy().copy()
    return out


def _whole_state(model, optimizer, digests: bool) -> dict:
    """The whole parameters (every rank's, as numpy arrays, or with
    ``digests`` their sha256 on rank 0 alone) and the moments of this
    rank's parameters (not with ``digests``)."""
    import hashlib

    params = {k: v.cpu().numpy() for k, v in train.full_state_dict(model).items()}
    if digests:
        if torch.distributed.get_rank() != 0:
            return {}
        return {"params": {k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in params.items()}}
    return {"params": {k: v.copy() for k, v in params.items()},
            "moments": _whole_moments(model, optimizer)}


def checkpoint_save(cfg_kw: dict, shape, tokens: np.ndarray, directory: str, steps: int = 1,
                    later_steps: int = 0, device: str = "cpu", digests: bool = False) -> dict:
    """``steps`` sharded steps from seed 0's weights on the global batch
    ``tokens``, saved as step ``steps`` under ``directory``; then
    ``later_steps`` more (the run that never stopped). The losses, and the
    whole state as it was saved (``_whole_state``)."""
    from k8s_device_plugin_tpu_torch.workload.checkpointing import TrainCheckpointer

    mesh, model, optimizer = _state_on(cfg_kw, shape, None, device)
    rows = batch_shard(torch.from_numpy(tokens).long(), mesh).to(local_device(device))
    losses = [float(train.train_step(model, optimizer, rows)) for _ in range(steps)]
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(steps, model, optimizer)
    whole = _whole_state(model, optimizer, digests)
    later = [float(train.train_step(model, optimizer, rows)) for _ in range(later_steps)]
    return {"losses": losses, "later_losses": later, "whole": whole}


def checkpoint_restore(cfg_kw: dict, shape, tokens: np.ndarray, directory: str,
                       steps: int = 1, device: str = "cpu", digests: bool = False) -> dict:
    """A model from seed 1's weights on a mesh of ``shape`` with a fresh
    optimizer, into which the newest step under ``directory`` is restored;
    then ``steps`` steps on ``tokens``. The restored step, the whole state
    right after the restore (``_whole_state``), each parameter's local
    shape before and after, and the losses."""
    from k8s_device_plugin_tpu_torch.workload.checkpointing import TrainCheckpointer

    dev = local_device(device)
    mesh = make_mesh(shape=shape, device=device)
    model, optimizer = train.make_train_state(ModelConfig(**cfg_kw), dev, 1, mesh=mesh)

    def local_shapes() -> dict:
        return {n: tuple((p.to_local() if isinstance(p, DTensor) else p).shape)
                for n, p in model.named_parameters()}

    before = local_shapes()
    with TrainCheckpointer(directory) as ckpt:
        step = ckpt.restore_latest(model, optimizer)[0]
    whole = _whole_state(model, optimizer, digests)
    rows = batch_shard(torch.from_numpy(tokens).long(), mesh).to(dev)
    losses = [float(train.train_step(model, optimizer, rows)) for _ in range(steps)]
    return {"step": step, "whole": whole, "local_shapes": (before, local_shapes()),
            "losses": losses}


def resumed_training(cfg_kw: dict, shape, directory: str, steps: int, device: str = "cpu") -> dict:
    """``run_training`` of ``ModelConfig(**cfg_kw)`` on a mesh of ``shape``
    for ``steps`` total steps, resuming from ``directory`` (no checkpoint
    when it is empty), batch 4 a rank, no save on the way."""
    from k8s_device_plugin_tpu_torch.workload.loop import run_training

    mesh = make_mesh(shape=shape, device=device)
    return run_training(ModelConfig(**cfg_kw), steps=steps, batch_per_device=4,
                        checkpoint_dir=directory or None, save_every=100, mesh=mesh)
