"""What the port's multi-rank tests run on each gloo rank.

The ranks are processes of ``parallel.distributed.RankPool``: they import
this module (not a test module, and not ``conftest.py``) and so import no
JAX. The tests run the JAX side in their own process and hand numpy
arrays to these functions.
"""

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
    trains its rows): the losses, and the whole parameters after each step
    in ``keep_after``."""
    mesh, model, optimizer = _state_on(cfg_kw, shape, state, device)
    rows = batch_shard(torch.from_numpy(tokens).long(), mesh).to(local_device(device))
    losses, params = [], {}
    for i in range(1, steps + 1):
        losses.append(float(train.train_step(model, optimizer, rows)))
        if i in keep_after:
            params[i] = _numpy_state(model)
    return {"losses": losses, "params": params}


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
    import time

    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    time.sleep(wait_s)
    return dist.get_rank()
