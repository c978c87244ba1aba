"""The device mesh over the ranks of the process group: the counterpart of
the JAX package's ``parallel/mesh.py``.

A pod allocated N cards runs one rank per card (``workload/smoke.py``
starts them), and the ranks build one ``DeviceMesh`` over the same six
named axes, in the same order, as the JAX mesh: data-parallel batch
splitting (``data``), fully-sharded parameter storage (``fsdp``, FSDP2),
expert parallelism (``expert``, the MoE layers), pipeline stages
(``pipe``), context parallelism (``seq``, ring attention) and tensor
parallelism (``model``). ``workload/train.shard_model`` lays a model out
over it.
"""

from __future__ import annotations

import math
import os

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
# Mesh order, as the JAX mesh: the axis with the most traffic (model, a sum
# per layer) innermost, so it lands on neighbouring ranks of one host.
AXES = (DATA_AXIS, FSDP_AXIS, EXPERT_AXIS, PIPE_AXIS, SEQ_AXIS, MODEL_AXIS)

# Logical axis -> mesh axis, as the JAX rules: parameters shard their embed
# dim over fsdp and their wide dims over model; the batch splits over
# data x fsdp.
LOGICAL_AXIS_RULES = (
    ("batch", (DATA_AXIS, FSDP_AXIS)),
    ("embed", FSDP_AXIS),
    ("mlp", MODEL_AXIS),
    ("heads", MODEL_AXIS),
    ("kv", None),
    ("vocab", MODEL_AXIS),
    ("seq", None),
    ("expert", EXPERT_AXIS),
    ("layers", PIPE_AXIS),
)


def factorize(n: int, max_model: int = 4) -> tuple[int, int, int]:
    """Split n ranks into (data, fsdp, model) sizes, as the JAX
    ``factorize``: model kept small (a collective per layer), fsdp takes
    the bulk, data the rest. All factors divide n."""
    if n < 1:
        raise ValueError(f"need at least 1 device, got {n}")
    model = 1
    for cand in range(min(max_model, n), 0, -1):
        if n % cand == 0:
            model = cand
            break
    rest = n // model
    fsdp = 1
    for cand in range(int(math.isqrt(rest)), 0, -1):
        if rest % cand == 0:
            fsdp = rest // cand
            break
    return (rest // fsdp, fsdp, model)


def mesh_shape(world: int, shape: tuple[int, ...] | None = None) -> tuple[int, ...]:
    """The six-axis shape of a mesh over ``world`` ranks: ``factorize``'s
    when ``shape`` is None; a short ``shape`` — (data, fsdp, model) or
    (data, fsdp, seq, model) — gets the missing axes at size 1. Raises
    unless the shape has six axes and multiplies to ``world``."""
    if shape is None:
        shape = factorize(world)
    shape = tuple(shape)
    if len(shape) == 3:
        shape = (shape[0], shape[1], 1, shape[2])
    if len(shape) == 4:
        shape = (shape[0], shape[1], 1, 1, shape[2], shape[3])
    if len(shape) != len(AXES):
        raise ValueError(f"mesh shape {shape} must have {len(AXES)} axes")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    return shape


def make_mesh(world: int | None = None, shape: tuple[int, ...] | None = None,
              device: str | torch.device | None = None) -> DeviceMesh:
    """A (data, fsdp, expert, pipe, seq, model) ``DeviceMesh`` over every
    rank of the process group, which this brings up first if it is not
    (``distributed.initialize``). ``world``, when given, must be the
    group's size. ``device``: the card unless the caller asks for the
    CPU."""
    from .distributed import initialize, local_device

    dev = local_device(device)
    initialize(dev)
    size = torch.distributed.get_world_size()
    if world is not None and world != size:
        raise ValueError(f"a mesh over {world} devices, but the process group has {size}")
    return init_device_mesh(dev.type, mesh_shape(size, shape), mesh_dim_names=AXES)


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """The mesh's size along each axis, by name (the JAX ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_index(mesh: DeviceMesh, rank: int | None = None) -> tuple[int, int]:
    """(which batch shard, of how many) a rank feeds: the batch splits over
    (data, fsdp), data major, as the JAX ``batch_sharding``; ranks that
    differ only along another axis feed the same shard. Default: this
    rank."""
    sizes = axis_sizes(mesh)
    if rank is None:
        d, f = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(FSDP_AXIS)
    else:
        coord = (mesh.mesh == rank).nonzero()[0].tolist()
        d, f = coord[AXES.index(DATA_AXIS)], coord[AXES.index(FSDP_AXIS)]
    return d * sizes[FSDP_AXIS] + f, sizes[DATA_AXIS] * sizes[FSDP_AXIS]


def batch_shard(batch: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """The rows of a global batch (along ``dim``) that this rank feeds."""
    index, shards = batch_index(mesh)
    rows = batch.shape[dim]
    if rows % shards:
        raise ValueError(f"a batch of {rows} does not split over {shards} (data, fsdp) shards")
    per = rows // shards
    return batch.narrow(dim, index * per, per)


def host_bounds_from_env() -> tuple[int, int, int] | None:
    """The allocated sub-slice shape the plugin exported
    (TPU_CHIPS_PER_HOST_BOUNDS), if set and well formed."""
    raw = os.environ.get("TPU_CHIPS_PER_HOST_BOUNDS", "")
    if not raw:
        return None
    try:
        x, y, z = (int(v) for v in raw.split(","))
        return (x, y, z)
    except ValueError:
        return None
