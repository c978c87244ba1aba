"""Resumable training loop: the smoke workload's long-running form, the
counterpart of the JAX package's ``workload/loop.py``.

Ties together the sharded train step (``train.py``) and checkpoint/resume
(``checkpointing.py``): a pod evicted mid-run — e.g. by the plugin's own
health path re-advertising its card Unhealthy — restarts, restores the
newest checkpoint onto whatever mesh its new allocation supports, and
continues from the saved step rather than step 0.

As in the JAX loop, each step is one eager ``train.train_step`` whose loss
the host reads before the next step (no CUDA graph, no multi-step
dispatch).
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from ..parallel import distributed
from ..parallel.mesh import axis_sizes, batch_shard, make_mesh
from ..utils import compilation_cache
from ..utils.profiling import annotate, trace
from . import train
from .checkpointing import TrainCheckpointer
from .model import ModelConfig

PROFILE_DIR_ENV = "TPU_WORKLOAD_PROFILE_DIR"


def synthetic_batch(cfg: ModelConfig, mesh, batch: int, step: int,
                    device: str | torch.device) -> torch.Tensor:
    """Deterministic per-step synthetic tokens (so a resumed run sees the
    same stream it would have seen uninterrupted): the global batch drawn
    on the CPU from ``step``'s seed, of which this rank keeps its rows."""
    gen = torch.Generator().manual_seed(step)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen)
    return batch_shard(tokens, mesh).to(device)


def run_training(
    cfg: ModelConfig | None = None,
    steps: int = 100,
    batch_per_device: int = 8,
    checkpoint_dir: str | None = None,
    save_every: int = 20,
    seed: int = 0,
    mesh=None,
    profile_dir: str | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Train for ``steps`` total steps, resuming from ``checkpoint_dir``
    when it holds a previous run's state. ``profile_dir`` (or env
    ``TPU_WORKLOAD_PROFILE_DIR``) captures the whole run as a
    TensorBoard-loadable ``torch.profiler`` trace. Every rank of the
    process group calls it. Returns a JSON-able report.

    Without ``mesh``, the world is every rank of the process group (this
    process alone outside a launcher, as in ``smoke.run_smoke``) on
    ``factorize``'s mesh; ``device`` defaults to the mesh's device type,
    else this rank's card (raising when there is none): pass
    ``device="cpu"`` for the plain PyTorch path. The global batch is
    ``batch_per_device`` x the mesh's ranks.

    The report has the JAX loop's keys (``start_step``, ``end_step``,
    ``resumed``, ``first_loss``, ``final_loss``, ``losses``, ``mesh``) and
    the run's host times: ``step_s`` (each step, its loss read included),
    ``time_to_first_step_s`` (from the call to the first loss read: the
    restart's cost, restore included), ``restore_s`` (None when nothing was
    restored) and ``save_s`` (each save, its commit included)."""
    t_start = time.monotonic()
    profile_dir = profile_dir or os.environ.get(PROFILE_DIR_ENV, "")
    compilation_cache.maybe_enable()
    cfg = cfg or ModelConfig()
    if device is None and mesh is not None:
        device = mesh.device_type
    dev = distributed.local_device(device)
    if mesh is None:
        distributed.initialize(dev)
        mesh = make_mesh(dist.get_world_size(), device=dev)
    model, optimizer = train.make_train_state(cfg, dev, seed, mesh=mesh)

    start_step = 0
    ckpt = None
    batch = batch_per_device * mesh.size()
    losses, step_s, save_s = [], [], []
    restore_s = first_step_s = None
    try:
        if checkpoint_dir:
            ckpt = TrainCheckpointer(checkpoint_dir, save_every=save_every)
            t0 = time.monotonic()
            restored = ckpt.restore_latest(model, optimizer)
            if restored is not None:
                restore_s = time.monotonic() - t0
                start_step = restored[0] + 1  # saved state is *after* that step ran

        def save(saver, step: int) -> None:
            t0 = time.monotonic()
            if saver(step, model, optimizer):
                save_s.append(time.monotonic() - t0)

        step = start_step
        with trace(profile_dir):
            for step in range(start_step, steps):
                t0 = time.monotonic()
                with annotate("train_step"):
                    loss = train.train_step(model, optimizer,
                                            synthetic_batch(cfg, mesh, batch, step, dev))
                losses.append(float(loss))
                step_s.append(time.monotonic() - t0)
                if first_step_s is None:
                    first_step_s = time.monotonic() - t_start
                if ckpt is not None:
                    with annotate("checkpoint"):
                        save(ckpt.maybe_save, step)
        if ckpt is not None and losses and ckpt.latest_step() != step:
            # Skip when maybe_save already wrote this step (final step on a
            # save_every boundary): a second save of a step raises.
            save(ckpt.save, step)
    finally:
        # Always flush + close (zero-step resumes, exceptions mid-loop):
        # leaking the checkpointer would strand an in-flight async save.
        if ckpt is not None:
            ckpt.close()

    return {
        "start_step": start_step,
        "end_step": steps,
        "resumed": start_step > 0,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "mesh": axis_sizes(mesh),
        "step_s": step_s,
        "time_to_first_step_s": first_step_s,
        "restore_s": restore_s,
        "save_s": save_s,
    }
