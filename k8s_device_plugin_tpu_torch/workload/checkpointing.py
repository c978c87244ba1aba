"""Workload checkpoint/resume on ``torch.distributed.checkpoint`` (DCP): the
counterpart of the JAX package's ``workload/checkpointing.py`` (orbax).

A training pod that gets rescheduled (node drain, or the plugin's own
health path evicting it when its card goes Unhealthy) must resume rather
than restart. ``TrainCheckpointer`` saves (parameters, AdamW state, step)
every N steps and restores the newest save into the live model and
optimizer of the *current* mesh, which may have another shape than the one
that saved: DCP reads each rank's part of each tensor from whichever saved
pieces overlap it, as orbax reshards on restore from its template.

What orbax gives the JAX class, kept here:

- one directory per step, ``<directory>/<step>/``;
- an atomic commit: every rank writes into ``<step>.tmp/``, and after a
  barrier rank 0 renames it to ``<step>/``; a ``.tmp`` directory a killed
  save left behind is never restored, and is cleared by the next save of
  its step;
- retention of the newest ``max_to_keep`` steps;
- ``async_save=True`` writes through ``dcp.async_save`` while training
  goes on; ``wait`` (or the next save) commits it.

Every rank must see the same directory (one host, or a volume the hosts
share), as orbax needs.

The layout of a step is orbax's item ``{"params", "opt_state"}``, with
optax's names for the Adam state: ``params.<name>``, ``opt_state.mu.<name>``
and ``opt_state.nu.<name>`` (AdamW's two moments) and ``opt_state.count``
(its step count, saved once, replicated). Each parameter and moment is
written as a DTensor over the mesh's (data, fsdp, expert, seq, model) axes
with the placements of the JAX ``param_shardings``: ``Shard`` on ``model``
and ``expert`` where tensor and expert parallelism split it, ``Shard`` on
``fsdp`` where ``param_shardings`` puts ``fsdp``, ``Replicate`` elsewhere.
The pipe axis is left out: a pipeline stage's blocks are written by the
ranks that hold them. Two kinds of parameter are stored by FSDP2 on a dim
the JAX layout does not split (flax's norm scales, and a parameter whose
``embed`` dim the ``fsdp`` axis does not divide: ``train.apply_fsdp``);
their FSDP2 shards are gathered before the save and written replicated
over ``fsdp``, so no tensor is ever split twice along one dim. The
tensor- and expert-parallel slices are plain local tensors in the live
model: written as plain tensors, DCP would take every rank's slice for a
copy of one tensor and keep one of them.

A fresh AdamW has no state (optax's starts as zeros with count 0): a save
writes zeros and count 0 for it, and a restore creates the state a first
step would, so no parameter moves. A restore copies every value into the
live tensors in place, each keeping its device (the step count stays on
the card where the optimizer is ``capturable``).

``CheckpointBeacon`` is the JAX class as it is: the control plane (the
extender's preemption planner and defrag engine) reads its annotation
through the JAX ``CheckpointBeacon.age_from``.
"""

from __future__ import annotations

import os
import shutil
import time
from collections.abc import Callable

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel.mesh import FSDP_AXIS, PIPE_AXIS
from . import train
from .model import TransformerLM

# The pod annotation the beacon stamps, as the JAX package's
# api/constants.py names it: the extender (extender/preemption.py) reads it
# to rank a victim's restart cost. A gang that checkpointed seconds ago
# loses almost nothing to an eviction; one an hour past its last save loses
# an hour of card time.
CHECKPOINT_TS_ANNOTATION = "tpu.google.com/last-checkpoint"

# The suffix of the directory a save writes before its commit.
TMP_SUFFIX = ".tmp"


class CheckpointBeacon:
    """Publishes checkpoint recency to the control plane.

    After every durable save, the beacon stamps the pod's
    ``tpu.google.com/last-checkpoint`` annotation (epoch seconds) so
    the extender's preemption planner (extender/preemption.py) can
    rank this gang's restart cost truthfully: a gang that saved
    seconds ago is a cheap victim, one an hour past its save is not.
    Best-effort by design — a failed stamp costs accuracy of the cost
    ranking, never the save.

    ``stamp`` is any ``(annotations: dict) -> None`` writer; the
    common wiring is ``KubeClient.patch_pod_annotations`` curried with
    this pod's identity (``CheckpointBeacon.for_pod``)."""

    ANNOTATION = CHECKPOINT_TS_ANNOTATION

    def __init__(self, stamp: Callable[[dict], None]):
        self._stamp = stamp
        self.last_stamped: float | None = None

    @staticmethod
    def for_pod(client, namespace: str = "", name: str = ""):
        """Beacon bound to this pod via the downward-API env vars
        (POD_NAMESPACE / POD_NAME) or explicit identity."""
        ns = namespace or os.environ.get("POD_NAMESPACE", "default")
        pod = name or os.environ.get("POD_NAME", "")
        if not pod:
            return None

        def stamp(ann: dict) -> None:
            client.patch_pod_annotations(ns, pod, ann)

        return CheckpointBeacon(stamp)

    @staticmethod
    def age_from(annotations: dict | None, now: float | None = None) -> float | None:
        """Seconds since the last durable save recorded on a pod's
        annotations, or None when never stamped / unparsable — the ONE
        parser of the beacon's annotation, shared by the preemption
        planner's victim ranking and the defrag engine's
        fresh-checkpoint preference so the two cost models can never
        read the same stamp differently. Clock skew that would read
        negative clamps to 0 (a save from "the future" is simply
        fresh)."""
        raw = (annotations or {}).get(CHECKPOINT_TS_ANNOTATION)
        if not raw:
            return None
        try:
            ts = float(raw)
        except (TypeError, ValueError):
            return None
        return max(0.0, (now if now is not None else time.time()) - ts)

    def note_saved(self, step: int) -> bool:
        ts = round(time.time(), 3)
        try:
            self._stamp({self.ANNOTATION: str(ts)})
        except Exception:  # noqa: BLE001 — recency is advisory; the
            # checkpoint itself already committed
            return False
        self.last_stamped = ts
        return True


class _Layout:
    """How the checkpoint holds each parameter of ``model`` (and each of its
    moments): its global shape, its mesh axis per dim (the JAX
    ``param_shardings``) and the mesh it is written over."""

    def __init__(self, model: TransformerLM):
        mesh = getattr(model, "mesh", None)
        if mesh is None and train.is_sharded(model):
            raise ValueError("a sharded model is checkpointed over its mesh: lay it out "
                             "with train.shard_model")
        self.shapes = {n: p.shape for n, p in TransformerLM(model.cfg, device="meta")
                       .named_parameters()}
        if mesh is None:
            self.mesh, self.specs = None, {n: () for n in self.shapes}
        else:
            self.mesh = mesh[tuple(a for a in mesh.mesh_dim_names if a != PIPE_AXIS)]
            self.specs = train.param_shardings(model.cfg, mesh)

    def saved(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """What this rank writes of ``t``, the live parameter ``name`` or
        one of its moments: FSDP2's shard where it is the JAX ``fsdp``
        split, else the gathered tensor; a DTensor over the mesh with the
        JAX placements (a plain tensor without a mesh)."""
        spec = self.specs[name]
        if isinstance(t, DTensor):
            t = t.to_local() if FSDP_AXIS in spec else t.full_tensor()
        if self.mesh is None:
            return t
        shape = self.shapes[name]
        placements = [Shard(spec.index(a)) if a in spec else Replicate()
                      for a in self.mesh.mesh_dim_names]
        return DTensor.from_local(t, self.mesh, placements, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    def restore(self, name: str, live: torch.Tensor, loaded: torch.Tensor) -> None:
        """Copy ``loaded`` (what ``saved`` gives of ``name``, read back) into
        the live tensor, in place."""
        if isinstance(loaded, DTensor):
            loaded = loaded.to_local()
        if isinstance(live, DTensor):
            if FSDP_AXIS not in self.specs[name]:  # saved gathered: keep FSDP2's shard
                loaded = DTensor.from_local(loaded, live.device_mesh,
                                            [Replicate()] * live.device_mesh.ndim,
                                            run_check=False)
                loaded = loaded.redistribute(live.device_mesh, live.placements).to_local()
            live = live.to_local()
        live.copy_(loaded)


def _fresh_state(optimizer: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """AdamW's state of ``p``, created as its first step creates it (zeros,
    step 0) where the optimizer has none yet."""
    state = optimizer.state[p]
    if not state:
        group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
        dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
        on_device = group["capturable"] or group["fused"]
        state["step"] = (torch.zeros((), dtype=dtype, device=p.device) if on_device
                         else torch.tensor(0.0, dtype=dtype))
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def _state_dict(model: TransformerLM, optimizer: torch.optim.Optimizer, layout: _Layout) -> dict:
    """The item a save writes, views of the live state where the layout
    allows (a fresh optimizer's moments are zeros)."""
    params, mu, nu, count = {}, {}, {}, 0.0
    for name, p in model.named_parameters():
        state = optimizer.state.get(p) or {}
        params[name] = layout.saved(name, p.detach())
        if state:
            count = float(state["step"])
            mu[name] = layout.saved(name, state["exp_avg"])
            nu[name] = layout.saved(name, state["exp_avg_sq"])
        else:
            mu[name] = torch.zeros_like(params[name])
            nu[name] = torch.zeros_like(params[name])
    return {"params": params,
            "opt_state": {"count": torch.tensor(count), "mu": mu, "nu": nu}}


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class TrainCheckpointer:
    """DCP checkpoints of the smoke workload's train state (the model and
    its AdamW) under ``directory``, one directory a step. Every rank of the
    process group calls each method (they hold collectives). Synchronous by
    default; ``async_save=True`` lets the save overlap the next steps."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_every: int = 50,
        async_save: bool = False,
        beacon: CheckpointBeacon | None = None,
    ):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = max(1, save_every)
        # Control-plane recency beacon: each committed save stamps the
        # pod's last-checkpoint annotation so preemption's victim
        # ranking sees honest restart cost. None = no stamping.
        self.beacon = beacon
        self._async_save = async_save
        self._group = None
        if async_save and dist.is_initialized() and dist.get_backend() != "gloo":
            # dcp.async_save runs its collectives on a thread, which needs a
            # group with a CPU backend; its commit uses the same group.
            self._group = dist.new_group(backend="gloo")
        self._pending: tuple[int, object] | None = None  # an async save not yet committed
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.directory, f"{step}{TMP_SUFFIX if tmp else ''}")

    def _barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier(group=self._group)

    def committed_steps(self) -> list[int]:
        """The committed steps on disk, oldest first (a ``.tmp`` directory
        is not one)."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(os.path.join(self.directory, name)))

    def maybe_save(self, step: int, model: TransformerLM, optimizer: torch.optim.Optimizer) -> bool:
        """Save if ``step`` is on the cadence; returns whether it saved."""
        if step % self.save_every:
            return False
        return self.save(step, model, optimizer)

    def save(self, step: int, model: TransformerLM, optimizer: torch.optim.Optimizer) -> bool:
        """Write ``step``'s state and commit it (with ``async_save``, start
        the write; ``wait`` or the next save commits it). Raises when the
        step is already committed."""
        self.wait()
        if step in self.committed_steps():
            raise ValueError(f"step {step} is already saved in {self.directory}")
        tmp = self._path(step, tmp=True)
        if _is_rank0():
            shutil.rmtree(tmp, ignore_errors=True)  # what a killed save of this step left
        self._barrier()
        state = _state_dict(model, optimizer, _Layout(model))
        if self._async_save:
            self._pending = (step, dcp.async_save(state, checkpoint_id=tmp,
                                                  process_group=self._group))
        else:
            dcp.save(state, checkpoint_id=tmp, process_group=self._group)
            self._commit(step)
        if self.beacon is not None:
            # The stamp claims "this much work is safe"; an async save that
            # is merely started is not, so it commits first (once per save
            # cadence, not per step).
            self.wait()
            self.beacon.note_saved(step)
        return True

    def _commit(self, step: int) -> None:
        """Every rank has written ``step``: rank 0 renames its directory
        into place and drops the steps past ``max_to_keep``."""
        self._barrier()
        if _is_rank0():
            os.replace(self._path(step, tmp=True), self._path(step))
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)  # the rename is durable before anyone is told
            finally:
                os.close(fd)
            steps = self.committed_steps()
            if self.max_to_keep:
                for old in steps[:-self.max_to_keep]:
                    shutil.rmtree(self._path(old))
        self._barrier()

    def latest_step(self) -> int | None:
        """The newest step saved: one whose async save is still being
        written counts, as orbax counts it; a ``.tmp`` directory a killed
        save left does not."""
        if self._pending is not None:
            return self._pending[0]
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore_latest(
        self, model: TransformerLM, optimizer: torch.optim.Optimizer,
    ) -> tuple[int, TransformerLM, torch.optim.Optimizer] | None:
        """Load the newest committed step into ``model`` and ``optimizer``,
        laid out on the current mesh (any shape), in place. Returns (step,
        model, optimizer), or None when no step is committed. A checkpoint
        that does not fit the model (a missing tensor, another shape)
        raises."""
        self.wait()
        steps = self.committed_steps()
        found = [steps[-1] if steps else None]
        if dist.is_initialized():
            dist.broadcast_object_list(found, src=0, group=self._group)  # one step for all
        step = found[0]
        if step is None:
            return None
        layout = _Layout(model)
        live = {name: (p, _fresh_state(optimizer, p)) for name, p in model.named_parameters()}
        target = _tree_map(torch.empty_like, _state_dict(model, optimizer, layout))
        dcp.load(target, checkpoint_id=self._path(step), process_group=self._group)
        count = target["opt_state"]["count"]
        with torch.no_grad():
            for name, (p, state) in live.items():
                layout.restore(name, p.detach(), target["params"][name])
                layout.restore(name, state["exp_avg"], target["opt_state"]["mu"][name])
                layout.restore(name, state["exp_avg_sq"], target["opt_state"]["nu"][name])
                state["step"].copy_(count)
        return step, model, optimizer

    def wait(self) -> None:
        """Block until an async save is written, and commit it."""
        if self._pending is None:
            return
        step, future = self._pending
        self._pending = None
        future.result()
        self._commit(step)

    def close(self) -> None:
        """Commit what is in flight and release the checkpointer's group."""
        try:
            self.wait()
        finally:
            if self._group is not None:
                dist.destroy_process_group(self._group)
                self._group = None

    def __enter__(self) -> TrainCheckpointer:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
