"""A training job: the port's eager training step, one AdamW step a call.

``start`` makes the weights and the traffic's batches on the device from
the seed, loads the weights into the port's model
(``k8s_device_plugin_tpu_torch``, the family's ``program_model``), and
takes the first three steps through ``workload.train.train_step`` with
``make_optimizer``'s AdamW, reading what ``correct`` compares; the same
step then serves the timed window. ``check`` runs the family's plain
reference over those three batches and gives ``correct.gaps``.

On a mesh (a traffic's ``mesh``: data, fsdp, model), each rank lays the
loaded model out with ``train.shard_model`` before its first step and
feeds the whole batch (only the model axis may be larger than 1), and its
readings are of its own slices (``Evidence.split``), which
``correct.whole`` puts together; ``check`` then runs the reference over
the cards (``devices``).
"""

from __future__ import annotations

import dataclasses

import torch
from k8s_device_plugin_tpu_torch.workload import train

from .. import correct, families, generator
from . import Program


@dataclasses.dataclass
class Evidence:
    readings: correct.Readings
    batches: torch.Tensor  # the three checked steps' tokens
    # The leaves split over the model axis, whose readings are this rank's
    # slice's; empty off a mesh.
    split: tuple[str, ...] = ()


def start(cell, seed: int, dev, mesh=None) -> Program:
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    tr = cell.traffic
    pool = generator.batches(tr, sz.vocab, sz.seq, seed, dev)
    model = fam.program_model(sz, cell.config, dev)
    weights = fam.initial_weights(sz, seed, dev)
    fam.load_weights(model, weights)

    def initial():
        return fam.initial_weights(sz, seed, dev)

    if mesh is not None:
        if mesh.size() != mesh["model"].size():
            raise ValueError("a mesh cell splits the model axis alone: data and fsdp are 1")
        train.shard_model(model, mesh)
        size, rank, dims = mesh["model"].size(), mesh["model"].get_local_rank(), model.tp_dims
        # This rank's step-0 slices are kept from here: drawn again after the
        # steps, the whole weights would need one block as large as the
        # card's free memory in pieces.
        kept = {n: (w.chunk(size, dims[n])[rank] if n in dims else w).clone()
                for n, w in weights.items()}

        def initial():
            return kept

    del weights
    optimizer = train.make_optimizer(model, lr=tr["optimizer"]["lr"])

    def step(tokens):
        return train.train_step(model, optimizer, tokens, tr["xent_chunk"])

    readings = correct.program_readings(model, optimizer, step, pool[:3], initial,
                                        tr["optimizer"]["betas"][0])
    return Program(step, pool, tr["batch"] * sz.seq,
                   Evidence(readings, pool[:3].clone(), tuple(model.tp_dims)))


def gather(evidence: list[Evidence]) -> Evidence:
    """The whole model's evidence from each rank's (``correct.whole``); the
    batches are the first rank's, which every rank fed."""
    first = evidence[0]
    return Evidence(correct.whole([e.readings for e in evidence], set(first.split)),
                    first.batches, first.split)


def counters() -> dict[str, float]:
    """The launches of each of the port's hand-written kernels so far."""
    from k8s_device_plugin_tpu_torch.ops import _build

    return {f"launches.{name}": n for name, n in _build.LAUNCHES.items()}


def check(cell, seed: int, dev, evidence: Evidence, devices=None) -> dict[str, float]:
    fam = families.load(cell.config)
    ref = correct.reference_readings(fam, fam.sizes(cell.config), seed, evidence.batches.to(dev),
                                     cell.traffic["optimizer"], dev, devices=devices)
    return correct.gaps(evidence.readings, ref, fam.HEAD_LEAVES)
