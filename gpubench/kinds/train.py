"""A training job: the port's eager training step, one AdamW step a call.

``start`` makes the weights and the traffic's batches on the device from
the seed, loads the weights into the port's model
(``k8s_device_plugin_tpu_torch``, the family's ``program_model``), and
takes the first three steps through ``workload.train.train_step`` with
``make_optimizer``'s AdamW, reading what ``correct`` compares; the same
step then serves the timed window. ``check`` runs the family's plain
reference over those three batches and gives ``correct.gaps``.
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


def start(cell, seed: int, dev) -> Program:
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    tr = cell.traffic
    pool = generator.batches(tr, sz.vocab, sz.seq, seed, dev)
    model = fam.program_model(sz, cell.config, dev)
    fam.load_weights(model, fam.initial_weights(sz, seed, dev))
    optimizer = train.make_optimizer(model, lr=tr["optimizer"]["lr"])

    def step(tokens):
        return train.train_step(model, optimizer, tokens, tr["xent_chunk"])

    readings = correct.program_readings(model, optimizer, step, pool[:3],
                                        lambda: fam.initial_weights(sz, seed, dev),
                                        tr["optimizer"]["betas"][0])
    return Program(step, pool, tr["batch"] * sz.seq, Evidence(readings, pool[:3].clone()))


def counters() -> dict[str, float]:
    """The launches of each of the port's hand-written kernels so far."""
    from k8s_device_plugin_tpu_torch.ops import _build

    return {f"launches.{name}": n for name, n in _build.LAUNCHES.items()}


def check(cell, seed: int, dev, evidence: Evidence) -> dict[str, float]:
    fam = families.load(cell.config)
    ref = correct.reference_readings(fam, fam.sizes(cell.config), seed, evidence.batches,
                                     cell.traffic["optimizer"], dev)
    return correct.gaps(evidence.readings, ref, fam.HEAD_LEAVES)
