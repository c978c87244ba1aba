"""A training job of a model with DeepSeek-V3's routed layers: the port's
eager training step, one AdamW step and one routing-bias update a call,
as ``kinds/train.py`` drives it, with the routed layers' counters.

``start`` turns the port's routed-layer counters on
(``workload/routed.py`` ``COUNTERS``), makes the weights and batches on
the device from the seed, loads the weights into the port's model (the
family's ``program_model``), and takes the first three steps through
``workload.train.train_step`` with ``make_optimizer``'s AdamW, reading
what ``correct`` compares and, on the first step, each routed layer's
choice of experts for every token. ``counters`` adds the routed layers'
tallies to ``kinds/train.py``'s launches. ``check`` runs the family's
plain reference over the three batches (it takes its own routing
decisions) and gives ``correct.gaps``, and beside them
``routing_disagreement``: the share of (token, routed layer) pairs whose
set of chosen experts on the first step differs between the program and
the reference, printed on standard error; it has no limit.
"""

from __future__ import annotations

import dataclasses
import sys

import torch
from k8s_device_plugin_tpu_torch.workload import routed, train

from .. import correct, families, generator
from . import Program
from . import train as train_kind


@dataclasses.dataclass
class Evidence(train_kind.Evidence):
    # Layer index -> (tokens, k) experts the program chose on step 1.
    choices: dict = dataclasses.field(default_factory=dict)


def start(cell, seed: int, dev) -> Program:
    routed.COUNTERS.reset()
    routed.COUNTERS.on = True
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    tr = cell.traffic
    pool = generator.batches(tr, sz.vocab, sz.seq, seed, dev)
    model = fam.program_model(sz, cell.config, dev)
    weights = fam.initial_weights(sz, seed, dev)
    fam.load_weights(model, weights)
    del weights
    optimizer = train.make_optimizer(model, lr=tr["optimizer"]["lr"])
    layers = [i for i, block in enumerate(model.blocks) if block.is_moe]
    choices: dict = {}

    def keep(i, route):
        def observed(x):
            scores, chosen, gates = route(x)
            choices[i] = chosen.to(torch.uint8)
            return scores, chosen, gates
        return observed

    for i in layers:
        model.blocks[i].moe.route = keep(i, model.blocks[i].moe.route)

    def step(tokens):
        return train.train_step(model, optimizer, tokens, tr["xent_chunk"])

    def checked(tokens):
        loss = step(tokens)
        for i in layers:  # the first step's choices alone
            vars(model.blocks[i].moe).pop("route", None)
        return loss

    readings = correct.program_readings(model, optimizer, checked, pool[:3],
                                        lambda: fam.initial_weights(sz, seed, dev),
                                        tr["optimizer"]["betas"][0])
    return Program(step, pool, tr["batch"] * sz.seq,
                   Evidence(readings, pool[:3].clone(), choices=choices))


def counters() -> dict[str, float]:
    """The hand-written kernels' launches and the routed layers' tallies
    (``moe.*``: rows a held expert, choices an expert, the held experts'
    most rows over their mean summed over layer-steps, the layer-steps)."""
    return {**train_kind.counters(), **routed.COUNTERS.read()}


def _reference(fam, sz, seed: int, batches, optimizer: dict, dev):
    """``correct.reference_readings`` on one device, with the reference's
    own routing choices of its first step."""
    choices: dict = {}
    losses, grads, params = [], None, None
    steps = fam.reference_steps(sz, fam.initial_weights(sz, seed, dev), batches, optimizer,
                                choices=choices)
    for i, (loss, g, params) in enumerate(steps):
        losses.append(loss)
        if i == 0:
            grads = correct._norms(g)
    changes = correct._changes(params, fam.initial_weights(sz, seed, dev))
    return correct.Readings(torch.stack(losses).tolist(), grads, changes), choices


def disagreement(program: dict, reference: dict) -> float:
    """The share of (token, layer) pairs whose sets of chosen experts
    differ; a token that one side routed and the other did not counts as
    differing."""
    differ = total = 0
    for i, mine in program.items():
        a = mine.long().sort(-1).values
        b = reference[i].to(a.device).sort(-1).values
        n = min(len(a), len(b))
        differ += int((a[:n] != b[:n]).any(-1).sum()) + abs(len(a) - len(b))
        total += max(len(a), len(b))
    return differ / total if total else float("nan")


def check(cell, seed: int, dev, evidence: Evidence, devices=None) -> dict[str, float]:
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    ref, choices = _reference(fam, sz, seed, evidence.batches.to(dev),
                              cell.traffic["optimizer"], dev)
    found = correct.gaps(evidence.readings, ref, fam.HEAD_LEAVES)
    found["routing_disagreement"] = disagreement(evidence.choices, choices)
    print(f"routing_disagreement {found['routing_disagreement']!r}", file=sys.stderr)
    return found
