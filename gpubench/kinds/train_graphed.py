"""A training job through the port's CUDA graph of the training step:
``inner_steps`` AdamW steps a call (``workload.train.make_multi_train_
step``, a ``GraphedTrainStep`` on the card; the eager loop on the CPU).

A timed step is one call: ``inner_steps`` training steps over a stack of
that many batches, replayed from the graph. The pool is the traffic's
batches taken ``inner_steps`` at a time. ``start`` makes the weights and
batches on the device from the seed, loads the weights into the port's
model and makes the first call, whose first steps run eagerly (the
graph's warm-up), whose capture follows and whose remaining steps are
replays. What ``correct`` compares is what that call produced: its
``inner_steps`` losses, the first step's gradient (the optimizer's state
after that eager step) and the weights' change after the call, held to
the family's plain reference over the same batches (``kinds/train.py``'s
``check``). ``LAST`` keeps the capture's host seconds of the last program
started (``metrics/capture_s.py``).
"""

from __future__ import annotations

import torch
from k8s_device_plugin_tpu_torch.workload import train

from .. import correct, families, generator
from . import Program
from . import train as train_kind

LAST: dict = {}


def start(cell, seed: int, dev) -> Program:
    LAST.clear()
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    tr = cell.traffic
    n = tr["inner_steps"]
    flat = generator.batches(tr, sz.vocab, sz.seq, seed, dev)
    if flat.shape[0] % n:
        raise ValueError(f"{flat.shape[0]} batches do not make stacks of {n}")
    pool = flat.view(-1, n, tr["batch"], sz.seq)
    model = fam.program_model(sz, cell.config, dev)
    fam.load_weights(model, fam.initial_weights(sz, seed, dev))
    optimizer = train.make_optimizer(model, lr=tr["optimizer"]["lr"])
    multi = train.make_multi_train_step(model, optimizer, n, tr["xent_chunk"])

    names = {p: name for name, p in model.named_parameters()}
    grads: dict = {}
    real = train.train_step

    def first_step_read(*args, **kwargs):
        loss = real(*args, **kwargs)
        if not grads:
            state = optimizer.state
            grads.update(correct._norms({names[p]: state[p]["exp_avg"] for p in names},
                                        1.0 / (1.0 - tr["optimizer"]["betas"][0])))
        return loss

    train.train_step = first_step_read
    try:
        losses = multi(pool[0])
    finally:
        train.train_step = real
    LAST["capture_s"] = getattr(multi, "capture_s", None)
    changes = correct._changes(dict(model.named_parameters()),
                               fam.initial_weights(sz, seed, dev))
    readings = correct.Readings(losses.tolist(), grads, changes)
    return Program(multi, pool, n * tr["batch"] * sz.seq,
                   train_kind.Evidence(readings, pool[0].clone()))


counters = train_kind.counters
check = train_kind.check
