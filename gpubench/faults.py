"""Faults planted under the port's training step, for the checks that
``correct`` must fail (``calibrate.py``, ``tests/``): never used by a
benchmark run.

- ``unchanged``: the step computes its loss, gradients and update, then
  puts every parameter back as it was (a step that returns its state
  unchanged);
- ``half_batch``: the step sees only the first half of the batch's rows,
  its loss the mean over them;
- ``no_exchange`` (``SPLIT_KINDS``, a cell on the model axis alone): the
  exchange between cards left out, every ``enter_split`` and
  ``leave_split`` of the port's model the identity, so that each rank
  works on from its own partial sums.

``ACTIVE`` names the fault planted while ``planted`` runs, so that a run
over several ranks plants it in each rank too (``ranks.py``).
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half_batch")
SPLIT_KINDS = ("no_exchange",)
ACTIVE: str | None = None


@contextlib.contextmanager
def planted(kind: str):
    """Replace the port's code with the fault ``kind`` while the block
    runs: ``workload.train.train_step``, or for ``no_exchange`` the model's
    ``enter_split`` and ``leave_split``."""
    global ACTIVE
    from k8s_device_plugin_tpu_torch.workload import model as model_mod
    from k8s_device_plugin_tpu_torch.workload import train

    real = train.train_step, model_mod.enter_split, model_mod.leave_split

    def unchanged(model, optimizer, tokens, xent_chunk=None):
        before = [p.detach().clone() for p in model.parameters()]
        loss = real[0](model, optimizer, tokens, xent_chunk)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss

    def half_batch(model, optimizer, tokens, xent_chunk=None):
        return real[0](model, optimizer, tokens[: tokens.shape[0] // 2], xent_chunk)

    def alone(x, group):
        return x

    if kind == "no_exchange":
        model_mod.enter_split = model_mod.leave_split = alone
    else:
        train.train_step = {"unchanged": unchanged, "half_batch": half_batch}[kind]
    ACTIVE = kind
    try:
        yield
    finally:
        train.train_step, model_mod.enter_split, model_mod.leave_split = real
        ACTIVE = None
