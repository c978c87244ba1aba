"""Faults planted under the port's training step, for the checks that
``correct`` must fail (``calibrate.py``, ``tests/``): never used by a
benchmark run.

- ``unchanged``: the step computes its loss, gradients and update, then
  puts every parameter back as it was (a step that returns its state
  unchanged);
- ``half_batch``: the step sees only the first half of the batch's rows,
  its loss the mean over them.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half_batch")


@contextlib.contextmanager
def planted(kind: str):
    """Replace ``workload.train.train_step`` with the fault ``kind`` while
    the block runs."""
    from k8s_device_plugin_tpu_torch.workload import train

    real = train.train_step

    def unchanged(model, optimizer, tokens, xent_chunk=None):
        before = [p.detach().clone() for p in model.parameters()]
        loss = real(model, optimizer, tokens, xent_chunk)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss

    def half_batch(model, optimizer, tokens, xent_chunk=None):
        return real(model, optimizer, tokens[: tokens.shape[0] // 2], xent_chunk)

    train.train_step = {"unchanged": unchanged, "half_batch": half_batch}[kind]
    try:
        yield
    finally:
        train.train_step = real
