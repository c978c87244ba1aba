"""How ``correct`` is decided: the program's first three training steps
held to the plain reference's, from the same weights and the same batches.

Three numbers are read on each side and compared:

- ``loss_gap``: the largest gap, in nats, between the program's loss and
  the reference's over the three steps;
- ``grad_gap``: the first step's gradient by leaf, as the optimizer got it
  (the program's from its AdamW state, ``exp_avg / (1 - beta1)``): the
  worst leaf's gap between the two norms, over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the parameters' change after the three steps by leaf,
  the same measure. Leaves whose reference gradient is under a thousandth
  of the median leaf's move by round-off alone and are left out;
- ``head_grad_gap``: ``grad_gap`` over the family's head leaves alone
  (``HEAD_LEAVES``: the tied embedding and the final norm), whose products
  are f32 where the blocks' are bf16: the blocks' rounding sets
  ``grad_gap``'s worst leaf and would hide a coarser head.

On a mesh (a cell of several cards) each rank reads its own slices, and
``whole`` makes the whole model's readings of them: a leaf split over the
model axis has the norm of its slices together, a replicated leaf is read
once, on the first rank.

Each has a limit of its own per cell (``limits/<cell>.json``), set from the
program's readings over a dozen seeds and more and from the control's and
the faults' (``calibrate.py``); a number over its limit, or not finite,
makes the run incorrect. A number that neither the control nor a fault
separates from the program's own readings gets no limit in that cell and
is not compared there.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

# A leaf whose reference gradient norm is under this share of the median
# leaf's is left out of ``change_gap``.
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Readings:
    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]


def _norms(tensors: dict[str, torch.Tensor], scale: float = 1.0) -> dict[str, float]:
    names = list(tensors)
    first = tensors[names[0]].device
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()).to(first) for n in names])
    return dict(zip(names, (values * scale).tolist()))


def _changes(params: dict[str, torch.Tensor], initial: dict[str, torch.Tensor]) -> dict[str, float]:
    return _norms({n: params[n].detach() - initial[n] for n in params})


def program_readings(model, optimizer, step, batches, initial_weights, beta1: float) -> Readings:
    """Drive the program's own training step ``step(tokens) -> loss``
    through ``batches`` (one step each) and read it: the losses, the first
    gradient from the optimizer's state after step 1, and each leaf's
    change from ``initial_weights()`` after the last step."""
    names = {p: n for n, p in model.named_parameters()}
    losses, grads = [], None
    for i, tokens in enumerate(batches):
        losses.append(step(tokens))
        if i == 0:
            state = optimizer.state
            grads = _norms({names[p]: state[p]["exp_avg"] for p in names}, 1.0 / (1.0 - beta1))
    params = dict(model.named_parameters())
    changes = _changes(params, initial_weights())
    return Readings(torch.stack(losses).tolist(), grads, changes)


def whole(ranks: list[Readings], split) -> Readings:
    """The whole model's readings from each rank's readings of its own
    slices, by rank: the norm of a leaf named in ``split`` is that of its
    slices together; every other leaf, replicated, and the losses (the
    global batch's on every rank) are read on the first rank."""

    def together(norms: list[dict[str, float]]) -> dict[str, float]:
        return {n: math.sqrt(sum(r[n] ** 2 for r in norms)) if n in split else v
                for n, v in norms[0].items()}

    return Readings(ranks[0].losses, together([r.grad_norms for r in ranks]),
                    together([r.change_norms for r in ranks]))


def reference_readings(family, sz, seed: int, batches, optimizer: dict, device,
                       precision: str = "stated", devices=None) -> Readings:
    """The same readings of the family's plain reference, from the same
    seed's weights, on the same batches; over ``devices`` (the family's
    ``place``) where given, on ``device`` alone otherwise. The weights are
    drawn on ``device``."""
    devices = devices or [device]
    losses, grads, params = [], None, None
    weights = family.place(sz, family.initial_weights(sz, seed, device), devices)
    # Over several devices the step-0 weights are kept as placed: drawn again
    # on the first device once it holds its share of the state, they would
    # need one block of the whole weights' size there.
    kept = {n: w.clone() for n, w in weights.items()} if len(devices) > 1 else None
    steps = family.reference_steps(sz, weights, batches, optimizer, precision)
    for i, (loss, g, params) in enumerate(steps):
        losses.append(loss.to(device))
        if i == 0:
            grads = _norms(g)
    changes = _changes(params, kept or family.initial_weights(sz, seed, device))
    return Readings(torch.stack(losses).tolist(), grads, changes)


def leaf_gaps(side: dict[str, float], ref: dict[str, float], leaves) -> dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median of ``ref``'s leaves."""
    med = statistics.median(ref.values())
    return {n: abs(side[n] - ref[n]) / max(ref[n], med) for n in leaves}


def gaps(side: Readings, ref: Readings, head=()) -> dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of one side against
    the reference, and ``head_grad_gap`` where ``head`` names leaves; NaN
    where the side read something not finite."""
    med = statistics.median(ref.grad_norms.values())
    moving = {n for n, g in ref.grad_norms.items() if g >= STILL_LEAF * med}
    changes = {n: c for n, c in ref.change_norms.items() if n in moving}
    out = {
        "loss_gap": max(abs(a - b) for a, b in zip(side.losses, ref.losses, strict=True)),
        "grad_gap": max(leaf_gaps(side.grad_norms, ref.grad_norms, ref.grad_norms).values()),
        "change_gap": max(leaf_gaps(side.change_norms, changes, changes).values()),
    }
    if head:
        out["head_grad_gap"] = max(leaf_gaps(side.grad_norms, ref.grad_norms, head).values())
    return {k: v if math.isfinite(v) else math.nan for k, v in out.items()}


def checks(found: dict[str, float], limits: dict[str, float]) -> dict[str, dict]:
    """Each compared number beside its limit; ``ok`` false where it is
    over the limit or not finite."""
    return {name: {"value": found[name], "limit": limit, "ok": found[name] <= limit}
            for name, limit in limits.items()}
