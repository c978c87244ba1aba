"""Single-device training step for the smoke workload: the counterpart of
the JAX package's ``workload/train.py`` (full-logits or chunked-vocab
loss, AdamW).

Sharding over a mesh is not carried by this port yet (ROADMAP.md, Queue 1:
'Mesh + fsdp/tp sharding').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import chunked_softmax_xent
from .model import ModelConfig, TransformerLM, init_model

# optax.adamw(lr)'s defaults, which the JAX step uses (train.py:104):
# decay 1e-4 on every parameter. torch's AdamW defaults to decay 1e-2, so
# every value is set explicitly.
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def loss_fn(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy; the last position predicts nothing.

    With ``cfg.xent_chunk`` > 0 the model returns its final hidden states
    and the tied unembedding folds into the chunked-vocab CE
    (``ops/xent.py``): the (rows, vocab) logits are never materialised."""
    out = model(tokens)[:, :-1]
    targets = tokens[:, 1:]
    if model.cfg.xent_chunk > 0:
        return chunked_softmax_xent(out, model.embed, targets, model.cfg.xent_chunk)
    logp = F.log_softmax(out, dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    return -ll.mean()


def make_optimizer(model: TransformerLM, lr: float = 1e-3) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW)


def make_train_state(
    cfg: ModelConfig, device, seed: int = 0, lr: float = 1e-3
) -> tuple[TransformerLM, torch.optim.AdamW]:
    """A model with random weights from ``seed`` on ``device`` and its
    optimizer."""
    model = init_model(cfg, seed, device)
    return model, make_optimizer(model, lr)


def train_step(
    model: TransformerLM, optimizer: torch.optim.Optimizer, tokens: torch.Tensor
) -> torch.Tensor:
    """One optimizer step; returns the (detached) loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens)
    loss.backward()
    optimizer.step()
    return loss.detach()
