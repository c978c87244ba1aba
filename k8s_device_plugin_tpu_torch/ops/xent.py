"""Chunked-vocabulary softmax cross-entropy over a tied-embedding LM head:
the counterpart of the JAX package's ``ops/xent.py``.

The full-logits loss materialises ``(rows, vocab)`` f32 logits. This one
computes the same loss with the vocabulary taken ``chunk`` rows of the
embedding at a time: each chunk's logits are folded into an online
logsumexp (running max and sum, as flash attention does along its kv
axis), the target logit is captured where it falls in the chunk, and the
chunk is dropped before the next. The backward recomputes each chunk's
logits from the saved per-row logsumexp. Nothing vocabulary-sized is kept
but the embedding and its gradient.

Products and sums run in f32, as the JAX scan does. It holds no TPU kernel
(the JAX version is ``lax.scan`` over matmuls), so the port runs it as
PyTorch matmuls and elementwise ops on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _flatten(hidden: torch.Tensor, targets: torch.Tensor):
    return hidden.reshape(-1, hidden.shape[-1]).float(), targets.reshape(-1).long()


def _embed3(embed: torch.Tensor, chunk: int) -> torch.Tensor:
    vocab, d = embed.shape
    if vocab % chunk != 0:
        raise ValueError(f"vocab {vocab} not a multiple of chunk {chunk}")
    return embed.float().reshape(vocab // chunk, chunk, d)


def _xent_fwd_core(h2, t1, e3, chunk):
    """(mean NLL, per-row logsumexp) by the chunked online logsumexp."""
    rows = h2.shape[0]
    m = torch.full((rows,), float("-inf"), device=h2.device)
    s = torch.zeros(rows, device=h2.device)
    tl = torch.zeros(rows, device=h2.device)
    for idx in range(e3.shape[0]):
        logits = h2 @ e3[idx].T  # (rows, chunk) f32, dropped after this step
        nm = torch.maximum(m, logits.amax(1))
        s = s * torch.exp(m - nm) + torch.exp(logits - nm[:, None]).sum(1)
        m = nm
        base = idx * chunk
        local = (t1 - base).clamp(0, chunk - 1)
        t_logit = logits.gather(1, local[:, None])[:, 0]
        in_chunk = (t1 >= base) & (t1 < base + chunk)
        tl = torch.where(in_chunk, t_logit, tl)
    lse = m + torch.log(s)
    return (lse - tl).mean(), lse


class ChunkedSoftmaxXent(torch.autograd.Function):
    """The chunked loss with its chunked recompute backward, the
    counterpart of the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, hidden, embed, targets, chunk):
        h2, t1 = _flatten(hidden, targets)
        loss, lse = _xent_fwd_core(h2, t1, _embed3(embed, chunk), chunk)
        ctx.save_for_backward(hidden, embed, targets, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, embed, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        h2, t1 = _flatten(hidden, targets)
        e3 = _embed3(embed, chunk)
        rows = h2.shape[0]
        scale = g / rows  # d(mean) / d(per-row NLL)
        dh = torch.zeros_like(h2)
        demb = torch.empty_like(e3)
        for idx in range(e3.shape[0]):
            emb_c = e3[idx]
            # p - onehot(target), built in place: subtracting 0 leaves p as
            # it is, so this equals the JAX one_hot form without its
            # (rows, chunk) one-hot tensor.
            dlogits = torch.exp(h2 @ emb_c.T - lse[:, None])
            local = t1 - idx * chunk
            in_chunk = (local >= 0) & (local < chunk)
            dlogits.scatter_add_(1, local.clamp(0, chunk - 1)[:, None],
                                 -in_chunk.float()[:, None])
            dlogits = dlogits * scale
            dh = dh + dlogits @ emb_c
            demb[idx] = dlogits.T @ h2
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                demb.reshape(embed.shape).to(embed.dtype), None, None)


def chunked_softmax_xent(hidden: torch.Tensor, embed: torch.Tensor,
                         targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean next-token NLL ``mean(logsumexp(h E^T) - (h E^T)[target])``.

    hidden: (..., d) activations of any leading shape; embed: (vocab, d)
    tied embedding; targets: integer labels with hidden's leading shape.
    ``vocab`` must be a multiple of ``chunk``."""
    return ChunkedSoftmaxXent.apply(hidden, embed, targets, chunk)


def reference_softmax_xent(hidden: torch.Tensor, embed: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """The full-logits formulation (the correctness oracle and the
    microbench's baseline): logits, log_softmax, gather."""
    logits = torch.einsum("...d,vd->...v", hidden.float(), embed.float())
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()
