"""Mixture-of-Experts MLP: the counterpart of the JAX package's
``workload/moe.py``.

Top-k routing with capacity-based dense dispatch: the token-to-expert
assignment is a pair of one-hot tensors (dispatch and combine), and the
layer is four einsums with static shapes, batched over the experts. The
values are the JAX module's: routing in f32, ``top_k`` renormalised, the
position in an expert a cumsum over the (token, k-slot) order with k
varying fastest, capacity ``max(1, int(cf * s * k / e))`` a batch row, the
expert products in the compute dtype, GELU in its tanh form, and the
Switch load-balance loss ``e * sum(frac_tokens * frac_probs)`` over the
batch. flax ``sow``s that loss; here ``forward`` returns it beside y.

Expert parallelism (``train.apply_ep``): the tokens are replicated over
the ``expert`` axis (the batch splits over data and fsdp only), so no
all-to-all is needed. Each rank keeps its experts' slices of ``w1`` and
``w2``, runs the dispatch, expert and combine einsums for those experts
only, between ``enter_split`` and ``leave_split`` over the expert group
(and, under tensor parallelism, the model group), and the sum over the
groups completes y. The router and the aux loss stay outside, replicated.
Where the batch is split over (data, fsdp), both fractions of the aux
loss are averaged over those ranks before their product, as GSPMD takes
JAX's means over the global batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import enter_split, leave_split, sum_over_ranks


class MoeMlp(nn.Module):
    """Top-k routed expert MLP (the dense ``Mlp``'s drop-in); ``forward``
    returns ``(y, aux)``. Parameters in the JAX shapes and initialisers:
    ``wg`` (d_model, n_experts), ``w1`` (n_experts, d_model, d_ff), ``w2``
    (n_experts, d_ff, d_model), all xavier-uniform in f32."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, top_k: int = 2,
                 capacity_factor: float = 2.0, dtype: torch.dtype = torch.bfloat16,
                 generator=None, device=None):
        super().__init__()
        from .model import _xavier_uniform

        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.wg = nn.Parameter(_xavier_uniform((d_model, n_experts), generator, device))
        self.w1 = nn.Parameter(_xavier_uniform((n_experts, d_model, d_ff), generator, device))
        self.w2 = nn.Parameter(_xavier_uniform((n_experts, d_ff, d_model), generator, device))
        # Set by train.shard_model: the groups the expert computation is
        # split over (expert, then model), this rank's experts, and the
        # groups of the ranks that hold other rows of the batch.
        self.split_groups: tuple = ()
        self.experts = slice(0, n_experts)
        self.batch_groups: tuple = ()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        e, k = self.n_experts, self.top_k
        capacity = max(1, int(self.capacity_factor * s * k / e))

        # Routing in f32 (router logits are precision-sensitive).
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), self.wg), dim=-1)
        topk_probs, topk_idx = torch.topk(probs, k, dim=-1)  # [b,s,k]
        topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True)

        # Position in expert: a cumsum over the (token, k-slot) order.
        flat = F.one_hot(topk_idx, e).float().reshape(b, s * k, e)
        pos = (flat.cumsum(1) - flat).long()
        keep = flat * (pos < capacity)
        # The JAX one_hot(pos, capacity) * keep: a position past the
        # capacity has keep 0, so clamping it changes nothing.
        pos_onehot = torch.zeros(b, s * k, e, capacity, device=x.device).scatter_(
            -1, pos.clamp(max=capacity - 1)[..., None], keep[..., None])
        slots = pos_onehot.view(b, s, k, e, capacity)
        dispatch = slots.sum(2)  # [b,s,e,cap], 0 or 1
        combine = torch.einsum("bsk,bskec->bsec", topk_probs, slots)

        cdt = self.dtype
        xc, comb = x.to(cdt), combine.to(cdt)
        for group in self.split_groups:
            xc, comb = enter_split(xc, group), enter_split(comb, group)
        xe = torch.einsum("bsec,bsd->ebcd", dispatch[:, :, self.experts].to(cdt), xc)
        h = F.gelu(torch.einsum("ebcd,edf->ebcf", xe, self.w1.to(cdt)), approximate="tanh")
        ye = torch.einsum("ebcf,efd->ebcd", h, self.w2.to(cdt))
        y = torch.einsum("bsec,ebcd->bsd", comb[:, :, self.experts], ye)
        for group in reversed(self.split_groups):
            y = leave_split(y, group)

        # Switch load-balance loss: e * sum_e (token fraction)(prob mass).
        frac_tokens = F.one_hot(topk_idx[..., 0], e).float().mean((0, 1))
        frac_probs = probs.mean((0, 1))
        if self.batch_groups:
            shards = 1
            for group in self.batch_groups:
                frac_tokens = sum_over_ranks(frac_tokens, group)
                frac_probs = sum_over_ranks(frac_probs, group)
                shards *= dist.get_world_size(group)
            frac_tokens, frac_probs = frac_tokens / shards, frac_probs / shards
        aux = e * (frac_tokens * frac_probs).sum()
        return y, aux
