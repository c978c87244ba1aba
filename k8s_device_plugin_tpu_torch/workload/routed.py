"""DeepSeek-V3's routed MoE layer (DeepSeek-V3, arXiv:2412.19437, section
2.1.2), beside the JAX-mirroring ``workload/moe.py``, with no counterpart
in the JAX package:

    s = sigmoid(x_f32 W_r)                  over all n_routed_experts
    chosen = top-k of s + b                 b: the routing bias, a buffer
    g_i = scaling * s_i / sum_{chosen} s    for i chosen
    y = sum_{i held and chosen} g_i SwiGLU_i(x) + SwiGLU_shared(x)

This device holds the experts ``held_experts`` (first, count) of the
layer, and computes their part of the result alone: the share that an
expert-parallel deployment gives one rank, with no exchange (on one card
there is none to make). The router scores every expert; the shared
SwiGLU (``n_shared_experts`` experts as one) is computed whole.

The dispatch is dropless and index-based: the (token, slot) pairs routed
to the held experts are sorted by expert (a stable sort of the slots'
expert keys, the others keyed past the last), their rows gathered, the
experts' three products run grouped over the sorted rows
(``torch._grouped_mm`` on device-side offsets on the card, a loop over
the experts on the CPU), and the weighted rows added back onto their
tokens. No capacity: nothing is dropped, however skewed the router. The
number of held rows reaches the host once a layer's forward (one sync),
so that every tensor has its exact size.

The layer returns, beside y, the sequence-wise balance term
``sum_i f_i P_i`` (eqs. 17-20: f_i the share of a sequence's k choices
that went to expert i, times n_experts / k; P_i the mean of the
normalised scores s_i / sum_j s_j over the sequence; averaged over the
batch's sequences), which ``train.loss_fn`` weighs by the config's
``moe_aux_weight`` (alpha). The forward keeps the step's choice counts of
every expert, and ``update_bias`` (``train.train_step``, after the
optimizer step) moves the bias by the auxiliary-loss-free rule,
``b_i += gamma * sign(mean - count_i)``.

Spans (``utils/tracing``, service ``workload``): ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine`` inside the forward,
and ``moe.backward`` from the moment the layer's output gets its gradient
to the moment its input has one. Counters (``COUNTERS``): the rows routed
to each held expert, every expert's choices, and the held experts' most
rows over their mean a layer-step (those where they got any row), summed
on the device and read at a window's ends. Each is one bool check while
off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing


class Counters:
    """The routed layers' tallies over every forward while ``on``, kept on
    the device: rows routed to each held expert (by its index among the
    held), choices of each expert, and, over the layer-steps whose held
    experts got any row, the count and the sum of their most rows over
    their mean; ``layer_steps`` (all of them) on the host. ``read()``
    synchronises, so a caller reads at a window's ends."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self) -> None:
        self.rows = None
        self.choices = None
        self.max_over_mean = None
        self.routed_layer_steps = None
        self.layer_steps = 0

    def add(self, rows: torch.Tensor, choices: torch.Tensor) -> None:
        if self.rows is None:
            self.rows = torch.zeros_like(rows)
            self.choices = torch.zeros_like(choices)
            self.max_over_mean = torch.zeros((), dtype=torch.float32, device=rows.device)
            self.routed_layer_steps = torch.zeros((), dtype=torch.int64, device=rows.device)
        self.rows += rows
        self.choices += choices
        mean = rows.float().mean()
        self.max_over_mean += torch.where(mean > 0, rows.max() / mean.clamp_min(1e-30), 0.0)
        self.routed_layer_steps += (mean > 0).long()
        self.layer_steps += 1

    def read(self) -> dict[str, float]:
        """``moe.layer_steps``, ``moe.routed_layer_steps`` (those with held
        rows), ``moe.rows_max_over_mean`` (the sum over them) and
        ``moe.rows.<i>``, ``moe.choices.<e>`` as floats."""
        out = {"moe.layer_steps": float(self.layer_steps)}
        if self.rows is None:
            return out
        out["moe.routed_layer_steps"] = float(self.routed_layer_steps)
        out["moe.rows_max_over_mean"] = float(self.max_over_mean)
        out.update({f"moe.rows.{i}": float(n) for i, n in enumerate(self.rows.tolist())})
        out.update({f"moe.choices.{e}": float(n) for e, n in enumerate(self.choices.tolist())})
        return out


COUNTERS = Counters()


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (rows, k) times ``w[g]`` (groups, k, n), group g taking
    the rows from ``offsets[g - 1]`` (0 for the first) to ``offsets[g]``
    (int32 ends, the last = rows): ``torch._grouped_mm`` on the card, a loop
    over the groups on the CPU."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=offsets)
    ends = offsets.tolist()
    parts = [x[a:b] @ w[g] for g, (a, b) in enumerate(zip([0] + ends[:-1], ends))]
    return torch.cat(parts)


def _backward_span(x: torch.Tensor, y: torch.Tensor) -> None:
    """Record ``moe.backward`` from y's gradient to x's: the layer's
    backward, on whichever thread autograd runs it."""
    held = []

    def opened(grad):
        scope = tracing.span("moe.backward", service="workload")
        scope.__enter__()
        held.append(scope)
        return grad

    def closed(grad):
        if held:
            held.pop().__exit__(None, None, None)
        return grad

    y.register_hook(opened)
    x.register_hook(closed)


class RoutedMoe(nn.Module):
    """The routed layer of a ``DeepSeekV3Config``: parameters ``router``
    (d_model, n_routed_experts) f32, the held experts' ``w_gate``, ``w_up``
    (held, d_model, expert_d_ff) and ``w_down`` (held, expert_d_ff,
    d_model), the ``shared`` SwiGLU (width n_shared_experts x expert_d_ff),
    and the buffer ``router_bias`` (n_routed_experts,), zero at the start.
    ``forward(x)`` returns ``(y, aux)``."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        from .model import SwiGlu, _xavier_uniform

        d, e, ff = cfg.d_model, cfg.n_routed_experts, cfg.expert_d_ff
        self.n_experts, self.top_k = e, cfg.moe_top_k
        self.first, self.n_held = cfg.held_experts
        self.scaling = cfg.routed_scaling_factor
        self.bias_step = cfg.bias_update_speed
        self.dtype = cfg.dtype
        self.router = nn.Parameter(_xavier_uniform((d, e), generator, device))
        self.w_gate = nn.Parameter(_xavier_uniform((self.n_held, d, ff), generator, device))
        self.w_up = nn.Parameter(_xavier_uniform((self.n_held, d, ff), generator, device))
        self.w_down = nn.Parameter(_xavier_uniform((self.n_held, ff, d), generator, device))
        self.shared = SwiGlu(d, cfg.n_shared_experts * ff, cfg.dtype, generator, device)
        self.register_buffer("router_bias", torch.zeros(e, dtype=torch.float32, device=device))
        # The last forward's choices of each expert (float, n_experts), for
        # update_bias.
        self.choice_counts: torch.Tensor | None = None

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scores, chosen, gates) of x (tokens, d_model): the sigmoid scores
        (tokens, n_experts) f32, the top-k experts of scores + bias (tokens,
        k) and their weights."""
        scores = torch.sigmoid(x.float() @ self.router)
        chosen = torch.topk(scores + self.router_bias, self.top_k, dim=-1).indices
        picked = scores.gather(1, chosen)
        gates = self.scaling * picked / (picked.sum(-1, keepdim=True) + 1e-20)
        return scores, chosen, gates

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        e, k, dt = self.n_experts, self.top_k, self.dtype
        tokens = b * s
        with tracing.span("moe.route", service="workload"):
            scores, chosen, gates = self.route(x.reshape(tokens, d))
            onehot = torch.zeros(tokens, e, device=x.device).scatter_(1, chosen, 1.0)
            counts = onehot.sum(0)
            f = onehot.view(b, s, e).mean(1) * (e / k)
            p = (scores / scores.sum(-1, keepdim=True)).view(b, s, e).mean(1)
            aux = (f * p).sum(-1).mean()
            self.choice_counts = counts

        with tracing.span("moe.dispatch", service="workload"):
            local = chosen - self.first
            held = (local >= 0) & (local < self.n_held)
            key = torch.where(held, local, self.n_held).flatten()
            # Counted by a scatter: bincount reads its input's maximum on the host.
            rows_by_expert = torch.zeros(self.n_held + 1, dtype=torch.long, device=x.device)
            rows_by_expert = rows_by_expert.scatter_add_(0, key, torch.ones_like(key))
            rows_by_expert = rows_by_expert[: self.n_held]
            if COUNTERS.on:
                COUNTERS.add(rows_by_expert, counts)
            order = torch.argsort(key, stable=True)
            n_rows = int(rows_by_expert.sum())  # the layer's one sync
            pairs = order[:n_rows]
            token_of = pairs // k
            xc = x.to(dt).reshape(tokens, d)
            xs = xc[token_of]
            weight = gates.flatten()[pairs]
            offsets = rows_by_expert.cumsum(0).to(torch.int32)

        with tracing.span("moe.experts", service="workload"):
            if n_rows:
                h = F.silu(grouped_mm(xs, self.w_gate.to(dt), offsets))
                h = h * grouped_mm(xs, self.w_up.to(dt), offsets)
                ys = grouped_mm(h, self.w_down.to(dt), offsets)
            shared = self.shared(xc)

        with tracing.span("moe.combine", service="workload"):
            routed = torch.zeros(tokens, d, dtype=torch.float32, device=x.device)
            if n_rows:
                routed = routed.index_add(0, token_of, ys.float() * weight[:, None])
            y = (routed + shared.float()).to(dt).view(b, s, d)
        if tracing.enabled() and x.requires_grad:
            _backward_span(x, y)
        return y, aux

    @torch.no_grad()
    def update_bias(self) -> None:
        """The auxiliary-loss-free balance step: each expert's bias up by
        ``bias_update_speed`` where the last forward chose it less often
        than the mean, down where more often."""
        counts = self.choice_counts
        if counts is None:
            return
        self.router_bias += self.bias_step * torch.sign(counts.mean() - counts)
