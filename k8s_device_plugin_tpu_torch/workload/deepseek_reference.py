"""The plain reference of the DeepSeek-V3 model that ``DeepSeekV3Config``
builds (``workload/model.py``, ``workload/routed.py``): its forward, loss,
gradients, AdamW steps and routing-bias updates in plain f32 ``torch``,
with TF32 off for cuBLAS and cuDNN. It imports nothing of the port, no
kernel and nothing of JAX; the tests hold the port to it on seeded weights.

    x = E[tokens]
    per layer:  h = x + MLA(RMSNorm1(x));  x = h + FFN(RMSNorm2(h))
    MLA(h): q = h Wq, split (nope, rope); [c, k_r] = h Wdkv;
            [k_nope, v] = RMSNorm(c) Wukv; RoPE on q_rope and k_r (k_r one
            for every head; the pairs (2i, 2i+1) gathered into halves, then
            rotate-half, theta^(-2i/rope)); softmax(causal(q.k) /
            sqrt(nope + rope)) v, then Wo
    FFN: the leading dense layers' SwiGLU, W_down(silu(x W_gate) * x W_up);
         the others' routed layer: s = sigmoid(x W_r) over every expert,
         the top k of s + b chosen, g = scaling * s / sum over the chosen,
         y = sum over the held and chosen of g_i SwiGLU_i(x) + the shared
         SwiGLU(x); the balance term sum_i f_i P_i per sequence, averaged
         (DeepSeek-V3 eqs. 17-20)
    logits = RMSNorm(x) H^T (untied head); loss = mean next-token
    cross-entropy + alpha * sum over the routed layers of their terms
    after each AdamW step, b_i += gamma * sign(mean - count_i) with the
    step's choice counts of every expert

It holds the same share of experts (``Shape.held_first``, ``n_held``) and
of the vocabulary as the program, and takes its own routing decisions.
For the card, ``block`` computes attention a block of query rows at a
time and ``recompute`` recomputes each layer (and each block) in the
backward, so that a step at 8,192 positions fits once the program is
freed. ``mm`` and ``head_mm`` compute the blocks' and the f32 head's (and
router's) products: plain ``@`` here; a benchmark's lower-precision
control passes its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class Shape:
    vocab: int
    d_model: int
    heads: int
    layers: int
    d_ff: int
    seq: int
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_head: int
    rope_theta: float
    norm_eps: float
    first_dense: int
    n_experts: int
    held_first: int
    n_held: int
    expert_d_ff: int
    top_k: int
    n_shared: int
    scaling: float
    alpha: float
    gamma: float

    @staticmethod
    def of(cfg) -> "Shape":
        """The shape of a ``DeepSeekV3Config`` (read by attribute)."""
        return Shape(
            vocab=cfg.vocab_size, d_model=cfg.d_model, heads=cfg.n_heads, layers=cfg.n_layers,
            d_ff=cfg.d_ff, seq=cfg.max_seq_len, kv_lora_rank=cfg.kv_lora_rank,
            qk_nope=cfg.qk_nope_head_dim, qk_rope=cfg.qk_rope_head_dim, v_head=cfg.v_head_dim,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, first_dense=cfg.first_dense,
            n_experts=cfg.n_routed_experts, held_first=cfg.held_experts[0],
            n_held=cfg.held_experts[1], expert_d_ff=cfg.expert_d_ff, top_k=cfg.moe_top_k,
            n_shared=cfg.n_shared_experts, scaling=cfg.routed_scaling_factor,
            alpha=cfg.moe_aux_weight, gamma=cfg.bias_update_speed)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """RoPE on x (b, s, h, d): DeepSeek-V3's permute, then rotate-half."""
    b, s, h, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    freqs = torch.outer(torch.arange(s, device=x.device, dtype=torch.float32), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    x = x.reshape(b, s, h, d // 2, 2).transpose(-1, -2).reshape(b, s, h, d)
    rot = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * emb.cos()[None, :, None] + rot * emb.sin()[None, :, None]


def _attend(q, k, v, start, mm):
    """Causal attention of the query rows start.. (q: b, h, rows, d_qk)
    over the keys up to the block's last row."""
    end = start + q.shape[2]
    scores = mm(q, k[:, :, :end].transpose(-1, -2)) / math.sqrt(q.shape[-1])
    rows = torch.arange(start, end, device=q.device)[:, None]
    cols = torch.arange(end, device=q.device)[None]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v[:, :, :end])


def _attention(q, k, v, block, recompute, mm):
    s = q.shape[2]
    if block is None or block >= s:
        return _attend(q, k, v, 0, mm)
    outs = []
    for start in range(0, s, block):
        qb = q[:, :, start:start + block]
        if recompute:
            outs.append(checkpoint(_attend, qb, k, v, start, mm, use_reentrant=False))
        else:
            outs.append(_attend(qb, k, v, start, mm))
    return torch.cat(outs, dim=2)


def _mla(h, p, pre, sh: Shape, block, recompute, mm):
    b, s, d = h.shape
    nope, rope, heads = sh.qk_nope, sh.qk_rope, sh.heads
    q = mm(h, p[pre + "wq"].reshape(d, -1)).view(b, s, heads, nope + rope)
    c, k_r = mm(h, p[pre + "wdkv"]).split([sh.kv_lora_rank, rope], dim=-1)
    c = _rms(c, p[pre + "kv_norm.scale"], sh.norm_eps)
    kv = mm(c, p[pre + "wukv"].reshape(sh.kv_lora_rank, -1)).view(b, s, heads, nope + sh.v_head)
    k_nope, v = kv.split([nope, sh.v_head], dim=-1)
    q = torch.cat((q[..., :nope], _rope(q[..., nope:], sh.rope_theta)), dim=-1)
    k_r = _rope(k_r[:, :, None], sh.rope_theta).expand(b, s, heads, rope)
    k = torch.cat((k_nope, k_r), dim=-1)
    o = _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), block, recompute, mm)
    o = o.transpose(1, 2).reshape(b, s, heads * sh.v_head)
    return mm(o, p[pre + "wo"].reshape(heads * sh.v_head, d))


def _swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def _routed(x, p, pre, bias, sh: Shape, mm, head_mm):
    """(y, the balance term, the choices (tokens, k), each expert's choice
    count) of the routed layer on x (b, s, d)."""
    b, s, d = x.shape
    e, k = sh.n_experts, sh.top_k
    xf = x.reshape(b * s, d)
    scores = torch.sigmoid(head_mm(xf, p[pre + "router"]))
    chosen = torch.topk(scores + bias, k, dim=-1).indices
    picked = scores.gather(1, chosen)
    gates = sh.scaling * picked / (picked.sum(-1, keepdim=True) + 1e-20)
    onehot = torch.zeros(b * s, e, device=x.device).scatter_(1, chosen, 1.0)
    f = onehot.view(b, s, e).mean(1) * (e / k)
    share = (scores / scores.sum(-1, keepdim=True)).view(b, s, e).mean(1)
    aux = (f * share).sum(-1).mean()
    y = _swiglu(xf, p[pre + "shared.w_gate"], p[pre + "shared.w_up"],
                p[pre + "shared.w_down"], mm)
    for j in range(sh.n_held):
        tok, slot = (chosen == sh.held_first + j).nonzero(as_tuple=True)
        if tok.numel():
            out = _swiglu(xf[tok], p[pre + "w_gate"][j], p[pre + "w_up"][j],
                          p[pre + "w_down"][j], mm)
            y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    return y.view(b, s, d), aux, chosen, onehot.sum(0)


def _layer(x, p, biases, i, sh: Shape, block, recompute, mm, head_mm):
    pre = f"blocks.{i}."
    h = x + _mla(_rms(x, p[pre + "norm1.scale"], sh.norm_eps), p, pre + "attn.", sh, block,
                 recompute, mm)
    hn = _rms(h, p[pre + "norm2.scale"], sh.norm_eps)
    if i < sh.first_dense:
        out = _swiglu(hn, p[pre + "mlp.w_gate"], p[pre + "mlp.w_up"], p[pre + "mlp.w_down"], mm)
        return h + out, None, None, None
    y, aux, chosen, counts = _routed(hn, p, pre + "moe.", biases[i], sh, mm, head_mm)
    return h + y, aux, chosen, counts


def forward(p: dict, biases: dict, tokens: torch.Tensor, sh: Shape, block=None,
            recompute: bool = False, mm=matmul, head_mm=matmul):
    """(the final norm's output, the routed layers' balance terms summed,
    each routed layer's choices and choice counts by layer index) of
    ``tokens`` (batch, seq) under the parameters ``p`` (f32, by the
    program's names) and routing biases ``biases`` (by layer index)."""
    x = p["embed"][tokens]
    aux, choices, counts = None, {}, {}
    for i in range(sh.layers):
        run = functools.partial(_layer, p=p, biases=biases, i=i, sh=sh, block=block,
                                recompute=recompute, mm=mm, head_mm=head_mm)
        x, a, ch, ct = checkpoint(run, x, use_reentrant=False) if recompute else run(x)
        if a is not None:
            aux = a if aux is None else aux + a
            choices[i], counts[i] = ch, ct
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return _rms(x, p["norm.scale"], sh.norm_eps), aux, choices, counts


def loss(p: dict, biases: dict, tokens: torch.Tensor, sh: Shape, block=None,
         recompute: bool = False, mm=matmul, head_mm=matmul):
    """(mean next-token cross-entropy + alpha * the balance terms, the
    routed layers' choices, their choice counts)."""
    h, aux, choices, counts = forward(p, biases, tokens, sh, block, recompute, mm, head_mm)
    logits = head_mm(h[:, :-1].reshape(-1, sh.d_model), p["head"].T)
    ce = F.cross_entropy(logits, tokens[:, 1:].reshape(-1))
    return ce + sh.alpha * aux, choices, counts


@contextlib.contextmanager
def no_tf32(on: bool = False):
    """TF32 ``on`` (off by default) for cuBLAS and cuDNN while the block
    runs."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def reference_steps(sh: Shape, params: dict, biases: dict, batches, optimizer: dict,
                    block=None, recompute: bool = False, mm=matmul, head_mm=matmul):
    """Train ``params`` (f32, taken over and updated in place) and
    ``biases`` (likewise) for one AdamW step on each of ``batches``, then
    the routing biases' update. Yields after each step its loss, the
    gradient by leaf, the parameters, and the routed layers' choices."""
    lr, eps, wd = optimizer["lr"], optimizer["eps"], optimizer["weight_decay"]
    b1, b2 = optimizer["betas"]
    params = {n: w.requires_grad_() for n, w in params.items()}
    m = {n: torch.zeros_like(w) for n, w in params.items()}
    v = {n: torch.zeros_like(w) for n, w in params.items()}
    # Each leaf's own step count: a leaf left without a gradient (a routed
    # layer whose held experts no token chose) is skipped, as torch's AdamW
    # skips it, decay included.
    taken = dict.fromkeys(params, 0)
    with no_tf32():
        for t, tokens in enumerate(batches, 1):
            for w in params.values():
                w.grad = None
            value, choices, counts = loss(params, biases, tokens, sh, block, recompute, mm,
                                          head_mm)
            value.backward()
            with torch.no_grad():
                for n, w in params.items():
                    g = w.grad
                    if g is None:
                        continue
                    taken[n] += 1
                    k = taken[n]
                    w.mul_(1 - lr * wd)
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** k)).add_(eps)
                    w.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** k))
                for i, c in counts.items():
                    biases[i] += sh.gamma * torch.sign(c.mean() - c)
            yield value.detach(), {n: w.grad for n, w in params.items()}, params, choices
