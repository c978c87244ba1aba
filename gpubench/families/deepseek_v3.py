"""DeepSeek-V3's architecture (HF ``modeling_deepseek_v3`` with
``q_lora_rank`` null: multi-head latent attention, SwiGLU, sigmoid-routed
experts with a bias-corrected top-k and shared experts, an untied head),
for configurations written with the source's ``config.json`` keys: the
sizes, the weights made from a seed, the analytic FLOPs, the MLA flash
kernels' shape, the port's model built to these sizes
(``k8s_device_plugin_tpu_torch``'s ``DeepSeekV3Config``) and the plain
reference of one training step.

A configuration holds one card's share of a deployment (its ``deployment``
and ``published`` keys say which): ``n_routed_experts`` counts the experts
this card holds (from ``held_first``), ``published.n_routed_experts`` the
experts the router scores; ``vocab_size`` is the card's slice of the
vocabulary, which the traffic draws from and the logits and loss run
over; ``num_hidden_layers`` the layers of its pipeline stage, the
embedding and the head both held. ``seq_aux_alpha`` weighs the
sequence-wise balance loss and ``bias_update_speed`` moves the routing
bias (DeepSeek-V3 section 2.1.2), both assumed.

Everything below the program's own model builder is a frozen copy of the
port's ``workload/deepseek_reference.py`` and imports nothing of the
program: the forward, the loss with its balance term, the gradients, AdamW
and the routing bias's update, in f32 with TF32 off, attention a block of
``QUERY_BLOCK`` query rows at a time and each layer (and block)
recomputed in the backward, so that a step at 8,192 positions fits on the
card once the program is freed. It holds the same experts and vocabulary
as the program and takes its own routing decisions.

``precision="control"`` computes it one step lower: the blocks' products'
operands rounded to fp8 (e4m3 forward, e5m2 for the gradients, each
scaled by its tensor's largest magnitude), attention's included, and the
f32 products (the head and the router) in TF32. ``precision="head_tf32"``
lowers those f32 products alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("stated", "control", "head_tf32")
# The head's leaves (its f32 products, and the final norm before them),
# for ``correct``'s ``head_grad_gap``.
HEAD_LEAVES = ("head", "norm.scale")
INIT_STD = 0.02  # the source's initializer_range
# Query rows a block of the reference's attention.
QUERY_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class Sizes:
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

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope


def sizes(config: dict) -> Sizes:
    """The sizes of a configuration file written with DeepSeek-V3's keys."""
    return Sizes(
        vocab=config["vocab_size"], d_model=config["hidden_size"],
        heads=config["num_attention_heads"], layers=config["num_hidden_layers"],
        d_ff=config["intermediate_size"], seq=config["max_position_embeddings"],
        kv_lora_rank=config["kv_lora_rank"], qk_nope=config["qk_nope_head_dim"],
        qk_rope=config["qk_rope_head_dim"], v_head=config["v_head_dim"],
        rope_theta=float(config["rope_theta"]), norm_eps=config["rms_norm_eps"],
        first_dense=config["first_k_dense_replace"],
        n_experts=config["published"]["n_routed_experts"], held_first=config["held_first"],
        n_held=config["n_routed_experts"], expert_d_ff=config["moe_intermediate_size"],
        top_k=config["num_experts_per_tok"], n_shared=config["n_shared_experts"],
        scaling=config["routed_scaling_factor"], alpha=config["seq_aux_alpha"],
        gamma=config["bias_update_speed"])


def leaves(sz: Sizes) -> list[tuple[str, tuple[int, ...], float | None]]:
    """(name, shape, init std; None: ones) of every parameter, in the
    program's names and layouts: N(0, 0.02), the projections into the
    residual stream (attention's wo, every SwiGLU's w_down) scaled by
    1/sqrt(2 x layers), as GPT-2's; norm scales 1."""
    d, h = sz.d_model, sz.heads
    resid = INIT_STD / math.sqrt(2 * sz.layers)
    out = [("embed", (sz.vocab, d), INIT_STD), ("head", (sz.vocab, d), INIT_STD)]
    for i in range(sz.layers):
        b = f"blocks.{i}."
        out += [
            (b + "norm1.scale", (d,), None),
            (b + "attn.wq", (d, h, sz.qk_head), INIT_STD),
            (b + "attn.wdkv", (d, sz.kv_lora_rank + sz.qk_rope), INIT_STD),
            (b + "attn.wukv", (sz.kv_lora_rank, h, sz.qk_nope + sz.v_head), INIT_STD),
            (b + "attn.wo", (h, sz.v_head, d), resid),
            (b + "attn.kv_norm.scale", (sz.kv_lora_rank,), None),
            (b + "norm2.scale", (d,), None),
        ]
        if i < sz.first_dense:
            out += [(b + "mlp.w_gate", (d, sz.d_ff), INIT_STD),
                    (b + "mlp.w_up", (d, sz.d_ff), INIT_STD),
                    (b + "mlp.w_down", (sz.d_ff, d), resid)]
        else:
            ff, shared = sz.expert_d_ff, sz.n_shared * sz.expert_d_ff
            out += [(b + "moe.router", (d, sz.n_experts), INIT_STD),
                    (b + "moe.w_gate", (sz.n_held, d, ff), INIT_STD),
                    (b + "moe.w_up", (sz.n_held, d, ff), INIT_STD),
                    (b + "moe.w_down", (sz.n_held, ff, d), resid),
                    (b + "moe.shared.w_gate", (d, shared), INIT_STD),
                    (b + "moe.shared.w_up", (d, shared), INIT_STD),
                    (b + "moe.shared.w_down", (shared, d), resid)]
    out.append(("norm.scale", (d,), None))
    return out


def initial_weights(sz: Sizes, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter at step 0, in f32, from one draw of a generator on
    ``device`` seeded with ``seed``: views into one flat buffer."""
    specs = leaves(sz)
    total = sum(math.prod(shape) for _, shape, std in specs if std is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in specs:
        if std is None:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out


def flops_per_step(sz: Sizes, batch: int) -> float:
    """Analytic FLOPs of one training step on this card: 3 x tokens x (the
    attention projections, scores and P V counted dense, the dense
    layers' SwiGLU, the router, the shared experts and top_k x
    n_held / n_experts of a token's routed experts, the held experts'
    expected share, and the head), 2 per multiply-add, no recompute."""
    d, h, s = sz.d_model, sz.heads, sz.seq
    attn = 2 * (d * h * sz.qk_head + d * (sz.kv_lora_rank + sz.qk_rope)
                + sz.kv_lora_rank * h * (sz.qk_nope + sz.v_head) + h * sz.v_head * d)
    attn += 2 * s * h * (sz.qk_head + sz.v_head)
    dense = 6 * d * sz.d_ff
    routed = (2 * d * sz.n_experts + 6 * d * sz.expert_d_ff * sz.n_shared
              + 6 * d * sz.expert_d_ff * sz.top_k * sz.n_held / sz.n_experts)
    ffn = sum(dense if i < sz.first_dense else routed for i in range(sz.layers))
    per_token = sz.layers * attn + ffn + 2 * d * sz.vocab
    return 3.0 * batch * s * per_token


def mla_flash_shape(sz: Sizes, batch: int) -> tuple[int, int, int, int, int]:
    """(batch, heads, seq, q.k head, v head) of every flash launch of a
    step."""
    return batch, sz.heads, sz.seq, sz.qk_head, sz.v_head


# --- the program -----------------------------------------------------------

def program_model(sz: Sizes, config: dict, device):
    """The port's ``TransformerLM`` of a ``DeepSeekV3Config`` at these sizes
    on ``device``, its parameters allocated and not yet filled
    (``load_weights``)."""
    from k8s_device_plugin_tpu_torch.workload.model import DeepSeekV3Config, TransformerLM

    cfg = DeepSeekV3Config(
        vocab_size=sz.vocab, d_model=sz.d_model, n_heads=sz.heads, n_layers=sz.layers,
        d_ff=sz.d_ff, max_seq_len=sz.seq, use_flash_attention=True, moe_top_k=sz.top_k,
        moe_aux_weight=sz.alpha, kv_lora_rank=sz.kv_lora_rank, qk_nope_head_dim=sz.qk_nope,
        qk_rope_head_dim=sz.qk_rope, v_head_dim=sz.v_head, rope_theta=sz.rope_theta,
        norm_eps=sz.norm_eps, first_dense=sz.first_dense, n_routed_experts=sz.n_experts,
        held_experts=(sz.held_first, sz.n_held), expert_d_ff=sz.expert_d_ff,
        n_shared_experts=sz.n_shared, routed_scaling_factor=sz.scaling,
        bias_update_speed=sz.gamma)
    return TransformerLM(cfg, device="meta").to_empty(device=device)


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters, by name (every
    parameter must be given), and start every routing bias at 0."""
    params = dict(model.named_parameters())
    if params.keys() != weights.keys():
        missing = sorted(params.keys() ^ weights.keys())[:5]
        raise ValueError(f"the program's parameters and the benchmark's differ: {missing}")
    for name, p in params.items():
        p.copy_(weights[name])
    for name, buf in model.named_buffers():
        if name.endswith("router_bias"):
            buf.zero_()


# --- the plain reference ---------------------------------------------------

def place(sz: Sizes, weights: dict[str, torch.Tensor], devices) -> dict[str, torch.Tensor]:
    """``weights`` as the reference holds them: on one device, the tensors
    themselves (this family runs on one card)."""
    if len(devices) != 1:
        raise ValueError("the DeepSeek-V3 family's reference runs on one device")
    return weights


class _Fp8(torch.autograd.Function):
    """Rounds a tensor to fp8 e4m3, and its gradient to fp8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    fmax = torch.finfo(dtype).max
    scale = fmax / x.abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(dtype).float().div(scale).to(x.dtype)


class _Tf32Mm(torch.autograd.Function):
    """``a @ b`` with its two backward products, in TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _tf32(True):
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _tf32(True):
            return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def _plain(a, b):
    return a @ b


def _fp8(a, b):
    return _Fp8.apply(a) @ _Fp8.apply(b)


def _tf32_mm(a, b):
    if a.dim() > 2:  # (b, s, d) rows: the product of their flattening
        return _Tf32Mm.apply(a.reshape(-1, a.shape[-1]), b).view(*a.shape[:-1], b.shape[-1])
    return _Tf32Mm.apply(a, b)


@contextlib.contextmanager
def _tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


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


def _mla(h, p, pre, sh: Sizes, block, recompute, mm):
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


def _routed(x, p, pre, bias, sh: Sizes, mm, head_mm):
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


def _layer(x, p, biases, i, sh: Sizes, block, recompute, mm, head_mm):
    pre = f"blocks.{i}."
    h = x + _mla(_rms(x, p[pre + "norm1.scale"], sh.norm_eps), p, pre + "attn.", sh, block,
                 recompute, mm)
    hn = _rms(h, p[pre + "norm2.scale"], sh.norm_eps)
    if i < sh.first_dense:
        out = _swiglu(hn, p[pre + "mlp.w_gate"], p[pre + "mlp.w_up"], p[pre + "mlp.w_down"], mm)
        return h + out, None, None, None
    y, aux, chosen, counts = _routed(hn, p, pre + "moe.", biases[i], sh, mm, head_mm)
    return h + y, aux, chosen, counts


def forward(p: dict, biases: dict, tokens: torch.Tensor, sh: Sizes, block=None,
            recompute: bool = False, mm=_plain, head_mm=_plain):
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


def loss(p: dict, biases: dict, tokens: torch.Tensor, sh: Sizes, block=None,
         recompute: bool = False, mm=_plain, head_mm=_plain):
    """(mean next-token cross-entropy + alpha * the balance terms, the
    routed layers' choices, their choice counts)."""
    h, aux, choices, counts = forward(p, biases, tokens, sh, block, recompute, mm, head_mm)
    logits = head_mm(h[:, :-1].reshape(-1, sh.d_model), p["head"].T)
    ce = F.cross_entropy(logits, tokens[:, 1:].reshape(-1))
    return ce + sh.alpha * aux, choices, counts


def reference_steps(sz: Sizes, weights: dict[str, torch.Tensor], batches, optimizer: dict,
                    precision: str = "stated", choices: dict | None = None):
    """Train ``weights`` (taken over and updated in place) for one AdamW
    step on each of ``batches``, each followed by the routing biases'
    update (all biases 0 at the start). Yields, after each step, its loss,
    the gradient it took by leaf, and the parameters by leaf; where
    ``choices`` is given, the first step's routing choices of each routed
    layer go into it (layer index -> (tokens, k))."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {', '.join(PRECISIONS)}")
    mm = _fp8 if precision == "control" else _plain
    head_mm = _plain if precision == "stated" else _tf32_mm
    block = QUERY_BLOCK if sz.seq > QUERY_BLOCK else None
    recompute = block is not None
    lr, eps, wd = optimizer["lr"], optimizer["eps"], optimizer["weight_decay"]
    b1, b2 = optimizer["betas"]
    device = next(iter(weights.values())).device
    biases = {i: torch.zeros(sz.n_experts, device=device) for i in range(sz.first_dense, sz.layers)}
    params = {n: w.requires_grad_() for n, w in weights.items()}
    m = {n: torch.zeros_like(w) for n, w in params.items()}
    v = {n: torch.zeros_like(w) for n, w in params.items()}
    # Each leaf's own step count: a leaf left without a gradient (a routed
    # layer whose held experts no token chose) is skipped, as torch's AdamW
    # skips it, decay included.
    taken = dict.fromkeys(params, 0)
    with _tf32(False):
        for t, tokens in enumerate(batches, 1):
            for w in params.values():
                w.grad = None
            value, chosen, counts = loss(params, biases, tokens, sz, block, recompute, mm,
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
                    biases[i] += sz.gamma * torch.sign(c.mean() - c)
            if choices is not None and t == 1:
                choices.update(chosen)
            yield value.detach(), {n: w.grad for n, w in params.items()}, params
