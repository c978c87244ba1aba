"""The pre-norm dense transformer LM that ``k8s_device_plugin_tpu_torch``'s
``workload/model.py`` runs, for configurations written with GPT-2's
``config.json`` keys: the sizes, the weights made from a seed, the
analytic FLOPs, the flash kernels' launches, the port's model built to
these sizes, and the plain reference of one training step.

Everything below the program's own model builder is a frozen copy of the
equations and imports nothing of the program:

    x = (E[tokens] + P[:s]) in f32, cast to bf16
    per layer:  x = x + Attn(RMSNorm1(x));  x = x + MLP(RMSNorm2(x))
    RMSNorm(x) = x32 * rsqrt(mean(x32^2) + 1e-6) * scale, in f32
    Attn(h) = softmax(causal(Q K^T / sqrt(head_dim))) V Wo, with Q, K, V =
              h Wq, h Wk, h Wv; projections and P.V in bf16 operands,
              the scores and the softmax in f32
    MLP(h) = gelu_tanh(h W1) W2, in bf16 operands
    logits = RMSNorm(x) E^T in f32; loss = mean next-token cross-entropy
    AdamW (decoupled decay), in f32

With several devices (``placement``) the reference lays layer i on
device ``devices[len(devices) * i // layers]``, the embedding and the
positions on the first and the final norm and head on the last, and moves
the activations between them with ``.to()``: the same equations, a card's
share of the state each. With one device it is the one-device reference.

The reference states the precision the configuration states (f32
parameters, optimizer, norms, softmax, head and loss with TF32 off; bf16
operands for the blocks' products, accumulated in f32) and computes
attention densely. ``precision="control"`` computes it one step lower:
the blocks' product operands rounded to fp8 (e4m3 forward, e5m2 for the
gradients, each scaled by its tensor's largest magnitude) and the head's
f32 products in TF32. ``precision="head_tf32"`` lowers the head alone:
its products, forward and backward, in TF32, the rest as stated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

RMS_EPS = 1e-6
# The reference's precisions (``reference_steps``): as the configuration
# states, the control one step lower, and the head alone one step lower.
PRECISIONS = ("stated", "control", "head_tf32")
# The head's leaves: the tied embedding (the unembed's weight) and the
# final norm, whose products are f32 (``correct``'s ``head_grad_gap``).
HEAD_LEAVES = ("embed", "norm.scale")
INIT_STD = 0.02  # GPT-2's initializer_range


@dataclasses.dataclass(frozen=True)
class Sizes:
    vocab: int
    d_model: int
    heads: int
    layers: int
    d_ff: int
    seq: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


def sizes(config: dict) -> Sizes:
    """The sizes of a configuration file written with GPT-2's keys
    (``n_inner`` null: 4 x ``n_embd``, as GPT-2 reads it)."""
    d = config["n_embd"]
    return Sizes(vocab=config["vocab_size"], d_model=d, heads=config["n_head"],
                 layers=config["n_layer"], d_ff=config["n_inner"] or 4 * d,
                 seq=config["n_positions"])


def leaves(sz: Sizes) -> list[tuple[str, tuple[int, ...], float | None]]:
    """(name, shape, init std; None: ones) of every parameter, in the
    program's names and layouts: GPT-2's init, N(0, 0.02), with the two
    projections into the residual stream scaled by 1/sqrt(2 x layers)."""
    d, h, hd = sz.d_model, sz.heads, sz.head_dim
    resid = INIT_STD / math.sqrt(2 * sz.layers)
    out = [("embed", (sz.vocab, d), INIT_STD), ("pos", (sz.seq, d), INIT_STD)]
    for i in range(sz.layers):
        b = f"blocks.{i}."
        out += [
            (b + "norm1.scale", (d,), None),
            (b + "attn.wq", (d, h, hd), INIT_STD),
            (b + "attn.wk", (d, h, hd), INIT_STD),
            (b + "attn.wv", (d, h, hd), INIT_STD),
            (b + "attn.wo", (h, hd, d), resid),
            (b + "norm2.scale", (d,), None),
            (b + "mlp.w1", (d, sz.d_ff), INIT_STD),
            (b + "mlp.w2", (sz.d_ff, d), resid),
        ]
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
    """Analytic FLOPs of one training step, the numerator of ``mfu_pct``:
    3 x tokens x (layers x (8 d^2 + 4 s d + 4 d d_ff) + 2 d V), 2 per
    multiply-add, attention counted dense, no recompute counted. A frozen
    copy of the port's ``ModelConfig.train_flops_per_step`` (dense)."""
    d, s = sz.d_model, sz.seq
    per_token = sz.layers * (8 * d * d + 4 * s * d + 4 * d * sz.d_ff) + 2 * d * sz.vocab
    return 3.0 * batch * s * per_token


def flash_shape(sz: Sizes, batch: int, mesh=(1, 1, 1)) -> tuple[int, int, int, int]:
    """(batch, heads, seq, head_dim) of every flash launch of a step on one
    card of a (data, fsdp, model) ``mesh``: its rows of the batch, and its
    share of the heads where the model axis divides them (the port keeps
    them whole where it does not)."""
    data, fsdp, model = mesh
    heads = sz.heads // model if sz.heads % model == 0 else sz.heads
    return batch // (data * fsdp), heads, sz.seq, sz.head_dim


# --- the program -----------------------------------------------------------

def program_model(sz: Sizes, config: dict, device):
    """The port's ``TransformerLM`` at these sizes on ``device``, its
    parameters allocated and not yet filled (``load_weights``)."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, TransformerLM

    cfg = ModelConfig(vocab_size=sz.vocab, d_model=sz.d_model, n_heads=sz.heads,
                      n_layers=sz.layers, d_ff=sz.d_ff, max_seq_len=sz.seq,
                      use_flash_attention=config["flash_attention"])
    return TransformerLM(cfg, device="meta").to_empty(device=device)


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters, by name; every
    parameter must be given."""
    params = dict(model.named_parameters())
    if params.keys() != weights.keys():
        missing = sorted(params.keys() ^ weights.keys())[:5]
        raise ValueError(f"the program's parameters and the benchmark's differ: {missing}")
    for name, p in params.items():
        p.copy_(weights[name])


# --- the plain reference ---------------------------------------------------

def placement(sz: Sizes, devices) -> dict[str, torch.device]:
    """The device of each leaf when the reference runs over ``devices``:
    layer i on ``devices[len(devices) * i // layers]``, the embedding and
    the positions on the first, the final norm (and the head) on the last."""
    devices = [torch.device(d) for d in devices]
    out = {"embed": devices[0], "pos": devices[0], "norm.scale": devices[-1]}
    for name, _, _ in leaves(sz):
        if name.startswith("blocks."):
            out[name] = devices[len(devices) * int(name.split(".")[1]) // sz.layers]
    return out


def place(sz: Sizes, weights: dict[str, torch.Tensor], devices) -> dict[str, torch.Tensor]:
    """``weights`` as the reference holds them over ``devices``
    (``placement``): on one device, the tensors themselves; on several, each
    leaf a copy of its own on its device, so that no leaf keeps the flat
    buffer of ``initial_weights`` alive."""
    if len(devices) == 1:
        return weights
    where = placement(sz, devices)
    return {n: w.to(where[n], copy=True) for n, w in weights.items()}


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


def _mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    if low:
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    return a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return x32 * (torch.rsqrt(x32.square().mean(-1, keepdim=True) + RMS_EPS) * scale)


def _block(x, n1, wq, wk, wv, wo, n2, w1, w2, *, sz: Sizes, low: bool):
    bf = torch.bfloat16
    b, s, d = x.shape
    hn = _rms(x, n1).to(bf)

    def heads(w):
        return _mm(hn, w.to(bf).reshape(d, d), low).view(b, s, sz.heads, sz.head_dim).transpose(1, 2)

    q, k, v = heads(wq), heads(wk), heads(wv)
    if low:
        q, k = _Fp8.apply(q), _Fp8.apply(k)
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(sz.head_dim))
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1).to(bf)
    o = _mm(probs, v, low).transpose(1, 2).reshape(b, s, d)
    x = x + _mm(o, wo.to(bf).reshape(d, d), low)
    hn = _rms(x, n2).to(bf)
    return x + _mm(F.gelu(_mm(hn, w1.to(bf), low), approximate="tanh"), w2.to(bf), low)


_BLOCK_LEAVES = ("norm1.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                 "norm2.scale", "mlp.w1", "mlp.w2")


class _Tf32Head(torch.autograd.Function):
    """The head's product ``h E^T`` with its two backward products, in TF32."""

    @staticmethod
    def forward(ctx, h, embed):
        ctx.save_for_backward(h, embed)
        with _tf32(True):
            return h @ embed.T

    @staticmethod
    def backward(ctx, g):
        h, embed = ctx.saved_tensors
        with _tf32(True):
            return g @ embed, g.T @ h


def reference_loss(p: dict[str, torch.Tensor], tokens: torch.Tensor, sz: Sizes,
                   low: bool = False, head_tf32: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (batch, seq) under the
    parameters ``p``, a layer at a time: each block's activations are
    recomputed in the backward (``checkpoint``), so that the dense
    attention fits beside the step's state at the timed sizes. Each block
    runs where its leaves are, the head where the final norm is
    (``placement``); ``tokens`` lie with the embedding. ``low``:
    the blocks' products in fp8; ``head_tf32``: the head's in TF32."""
    s = tokens.shape[1]
    x = (p["embed"][tokens] + p["pos"][:s][None]).to(torch.bfloat16)
    block = functools.partial(_block, sz=sz, low=low)
    for i in range(sz.layers):
        args = [p[f"blocks.{i}.{leaf}"] for leaf in _BLOCK_LEAVES]
        x = checkpoint(block, x.to(args[0].device), *args, use_reentrant=False)
    scale = p["norm.scale"]
    h = _rms(x[:, :-1].to(scale.device), scale)
    h = h.reshape(-1, sz.d_model)
    embed = p["embed"].to(scale.device)
    logits = _Tf32Head.apply(h, embed) if head_tf32 else h @ embed.T
    return F.cross_entropy(logits, tokens[:, 1:].reshape(-1).to(scale.device))


@contextlib.contextmanager
def _tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def reference_steps(sz: Sizes, weights: dict[str, torch.Tensor], batches, optimizer: dict,
                    precision: str = "stated"):
    """Train ``weights`` (taken over and updated in place) for one AdamW
    step on each of ``batches``. Yields, after each step, its loss, the
    gradient it took by leaf, and the parameters by leaf."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {', '.join(PRECISIONS)}")
    low = precision == "control"
    lr, eps, wd = optimizer["lr"], optimizer["eps"], optimizer["weight_decay"]
    b1, b2 = optimizer["betas"]
    params = {n: w.requires_grad_() for n, w in weights.items()}
    m = {n: torch.zeros_like(w) for n, w in params.items()}
    v = {n: torch.zeros_like(w) for n, w in params.items()}
    with _tf32(low):
        for t, tokens in enumerate(batches, 1):
            for w in params.values():
                w.grad = None
            loss = reference_loss(params, tokens, sz, low, precision == "head_tf32")
            loss.backward()
            with torch.no_grad():
                for n, w in params.items():
                    g = w.grad
                    w.mul_(1 - lr * wd)
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    w.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
            yield loss.detach(), {n: w.grad for n, w in params.items()}, params
