"""The smoke-workload model, a small causal transformer LM, in PyTorch: the
counterpart of the JAX package's ``workload/model.py``.

embed + pos -> blocks of [RMSNorm -> causal attention -> RMSNorm -> GELU
MLP, or the routed MoE MLP] -> RMSNorm -> tied unembed. bf16 activations
and products over f32 parameters. The dtypes follow the JAX reference at
every step, including where that is not the obvious choice:

- flax's ``nn.RMSNorm`` (eps 1e-6) reduces in f32 and, with a bf16 input
  and an f32 scale, returns f32; ``Attention`` and ``Mlp`` cast their input
  back to the compute dtype. Under ``use_pallas_norm`` the norm is the
  RMSNorm kernel (``ops/rmsnorm.py``), which returns x's dtype: bf16 in a
  bf16 model, so the final norm's output is rounded to bf16 before the f32
  unembed.
- The dense attention divides the scores by ``sqrt(head_dim)`` in the
  compute dtype, masks with -1e9 and takes the softmax in f32.
- ``jax.nn.gelu`` is the tanh approximation.
- ``embed[tokens] + pos`` is summed in f32 before the cast; the tied
  unembedding runs in f32.

Parameters are always per layer (``blocks.<i>``): PyTorch runs the layer
loop eagerly, so the config has no ``scan_layers`` option, and
``workload/params.py`` unstacks the JAX scanned layout.

Decode mode (``cfg.decode``) takes one position per call and attends over
an explicit ``KVCache`` (the JAX model's flax "cache" collection), which
the forward updates in place; ``workload/generate.py`` drives it.

Parallelism (``train.shard_model``, which also sets ``model.mesh``):
``PARAM_AXES`` holds each parameter's logical axes, as the JAX model's
``param_with_axes`` names them. Every split region runs between Megatron's
pair (``parallel/collectives.py``): ``enter_split``, the identity whose
backward sums the gradient over the group, and ``leave_split``, the sum
over the group whose backward is the identity; outside them everything is
replicated over the group's axis.

- ``model`` (tensor parallelism): each rank holds its slice of the heads
  and of the ``mlp`` columns (the experts' ``d_ff`` too), and the split
  embedding is gathered whole (``TransformerLM.tied_embedding``) for the
  lookup, the unembed and the chunked CE.
- ``seq`` (ring attention, ``use_ring_attention``): the activations stay
  replicated; each rank takes its seq shard of q, k and v inside the
  bracket, runs ``parallel/ring.py`` and gathers the output along seq.
- ``expert`` (MoE, ``n_experts`` > 0, ``workload/moe.py``): each rank runs
  its experts' share of the dispatch and combine, and the sum over the
  axis completes y; the router and the aux loss stay replicated.
- ``pipe`` (``pipeline_microbatches`` > 0, ``parallel/pipeline.py``): each
  rank keeps its stage's blocks (the others become ``ElsewhereStage``);
  the embedding, the final norm and the unembed stay outside the pipeline,
  replicated over pipe.

The config holds no mesh (JAX's ``ring_mesh`` and ``pipe_mesh``): a ring
or pipeline model takes its groups from ``shard_model`` and raises when
run without them.

``DeepSeekV3Config`` (a ``ModelConfig`` with the fields of DeepSeek-V3's
``config.json``; the JAX package has no counterpart) builds DeepSeek-V3's
block on the same path: multi-head latent attention (``MlaAttention``,
DeepSeek-V2 section 2.1, no query compression) with RoPE on its rotary
dims and no position table, SwiGLU MLPs (``SwiGlu``) in the leading dense
layers, DeepSeek-V3's routed layers (``workload/routed.py``) after them,
RMSNorm at the config's epsilon, and an untied f32 head (``head``). It
runs on one device, unsharded (``train.shard_model`` refuses an axis
larger than 1), and the routed layer computes the share of the experts it
is told it holds.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import flash_attention, head
from ..ops.rmsnorm import rmsnorm
from ..parallel.collectives import enter_split, gather_split, leave_split

RMS_EPS = 1e-6  # flax nn.RMSNorm's default

# Each parameter's logical axes, by its name inside ``blocks.<i>`` or the
# root, from the JAX model (model.py:233-248, 340-344, 402-407, and
# moe.py:50-60). The norm
# scale's ("embed",) holds under ``use_pallas_norm`` only (model.py:37-40):
# flax's nn.RMSNorm scale has no axes and stays replicated.
PARAM_AXES = {
    "attn.wq": ("embed", "heads", "kv"),
    "attn.wk": ("embed", "heads", "kv"),
    "attn.wv": ("embed", "heads", "kv"),
    "attn.wo": ("heads", "kv", "embed"),
    "mlp.w1": ("embed", "mlp"),
    "mlp.w2": ("mlp", "embed"),
    "moe.wg": ("embed", "expert_gate"),
    "moe.w1": ("expert", "embed", "mlp"),
    "moe.w2": ("expert", "mlp", "embed"),
    "embed": ("vocab", "embed"),
    "pos": ("seq", "embed"),
    # DeepSeekV3Config's leaves, which shard_model never splits.
    "attn.wdkv": (None, None),
    "attn.wukv": (None, None, None),
    "mlp.w_gate": (None, None),
    "mlp.w_up": (None, None),
    "mlp.w_down": (None, None),
    "moe.router": (None, None),
    "moe.w_gate": (None, None, None),
    "moe.w_up": (None, None, None),
    "moe.w_down": (None, None, None),
    "moe.shared.w_gate": (None, None),
    "moe.shared.w_up": (None, None),
    "moe.shared.w_down": (None, None),
    "head": (None, None),
}
PALLAS_NORM_AXES = ("embed",)


def param_axes(cfg: "ModelConfig", name: str) -> tuple[str, ...] | None:
    """The logical axes of parameter ``name`` of ``TransformerLM(cfg)``;
    None where the JAX model gives it none (flax's norm scale)."""
    if name.endswith("scale"):
        return PALLAS_NORM_AXES if cfg.use_pallas_norm else None
    return PARAM_AXES[name.split(".", 2)[2] if name.startswith("blocks.") else name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq_len: int = 128
    dtype: torch.dtype = torch.bfloat16
    use_pallas_norm: bool = False
    use_flash_attention: bool = False
    # Context parallelism over the mesh's seq axis (parallel/ring.py);
    # ring_q_chunk > 0 caps each ring step's score tile at [q_chunk,
    # s_local]. Mutually exclusive with use_flash_attention.
    use_ring_attention: bool = False
    ring_q_chunk: int = 0
    xent_chunk: int = 0
    # Routed MoE MLP (workload/moe.py) with its expert dim over the mesh's
    # expert axis; its load-balance loss enters the training loss with
    # weight moe_aux_weight.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    # GPipe over the mesh's pipe axis (parallel/pipeline.py) with this many
    # microbatches.
    pipeline_microbatches: int = 0
    decode: bool = False

    def decode_supported(self) -> bool:
        """Whether this config has a decode-mode (KV cache) equivalent, as
        in the JAX reference: the plain dense attention path with per-layer
        parameters (the only layout the port has). MoE is excluded because
        its capacity-based dispatch depends on the sequence length."""
        return not (
            self.use_ring_attention
            or self.use_flash_attention
            or self.pipeline_microbatches > 0
            or self.n_experts > 0
        )

    def __post_init__(self):
        """The JAX config's checks (model.py:114-140), but for its
        ``scan_layers`` and ``pipe_mesh`` requirements: the port's layers
        are always separate, and its mesh comes from ``train.shard_model``
        (a pipelined model run without one raises)."""
        if self.decode and not self.decode_supported():
            raise ValueError(
                "decode mode supports the plain dense attention path only "
                "(no ring/flash/pipeline/MoE)"
            )
        if self.pipeline_microbatches > 0:
            if self.n_experts > 0:
                raise ValueError(
                    "MoE aux-loss collection is not supported under the "
                    "pipelined schedule; use expert parallelism without "
                    "pipeline_microbatches"
                )
            if self.use_ring_attention:
                raise ValueError(
                    "ring attention cannot run inside the pipelined "
                    "schedule; use context parallelism without "
                    "pipeline_microbatches"
                )
        if self.xent_chunk > 0 and self.vocab_size % self.xent_chunk != 0:
            raise ValueError(
                f"xent_chunk {self.xent_chunk} must divide vocab_size {self.vocab_size}"
            )

    @staticmethod
    def tiny() -> "ModelConfig":
        return ModelConfig(
            vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=16,
        )

    @staticmethod
    def bench() -> "ModelConfig":
        """The smoke pod's ``--bench`` shape: vocab 32768, d_model 2048, 16
        heads of 128, 4 layers, d_ff 8192, seq 2048, flash attention;
        about 235 M parameters. The JAX reference's bench() also stacks the
        layers (``scan_layers``); ``params.py`` unstacks that layout."""
        return ModelConfig(
            vocab_size=32768, d_model=2048, n_heads=16, n_layers=4,
            d_ff=8192, max_seq_len=2048, use_flash_attention=True,
        )

    # --- analytic FLOPs accounting (the MFU numerator) -------------------
    def matmul_params(self) -> int:
        """Parameters that take part in matmuls (PaLM-style N): attention
        projections, MLP and the tied unembedding."""
        attn = 4 * self.d_model * self.d_model
        mlp = 2 * self.d_model * self.d_ff
        per_layer = attn + (mlp * self.n_experts if self.n_experts > 0 else mlp)
        return self.n_layers * per_layer + self.vocab_size * self.d_model

    def fwd_flops_per_token(self) -> float:
        """Matmul FLOPs of one forward pass per token, 2 per multiply-add.
        Attention scores are counted dense (no causal halving), as in the
        JAX reference, so MFU stays comparable across attention paths."""
        d, s = self.d_model, self.max_seq_len
        attn_proj = 8 * d * d
        attn_scores = 4 * s * d
        mlp = 4 * self.d_model * self.d_ff
        if self.n_experts > 0:
            mlp = mlp * self.moe_top_k + 2 * d * self.n_experts
        unembed = 2 * d * self.vocab_size
        return self.n_layers * (attn_proj + attn_scores + mlp) + unembed

    def train_flops_per_step(self, batch: int) -> float:
        """Fwd + bwd matmul FLOPs of one optimizer step (bwd = 2x fwd)."""
        return 3.0 * batch * self.max_seq_len * self.fwd_flops_per_token()


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """DeepSeek-V3's architecture (HF ``modeling_deepseek_v3`` with
    ``q_lora_rank`` null, sigmoid routing, ``noaux_tc``, ``seq_aux``):
    ``n_heads`` heads of multi-head latent attention whose q.k heads are
    ``qk_nope_head_dim + qk_rope_head_dim`` wide and v heads
    ``v_head_dim``, over a shared latent of ``kv_lora_rank``; RoPE at
    ``rope_theta`` on the rotary dims; ``first_dense`` SwiGLU layers of
    width ``d_ff``, then routed layers of ``n_routed_experts`` SwiGLU
    experts of width ``expert_d_ff``, ``moe_top_k`` a token, with
    ``n_shared_experts`` of them as one shared SwiGLU; RMSNorm at
    ``norm_eps``; an untied head. This device holds the experts
    ``held_experts`` (first, count) of every routed layer; the router
    scores all of them. ``moe_aux_weight`` weighs the sequence-wise balance
    loss (alpha), ``bias_update_speed`` is the routing bias's step (gamma).
    ``max_seq_len`` is the context RoPE's table covers."""

    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    max_seq_len: int = 32
    use_flash_attention: bool = True
    moe_top_k: int = 2
    moe_aux_weight: float = 1e-4
    kv_lora_rank: int = 32
    qk_nope_head_dim: int = 24
    qk_rope_head_dim: int = 8
    v_head_dim: int = 16
    rope_theta: float = 50000.0
    norm_eps: float = 1e-5
    first_dense: int = 1
    n_routed_experts: int = 8
    held_experts: tuple[int, int] = (0, 8)
    expert_d_ff: int = 32
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    bias_update_speed: float = 1e-3

    def __post_init__(self):
        super().__post_init__()
        first, count = self.held_experts
        if not (0 <= first and 0 < count and first + count <= self.n_routed_experts):
            raise ValueError(f"held_experts {self.held_experts} outside the "
                             f"{self.n_routed_experts} routed experts")
        if not 0 < self.moe_top_k <= self.n_routed_experts:
            raise ValueError(f"moe_top_k {self.moe_top_k} of {self.n_routed_experts} experts")
        if self.qk_rope_head_dim % 2:
            raise ValueError("RoPE pairs the rotary dims: qk_rope_head_dim must be even")
        if not self.use_flash_attention or self.decode or self.use_ring_attention:
            raise ValueError("multi-head latent attention runs on the flash path alone "
                             "(use_flash_attention, no decode, no ring)")
        if self.n_experts or self.pipeline_microbatches or self.xent_chunk:
            raise ValueError("DeepSeekV3Config takes none of n_experts, "
                             "pipeline_microbatches or xent_chunk")

    @staticmethod
    def tiny() -> "DeepSeekV3Config":
        """The CPU tests' size: d 64, 4 heads of 24 + 8 q.k and 16 v, latent
        32, 8 experts (top 2, 2 shared), vocabulary 256, seq 32."""
        return DeepSeekV3Config()

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_routed(self, layer: int) -> bool:
        return layer >= self.first_dense


def _xavier_uniform(shape, generator, device) -> torch.Tensor:
    """flax's xavier_uniform: fans over the last two axes, times the
    receptive field of the leading ones."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-limit, limit, generator=generator)


class Norm(nn.Module):
    """flax ``nn.RMSNorm(use_scale=True)``: f32 statistics, f32 output; or,
    with ``use_pallas_norm``, the RMSNorm kernel, whose output has x's
    dtype (the JAX ``Norm`` under ``use_pallas_norm``)."""

    def __init__(self, d: int, device=None, use_pallas_norm: bool = False,
                 eps: float = RMS_EPS):
        super().__init__()
        self.use_pallas_norm = use_pallas_norm
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pallas_norm:
            return rmsnorm(x, self.scale, self.eps)
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        return x32 * (torch.rsqrt(var + self.eps) * self.scale)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.d_model // cfg.n_heads
        qkv = (cfg.d_model, cfg.n_heads, hd)
        self.wq = nn.Parameter(_xavier_uniform(qkv, generator, device))
        self.wk = nn.Parameter(_xavier_uniform(qkv, generator, device))
        self.wv = nn.Parameter(_xavier_uniform(qkv, generator, device))
        self.wo = nn.Parameter(
            _xavier_uniform((cfg.n_heads, hd, cfg.d_model), generator, device)
        )
        # The model axis's group when apply_tp split the heads; the head
        # count is then the weights' own, never cfg.n_heads.
        self.tp_group = None
        # The seq axis's group under use_ring_attention (shard_model).
        self.seq_group = None

    def forward(self, x: torch.Tensor, kv=None) -> torch.Tensor:
        """``kv``: in decode mode, this layer's ``(cache_k, cache_v,
        position)``; None otherwise."""
        cfg = self.cfg
        dt = cfg.dtype
        x = x.to(dt)
        if self.tp_group is not None:
            x = enter_split(x, self.tp_group)
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        if cfg.decode:
            out = self._decode_attend(q, k, v, *kv)
        elif cfg.use_ring_attention:
            out = self._ring_attend(q, k, v)
        elif cfg.use_flash_attention:
            # (b,s,h,k) -> (b,h,s,k); flash_attention makes them contiguous.
            out = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ).transpose(1, 2)
        else:
            scores = torch.einsum("bshk,bthk->bhst", q, k) / _sqrt_in(q.shape[-1], dt, x.device)
            seq = x.shape[1]
            causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~causal, -1e9)
            probs = torch.softmax(scores.float(), dim=-1).to(dt)
            out = torch.einsum("bhst,bthk->bshk", probs, v)
        out = torch.einsum("bshk,hkd->bsd", out, self.wo.to(dt))
        if self.tp_group is not None:
            out = leave_split(out, self.tp_group)
        return out

    def _ring_attend(self, q, k, v) -> torch.Tensor:
        """Ring attention over the seq group (q, k, v: (b, s, h, kd),
        replicated over seq): each rank takes its contiguous seq shard
        inside the split region, and the output is gathered along seq."""
        from ..parallel.ring import ring_attention

        if self.cfg.use_flash_attention:
            raise ValueError("use_ring_attention and use_flash_attention are mutually exclusive")
        group = self.seq_group
        if group is None:
            raise ValueError("use_ring_attention requires a mesh: lay the model out with "
                             "train.shard_model(model, mesh), whose seq axis carries the ring")
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        seq = q.shape[1]
        if seq % n:
            raise ValueError(f"seq {seq} does not split over the {n} ranks of the seq axis")
        per = seq // n

        def shard(t):
            return enter_split(t, group).narrow(1, rank * per, per).transpose(1, 2)

        out = ring_attention(shard(q), shard(k), shard(v), group, self.cfg.ring_q_chunk)
        return gather_split(out, group, 2).transpose(1, 2)

    def _decode_attend(self, q, k, v, cache_k, cache_v, i: int) -> torch.Tensor:
        """One-position attention over the K/V cache (q, k, v: (b, 1, h,
        kd)), as the JAX ``_decode_attend``: the new K/V are written at
        position ``i`` (in place), the scores cover the whole cache and
        every slot past ``i`` is masked to -1e9."""
        dt = self.cfg.dtype
        cache_k[:, i] = k[:, 0]
        cache_v[:, i] = v[:, 0]
        scores = torch.einsum("bqhk,bthk->bhqt", q, cache_k) / _sqrt_in(q.shape[-1], dt, q.device)
        valid = torch.arange(cache_k.shape[1], device=q.device) <= i
        scores = scores.masked_fill(~valid, -1e9)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        return torch.einsum("bhqt,bthk->bqhk", probs, cache_v)


def _sqrt_in(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``sqrt(n)`` in ``dtype`` (11.3125 for 128 in bf16) as a 0-d tensor on
    ``device``, the JAX ``jnp.sqrt(jnp.asarray(n, dtype))``. It is made by a
    fill on the device, so no host-to-device copy is issued (a CUDA graph
    capture refuses one). A tensor divisor keeps the division a true one on
    the card: with a Python-float divisor CUDA multiplies by its reciprocal,
    which can differ from the quotient by one bf16 ulp."""
    return torch.full((), n, dtype=dtype, device=device).sqrt()


class Mlp(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.w1 = nn.Parameter(_xavier_uniform((cfg.d_model, cfg.d_ff), generator, device))
        self.w2 = nn.Parameter(_xavier_uniform((cfg.d_ff, cfg.d_model), generator, device))
        self.tp_group = None  # the model axis's group when apply_tp split the mlp columns

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x.to(dt)
        if self.tp_group is not None:
            x = enter_split(x, self.tp_group)
        out = F.gelu(x @ self.w1.to(dt), approximate="tanh") @ self.w2.to(dt)
        if self.tp_group is not None:
            out = leave_split(out, self.tp_group)
        return out


def rope_tables(seq: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), f32 (seq, dim), of DeepSeek-V3's rotary embedding:
    frequencies theta^(-2i/dim) for i < dim/2, each repeated over the two
    halves (HF ``DeepseekV3RotaryEmbedding``)."""
    inv_freq = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)
    freqs = torch.outer(torch.arange(seq, device=device, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on x (batch, seq, heads, dim) in f32 as DeepSeek-V3's
    ``apply_rotary_pos_emb`` takes it: the pairs (2i, 2i+1) gathered into
    the two halves (evens, then odds), then ``x cos + rotate_half(x) sin``.
    The output keeps that halves layout, for q and k alike."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, h, d // 2, 2).transpose(-1, -2).reshape(b, s, h, d)
    half = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * cos[None, :s, None] + half * sin[None, :s, None]


class MlaAttention(nn.Module):
    """Multi-head latent attention with no query compression (HF
    ``DeepseekV3Attention`` at ``q_lora_rank`` null):

        q = h Wq, (n_heads, nope + rope) a token, split into q_nope, q_rope
        [c, k_r] = h Wdkv, c of kv_lora_rank, k_r of rope (one for all heads)
        [k_nope, v] = RMSNorm(c) Wukv, (n_heads, nope + v_head_dim)
        q_rope, k_r = RoPE(q_rope), RoPE(k_r)
        o = softmax(causal([q_nope, q_rope] . [k_nope, k_r] / sqrt(nope + rope))) v
        out = o Wo

    The products take bf16 operands (f32 accumulation), the latent's norm
    and RoPE run in f32, and attention is the flash path (``ops/
    attention.py``: q.k heads of 192 over v heads of 128 at DeepSeek-V3's
    widths)."""

    def __init__(self, cfg: DeepSeekV3Config, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        h, r, rope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        self.wq = nn.Parameter(_xavier_uniform((cfg.d_model, h, cfg.qk_head_dim), generator,
                                               device))
        self.wdkv = nn.Parameter(_xavier_uniform((cfg.d_model, r + rope), generator, device))
        self.kv_norm = Norm(r, device, eps=cfg.norm_eps)
        self.wukv = nn.Parameter(_xavier_uniform(
            (r, h, cfg.qk_nope_head_dim + cfg.v_head_dim), generator, device))
        self.wo = nn.Parameter(_xavier_uniform((h, cfg.v_head_dim, cfg.d_model), generator,
                                               device))

    def forward(self, x: torch.Tensor, kv=None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        nope, rope, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        x = x.to(dt)
        b, s, _ = x.shape
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        c, k_r = (x @ self.wdkv.to(dt)).split([r, rope], dim=-1)
        kv = torch.einsum("bsr,rhk->bshk", self.kv_norm(c).to(dt), self.wukv.to(dt))
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        cos, sin = rope_tables(s, rope, cfg.rope_theta, x.device)
        q_rope = apply_rope(q[..., nope:].float(), cos, sin).to(dt)
        k_rope = apply_rope(k_r[:, :, None].float(), cos, sin).to(dt)
        q = torch.cat((q[..., :nope], q_rope), dim=-1)
        k = torch.cat((k_nope, k_rope.expand(b, s, cfg.n_heads, rope)), dim=-1)
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return torch.einsum("bhsk,hkd->bsd", out, self.wo.to(dt))


class SwiGlu(nn.Module):
    """DeepSeek-V3's MLP: ``W_down(silu(x W_gate) * x W_up)``, bf16
    operands; the dense layers' and the shared experts'."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype = torch.bfloat16,
                 generator=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.w_gate = nn.Parameter(_xavier_uniform((d_model, d_ff), generator, device))
        self.w_up = nn.Parameter(_xavier_uniform((d_model, d_ff), generator, device))
        self.w_down = nn.Parameter(_xavier_uniform((d_ff, d_model), generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        return (F.silu(x @ self.w_gate.to(dt)) * (x @ self.w_up.to(dt))) @ self.w_down.to(dt)


class Block(nn.Module):
    """[norm -> attention -> norm -> MLP or MoE], each with its residual.
    ``forward`` returns the output and the MoE layer's load-balance term
    (None for the dense MLP). Under ``DeepSeekV3Config`` the attention is
    ``MlaAttention`` and layer ``index`` is a SwiGLU or a routed layer."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None, index: int = 0):
        super().__init__()
        if isinstance(cfg, DeepSeekV3Config):
            self._init_latent(cfg, generator, device, index)
            return
        self.norm1 = Norm(cfg.d_model, device, cfg.use_pallas_norm)
        self.attn = Attention(cfg, generator, device)
        self.norm2 = Norm(cfg.d_model, device, cfg.use_pallas_norm)
        self.is_moe = cfg.n_experts > 0
        if self.is_moe:
            from .moe import MoeMlp

            self.moe = MoeMlp(cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.moe_top_k,
                              cfg.moe_capacity_factor, cfg.dtype, generator, device)
        else:
            self.mlp = Mlp(cfg, generator, device)

    def _init_latent(self, cfg: DeepSeekV3Config, generator, device, index: int) -> None:
        from .routed import RoutedMoe

        eps = cfg.norm_eps
        self.norm1 = Norm(cfg.d_model, device, cfg.use_pallas_norm, eps)
        self.attn = MlaAttention(cfg, generator, device)
        self.norm2 = Norm(cfg.d_model, device, cfg.use_pallas_norm, eps)
        self.is_moe = cfg.is_routed(index)
        if self.is_moe:
            self.moe = RoutedMoe(cfg, generator, device)
        else:
            self.mlp = SwiGlu(cfg.d_model, cfg.d_ff, cfg.dtype, generator, device)

    def forward(self, x: torch.Tensor, kv=None) -> tuple[torch.Tensor, torch.Tensor | None]:
        x = x + self.attn(self.norm1(x), kv)
        if self.is_moe:
            y, aux = self.moe(self.norm2(x))
            return x + y, aux
        return x + self.mlp(self.norm2(x)), None


class ElsewhereStage(nn.Module):
    """The place of a block that another rank of the pipe axis holds
    (``train.apply_pipe``): it keeps the block names global and holds no
    parameter."""

    def forward(self, *args):
        raise RuntimeError("this block belongs to another pipeline stage")


def _run_stage(stage, x: torch.Tensor) -> torch.Tensor:
    """One pipeline stage: its blocks in order (the pipeline rejects MoE,
    so no block has an aux term)."""
    for block in stage:
        x, _ = block(x)
    return x


def embed_tokens(cfg: ModelConfig, embed, pos, tokens):
    """Token + position embedding, summed in f32, then cast; the token
    embedding alone where the model has no position table (``pos`` None:
    RoPE)."""
    if pos is None:
        return embed[tokens].to(cfg.dtype)
    seq = tokens.shape[1]
    return (embed[tokens] + pos[:seq][None, :, :]).to(cfg.dtype)


def unembed(x, embed):
    """Tied-embedding logits projection, in f32 for the softmax. On the
    card, for plain tensors of at least ``ops/head.py``'s ``MIN_ROWS`` rows
    (``takes``), the f32 product and its two gradients run on the 3xTF32
    kernel, as accurate as the f32 product; elsewhere (the CPU, DTensors,
    decoding's few rows) the einsum."""
    x = x.float()
    if head.takes(x, embed):
        return head.head_logits(x, embed)
    return torch.einsum("bsd,vd->bsv", x, embed)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        latent = isinstance(cfg, DeepSeekV3Config)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=device)
            .normal_(0.0, 0.02, generator=generator)
        )
        if latent:
            self.register_parameter("pos", None)  # RoPE inside the attention
        else:
            self.pos = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, device=device)
                .normal_(0.0, 0.02, generator=generator)
            )
        self.blocks = nn.ModuleList(
            Block(cfg, generator, device, i) for i in range(cfg.n_layers)
        )
        if latent:
            self.norm = Norm(cfg.d_model, device, cfg.use_pallas_norm, cfg.norm_eps)
            self.head = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.d_model, device=device)
                .normal_(0.0, 0.02, generator=generator)
            )
        else:
            self.norm = Norm(cfg.d_model, device, cfg.use_pallas_norm)
            self.register_parameter("head", None)  # the tied embedding unembeds
        # The routed layers, whose routing bias train.train_step updates
        # after each optimizer step.
        self.routed_layers = tuple(b.moe for b in self.blocks if latent and b.is_moe)
        # Set by train.shard_model: the mesh; the model axis's group and
        # the dim each tensor-parallel parameter is split along, by name;
        # the expert axis's group and its split parameters likewise; the
        # pipe axis's group under pipeline_microbatches; the seq axis's
        # group under use_ring_attention.
        self.mesh = None
        self.tp_group = None
        self.tp_dims: dict[str, int] = {}
        self.ep_group = None
        self.ep_dims: dict[str, int] = {}
        self.pipe_group = None
        self.seq_group = None

    def tied_embedding(self) -> torch.Tensor:
        """The whole (vocab, d_model) embedding: the parameter itself, or,
        where tensor parallelism split the vocabulary, gathered over the
        model axis."""
        if "embed" in self.tp_dims:
            return gather_split(self.embed, self.tp_group, self.tp_dims["embed"])
        return self.embed

    def unembedding(self) -> torch.Tensor:
        """The (vocab, d_model) weight of the logits: the untied ``head``
        where the model has one, else ``tied_embedding()``."""
        return self.head if self.head is not None else self.tied_embedding()

    def hidden_states(self, tokens: torch.Tensor, cache: KVCache | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The final norm's output, and the sum of the MoE layers'
        load-balance terms (None without MoE). In decode mode ``tokens``
        is one position (batch, 1) and ``cache`` the K/V cache, which this
        call extends by that position; otherwise no cache is taken."""
        cfg = self.cfg
        if not cfg.decode:
            if cache is not None:
                raise ValueError("a KV cache is read only in decode mode (cfg.decode)")
            x = embed_tokens(cfg, self.tied_embedding(), self.pos, tokens)
            aux = None
            if cfg.pipeline_microbatches > 0:
                x = self._pipelined(x)
            else:
                for block in self.blocks:
                    x, a = block(x)
                    if a is not None:
                        aux = a if aux is None else aux + a
            return self.norm(x), aux
        if tokens.shape[1] != 1:
            raise ValueError(
                f"decode mode consumes one position per call, got tokens "
                f"{tuple(tokens.shape)}; the cache position only advances by 1"
            )
        if cache is None:
            raise ValueError("decode mode needs the KV cache (init_cache)")
        i = cache.pos
        x = (self.embed[tokens] + self.pos[i][None, None, :]).to(cfg.dtype)
        for block, cache_k, cache_v in zip(self.blocks, cache.k, cache.v):
            x, _ = block(x, (cache_k, cache_v, i))
        cache.pos = i + 1
        return self.norm(x), None

    def _pipelined(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks under the GPipe schedule over the pipe group: the JAX
        ``forward_pipelined``'s middle part."""
        from ..parallel.pipeline import pipeline_apply

        if self.pipe_group is None:
            raise ValueError("pipeline_microbatches requires a mesh: lay the model out with "
                             "train.shard_model(model, mesh), whose pipe axis carries the "
                             "stages")
        stage = [block for block in self.blocks if isinstance(block, Block)]
        return pipeline_apply(_run_stage, stage, x, self.pipe_group,
                              self.cfg.pipeline_microbatches)

    def forward(self, tokens: torch.Tensor, cache: KVCache | None = None) -> torch.Tensor:
        """Logits; with ``cfg.xent_chunk`` > 0 outside decode mode, the
        final norm's hidden states instead, which the loss unembeds
        chunk-wise (``ops/xent.py``) without the full logits."""
        x, _ = self.hidden_states(tokens, cache)
        if self.cfg.xent_chunk > 0 and not self.cfg.decode:
            return x
        return unembed(x, self.unembedding())


@dataclasses.dataclass
class KVCache:
    """Decode mode's cache: per layer, K and V of shape (batch,
    max_seq_len, heads, head_dim) in ``cfg.dtype``, and the position the
    next token takes. The forward writes into it in place."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    pos: int = 0


def init_cache(cfg: ModelConfig, batch: int, device) -> KVCache:
    """An empty (zero) cache for ``batch`` sequences of decode-mode
    ``cfg``."""
    shape = (batch, cfg.max_seq_len, cfg.n_heads, cfg.d_model // cfg.n_heads)

    def zeros():
        return [torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(cfg.n_layers)]

    return KVCache(zeros(), zeros())


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> TransformerLM:
    """A model with random weights drawn from ``seed`` on ``device``: the
    card unless the caller asks for the CPU (``device.resolve_device``)."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TransformerLM(cfg, generator, device)


def forward(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (batch, seq, vocab) in f32 (hidden states under
    ``xent_chunk``)."""
    return model(tokens)


def forward_with_aux(model: TransformerLM, tokens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward``'s output and the summed MoE load-balance terms, an f32
    zero without MoE: the JAX ``forward_with_aux``."""
    x, aux = model.hidden_states(tokens)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if model.cfg.xent_chunk > 0:
        return x, aux
    return unembed(x, model.unembedding()), aux
