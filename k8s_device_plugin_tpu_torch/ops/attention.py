"""Causal flash attention, forward and backward, over (batch, heads, seq,
head_dim) tensors: the counterpart of the JAX package's ``ops/attention.py``.

On a CUDA tensor each pass launches a hand-written CUDA kernel for
``sm_90a`` (``csrc/flash_fwd.cu``; the backward's delta prepass, dQ and
dK/dV kernels in ``csrc/flash_bwd.cu``); on a CPU tensor it runs the
kernel's plain PyTorch version below, which computes the same function
with the same casts. The kernels take bf16, contiguous inputs whose (q.k,
v) head widths are one of ``HEAD_WIDTHS``: equal heads of 64 or 128, or
multi-head latent attention's q.k heads of 192 (128 latent and 64 rotary
dims) over v heads of 128; anything else on the card raises. q and k share
the q.k width, v, o and dO the v width.

Numerics, as in the TPU kernels: scores ``scale * q.k`` in f32 with
``scale = 1/sqrt(d_qk)`` (the q.k head's width) as a Python float, causal entries masked to
-1e30, the probabilities rounded to the input dtype before each product
with V, dO or Q, and the logsumexp ``lse`` kept in f32 for the backward.
``lse`` is stored as ``(batch*heads, seq)``.

The depth of each kernel's ring of streamed tiles is a template parameter
of the CUDA source, built for a fixed set of depths (``FWD_STAGES``,
``BWD_STAGES``) and chosen per call, as the JAX ``flash_attention`` takes
its tiling per call; the defaults are the depths the main path runs (the
forward's deepest that fits the head widths: at q.k heads of 192 four
stages pass a block's shared memory, so that pair is built for 2 and 3).
On a CPU tensor a depth is checked and then has no effect: the plain
version has no ring.

Each kernel wrapper counts its launches in the shared ``LAUNCHES`` table
of ``_build.py`` (and nowhere else; every depth under its kernel's name),
so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import uses_kernel
from . import _build
from ._build import LAUNCHES

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The (q.k, v) head widths the kernels are built for.
HEAD_WIDTHS = ((64, 64), (128, 128), (192, 128))
# Ring depths the kernels are built for (csrc/flash_fwd.cu: the K/V ring;
# csrc/flash_bwd.cu: the streamed tiles of dQ and dK/dV), and the ones the
# main path runs; the forward's at (192, 128) stop at 3
# (``fwd_stages_for``).
FWD_STAGES = (2, 3, 4)
BWD_STAGES = (2, 3)
DEFAULT_FWD_STAGES = 4
DEFAULT_BWD_STAGES = 2
MLA_FWD_STAGES = (2, 3)


def check_stages(fwd_stages: int = DEFAULT_FWD_STAGES,
                 bwd_stages: int = DEFAULT_BWD_STAGES) -> None:
    """Raise on a ring depth the kernels are not built for, on any device."""
    if fwd_stages not in FWD_STAGES:
        raise ValueError(f"forward ring depth {fwd_stages!r} not in {FWD_STAGES}")
    if bwd_stages not in BWD_STAGES:
        raise ValueError(f"backward ring depth {bwd_stages!r} not in {BWD_STAGES}")


def fwd_stages_for(d_qk: int, d_v: int, stages: int | None = None) -> int:
    """The forward's ring depth at these head widths: ``stages``, checked
    (``check_stages``, and at most 3 where the q.k head is wider than the v
    head), or by default the deepest built for them."""
    split = d_qk != d_v
    if stages is None:
        return MLA_FWD_STAGES[-1] if split else DEFAULT_FWD_STAGES
    check_stages(fwd_stages=stages)
    if split and stages not in MLA_FWD_STAGES:
        raise ValueError(f"forward ring depth {stages!r} not in {MLA_FWD_STAGES} at head "
                         f"widths ({d_qk}, {d_v})")
    return stages


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def _causal_mask(seq: int, device) -> torch.Tensor:
    return torch.ones(seq, seq, dtype=torch.bool, device=device).tril()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v):
    """(o, lse) of causal attention, computed as the forward kernel does:
    f32 scores of the input-dtype operands, p = exp(s - rowmax) rounded to
    the input dtype before P.V, o = (P.V) / rowsum(p) in the input dtype,
    lse = rowmax + log(rowsum(p)) in f32 with shape (b*h, seq)."""
    b, h, seq, d = q.shape
    s = _scale(d) * (q.float() @ k.float().transpose(-1, -2))
    s = s.masked_fill(~_causal_mask(seq, q.device), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(v.dtype).float() @ v.float()) / l
    lse = (m + torch.log(l)).reshape(b * h, seq)
    return o.to(q.dtype), lse


def flash_bwd_delta_plain(o, do):
    """delta = rowsum(dO * O) in f32 as ``(b*h, seq)``: the value the TPU
    kernels recompute in every tile, and the prepass kernel computes once
    per backward."""
    b, h, seq, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * h, seq)


def _bwd_terms(q, k, v, o, lse, do, delta=None):
    """(P, dS) in f32, as both backward kernels rebuild them: P from lse,
    dS = P*(dP - delta) with dP = dO.V^T and delta = rowsum(dO*O) unless
    given."""
    b, h, seq, d = q.shape
    s = _scale(d) * (q.float() @ k.float().transpose(-1, -2))
    s = s.masked_fill(~_causal_mask(seq, q.device), NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, seq, 1))
    dp = do.float() @ v.float().transpose(-1, -2)
    if delta is None:
        delta = flash_bwd_delta_plain(o, do)
    return p, p * (dp - delta.reshape(b, h, seq, 1))


def flash_dq_plain(q, k, v, o, lse, do, delta=None):
    """dq as the dQ kernel computes it: dS rounded to the input dtype
    before dS.K, f32 accumulation, the result in the input dtype."""
    _, ds = _bwd_terms(q, k, v, o, lse, do, delta)
    dq = _scale(q.shape[-1]) * (ds.to(q.dtype).float() @ k.float())
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, o, lse, do, delta=None):
    """(dk, dv) as the dK/dV kernel computes them: P and dS rounded to the
    input dtype before P^T.dO and dS^T.Q, f32 accumulation, the results in
    the input dtype."""
    p, ds = _bwd_terms(q, k, v, o, lse, do, delta)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ do.float()
    dk = _scale(q.shape[-1]) * (ds.to(q.dtype).float().transpose(-1, -2) @ q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, delta=None):
    """(dq, dk, dv) from the saved forward: the plain versions of both
    backward kernels, sharing one delta."""
    if delta is None:
        delta = flash_bwd_delta_plain(o, do)
    return (flash_dq_plain(q, k, v, o, lse, do, delta),
            *flash_dkv_plain(q, k, v, o, lse, do, delta))


# How far a kernel's bf16 output may sit from its plain version. Both round
# the same f32 values to bf16 at the same places and differ only in f32
# summation order and in exp. That moves an element by about one bf16 ulp,
# at most 2^-7 of its value, and an element that is the small difference
# of large terms by a small share of the tensor's rms. Element by element:
#   |kernel - plain| <= BF16_ULP_SHARE * |plain| + BF16_RMS_SHARE * rms(plain),
# and over the tensor ||kernel - plain|| <= BF16_REL_NORM * ||plain||.
# At the bench shape on an H100 the kernels need an rms share of at most
# 0.014 and reach a relative error of at most 1.5e-3 (chip_smoke.py); a
# forward that weights each row's diagonal kv tile by 1.01 needs 0.17
# (tests/test_torch_tolerance.py).
BF16_ULP_SHARE = 2.0 ** -7
BF16_RMS_SHARE = 4e-2
BF16_REL_NORM = 1e-2
# delta (f32 in both versions, the same exact bf16 products summed in
# another order): max |kernel - plain| over max |plain|.
DELTA_RTOL = 1e-5


def bf16_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How a kernel's bf16 output ``got`` agrees with its plain version
    ``want``: ``ok`` under the rule above, the largest absolute error,
    ``worst_share`` (the largest error over its element's limit; at most 1
    passes), ``rms_share_needed`` (the least BF16_RMS_SHARE that would
    pass) and ``rel_err`` (the relative Frobenius error)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.square().mean().sqrt()
    ulp_part = BF16_ULP_SHARE * w.abs()
    limit = ulp_part + BF16_RMS_SHARE * rms
    worst = float(torch.where(err == 0, 0.0, err / limit).max())
    needed = float((err - ulp_part).clamp_min(0).max() / rms.clamp_min(1e-30))
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
    finite = bool(torch.isfinite(g).all())
    return {
        "ok": finite and worst <= 1.0 and rel <= BF16_REL_NORM,
        "max_abs_err": float(err.max()),
        "worst_share": worst,
        "rms_share_needed": needed,
        "rel_err": rel,
    }


def reference_attention(q, k, v):
    """Plain causal attention in f32 (the correctness oracle), cast back
    to the input dtype: the counterpart of the JAX package's
    ``reference_attention``."""
    seq, d = q.shape[-2], q.shape[-1]
    s = (q @ k.transpose(-1, -2)).float() / (d ** 0.5)
    s = s.masked_fill(~_causal_mask(seq, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_rows_f32(name, t, ref, b, h, seq):
    if (t.device != ref.device or t.dtype != torch.float32
            or t.shape != (b * h, seq) or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 "
                         "(batch*heads, seq) tensor on the inputs' device")


def _check_kernel_inputs(qk, vo, lse: torch.Tensor | None = None,
                         delta: torch.Tensor | None = None):
    """Raise on anything the kernels do not take. ``qk`` holds the
    tensors of the q.k head's width (q, k; may be empty), ``vo`` those of
    the v head's (v, o, dO). Returns (batch, heads, seq, d_qk, d_v), d_qk
    None where ``qk`` is empty."""
    ref = (qk or vo)[0]
    if ref.dim() != 4:
        raise ValueError(f"expected (batch, heads, seq, head_dim), got {tuple(ref.shape)}")
    b, h, seq = ref.shape[:3]
    d = qk[0].shape[-1] if qk else None
    dv = vo[0].shape[-1]
    if qk and (d, dv) not in HEAD_WIDTHS:
        raise ValueError(f"flash kernels take (q.k, v) head_dim pairs in {HEAD_WIDTHS}, "
                         f"got {(d, dv)}")
    if not qk and dv not in {w for _, w in HEAD_WIDTHS}:
        raise ValueError(f"flash kernels take v head_dim in {sorted({w for _, w in HEAD_WIDTHS})}, "
                         f"got {dv}")
    if seq < 1 or b * h < 1 or b * h > 65535 or b * h * seq >= 2 ** 31:
        raise ValueError(f"unsupported batch*heads {b * h} or seq {seq}")
    for group, width in ((qk, d), (vo, dv)):
        for t in group:
            if t.device != ref.device or t.device.type != "cuda":
                raise ValueError("flash kernel inputs must share one CUDA device")
            if t.dtype != torch.bfloat16:
                raise TypeError(f"flash kernels take bfloat16, got {t.dtype}")
            if t.shape != (b, h, seq, width):
                raise ValueError(f"shape mismatch {tuple(t.shape)} vs {(b, h, seq, width)}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("flash kernel inputs must be contiguous and 16-byte aligned")
    if lse is not None:
        _check_rows_f32("lse", lse, ref, b, h, seq)
    if delta is not None:
        _check_rows_f32("delta", delta, ref, b, h, seq)
    return b, h, seq, d, dv


def flash_fwd_kernel(q, k, v, stages=None):
    """(o, lse) from the CUDA forward kernel (replaces the TPU
    ``_fwd_kernel``), its K/V ring ``stages`` deep (``fwd_stages_for``)."""
    stages = fwd_stages_for(q.shape[-1], v.shape[-1], stages)
    b, h, seq, d, dv = _check_kernel_inputs((q, k), (v,))
    o = torch.empty_like(v)
    lse = torch.empty(b * h, seq, dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_fwd", "flash_fwd", [_P] * 5 + [_I] * 5 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * h, seq, d, dv, stages, _scale(d), stream)
    _build.check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_delta_kernel(o, do):
    """delta = rowsum(dO * O), f32 ``(b*h, seq)``, from the CUDA prepass
    (the per-tile delta of the TPU ``_dq_kernel`` and ``_dkv_kernel``)."""
    b, h, seq, _, d = _check_kernel_inputs((), (o, do))
    delta = torch.empty(b * h, seq, dtype=torch.float32, device=o.device)
    fn = _build.bind("flash_bwd", "flash_bwd_delta", [_P] * 3 + [_I, _I, _P])
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), b * h * seq, d, stream)
    _build.check(err, "flash_bwd_delta")
    LAUNCHES["flash_bwd_delta"] += 1
    return delta


def flash_dq_kernel(q, k, v, o, lse, do, delta=None, stages=DEFAULT_BWD_STAGES):
    """dq from the CUDA dQ kernel (replaces the TPU ``_dq_kernel``), its
    ring of kv tiles ``stages`` deep. Without ``delta`` it launches the
    prepass first."""
    check_stages(bwd_stages=stages)
    b, h, seq, d, dv = _check_kernel_inputs((q, k), (v, o, do), lse=lse, delta=delta)
    if delta is None:
        delta = flash_bwd_delta_kernel(o, do)
    dq = torch.empty_like(q)
    fn = _build.bind("flash_bwd", "flash_dq", [_P] * 7 + [_I] * 5 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), b * h, seq, d, dv, stages, _scale(d), stream)
    _build.check(err, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv_kernel(q, k, v, o, lse, do, delta=None, stages=DEFAULT_BWD_STAGES):
    """(dk, dv) from the CUDA dK/dV kernel (replaces the TPU
    ``_dkv_kernel``), its ring of q tiles ``stages`` deep. Without
    ``delta`` it launches the prepass first."""
    check_stages(bwd_stages=stages)
    b, h, seq, d, d_v = _check_kernel_inputs((q, k), (v, o, do), lse=lse, delta=delta)
    if delta is None:
        delta = flash_bwd_delta_kernel(o, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.bind("flash_bwd", "flash_dkv", [_P] * 8 + [_I] * 5 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, seq, d, d_v, stages,
                 _scale(d), stream)
    _build.check(err, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------

def flash_attention_fwd(q, k, v, stages=None):
    """(o, lse): the CUDA kernel of ring depth ``stages``
    (``fwd_stages_for``) for CUDA tensors, the plain version for CPU
    tensors."""
    stages = fwd_stages_for(q.shape[-1], v.shape[-1], stages)
    if uses_kernel(q):
        return flash_fwd_kernel(q, k, v, stages)
    return flash_attention_fwd_plain(q, k, v)


def flash_attention_bwd(q, k, v, o, lse, do, delta=None, stages=DEFAULT_BWD_STAGES):
    """(dq, dk, dv): for CUDA tensors the delta prepass (unless ``delta``
    is given) and the dQ and dK/dV kernels of ring depth ``stages``, which
    share its delta; the plain version for CPU tensors."""
    check_stages(bwd_stages=stages)
    if uses_kernel(q):
        if delta is None:
            delta = flash_bwd_delta_kernel(o, do)
        dq = flash_dq_kernel(q, k, v, o, lse, do, delta=delta, stages=stages)
        dk, dv = flash_dkv_kernel(q, k, v, o, lse, do, delta=delta, stages=stages)
        return dq, dk, dv
    return flash_attention_bwd_plain(q, k, v, o, lse, do, delta)


class FlashAttention(torch.autograd.Function):
    """Causal flash attention whose gradient runs the backward kernels;
    the counterpart of the JAX ``custom_vjp``. The backward runs at the
    ring depth the forward was given."""

    @staticmethod
    def forward(ctx, q, k, v, fwd_stages=None, bwd_stages=DEFAULT_BWD_STAGES):
        o, lse = flash_attention_fwd(q, k, v, fwd_stages)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.bwd_stages = bwd_stages
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), stages=ctx.bwd_stages)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    fwd_stages: int | None = None,
                    bwd_stages: int = DEFAULT_BWD_STAGES) -> torch.Tensor:
    """Causal attention over (batch, heads, seq, head_dim) tensors, the
    layout of the JAX package's ``flash_attention``; v (and the output) may
    have a narrower head than q and k (``HEAD_WIDTHS``). Inputs are made
    contiguous, as the kernels read rows of the (b*h, seq, d) layout.
    ``fwd_stages`` (default: ``fwd_stages_for``'s) and ``bwd_stages`` pick
    the kernels' ring depths (the counterpart of the JAX function's
    ``block_q`` and ``block_kv``), checked on every device."""
    fwd_stages = fwd_stages_for(q.shape[-1], v.shape[-1], fwd_stages)
    check_stages(bwd_stages=bwd_stages)
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                fwd_stages, bwd_stages)

