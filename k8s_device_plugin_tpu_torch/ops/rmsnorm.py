"""RMSNorm over the last axis, forward as a hand-written kernel: the
counterpart of the JAX package's ``ops/rmsnorm.py``.

On a CUDA tensor the forward launches a hand-written CUDA kernel for
``sm_90a`` (``csrc/rmsnorm.cu``); on a CPU tensor it runs the kernel's plain
PyTorch version below, which computes the same function with the same
casts. The kernel takes contiguous bf16 or f32 rows with a bf16 or f32
scale and a width that is a multiple of 8, at most 8192; anything else on
the card raises.

Numerics, as in the TPU kernel: per row in f32,
``rrms = rsqrt(mean(x^2) + eps)`` and ``y = x * rrms * scale``, with ``y``
rounded to **x's dtype** (not promoted: a bf16 input gives a bf16 output,
unlike flax's ``nn.RMSNorm``). ``rrms`` is kept as ``(rows, 1)`` f32 for the
backward, which is plain PyTorch, as the JAX backward is plain jnp: dx
comes back in x's dtype and dscale in scale's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import uses_kernel
from . import _build
from ._build import LAUNCHES

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The C entry point's dtype codes.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 8192


def rmsnorm_fwd_plain(x2d: torch.Tensor, scale: torch.Tensor, eps: float):
    """(y, rrms) as the kernel computes them: f32 statistics, y in x's
    dtype, rrms as (rows, 1) f32."""
    x = x2d.float()
    rrms = torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    y = (x * rrms * scale.float()).to(x2d.dtype)
    return y, rrms


def rmsnorm_fwd_kernel(x2d: torch.Tensor, scale: torch.Tensor, eps: float):
    """(y, rrms) from the CUDA kernel (replaces the TPU ``_rmsnorm_kernel``)."""
    if x2d.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x2d.shape[1]:
        raise ValueError(f"expected x (rows, d) and scale (d,), got {tuple(x2d.shape)} "
                         f"and {tuple(scale.shape)}")
    rows, d = x2d.shape
    if d % 8 or not 8 <= d <= MAX_WIDTH:
        raise ValueError(f"the RMSNorm kernel takes a width that is a multiple of 8 "
                         f"up to {MAX_WIDTH}, got {d}")
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"unsupported row count {rows}")
    for t in (x2d, scale):
        if t.device != x2d.device or t.device.type != "cuda":
            raise ValueError("RMSNorm kernel inputs must share one CUDA device")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("RMSNorm kernel inputs must be contiguous and 16-byte aligned")
    y = torch.empty_like(x2d)
    rrms = torch.empty(rows, 1, dtype=torch.float32, device=x2d.device)
    fn = _build.bind("rmsnorm", "rmsnorm_fwd", [_P] * 4 + [_I] * 4 + [_F, _P])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2d.data_ptr(), scale.data_ptr(), y.data_ptr(), rrms.data_ptr(),
                 rows, d, _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[scale.dtype], eps, stream)
    _build.check(err, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return y, rrms


def rmsnorm_fwd(x2d: torch.Tensor, scale: torch.Tensor, eps: float):
    """(y, rrms): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if uses_kernel(x2d):
        return rmsnorm_fwd_kernel(x2d, scale, eps)
    return rmsnorm_fwd_plain(x2d, scale, eps)


def rmsnorm_bwd(x2d: torch.Tensor, rrms: torch.Tensor, scale: torch.Tensor,
                g: torch.Tensor):
    """(dx, dscale) from the saved (x2d, rrms, scale), term for term as the
    JAX ``_vjp_bwd``: with gs = g * scale in f32,
    dx = rrms * (gs - x * mean(gs * x) * rrms^2) in x's dtype and
    dscale = sum over rows of g * x * rrms in scale's dtype."""
    d = x2d.shape[-1]
    g2d = g.reshape(-1, d).float()
    xf = x2d.float()
    gs = g2d * scale.float()
    inner = (gs * xf).mean(-1, keepdim=True)
    dx = rrms * (gs - xf * inner * rrms * rrms)
    dscale = (g2d * xf * rrms).sum(0)
    return dx.to(x2d.dtype).reshape(g.shape), dscale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward reads the forward's own rrms, as the JAX
    ``custom_vjp`` saves the kernel's residuals."""

    @staticmethod
    def forward(ctx, x2d, scale, eps):
        y, rrms = rmsnorm_fwd(x2d, scale, eps)
        ctx.save_for_backward(x2d, rrms, scale)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, rrms, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2d, rrms, scale, g)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * scale / sqrt(mean(x^2, -1) + eps)`` over x of any leading shape
    and scale of shape (d,); differentiable in x and scale."""
    shape = x.shape
    y = RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), scale.contiguous(), eps)
    return y.reshape(shape)
