"""The tied unembed's three f32 products on the tensor cores: a 3xTF32
GEMM (``csrc/head_gemm.cu``), f32-accurate.

The full-logits LM head computes, with X (rows, d) the final norm's rows
in f32, E (vocab, d) the tied embedding and G (rows, vocab) the logits'
gradient:

- ``head_matmul_nt(X, E)`` = X . E^T, the logits (forward);
- ``head_matmul_nn(G, E)`` = G . E, dX (backward);
- ``head_matmul_tn(G, X)`` = G^T . X, dE (backward).

On a CUDA tensor each launches the kernel or raises; on a CPU tensor it
runs the plain version below, which does the kernel's arithmetic: every
operand value x is split into ``hi = rna_tf32(x)`` and
``lo = rna_tf32(x - hi)``, and the product is ``lo . hi + hi . lo +
hi . hi`` with f32 sums (``lo . lo``, below 2^-22 of each term, is left
out). The kernel takes contiguous 2-D f32 tensors on one card; anything
else raises. ``HeadProduct`` is the logits as an autograd function whose
backward is the other two products; ``model.unembed`` takes it where
``takes`` says the card gains by it.

The JAX package leaves this product to XLA (no Pallas kernel); on this
card cuBLAS runs f32 products with TF32 off on the CUDA cores, and the
kernel runs the same f32 product on the TF32 tensor cores.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from ..device import uses_kernel
from . import _build
from ._build import LAUNCHES

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# The C entry point's layout codes.
_LAYOUTS = {"nt": 0, "nn": 1, "tn": 2}
# Rows (batch x seq) from which ``model.unembed`` takes the kernel. Timed
# on an H100 SXM against torch.matmul in f32 at both full-logits cells'
# (d, vocab), the three products of a training step together: (2048,
# 32768) is faster on the kernel from 512 rows, (1600, 50257) from 768, and
# both are slower at 256. dX (rows x d, the whole vocab deep) sets it: its
# few output tiles take one wave of the kernel whatever the row count,
# where cuBLAS splits the depth. The logits alone win from 128 rows, but
# one rule serves both: forwards here have 8 rows (decoding) or 2048 and
# more.
MIN_ROWS = 768


def _on_one_card(x: torch.Tensor, embed: torch.Tensor) -> bool:
    return x.is_cuda and embed.is_cuda and x.device == embed.device


def takes(x: torch.Tensor, embed: torch.Tensor) -> bool:
    """Whether ``model.unembed`` runs ``x`` (..., d) against ``embed``
    (vocab, d) through the kernel: plain (not DTensor) f32 tensors on one
    card, their rows 16-byte aligned (d a multiple of 4), at least
    ``MIN_ROWS`` rows of x. Sharded tensors keep the einsum, whose
    collectives DTensor brings."""
    if isinstance(x, DTensor) or isinstance(embed, DTensor):
        return False
    if not _on_one_card(x, embed):
        return False
    if x.dtype != torch.float32 or embed.dtype != torch.float32:
        return False
    if x.shape[-1] % 4 or x.data_ptr() % 16 or not _aligned_rows(embed):
        return False
    return x.numel() // x.shape[-1] >= MIN_ROWS


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32's 10 fraction bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``): add half a TF32 unit to the
    magnitude's bits and clear the low 13. Finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): ``hi = rna_tf32(x)``, ``lo = rna_tf32(x - hi)``."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _three_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b as the kernel forms it: ``lo . hi + hi . lo + hi . hi``."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def head_matmul_nt_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) . b (n, k)^T by the kernel's arithmetic."""
    return _three_pass(a, b.T)


def head_matmul_nn_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) . b (k, n) by the kernel's arithmetic."""
    return _three_pass(a, b)


def head_matmul_tn_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (k, m)^T . b (k, n) by the kernel's arithmetic."""
    return _three_pass(a.T, b)


def _aligned_rows(t: torch.Tensor) -> bool:
    """Whether a 2-D f32 tensor's rows start 16-byte aligned, as a TMA
    tensor map needs them."""
    return t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0


def _check_device(t: torch.Tensor, first: torch.Tensor) -> None:
    if t.device.type != "cuda" or t.device != first.device:
        raise ValueError("head GEMM inputs must share one CUDA device")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for t in (a, b):
        _check_device(t, a)
        if t.dtype != torch.float32:
            raise TypeError(f"the head GEMM takes float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"the head GEMM takes 2-D operands, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("head GEMM inputs must be contiguous")
        if not (1 <= min(t.shape) and max(t.shape) < 2 ** 31):
            raise ValueError(f"unsupported head GEMM operand shape {tuple(t.shape)}")


def _launch(layout: str, a: torch.Tensor, b: torch.Tensor, m: int, n: int,
            k: int) -> torch.Tensor:
    """C (m, n) = the product ``layout`` of the checked a and b. b's rows,
    and for ``nt`` a's, must start 16-byte aligned (a multiple of 4 values
    long): the kernel loads them by TMA. a's rows need not for ``nn`` and
    ``tn``: G's are vocab values long, and gpt2-xl's 50,257 are copied 4
    bytes at a time."""
    for t in (a, b) if layout == "nt" else (b,):
        if not _aligned_rows(t):
            raise ValueError(f"{layout}: the head GEMM needs 16-byte aligned rows here, got "
                             f"{tuple(t.shape)} with row stride {t.stride(0)}")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    fn = _build.bind("head_gemm", "head_gemm", [_I, _P, _L, _P, _L, _P, _L] + [_I] * 3 + [_P])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_LAYOUTS[layout], a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                 out.data_ptr(), n, m, n, k, stream)
    _build.check(err, f"head_gemm {layout}")
    LAUNCHES["head_gemm"] += 1
    return out


def head_matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) . b (n, k)^T: the logits X . E^T."""
    if not uses_kernel(a):
        return head_matmul_nt_plain(a, b)
    _check(a, b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"nt: depths differ, {tuple(a.shape)} and {tuple(b.shape)}")
    return _launch("nt", a, b, a.shape[0], b.shape[0], a.shape[1])


def head_matmul_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) . b (k, n): dX = G . E."""
    if not uses_kernel(a):
        return head_matmul_nn_plain(a, b)
    _check(a, b)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"nn: depths differ, {tuple(a.shape)} and {tuple(b.shape)}")
    return _launch("nn", a, b, a.shape[0], b.shape[1], a.shape[1])


def head_matmul_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (k, m)^T . b (k, n): dE = G^T . X."""
    if not uses_kernel(a):
        return head_matmul_tn_plain(a, b)
    _check(a, b)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"tn: depths differ, {tuple(a.shape)} and {tuple(b.shape)}")
    return _launch("tn", a, b, a.shape[1], b.shape[1], a.shape[0])


class HeadProduct(torch.autograd.Function):
    """The logits X (rows, d) . E (vocab, d)^T, whose backward is the other
    two products: dX = G . E and dE = G^T . X. It keeps X and E for the
    backward, as the einsum does, and allocates only its outputs; nothing
    waits for the card, so a CUDA graph can capture it."""

    @staticmethod
    def forward(ctx, x2d, embed):
        ctx.save_for_backward(x2d, embed)
        return head_matmul_nt(x2d, embed)

    @staticmethod
    def backward(ctx, g):
        x2d, embed = ctx.saved_tensors
        g = g.contiguous()
        dx = head_matmul_nn(g, embed) if ctx.needs_input_grad[0] else None
        de = head_matmul_tn(g, x2d) if ctx.needs_input_grad[1] else None
        return dx, de


def head_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Logits (..., vocab) of f32 ``x`` (..., d) against ``embed`` (vocab,
    d) through ``HeadProduct``."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    return HeadProduct.apply(x2d, embed).reshape(*lead, embed.shape[0])
