"""The least times of the flash kernels at multi-head latent attention's
head widths, where q and k heads (d_qk) are wider than v heads (d_v):
frozen here, beside ``arith.py``'s equal-width bounds, so that no change to
the program can move them.

Over the s(s+1)/2 unmasked causal pairs P of a head, 2 operations per
multiply-add:

- ``fwd`` (Q K^T, P V): 2 P (d_qk + d_v);
- ``dq`` (Q K^T, dO V^T, dS K): 2 P (2 d_qk + d_v);
- ``dkv`` (Q K^T, dO V^T, P^T dO, dS^T Q): 2 P (2 d_qk + 2 d_v);

on the bf16 tensor cores' 989 TFLOP/s. Bytes: each input read once and
each output written once, at its own width (bf16 rows, f32 lse and delta).
The ``delta`` prepass reads O and dO (d_v) and writes delta, against one
f32 multiply-add per element on the CUDA cores. A bound is the larger of
operations over peak and bytes over 3.35 TB/s.
"""

from __future__ import annotations

from .arith import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_s, causal_pairs

# Per kind: the products' widths (as multiples of d_qk, d_v), and the bf16
# inputs and outputs (each a q.k or a v width) besides lse and delta.
_PRODUCTS = {"fwd": (1, 1), "dq": (2, 1), "dkv": (2, 2)}
_TENSORS = {  # (q.k-wide, v-wide, f32 rows) read and written
    "fwd": (2 + 0, 1 + 1, 1),    # q, k; v, o; lse
    "dq": (2 + 1, 2, 2),         # q, k, dq; v, dO; lse, delta
    "dkv": (2 + 1, 2 + 1, 2),    # q, k, dk; v, dO, dv; lse, delta
}


def flash_bound_s(kind: str, batch: int, heads: int, seq: int, d_qk: int, d_v: int) -> float:
    """Least time of one launch of a flash kernel on (batch, heads, seq)
    rows of q.k heads d_qk and v heads d_v: ``fwd``, ``dq``, ``dkv`` or
    ``delta``."""
    rows = batch * heads * seq
    if kind == "delta":
        return bound_s(2.0 * rows * d_v, PEAK_F32_FLOPS, 2 * rows * d_v * 2 + rows * 4)
    a, b = _PRODUCTS[kind]
    flops = 2.0 * causal_pairs(seq) * (a * d_qk + b * d_v) * batch * heads
    n_qk, n_v, n_f32 = _TENSORS[kind]
    nbytes = rows * (2 * (n_qk * d_qk + n_v * d_v) + 4 * n_f32)
    return bound_s(flops, PEAK_BF16_FLOPS, nbytes)
