"""The benchmark's frozen arithmetic: the card's published peaks, the flash
kernels' least times, and the grouping of kernels by name.

Each is a copy, frozen here so that no change to the program can move the
yardstick it is measured by:

- the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
  700 W): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the
  CUDA cores, 3.35 TB/s of HBM;
- the flash bounds of the port's kernel table (``chip_smoke.py``'s
  ``attention_bound`` and ``delta_bound``): 2 operations per multiply-add
  over the s(s+1)/2 unmasked causal pairs, 2, 3 and 4 products for the
  forward, dQ and dK/dV passes, each input read once and each output
  written once, the larger of operations over peak and bytes over the
  memory rate;
- the kernel groups of ``workload/step_profile.py``'s ``GROUPS``, checked
  in order, the first match naming the group, after the benchmark's own
  first group, ``collective``: NCCL's kernels (``nccl`` in the name, any
  case), the model axis's sums on a cell of several cards.
"""

from __future__ import annotations

import re

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
MEMORY_BYTES_PER_S = 3.35e12

GROUPS = (
    ("collective", re.compile(r"nccl", re.I)),
    ("flash_fwd", re.compile(r"flash::fwd_kernel")),
    ("flash_bwd", re.compile(r"flash::\w*(dq|dkv|bwd)\w*")),
    ("rmsnorm", re.compile(r"rmsnorm::fwd_kernel")),
    ("matmul_f32", re.compile(r"sgemm|gemm_f32f32", re.I)),
    ("matmul", re.compile(r"gemm|xmma|cutlass|cublas|nvjet|sm90_", re.I)),
    ("optimizer", re.compile(r"multi_tensor|adam", re.I)),
    ("softmax_xent", re.compile(r"softmax|nll|log_softmax", re.I)),
)

# The four flash kernels of a training step by the name each launches
# under (``ops/csrc/flash_fwd.cu``, ``ops/csrc/flash_bwd.cu``), checked in
# this order: ``bwd_delta_kernel`` before the dQ and dK/dV passes.
FLASH_KERNELS = (
    ("delta", re.compile(r"flash::bwd_delta_kernel")),
    ("fwd", re.compile(r"flash::fwd_kernel")),
    ("dq", re.compile(r"flash::dq_kernel")),
    ("dkv", re.compile(r"flash::dkv_kernel")),
)


def group(name: str) -> str:
    """The kernel group of a device operation's name; ``other`` where no
    pattern matches (casts, adds, GELU, norms, copies)."""
    for g, pattern in GROUPS:
        if pattern.search(name):
            return g
    return "other"


def flash_kernel(name: str) -> str | None:
    """Which of the four flash kernels ``name`` is, or None."""
    for kind, pattern in FLASH_KERNELS:
        if pattern.search(name):
            return kind
    return None


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def bound_s(flops: float, peak_flops: float, nbytes: float) -> float:
    """The larger of the operations over their peak and the bytes over the
    memory rate, in seconds."""
    return max(flops / peak_flops, nbytes / MEMORY_BYTES_PER_S)


def flash_bound_s(kind: str, batch: int, heads: int, seq: int, head_dim: int) -> float:
    """Least time of one launch of a flash kernel on (batch, heads, seq,
    head_dim) bf16 tensors: ``fwd`` (QK^T, PV), ``dq`` (QK^T, dO V^T, dS K),
    ``dkv`` (QK^T, dO V^T, P^T dO, dS^T Q) on the bf16 tensor cores, or the
    ``delta`` prepass (O and dO read, delta written in f32) on the f32
    CUDA cores."""
    rows = batch * heads * seq
    if kind == "delta":
        return bound_s(2.0 * rows * head_dim, PEAK_F32_FLOPS, 2 * rows * head_dim * 2 + rows * 4)
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2.0 * products * head_dim * batch * heads * causal_pairs(seq)
    tensor = rows * head_dim * 2
    n_in, n_out = {"fwd": (3, 1), "dq": (5, 1), "dkv": (5, 2)}[kind]
    return bound_s(flops, PEAK_BF16_FLOPS, (n_in + n_out) * tensor + rows * 4)
