"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

The RMSNorm function is not re-exported here, so that ``ops.rmsnorm`` stays
the module (``from ..ops.rmsnorm import rmsnorm`` for the function)."""

from ._build import LAUNCHES, reset_launches
from .attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
    reference_attention,
)
from .xent import chunked_softmax_xent, reference_softmax_xent

__all__ = [
    "LAUNCHES",
    "chunked_softmax_xent",
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_fwd_plain",
    "reference_attention",
    "reference_softmax_xent",
    "reset_launches",
]
