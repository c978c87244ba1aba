"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from .attention import (
    LAUNCHES,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
    reference_attention,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_fwd_plain",
    "reference_attention",
    "reset_launches",
]
