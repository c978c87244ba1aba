"""Device policy: the counterpart of the JAX package's ``ops/_common.py``.

The JAX ``interpret_mode()`` switch (Pallas compiled on a TPU, interpreted
on the CPU) becomes a rule on the tensor a wrapper is given: a CPU tensor
goes through the kernel's plain PyTorch version, a CUDA tensor through the
hand-written kernel, and anything else raises. There is no fallback from a
kernel to its plain version on the card.
"""

from __future__ import annotations

import torch


def _strict_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    TF32 keeps about three decimal digits; the parity tests and the
    kernels' plain versions compare float32 results with the JAX
    reference, so TF32 is switched off explicitly for both the cuBLAS
    and the cuDNN paths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for the CPU. Raises when CUDA is needed and absent; never
    carries on silently on the CPU."""
    _strict_float32()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the hand-written kernel), False for
    a CPU tensor (use the plain version). Raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on unsupported device {t.device}")
