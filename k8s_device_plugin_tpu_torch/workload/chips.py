"""The port's own accelerator table and allocation check: NVIDIA cards'
peaks and memory rate (the MFU denominator, the kernels' bounds and the
microbench's physics guards) and the device count the allocation promised
this container.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class CardSpec:
    """One card's published rates, dense (without sparsity)."""

    name: str
    peak_bf16_flops: float  # tensor cores
    peak_f32_flops: float  # CUDA cores, outside the tensor cores
    memory_bytes_per_s: float  # device memory (HBM)


# From NVIDIA's H100 data sheet. Checked in order: the first name found in
# the device name wins, so the PCIe and NVL parts come before plain "H100"
# (the SXM part, e.g. "NVIDIA H100 80GB HBM3").
CARDS = (
    CardSpec("H100 PCIe", 756e12, 51e12, 2.0e12),
    CardSpec("H100 NVL", 835e12, 60e12, 3.9e12),
    CardSpec("H100", 989e12, 67e12, 3.35e12),
)


def card_spec(device_kind: str) -> CardSpec | None:
    """The table's entry for a card named ``device_kind``; None when the
    card (or the CPU) is not in the table."""
    for spec in CARDS:
        if spec.name in device_kind:
            return spec
    return None


def peak_flops_for(device_kind: str, n_devices: int = 1) -> float | None:
    """Dense bf16 peak of ``n_devices`` cards named ``device_kind`` (the
    MFU denominator of a run over all of them); None when the card is not
    in the table, so the caller reports ``mfu: None`` instead of
    dividing."""
    spec = card_spec(device_kind)
    return spec.peak_bf16_flops * n_devices if spec else None


def _count(raw: str) -> int | None:
    raw = raw.strip()
    if raw in ("", "all"):
        return None
    if raw in ("none", "void", "-1"):
        return 0
    return len([c for c in raw.split(",") if c.strip() != ""])


def expected_device_count() -> int | None:
    """Cards the allocation promised this container: CUDA_VISIBLE_DEVICES,
    else NVIDIA_VISIBLE_DEVICES (the container runtime's list; "all" says
    nothing), else the device plugin's own TPU_PLUGIN_ALLOCATED_CHIPS.
    None when nothing says."""
    for var in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES"):
        if var in os.environ:
            n = _count(os.environ[var])
            if n is not None:
                return n
    allocated = os.environ.get("TPU_PLUGIN_ALLOCATED_CHIPS", "")
    if allocated:
        try:
            return int(allocated)
        except ValueError:
            return None
    return None
