"""The port's own accelerator table and allocation check: NVIDIA cards'
dense bf16 peak (the MFU denominator) and the device count the
allocation promised this container.
"""

from __future__ import annotations

import os

# Dense bf16 tensor-core peak in FLOP/s, without sparsity, from NVIDIA's
# H100 data sheet. Checked in order: the first substring found in the
# device name wins, so the PCIe and NVL parts come before plain "H100"
# (the SXM part, e.g. "NVIDIA H100 80GB HBM3").
PEAK_BF16_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
)


def peak_flops_for(device_kind: str) -> float | None:
    """Dense bf16 peak of one card named ``device_kind``; None when the
    card (or the CPU) is not in the table, so the caller reports
    ``mfu: None`` instead of dividing."""
    for needle, peak in PEAK_BF16_FLOPS:
        if needle in device_kind:
            return peak
    return None


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
