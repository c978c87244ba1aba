"""The card model of the node daemon: the counterpart of the JAX package's
``discovery/chips.py``.

Where the TPU model is a static table keyed by chip generation, an NVIDIA
card describes itself through NVML (the reference's per-GPU NVML state,
nvml.go:201-266): ``GpuChip`` holds what the scanner reads, and the card's
rates come from the port's one table, ``workload/chips.py``. The
telemetry records keep the JAX fields, so the health watcher and a
telemetry sampler read them unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class IciLinkTelemetry:
    """State of one link of the card: for an NVIDIA card one NVLink,
    numbered as NVML numbers them. ``errors`` is cumulative (0 where the
    backend reads no error counter)."""

    link: int
    up: bool
    errors: int


@dataclasses.dataclass(frozen=True)
class ChipTelemetry:
    """One card's runtime counters.

    Every field is optional and ``None`` means "not read", never 0: a card
    idling at duty 0 and a card whose counter could not be read are
    different facts, and an exporter must not invent zeros for the latter.
    """

    index: int
    duty_cycle_pct: Optional[float] = None
    hbm_used_bytes: Optional[int] = None
    temp_c: Optional[float] = None
    power_w: Optional[float] = None
    links: Tuple[IciLinkTelemetry, ...] = ()

    def hbm_used_ratio(self, hbm_total_bytes: int) -> Optional[float]:
        """Device-memory pressure as a 0–1 fraction, or None when it cannot
        be computed: used bytes unread, or no known total."""
        if self.hbm_used_bytes is None or hbm_total_bytes <= 0:
            return None
        return min(max(self.hbm_used_bytes / hbm_total_bytes, 0.0), 1.0)

    def to_dict(self, hbm_total_bytes: int = 0) -> dict:
        """JSON-able form; ``hbm_used_pct`` is null (not 0) where the total
        is unknown."""
        ratio = self.hbm_used_ratio(hbm_total_bytes)
        return {
            "index": self.index,
            "duty_cycle_pct": self.duty_cycle_pct,
            "hbm_used_bytes": self.hbm_used_bytes,
            "hbm_total_bytes": hbm_total_bytes or None,
            "hbm_used_pct": round(ratio * 100.0, 1) if ratio is not None else None,
            "temp_c": self.temp_c,
            "power_w": self.power_w,
            "links": [dataclasses.asdict(l) for l in self.links],
        }


@dataclasses.dataclass(frozen=True)
class GpuChip:
    """One discovered NVIDIA card.

    ``index`` is the card's NVML index (NVML sees every card of the node,
    whatever ``CUDA_VISIBLE_DEVICES`` says), ``dev_path`` its
    ``/dev/nvidia<minor>`` node, ``pci_addr`` its bus ID in sysfs form
    (``0000:18:00.0``; "" where NVML will not give it, as in a container
    that hides the PCI tree). ``device_id_str`` is the kubelet-facing ID:
    the NVML UUID, as in the reference (nvidia.go:28). ``chip_type`` names
    the card's entry in ``workload/chips.py`` ("unknown" when it has none),
    and ``hbm_bytes`` is its memory total as NVML reads it.
    """

    index: int
    uuid: str
    name: str
    dev_path: str
    pci_addr: str
    numa_node: int
    chip_type: str
    hbm_bytes: int

    @property
    def device_id_str(self) -> str:
        return self.uuid

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["id"] = self.device_id_str
        return d
