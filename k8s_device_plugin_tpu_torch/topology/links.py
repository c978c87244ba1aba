"""The node's cards and the links between them: the counterpart of the JAX
package's ``topology/mesh.py`` (``IciMesh``) for NVIDIA cards.

A TPU host's ICI mesh is fixed by its generation, and pairs are scored by
hop distance. NVIDIA cards talk over NVLink (to the peer, or through an
NVSwitch) or over PCIe, so a pair is scored by its link class, with the
reference's link-score table (utils.go:33-47), higher is better as in
JAX:

    CrossCPU (SYSTEM, "SYS")      1
    SameCPU (NODE, "NODE")        2
    HostBridge ("PHB")            3
    MultiSwitch ("PXB")           4     1 NVLink   4
    SingleSwitch ("PIX")          5     2 NVLinks  5
    SameBoard (INTERNAL)          6     3 NVLinks  6
                                        4-6 NVLinks 7-9, more capped at 9
    unknown                       0

A pair with NVLinks takes the NVLink score, a pair without its PCIe
class's. The class is what ``nvidia-smi topo -m`` prints for the pair:
``NV<n>`` with n NVLinks, else the PCIe label. Like ``IciMesh`` the whole
table is read once, at construction, and never again.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ..discovery import nvml
from ..discovery.chips import GpuChip

# nvmlGpuTopologyLevel_t -> (nvidia-smi's label, the reference's score)
PCIE_CLASSES = {
    nvml.TOPOLOGY_SYSTEM: ("SYS", 1),
    nvml.TOPOLOGY_NODE: ("NODE", 2),
    nvml.TOPOLOGY_HOSTBRIDGE: ("PHB", 3),
    nvml.TOPOLOGY_MULTIPLE: ("PXB", 4),
    nvml.TOPOLOGY_SINGLE: ("PIX", 5),
    nvml.TOPOLOGY_INTERNAL: ("BOARD", 6),
}
SCORE_MAX = 9


def score_for(nvlinks: int, pcie_level: Optional[int]) -> int:
    """The reference's score of a pair with ``nvlinks`` NVLinks and the PCIe
    ``nvmlGpuTopologyLevel_t`` ``pcie_level`` (None: unknown)."""
    if nvlinks > 0:
        return min(3 + nvlinks, SCORE_MAX)
    return PCIE_CLASSES.get(pcie_level, ("", 0))[1]


def class_label(nvlinks: int, pcie_level: Optional[int]) -> str:
    """The pair's class as ``nvidia-smi topo -m`` prints it."""
    if nvlinks > 0:
        return f"NV{nvlinks}"
    return PCIE_CLASSES.get(pcie_level, ("unknown", 0))[0]


class LinkTopology:
    """The node's cards and every pair's link, read from a backend with
    ``pair_link(a, b) -> (nvlinks, pcie_level)`` (``NvmlInfo``) over the
    cards' indices. ``neighbors`` are a card's NVLink peers and a set is
    contiguous when NVLink connects it; one card is a topology of one."""

    def __init__(self, chips: Sequence[GpuChip], backend):
        self.chips: List[GpuChip] = list(chips)
        self.by_id: Dict[str, GpuChip] = {c.device_id_str: c for c in self.chips}
        self._links: Dict[Tuple[str, str], Tuple[int, Optional[int]]] = {}
        for a, b in itertools.combinations(self.chips, 2):
            link = backend.pair_link(a.index, b.index)
            self._links[(a.device_id_str, b.device_id_str)] = link
            self._links[(b.device_id_str, a.device_id_str)] = link
        self._adjacency: Dict[str, List[str]] = {
            i: [j for j in self.ids if j != i and self._links[(i, j)][0] > 0]
            for i in self.ids
        }

    @property
    def ids(self) -> List[str]:
        return [c.device_id_str for c in self.chips]

    def neighbors(self, chip_id: str) -> List[str]:
        return self._adjacency[chip_id]

    def link_class(self, a: str, b: str) -> str:
        """The pair's class (``NV18``, ``SYS``, ...); ``X`` for a card with
        itself, as ``nvidia-smi topo -m`` prints it."""
        if a == b:
            return "X"
        return class_label(*self._links[(a, b)])

    def score_pair(self, a: str, b: str) -> int:
        if a == b:
            return SCORE_MAX
        return score_for(*self._links[(a, b)])

    def set_score(self, ids: Sequence[str]) -> float:
        """Average pairwise score of a card set (the reference's
        getAverageScore, topology.go:231-253, over the table read once)."""
        if len(ids) < 2:
            return float(SCORE_MAX)
        pairs = list(itertools.combinations(ids, 2))
        return sum(self.score_pair(a, b) for a, b in pairs) / len(pairs)

    def internal_links(self, ids: Sequence[str]) -> int:
        """Number of NVLink-connected pairs inside the set."""
        idset = set(ids)
        return sum(1 for i in ids for n in self._adjacency[i] if n in idset) // 2

    def is_contiguous(self, ids: Sequence[str]) -> bool:
        """True if the set is connected through its own NVLinks."""
        if not ids:
            return False
        idset = set(ids)
        seen = {next(iter(idset))}
        frontier = [next(iter(idset))]
        while frontier:
            cur = frontier.pop()
            for n in self._adjacency[cur]:
                if n in idset and n not in seen:
                    seen.add(n)
                    frontier.append(n)
        return seen == idset

    def pair_classes(self) -> Dict[str, str]:
        """``"<i>-<j>": class`` for every pair, by NVML index."""
        return {f"{a.index}-{b.index}": self.link_class(a.device_id_str, b.device_id_str)
                for a, b in itertools.combinations(sorted(self.chips, key=lambda c: c.index), 2)}
