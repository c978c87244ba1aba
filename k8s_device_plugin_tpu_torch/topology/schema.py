"""Node topology schema: the JSON the node daemon publishes as the node's
``nvidia.com/gpu-topology`` annotation, the GPU twin of the JAX package's
``topology/schema.py``.

The reference published a PCI/NUMA tree of GPUs for a scheduler extender
(device.go:8-97, server.go:287-309); the JAX package publishes its ICI
mesh. Here a scheduler reads, per card, what NVML says of it (UUID, NVML
index, minor and ``/dev/nvidia<minor>``, bus ID, NUMA node, memory, name)
and, per pair, the link class ``nvidia-smi topo -m`` prints and the
reference's score of it (``topology/links.py``), so it can place a
multi-card pod on the best-linked free set. ``available`` and ``failed``
are kept live by the publisher (``controller/wiring.py``), as in JAX;
``numa`` and ``host`` describe the host. The TPU-only fields (chip
coordinates, host bounds, torus, the multi-host slice) have no twin.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import platform
from typing import List, Optional

from ..discovery.chips import GpuChip
from .links import PCIE_CLASSES, LinkTopology, score_for

SCHEMA_VERSION = 1


@dataclasses.dataclass
class CardInfo:
    id: str  # the NVML UUID, the kubelet-facing device id
    index: int  # NVML's index
    minor: int  # of /dev/nvidia<minor>; -1 when the node is not named so
    dev_path: str
    pci_addr: str  # "" where NVML gives no bus ID
    numa_node: int  # -1 when unknown
    hbm_bytes: int
    name: str


@dataclasses.dataclass
class PairInfo:
    a: str
    b: str
    link: str  # "NV18", "SYS", ...: nvidia-smi topo -m's class of the pair
    score: int  # the reference's score of that class (topology/links.py)


@dataclasses.dataclass
class NodeTopology:
    version: int
    hostname: str
    # The card's entry in workload/chips.py ("H100", "H100 PCIe", ...) and
    # its product name as NVML gives it; "" on a node without cards.
    chip_type: str
    product: str
    chip_count: int
    numa_nodes: int
    chips: List[CardInfo]
    # Every pair of cards once, in NVML index order.
    pairs: List[PairInfo] = dataclasses.field(default_factory=list)
    # Card ids allocatable now (not allocated, not unhealthy), republished
    # on every allocation and health change.
    available: List[str] = dataclasses.field(default_factory=list)
    # Card ids withdrawn as unhealthy: absent from ``available`` like
    # allocated cards, published apart so a consumer can tell "a pod holds
    # it" from "it is broken under whoever holds it".
    failed: List[str] = dataclasses.field(default_factory=list)
    # [{node_id, mem_total_bytes, cpu_count}] per host NUMA node.
    numa: List[dict] = dataclasses.field(default_factory=list)
    # {mem_total_bytes, cpu_count, cpu_sockets, cpu_model}.
    host: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "NodeTopology":
        d = json.loads(s)
        # Unknown keys (top level, per card, per pair) are dropped, so an
        # older consumer parses a newer daemon's annotation; new fields
        # are additive and SCHEMA_VERSION bumps only on a breaking change.
        chips = [CardInfo(**_known(CardInfo, c)) for c in d.pop("chips", [])]
        pairs = [PairInfo(**_known(PairInfo, p)) for p in d.pop("pairs", [])]
        return NodeTopology(chips=chips, pairs=pairs,
                            **{k: v for k, v in _known(NodeTopology, d).items()
                               if k not in ("chips", "pairs")})

    @staticmethod
    def from_topology(
        topology: LinkTopology,
        numa_nodes: int = 1,
        hostname: Optional[str] = None,
        available: Optional[List[str]] = None,
        numa_info: Optional[List[dict]] = None,
        host_info: Optional[dict] = None,
        failed: Optional[List[str]] = None,
    ) -> "NodeTopology":
        chips = sorted(topology.chips, key=lambda c: c.index)
        first = chips[0] if chips else None
        return NodeTopology(
            version=SCHEMA_VERSION,
            hostname=hostname or platform.node(),
            chip_type=first.chip_type if first else "",
            product=first.name if first else "",
            chip_count=len(chips),
            numa_nodes=numa_nodes,
            available=sorted(available) if available is not None else sorted(topology.ids),
            failed=sorted(failed) if failed else [],
            numa=list(numa_info or []),
            host=dict(host_info or {}),
            chips=[
                CardInfo(
                    id=c.device_id_str,
                    index=c.index,
                    minor=minor_of(c.dev_path),
                    dev_path=c.dev_path,
                    pci_addr=c.pci_addr,
                    numa_node=c.numa_node,
                    hbm_bytes=c.hbm_bytes,
                    name=c.name,
                )
                for c in chips
            ],
            pairs=[
                PairInfo(a=a.device_id_str, b=b.device_id_str,
                         link=topology.link_class(a.device_id_str, b.device_id_str),
                         score=topology.score_pair(a.device_id_str, b.device_id_str))
                for a, b in itertools.combinations(chips, 2)
            ],
        )

    def to_topology(self) -> LinkTopology:
        """The published cards and pair classes as a ``LinkTopology``, the
        twin of the JAX ``to_mesh``: what a consumer of the annotation
        (``tools/topo.py --from-json``, the scheduler extender) places and
        scores on. Each pair reads back the class and score the daemon
        published.

        Memoized per instance, as ``to_mesh`` is: the topology depends only
        on the cards and pairs, which no consumer mutates after parsing (the
        one mutable field is ``available``, which it does not read)."""
        cached = self.__dict__.get("_topology")
        if cached is not None:
            return cached
        chips = [GpuChip(index=c.index, uuid=c.id, name=c.name, dev_path=c.dev_path,
                         pci_addr=c.pci_addr, numa_node=c.numa_node,
                         chip_type=self.chip_type, hbm_bytes=c.hbm_bytes)
                 for c in self.chips]
        topology = LinkTopology(chips, _PublishedLinks(self))
        self.__dict__["_topology"] = topology  # a plain attr: asdict/to_json skip it
        return topology


class _PublishedLinks:
    """``pair_link`` over an annotation's pair classes: ``NV<n>`` is n
    NVLinks, a PCIe label its ``nvmlGpuTopologyLevel_t``, anything else
    unknown."""

    def __init__(self, topo: NodeTopology):
        index = {c.id: c.index for c in topo.chips}
        levels = {label: level for level, (label, _) in PCIE_CLASSES.items()}
        self._links = {}
        for p in topo.pairs:
            if p.link.startswith("NV") and p.link[2:].isdigit():
                link = (int(p.link[2:]), None)
            else:
                link = (0, levels.get(p.link))
            self._links[frozenset((index[p.a], index[p.b]))] = link

    def pair_link(self, a: int, b: int):
        return self._links.get(frozenset((a, b)), (0, None))


def hgx_topology(host: str, cards: int, available: Optional[List[str]] = None) -> NodeTopology:
    """A synthetic HGX node of ``cards`` H100s as its daemon would publish
    it: card ids ``GPU-<host>-<i>``, every pair NV18 through NVSwitches;
    ``available`` its free card ids in the order given (every card when
    None). The one builder of such nodes: the eviction planes' and
    sharding's self-tests and the simulator's cluster."""
    chips = [CardInfo(id=f"GPU-{host}-{i}", index=i, minor=i, dev_path=f"/dev/nvidia{i}",
                      pci_addr="", numa_node=0, hbm_bytes=80 << 30,
                      name="NVIDIA H100 80GB HBM3") for i in range(cards)]
    return NodeTopology(
        version=SCHEMA_VERSION, hostname=host, chip_type="H100",
        product="NVIDIA H100 80GB HBM3", chip_count=cards, numa_nodes=1, chips=chips,
        pairs=[PairInfo(a=a.id, b=b.id, link="NV18", score=score_for(18, None))
               for a, b in itertools.combinations(chips, 2)],
        available=[c.id for c in chips] if available is None else list(available))


def _known(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def minor_of(dev_path: str) -> int:
    """The minor number of a ``/dev/nvidia<minor>`` path; -1 for any other
    name."""
    base = os.path.basename(dev_path)
    digits = base[len("nvidia"):]
    return int(digits) if base.startswith("nvidia") and digits.isdigit() else -1


# ---------------------------------------------------------------------------
# Annotation parse cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8192)
def _parse_template(raw: str) -> NodeTopology:
    """Parse and build the link topology once per distinct annotation
    string. Any failure (JSON, schema, a pair naming an unknown card) is a
    ValueError, so a consumer skips a malformed annotation with one except
    clause; lru_cache does not cache exceptions."""
    try:
        tmpl = NodeTopology.from_json(raw)
        tmpl.to_topology()  # memoize the topology on the template
    except Exception as e:  # noqa: BLE001 — untrusted input, normalized
        raise ValueError(f"bad topology annotation: {e!r}") from e
    return tmpl


def parse_topology_cached(raw: str) -> NodeTopology:
    """Parse a topology annotation through a process-wide LRU cache: a
    consumer re-reads the same string for every candidate node, and a
    republish is a new string, so caching on it is exact. Returns a clone
    whose ``available`` list is private (callers mutate it) while the cards,
    the pairs and the memoized ``LinkTopology`` are shared read-only. Raises
    ValueError on a malformed annotation."""
    tmpl = _parse_template(raw)
    clone = dataclasses.replace(tmpl, available=list(tmpl.available))
    clone.__dict__["_topology"] = tmpl.__dict__.get("_topology")
    return clone
