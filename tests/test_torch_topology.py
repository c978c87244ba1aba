"""The port's link topology (topology/links.py): the reference's link-score
table, the NVSwitch case, and the method contract of the JAX ``IciMesh``,
over a scripted backend and over the fake NVML library."""

import itertools

import pytest

from k8s_device_plugin_tpu.discovery.chips import TpuChip
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu_torch.discovery import nvml
from k8s_device_plugin_tpu_torch.discovery.chips import GpuChip
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.topology import links
from tests import torch_fake_nvml as fk

# The reference's table (utils.go:33-47), by PCIe class without NVLink.
PCIE = [
    (nvml.TOPOLOGY_SYSTEM, "SYS", 1),
    (nvml.TOPOLOGY_NODE, "NODE", 2),
    (nvml.TOPOLOGY_HOSTBRIDGE, "PHB", 3),
    (nvml.TOPOLOGY_MULTIPLE, "PXB", 4),
    (nvml.TOPOLOGY_SINGLE, "PIX", 5),
    (nvml.TOPOLOGY_INTERNAL, "BOARD", 6),
    (None, "unknown", 0),
    (99, "unknown", 0),
]


@pytest.mark.parametrize("level, label, score", PCIE)
def test_pcie_classes_score_as_the_reference(level, label, score):
    assert links.score_for(0, level) == score
    assert links.class_label(0, level) == label


@pytest.mark.parametrize("n, score", [(1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (7, 9),
                                      (12, 9), (18, 9)])
def test_nvlink_counts_score_as_the_reference_capped_at_9(n, score):
    for level in (None, nvml.TOPOLOGY_SYSTEM, nvml.TOPOLOGY_INTERNAL):
        assert links.score_for(n, level) == score
        assert links.class_label(n, level) == f"NV{n}"


def _chip(i):
    return GpuChip(index=i, uuid=fk.hgx_uuid(i), name=fk.H100, dev_path=f"/dev/nvidia{i}",
                   pci_addr=f"0000:{i:02x}:00.0", numa_node=0, chip_type="H100",
                   hbm_bytes=fk.H100_BYTES)


class Table:
    """A backend whose pair links are given: {(a, b): (nvlinks, level)}."""

    def __init__(self, table):
        self.table = table
        self.queries = 0

    def pair_link(self, a, b):
        self.queries += 1
        return self.table.get((a, b)) or self.table[(b, a)]


def test_topology_reads_each_pair_once_and_answers_from_the_table():
    # cards 0-1 and 2-3 NVLink pairs (NVLink bridges), PCIe between pairs
    table = {(0, 1): (4, nvml.TOPOLOGY_SINGLE), (2, 3): (4, nvml.TOPOLOGY_SINGLE),
             (0, 2): (0, nvml.TOPOLOGY_NODE), (0, 3): (0, nvml.TOPOLOGY_NODE),
             (1, 2): (0, nvml.TOPOLOGY_SYSTEM), (1, 3): (0, nvml.TOPOLOGY_SYSTEM)}
    backend = Table(table)
    topo = links.LinkTopology([_chip(i) for i in range(4)], backend)
    assert backend.queries == 6
    ids = topo.ids
    assert topo.neighbors(ids[0]) == [ids[1]] and topo.neighbors(ids[3]) == [ids[2]]
    assert topo.score_pair(ids[0], ids[1]) == 7 and topo.score_pair(ids[1], ids[2]) == 1
    assert topo.link_class(ids[0], ids[2]) == "NODE" and topo.link_class(ids[0], ids[0]) == "X"
    assert topo.is_contiguous(ids[:2]) and not topo.is_contiguous(ids[1:3])
    assert not topo.is_contiguous(ids) and topo.is_contiguous([ids[3]])
    assert topo.internal_links(ids) == 2
    assert topo.set_score(ids[:2]) == 7.0
    assert topo.set_score(ids) == pytest.approx((7 + 7 + 2 + 2 + 1 + 1) / 6)
    assert topo.pair_classes() == {"0-1": "NV4", "0-2": "NODE", "0-3": "NODE",
                                   "1-2": "SYS", "1-3": "SYS", "2-3": "NV4"}
    assert backend.queries == 6  # nothing read again


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


def test_nvswitch_links_score_9_not_0(fake, tmp_path):
    """HGX: every NVLink goes to an NVSwitch, none to the peer card. Counting
    only links whose far end is the peer gives 0; the switch links of both
    cards, confirmed by the pair's NVLink P2P status, give NV18 and 9."""
    fake.reset()
    fk.hgx_node(fake, tmp_path)
    with NvmlInfo(fake.path) as info:
        chips = info.scan(str(tmp_path), "/dev")
        topo = links.LinkTopology(chips, info)
    assert set(topo.pair_classes().values()) == {"NV18"}
    assert all(topo.score_pair(a, b) == 9 for a, b in itertools.combinations(topo.ids, 2))
    assert topo.is_contiguous(topo.ids) and topo.internal_links(topo.ids) == 6


def test_without_nvlink_p2p_switch_links_do_not_count(fake, tmp_path):
    fake.reset()
    fk.hgx_node(fake, tmp_path, n=2)
    fake.set_p2p_nvlink(0, 1, fk.P2P_NOT_SUPPORTED)
    with NvmlInfo(fake.path) as info:
        topo = links.LinkTopology(info.scan(str(tmp_path), "/dev"), info)
    assert topo.pair_classes() == {"0-1": "NODE"}
    assert topo.score_pair(*topo.ids) == 2


def test_fewer_switch_links_on_one_card_take_the_lesser(fake, tmp_path):
    fake.reset()
    fk.hgx_node(fake, tmp_path, n=2)
    for link in range(12, 18):
        fake.set_link(0, link, active=False)  # card 0: 12 of 18 up
    with NvmlInfo(fake.path) as info:
        topo = links.LinkTopology(info.scan(str(tmp_path), "/dev"), info)
    assert topo.pair_classes() == {"0-1": "NV12"}


def test_direct_nvlinks_to_the_peer_count(fake, tmp_path):
    """NVLink bridges (an H100 NVL pair): links whose far end is the peer
    card count; links to a third card do not."""
    fake.reset()
    buses = ["00000000:18:00.0", "00000000:2A:00.0", "00000000:3A:00.0"]
    for i, bus in enumerate(buses):
        fake.add_device(fk.hgx_uuid(i), bus, minor=i, name="NVIDIA H100 NVL")
    for link in range(3):
        fake.set_link(0, link, remote=fk.LINK_GPU, remote_bus=buses[1])
        fake.set_link(1, link, remote=fk.LINK_GPU, remote_bus=buses[0])
    fake.set_link(0, 3, remote=fk.LINK_GPU, remote_bus=buses[2])
    fake.set_link(2, 0, remote=fk.LINK_GPU, remote_bus=buses[0])
    fake.set_ancestor(0, 1, "PXB")
    fake.set_ancestor(0, 2, "SYS")
    fake.set_ancestor(1, 2, "SYS")
    with NvmlInfo(fake.path) as info:
        chips = info.scan(str(tmp_path), "/dev")
        topo = links.LinkTopology(chips, info)
    assert chips[0].chip_type == "H100 NVL"
    assert topo.pair_classes() == {"0-1": "NV3", "0-2": "NV1", "1-2": "SYS"}


def test_one_card_is_a_topology_of_one():
    topo = links.LinkTopology([_chip(0)], Table({}))
    only = topo.ids
    assert topo.pair_classes() == {} and topo.neighbors(only[0]) == []
    assert topo.is_contiguous(only) and topo.set_score(only) == 9.0


def test_method_names_and_return_types_match_ici_mesh():
    tpus = [TpuChip(index=i, dev_path=f"/dev/accel{i}", pci_addr=f"0000:00:0{i}.0",
                    vendor_id=0x1AE0, device_id=0x0063, numa_node=0, chip_type="v5p",
                    hbm_bytes=0, core_count=2) for i in range(4)]
    mesh = IciMesh(tpus)
    topo = links.LinkTopology([_chip(i) for i in range(4)],
                              Table({p: (18, 0) for p in itertools.combinations(range(4), 2)}))
    for name in ("ids", "neighbors", "score_pair", "set_score", "internal_links",
                 "is_contiguous"):
        assert hasattr(topo, name), name
    a, b = mesh.ids[:2], topo.ids[:2]
    for call in (lambda m, i: m.ids, lambda m, i: m.neighbors(i[0]),
                 lambda m, i: m.score_pair(*i), lambda m, i: m.set_score(i),
                 lambda m, i: m.internal_links(i), lambda m, i: m.is_contiguous(i)):
        assert type(call(topo, b)) is type(call(mesh, a))
