"""The port's NVML layers (discovery/nvml.py, discovery/scanner.py) over
the fake NVML library of tests/fake_nvml.c, built here with ``cc``, as
tests/test_discovery.py builds native/tpuinfo."""

import os

import pytest

from k8s_device_plugin_tpu_torch.discovery import nvml
from k8s_device_plugin_tpu_torch.discovery.chips import ChipTelemetry, GpuChip
from k8s_device_plugin_tpu_torch.discovery.scanner import (
    APP_XIDS,
    NoCards,
    NvmlInfo,
    get_backend,
)
from tests import torch_fake_nvml as fk


@pytest.fixture(scope="module")
def fake_path(tmp_path_factory):
    return fk.build(tmp_path_factory.mktemp("fake_nvml"))


@pytest.fixture
def fake(fake_path):
    f = fk.FakeNvml(fake_path)
    yield f
    f.reset()


@pytest.fixture
def node(fake, tmp_path):
    """A 4-card HGX node: (NvmlInfo, sysfs dir, UUIDs by NVML index)."""
    sysfs = tmp_path / "pci"
    uuids = fk.hgx_node(fake, sysfs)
    with NvmlInfo(fake.path) as info:
        yield info, str(sysfs), uuids


def test_four_card_scan_uuids_pci_order_numa(node):
    info, sysfs, uuids = node
    chips = info.scan(sysfs, "/dev")
    assert [c.pci_addr for c in chips] == ["0000:18:00.0", "0000:2a:00.0", "0000:3a:00.0",
                                           "0000:5d:00.0"]
    assert [c.index for c in chips] == [3, 2, 1, 0]  # NVML's order reversed
    assert [c.device_id_str for c in chips] == [uuids[i] for i in (3, 2, 1, 0)]
    assert [c.numa_node for c in chips] == [0, 0, 1, 1]
    assert [c.dev_path for c in chips] == [f"/dev/nvidia{m}" for m in range(4)]
    assert all(c.name == fk.H100 and c.chip_type == "H100" for c in chips)
    assert all(c.hbm_bytes == fk.H100_BYTES for c in chips)
    d = chips[0].to_dict()
    assert d["id"] == d["uuid"] == uuids[3] and set(d) >= {"index", "pci_addr", "numa_node"}
    assert info.version() == "nvml driver 999.99.99-fake"


def test_numa_node_reads_like_the_reference(node, tmp_path):
    info, sysfs, _ = node
    with open(os.path.join(sysfs, "0000:18:00.0", "numa_node"), "w") as f:
        f.write("-1\n")  # no affinity: the reference reads 0
    os.remove(os.path.join(sysfs, "0000:2a:00.0", "numa_node"))  # unreadable: -1
    by_addr = {c.pci_addr: c.numa_node for c in info.scan(sysfs, "/dev")}
    assert by_addr["0000:18:00.0"] == 0 and by_addr["0000:2a:00.0"] == -1


@pytest.mark.parametrize("bus, want", [("00000000:18:00.0", "0000:18:00.0"),
                                       ("00000001:AB:1F.3", "0001:ab:1f.3")])
def test_sysfs_bus_id(bus, want):
    assert nvml.sysfs_bus_id(bus) == want


def test_missing_library_gives_no_cards(tmp_path, caplog):
    backend = get_backend(str(tmp_path / "libnvidia-ml.so.1"))
    assert isinstance(backend, NoCards)
    assert backend.scan() == []
    assert "NVML unavailable" in caplog.text
    with pytest.raises(OSError):
        NvmlInfo(str(tmp_path / "libnvidia-ml.so.1"))


def test_init_failure_gives_no_cards_and_names_the_error(fake):
    fake.set_init_result(9)  # NVML_ERROR_DRIVER_NOT_LOADED
    assert isinstance(get_backend(fake.path), NoCards)
    with pytest.raises(nvml.NvmlError) as e:
        NvmlInfo(fake.path)
    assert e.value.code == 9 and "nvmlInit_v2" in str(e.value)


@pytest.mark.parametrize("xid", sorted(APP_XIDS))
def test_app_xids_leave_a_card_healthy(node, fake, xid):
    info, _, _ = node
    h = info.health_events_open("", "/dev")
    fake.push_xid(2, xid)
    assert info.health_events_wait(h, 100) is True
    assert info.chip_health_detail("", "", 2) == (False, APP_XIDS[xid])  # read once
    assert info.chip_health_detail("", "", 2) == (True, "")
    assert all(info.chip_health("", "", i) for i in range(4))
    info.health_events_close(h)


def test_hardware_xid_withdraws_the_card_until_restart(node, fake):
    info, _, _ = node
    h = info.health_events_open("", "/dev")
    fake.push_xid(1, 79)  # fallen off the bus
    fake.push_xid(1, 31)  # a later app fault does not hide it
    assert info.health_events_wait(h, 100) and info.health_events_wait(h, 100)
    assert not info.health_events_wait(h, 50)
    for _ in range(3):
        assert info.chip_health_detail("", "", 1) == (False, "xid_79")
    assert [info.chip_health("", "", i) for i in (0, 2, 3)] == [True] * 3


@pytest.mark.parametrize("xid, want", [(48, (False, "xid_48")), (43, (False, "app_abort"))])
def test_an_event_naming_no_card_marks_every_card(node, fake, xid, want):
    info, _, _ = node
    h = info.health_events_open("", "/dev")
    fake.push_xid(-1, xid)
    assert info.health_events_wait(h, 100)
    assert [info.chip_health_detail("", "", i) for i in range(4)] == [want] * 4


def test_lost_card_reads_gpu_lost(node, fake):
    info, _, _ = node
    fake.set_lost(3)
    assert info.chip_health_detail("", "", 3) == (False, "gpu_lost")
    assert info.chip_health_detail("", "", 0) == (True, "")
    with pytest.raises(OSError):
        info.chip_telemetry("", 3)


def test_event_source_unsupported_or_failing_raises_oserror(node, fake):
    info, _, _ = node
    fake.set_events_supported(False)
    with pytest.raises(OSError):
        info.health_events_open("", "/dev")
    assert fake.open_event_sets() == 0  # the half-registered set was freed
    fake.set_events_supported(True)
    h = info.health_events_open("", "/dev")
    fake.break_events()
    with pytest.raises(OSError):
        info.health_events_wait(h, 100)
    info.health_events_close(h)
    assert fake.open_event_sets() == 0
    with pytest.raises(OSError):
        info.health_events_wait(h, 100)  # closed


def test_telemetry_units(node):
    info, _, _ = node
    tel = info.chip_telemetry("", 1)  # NVML index 1: the card in PCI slot 2
    assert isinstance(tel, ChipTelemetry)
    assert tel.duty_cycle_pct == 20.0
    assert tel.hbm_used_bytes == 3 * fk.GIB
    assert tel.temp_c == 31.0
    assert tel.power_w == pytest.approx(71.234)  # from mW
    assert [(l.link, l.up) for l in tel.links] == [(k, True) for k in range(18)]
    assert tel.to_dict(fk.H100_BYTES)["hbm_used_pct"] == round(3 * fk.GIB / fk.H100_BYTES * 100, 1)
    assert info.power_limit_w(1) == 700.0


def test_unsupported_counters_read_none(fake, tmp_path):
    fake.add_device("GPU-a", "00000000:18:00.0")
    with NvmlInfo(fake.path) as info:
        tel = info.chip_telemetry("", 0)
    assert tel.links == () and tel.power_w == pytest.approx(71.234)


def test_host_surfaces_copy_the_python_scanner(node, tmp_path):
    from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo

    info, _, _ = node
    nodes = tmp_path / "nodes"
    for nid, cpus in ((0, "0-3,8"), (1, "4-7")):
        (nodes / f"node{nid}").mkdir(parents=True)
        (nodes / f"node{nid}" / "cpulist").write_text(cpus + "\n")
        (nodes / f"node{nid}" / "meminfo").write_text(f"Node {nid} MemTotal:  1024 kB\n")
    proc = tmp_path / "proc"
    proc.mkdir()
    (proc / "meminfo").write_text("MemTotal:       2048 kB\n")
    (proc / "cpuinfo").write_text("processor: 0\nphysical id: 0\nmodel name: Fake CPU\n"
                                  "processor: 1\nphysical id: 1\n")
    py = PyTpuInfo()
    assert info.numa_node_count(str(nodes)) == py.numa_node_count(str(nodes)) == 2
    assert info.numa_topology(str(nodes)) == py.numa_topology(str(nodes))
    assert info.host_info(str(proc)) == py.host_info(str(proc))
    assert info.numa_node_count(str(tmp_path / "none")) == 1


def test_gpu_chip_keeps_the_fields_the_watcher_and_topology_read():
    from k8s_device_plugin_tpu.discovery.chips import TpuChip

    kept = {"index", "dev_path", "pci_addr", "numa_node", "chip_type", "hbm_bytes"}
    gpu = {f.name for f in GpuChip.__dataclass_fields__.values()}
    tpu = {f.name for f in TpuChip.__dataclass_fields__.values()}
    assert kept <= gpu & tpu and gpu - tpu == {"uuid", "name"}
    assert isinstance(GpuChip.device_id_str, property)


def test_a_container_that_hides_the_pci_tree(node, fake):
    """As on the chip machine, whose NVML refuses the PCI queries: the bus
    ID reads "" and the NUMA node -1, the cards come in NVML's order, and
    the NVLinks still give the pair classes."""
    from k8s_device_plugin_tpu_torch.topology.links import LinkTopology

    info, sysfs, uuids = node
    fake.set_no_pci()
    chips = info.scan(sysfs, "/dev")
    assert [c.device_id_str for c in chips] == uuids
    assert {(c.pci_addr, c.numa_node) for c in chips} == {("", -1)}
    topo = LinkTopology(chips, info)
    assert set(topo.pair_classes().values()) == {"NV18"}
