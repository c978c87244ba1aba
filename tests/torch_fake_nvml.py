"""Build and script the fake NVML library (tests/fake_nvml.c) for the tests
of the port's node layers (discovery, health, topology).

``build(directory)`` compiles it with ``cc`` into
``<directory>/libnvidia-ml.so.1``; ``FakeNvml(path)`` loads the same
library the port's ``NvmlInfo(path)`` loads (one copy a process: ctypes
hands both the same handle) and scripts it. This module imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).with_name("fake_nvml.c")

GIB = 1024 ** 3
# nvmlIntNvLinkDeviceType_t, nvmlGpuTopologyLevel_t, nvmlGpuP2PStatus_t
LINK_GPU, LINK_SWITCH = 0x00, 0x02
TOPOLOGY = {"BOARD": 0, "PIX": 10, "PXB": 20, "PHB": 30, "NODE": 40, "SYS": 50}
P2P_OK, P2P_NOT_SUPPORTED = 0, 5
H100 = "NVIDIA H100 80GB HBM3"
H100_BYTES = 81559 * 2 ** 20


def build(directory) -> str:
    out = os.path.join(str(directory), "libnvidia-ml.so.1")
    subprocess.run(["cc", "-shared", "-fPIC", "-O1", "-pthread", "-o", out, str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    return out


class FakeNvml:
    """The fake library's controls (``fake_nvml_*``)."""

    def __init__(self, path: str):
        self.path = path
        lib = ctypes.CDLL(path)
        s, u, ull, i = ctypes.c_char_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int
        for name, argtypes, restype in (
            ("fake_nvml_reset", [], None),
            ("fake_nvml_set_init_result", [i], None),
            ("fake_nvml_add_device", [s, s, s, u, ull, ull, u, u, u, u], i),
            ("fake_nvml_set_link", [i, i, i, i, s], None),
            ("fake_nvml_set_p2p_nvlink", [i, i, i], None),
            ("fake_nvml_set_ancestor", [i, i, i], None),
            ("fake_nvml_set_lost", [i, i], None),
            ("fake_nvml_set_events_supported", [i], None),
            ("fake_nvml_set_no_pci", [i], None),
            ("fake_nvml_push_event", [i, ull], None),
            ("fake_nvml_break_events", [], None),
            ("fake_nvml_open_event_sets", [], i),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        self.lib = lib
        self.reset()

    def reset(self) -> None:
        self.lib.fake_nvml_reset()

    def add_device(self, uuid: str, bus_id: str, *, name: str = H100, minor: int = 0,
                   mem_total: int = H100_BYTES, mem_used: int = 0, temp_c: int = 31,
                   power_mw: int = 71234, limit_mw: int = 700000, util_gpu: int = 0) -> int:
        return self.lib.fake_nvml_add_device(
            uuid.encode(), name.encode(), bus_id.encode(), minor, mem_total, mem_used,
            temp_c, power_mw, limit_mw, util_gpu)

    def set_link(self, dev: int, link: int, active: bool = True, remote: int = LINK_SWITCH,
                 remote_bus: str = "") -> None:
        self.lib.fake_nvml_set_link(dev, link, int(active), remote, remote_bus.encode())

    def set_p2p_nvlink(self, a: int, b: int, status: int = P2P_OK) -> None:
        self.lib.fake_nvml_set_p2p_nvlink(a, b, status)

    def set_ancestor(self, a: int, b: int, label: str) -> None:
        self.lib.fake_nvml_set_ancestor(a, b, TOPOLOGY[label])

    def set_lost(self, dev: int, lost: bool = True) -> None:
        self.lib.fake_nvml_set_lost(dev, int(lost))

    def set_events_supported(self, supported: bool) -> None:
        self.lib.fake_nvml_set_events_supported(int(supported))

    def set_no_pci(self, hide: bool = True) -> None:
        """The PCI queries are not supported, as in a container that hides
        the PCI tree."""
        self.lib.fake_nvml_set_no_pci(int(hide))

    def set_init_result(self, ret: int) -> None:
        self.lib.fake_nvml_set_init_result(ret)

    def push_xid(self, dev: int, xid: int) -> None:
        """An XID event on card ``dev`` (-1: an event naming no card)."""
        self.lib.fake_nvml_push_event(dev, xid)

    def break_events(self) -> None:
        self.lib.fake_nvml_break_events()

    def open_event_sets(self) -> int:
        return self.lib.fake_nvml_open_event_sets()


# An HGX H100 node's PCI addresses (NVML's form), as nvidia-smi lists them,
# out of NVML's order so that the scan's sort shows.
HGX_BUSES = ("00000000:18:00.0", "00000000:2A:00.0", "00000000:3A:00.0", "00000000:5D:00.0")


def hgx_uuid(slot: int) -> str:
    return f"GPU-{slot:08x}-0000-4000-8000-{slot:012x}"


def hgx_node(fake: FakeNvml, sysfs_dir, n: int = 4, switch_links: int = 18,
             numa=(0, 0, 1, 1)) -> list:
    """``n`` H100s whose NVLinks all go to NVSwitches (``switch_links``
    each), every pair peer to peer over NVLink, PCIe NODE within a NUMA
    node and SYS across; each card's ``numa_node`` written under
    ``sysfs_dir``. NVML's order is the reverse of the PCI order. Returns
    the UUIDs by NVML index."""
    order = list(reversed(range(n)))
    uuids = []
    for index, slot in enumerate(order):
        uuid = hgx_uuid(slot)
        dev = fake.add_device(uuid, HGX_BUSES[slot], minor=slot, mem_used=(slot + 1) * GIB,
                              util_gpu=10 * slot)
        assert dev == index
        uuids.append(uuid)
        for link in range(switch_links):
            fake.set_link(dev, link, remote=LINK_SWITCH)
        addr = "0000:" + HGX_BUSES[slot].split(":", 1)[1].lower()
        os.makedirs(os.path.join(str(sysfs_dir), addr), exist_ok=True)
        with open(os.path.join(str(sysfs_dir), addr, "numa_node"), "w") as f:
            f.write(f"{numa[slot]}\n")
    for a in range(n):
        for b in range(a + 1, n):
            fake.set_p2p_nvlink(a, b, P2P_OK)
            same = numa[order[a]] == numa[order[b]]
            fake.set_ancestor(a, b, "NODE" if same else "SYS")
    return uuids
