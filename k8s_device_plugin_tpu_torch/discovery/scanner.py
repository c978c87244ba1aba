"""Card discovery over NVML: the counterpart of the JAX package's
``discovery/scanner.py``, and of the reference's device enumeration
(nvidia.go:20-49 over its NVML binding).

``NvmlInfo`` keeps the method contract of the JAX backends (``scan``,
``chip_health``, ``chip_health_detail``, ``chip_telemetry``, the NUMA and
host surfaces, and the health event source), so the health watcher takes
it unchanged. The JAX backends read a sysfs class directory and a dev
directory; here the first directory argument is the sysfs PCI devices
directory (``/sys/bus/pci/devices``), where a card's NUMA node is read,
and the dev directory is where its ``nvidia<minor>`` node lives.

A node without the NVML library is a normal result, as in the reference
(main.go:27-41) and the JAX scanner: ``get_backend()`` logs a warning and
returns a backend that finds no card.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ..workload.chips import card_spec
from ..utils.logging import get_logger
from . import nvml
from .chips import ChipTelemetry, GpuChip, IciLinkTelemetry

log = get_logger(__name__)

DEFAULT_SYSFS_PCI = "/sys/bus/pci/devices"
DEFAULT_DEV = "/dev"
DEFAULT_NUMA_DIR = "/sys/devices/system/node"

# Application-level XIDs (the reference's skip list, nvidia.go:84-86) and
# the health watcher's app-fault tokens they are reported as: 31 a GPU
# memory page fault, 43 the GPU stopped processing, 45 preemptive cleanup.
APP_XIDS = {31: "app_error", 43: "app_abort", 45: "preempted"}


def _read_trimmed(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


def numa_node_of(sysfs_pci_dir: str, pci_addr: str) -> int:
    """The card's NUMA node from ``<sysfs_pci_dir>/<pci_addr>/numa_node``:
    a negative node (no affinity) reads 0, as in the reference
    (nvml.go:294-309); -1 when the attribute cannot be read."""
    raw = _read_trimmed(os.path.join(sysfs_pci_dir, pci_addr, "numa_node"))
    try:
        return max(int(raw), 0)
    except ValueError:
        return -1


class NvmlInfo:
    """The node's NVIDIA cards through NVML (``discovery/nvml.py``).

    Card ``index`` is the NVML index. Health: a card NVML reports lost is
    ``(False, "gpu_lost")``; an XID read off the event source
    (``health_events_wait``) marks its card, or every card when the event
    names none: a hardware XID ``n`` as ``(False, "xid_<n>")`` until the
    daemon restarts (the reference never marks a GPU healthy again), an
    application-level XID as its app-fault token once, on the next read.
    """

    def __init__(self, lib_path: str = nvml.LIBRARY):
        self._nvml = nvml.Nvml(lib_path)
        self._lock = threading.Lock()
        self._hw_xid: Dict[int, int] = {}  # card index -> its first hardware XID
        self._app_xid: Dict[int, int] = {}  # card index -> an app XID not yet read
        self._event_sets: Dict[int, object] = {}
        self._next_set = 1

    def close(self) -> None:
        for handle in list(self._event_sets):
            self.health_events_close(handle)
        self._nvml.shutdown()

    def __enter__(self) -> "NvmlInfo":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def version(self) -> str:
        return f"nvml driver {self._nvml.driver_version()}"

    # -- enumeration -------------------------------------------------------

    def scan(self, sysfs_pci_dir: str = DEFAULT_SYSFS_PCI,
             dev_dir: str = DEFAULT_DEV) -> List[GpuChip]:
        """Every card NVML sees (every card of the node, whatever
        ``CUDA_VISIBLE_DEVICES`` says), sorted by PCI address as the JAX
        scanner sorts."""
        chips = []
        for index in range(self._nvml.device_count()):
            h = self._nvml.handle(index)
            name = self._nvml.name(h)
            pci_addr = self._pci_addr(h)
            spec = card_spec(name)
            chips.append(GpuChip(
                index=index,
                uuid=self._nvml.uuid(h),
                name=name,
                dev_path=os.path.join(dev_dir, f"nvidia{self._nvml.minor_number(h)}"),
                pci_addr=pci_addr,
                numa_node=numa_node_of(sysfs_pci_dir, pci_addr) if pci_addr else -1,
                chip_type=spec.name if spec else "unknown",
                hbm_bytes=self._nvml.memory(h).total,
            ))
        chips.sort(key=lambda c: (c.pci_addr, c.index))
        return chips

    def _pci_addr(self, h) -> str:
        """The card's bus ID in sysfs form; "" where NVML does not give it
        (a container that hides the PCI tree)."""
        bus = self._optional(lambda: self._nvml.bus_id(h))
        return nvml.sysfs_bus_id(bus) if bus else ""

    # -- health ------------------------------------------------------------

    def chip_health(self, sysfs_pci_dir: str, dev_dir: str, index: int) -> bool:
        return self.chip_health_detail(sysfs_pci_dir, dev_dir, index)[0]

    def chip_health_detail(self, sysfs_pci_dir: str, dev_dir: str,
                           index: int) -> "tuple[bool, str]":
        """(healthy, fault reason): ``gpu_lost``, then a hardware XID
        (``xid_<n>``), then a pending application-level XID's token; ``""``
        when healthy. Raises ``OSError`` on any other NVML failure."""
        try:
            self._nvml.memory(self._nvml.handle(index))
        except nvml.NvmlError as e:
            if e.code == nvml.ERROR_GPU_IS_LOST:
                return False, "gpu_lost"
            raise
        with self._lock:
            if index in self._hw_xid:
                return False, f"xid_{self._hw_xid[index]}"
            app = self._app_xid.pop(index, None)
        if app is not None:
            return False, APP_XIDS[app]
        return True, ""

    def _mark_xid(self, index: Optional[int], xid: int) -> None:
        """Record an XID for card ``index``, or for every card when None."""
        targets = range(self._nvml.device_count()) if index is None else (index,)
        with self._lock:
            for i in targets:
                if xid in APP_XIDS:
                    self._app_xid[i] = xid
                else:
                    self._hw_xid.setdefault(i, xid)

    # Event-driven health (the reference's XID event set, nvidia.go:51-102).
    def health_events_open(self, sysfs_pci_dir: str, dev_dir: str) -> int:
        """An event set registered for XID events on every card, behind an
        int handle. Raises ``OSError`` where registration is not supported:
        the watcher then polls only. A card already lost is left out (its
        sweep reads ``gpu_lost``), so that it does not blind the rest."""
        es = self._nvml.event_set_create()
        try:
            for index in range(self._nvml.device_count()):
                try:
                    self._nvml.register_events(self._nvml.handle(index),
                                               nvml.EVENT_TYPE_XID_CRITICAL_ERROR, es)
                except nvml.NvmlError as e:
                    if e.code != nvml.ERROR_GPU_IS_LOST:
                        raise
                    log.warning("card %d is lost; no XID events from it", index)
        except nvml.NvmlError:
            self._nvml.event_set_free(es)
            raise
        with self._lock:
            handle = self._next_set
            self._next_set += 1
            self._event_sets[handle] = es
        return handle

    def health_events_wait(self, handle: int, timeout_ms: int) -> bool:
        """True when an event came within ``timeout_ms`` (an XID event is
        recorded against its card, or every card when it names none or a
        card this backend does not know); raises ``OSError`` when the
        event source fails."""
        es = self._event_sets.get(handle)
        if es is None:
            raise OSError(9, f"no open health event set {handle}")  # EBADF
        data = self._nvml.event_set_wait(es, timeout_ms)
        if data is None:
            return False
        if data.eventType & nvml.EVENT_TYPE_XID_CRITICAL_ERROR:
            index = None
            if data.device:
                for i in range(self._nvml.device_count()):
                    if self._nvml.handle(i).value == data.device:
                        index = i
                        break
            self._mark_xid(index, data.eventData)
        return True

    def health_events_close(self, handle: int) -> None:
        with self._lock:
            es = self._event_sets.pop(handle, None)
        if es is not None:
            try:
                self._nvml.event_set_free(es)
            except nvml.NvmlError as e:
                log.warning("nvmlEventSetFree failed: %s", e)

    # -- telemetry and links -----------------------------------------------

    def _optional(self, read):
        """``read()``, or None where NVML does not support the counter on
        this card or this process may not read it."""
        try:
            return read()
        except nvml.NvmlError as e:
            if e.code in (nvml.ERROR_NOT_SUPPORTED, nvml.ERROR_NO_PERMISSION):
                return None
            raise

    def nvlinks(self, index: int) -> "list[tuple[int, bool]]":
        """(link, up) for every NVLink the card has."""
        h = self._nvml.handle(index)
        links = []
        for link in range(nvml.NVLINK_MAX_LINKS):
            up = self._nvml.nvlink_active(h, link)
            if up is not None:
                links.append((link, up))
        return links

    def chip_telemetry(self, sysfs_pci_dir: str, index: int) -> ChipTelemetry:
        """Runtime counters of card ``index``: utilization (the duty cycle),
        device memory in use, temperature, power (W), and each NVLink's
        state. An unsupported counter is None; a missing card raises."""
        h = self._nvml.handle(index)
        util = self._optional(lambda: self._nvml.utilization(h))
        used = self._optional(lambda: self._nvml.memory(h).used)
        temp = self._optional(lambda: self._nvml.temperature_c(h))
        power = self._optional(lambda: self._nvml.power_mw(h))
        return ChipTelemetry(
            index=index,
            duty_cycle_pct=float(util.gpu) if util is not None else None,
            hbm_used_bytes=used,
            temp_c=float(temp) if temp is not None else None,
            power_w=power / 1000.0 if power is not None else None,
            links=tuple(IciLinkTelemetry(link=k, up=up, errors=0)
                        for k, up in self.nvlinks(index)),
        )

    def power_limit_w(self, index: int) -> float:
        return self._nvml.power_limit_mw(self._nvml.handle(index)) / 1000.0

    def pair_link(self, a: int, b: int) -> "tuple[int, Optional[int]]":
        """(NVLinks between cards ``a`` and ``b``, their PCIe
        ``nvmlGpuTopologyLevel_t`` or None where NVML has none). The links
        are those from ``a`` whose far end is ``b``, plus, where the pair
        talks peer to peer over NVLink (``nvmlDeviceGetP2PStatus``), the
        lesser of the two cards' active links into an NVSwitch: on an HGX
        board every NVLink goes to a switch, none to the peer."""
        ha, hb = self._nvml.handle(a), self._nvml.handle(b)
        level = self._optional(lambda: self._nvml.common_ancestor(ha, hb))
        peer_bus = self._pci_addr(hb)  # "": a direct link cannot be told
        direct, switch = 0, {a: 0, b: 0}
        for index, h in ((a, ha), (b, hb)):
            for link, up in self.nvlinks(index):
                if not up:
                    continue
                kind = self._nvml.nvlink_remote_type(h, link)
                if kind == nvml.NVLINK_DEVICE_TYPE_SWITCH:
                    switch[index] += 1
                elif (index == a and kind == nvml.NVLINK_DEVICE_TYPE_GPU and peer_bus
                      and nvml.sysfs_bus_id(self._nvml.nvlink_remote_bus_id(h, link))
                      == peer_bus):
                    direct += 1
        via_switch = 0
        if min(switch.values()) > 0:
            status = self._optional(
                lambda: self._nvml.p2p_status(ha, hb, nvml.P2P_CAPS_INDEX_NVLINK))
            if status == nvml.P2P_STATUS_OK:
                via_switch = min(switch.values())
        return direct + via_switch, level

    # -- host (copies of the JAX Python scanner's) -------------------------

    def numa_node_count(self, nodes_dir: str = DEFAULT_NUMA_DIR) -> int:
        try:
            entries = os.listdir(nodes_dir)
        except FileNotFoundError:
            return 1
        n = sum(1 for e in entries if e.startswith("node") and e[4:].isdigit())
        return max(n, 1)

    def numa_topology(self, nodes_dir: str = DEFAULT_NUMA_DIR) -> List[dict]:
        try:
            entries = sorted(
                int(e[4:]) for e in os.listdir(nodes_dir)
                if e.startswith("node") and e[4:].isdigit()
            )
        except FileNotFoundError:
            return []
        out = []
        for nid in entries:
            base = os.path.join(nodes_dir, f"node{nid}")
            mem_kb = 0
            for line in _read_trimmed(os.path.join(base, "meminfo")).splitlines():
                if "MemTotal:" in line:
                    try:
                        mem_kb = int(line.split("MemTotal:")[1].split()[0])
                    except (ValueError, IndexError):
                        pass
                    break
            cpus = 0
            for part in _read_trimmed(os.path.join(base, "cpulist")).split(","):
                part = part.strip()
                if not part:
                    continue
                if "-" in part:
                    lo, hi = part.split("-", 1)
                    try:
                        if int(hi) >= int(lo):
                            cpus += int(hi) - int(lo) + 1
                    except ValueError:
                        pass
                else:
                    cpus += 1
            out.append({"node_id": nid, "mem_total_bytes": mem_kb * 1024, "cpu_count": cpus})
        return out

    def host_info(self, proc_dir: str = "/proc") -> dict:
        mem = 0
        for line in _read_trimmed(os.path.join(proc_dir, "meminfo")).splitlines():
            if "MemTotal:" in line:
                try:
                    mem = int(line.split("MemTotal:")[1].split()[0]) * 1024
                except (ValueError, IndexError):
                    pass
                break
        cpu_count = 0
        packages: list = []
        model = ""
        for line in _read_trimmed(os.path.join(proc_dir, "cpuinfo")).splitlines():
            if line.startswith("processor"):
                cpu_count += 1
            elif line.startswith("physical id"):
                try:
                    pid = int(line.split(":", 1)[1])
                except (ValueError, IndexError):
                    continue
                if pid not in packages:
                    packages.append(pid)
            elif not model and line.startswith("model name"):
                parts = line.split(":", 1)
                if len(parts) == 2:
                    model = parts[1].strip()[:63]
        sockets = len(packages) or (1 if cpu_count else 0)
        return {"mem_total_bytes": mem, "cpu_count": cpu_count, "cpu_sockets": sockets,
                "cpu_model": model}


class NoCards:
    """The backend of a node without NVML: it finds no card."""

    def version(self) -> str:
        return "nvml unavailable"

    def scan(self, sysfs_pci_dir: str = DEFAULT_SYSFS_PCI,
             dev_dir: str = DEFAULT_DEV) -> List[GpuChip]:
        return []


def get_backend(lib_path: str = nvml.LIBRARY):
    """``NvmlInfo`` when the NVML library loads and initialises, else (with
    a warning) ``NoCards``."""
    try:
        return NvmlInfo(lib_path)
    except OSError as e:
        log.warning("NVML unavailable (%s); no cards on this node", e)
        return NoCards()
