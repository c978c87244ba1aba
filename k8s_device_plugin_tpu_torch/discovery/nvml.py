"""NVML through ``ctypes``: the port's counterpart of ``native/tpuinfo``,
and of the reference's ``dlopen`` shim (nvml_dl.c:21-46).

``Nvml`` opens ``libnvidia-ml.so.1`` (the driver's library; no Python
package of NVML bindings is used), calls ``nvmlInit_v2`` and binds each
function below with its argument and result types. Every struct layout and
enum value that the node layers read is kept in this one file, each beside
the ``nvml.h`` type it mirrors. A call whose ``nvmlReturn_t`` is not
``NVML_SUCCESS`` raises ``NvmlError`` (an ``OSError``: the health
watcher's contract catches ``OSError``) with ``nvmlErrorString``'s text,
except where a method documents a value it returns instead (a timed-out
event wait, a link that does not exist).
"""

from __future__ import annotations

import ctypes
from typing import Optional

LIBRARY = "libnvidia-ml.so.1"

# nvmlReturn_t
SUCCESS = 0
ERROR_INVALID_ARGUMENT = 2
ERROR_NOT_SUPPORTED = 3
ERROR_NO_PERMISSION = 4
ERROR_TIMEOUT = 10
ERROR_GPU_IS_LOST = 15

# Buffer sizes (NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE,
# NVML_DEVICE_UUID_V2_BUFFER_SIZE, NVML_DEVICE_NAME_V2_BUFFER_SIZE,
# NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE, NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE)
DRIVER_VERSION_BUFFER = 80
UUID_BUFFER = 96
NAME_BUFFER = 96
PCI_BUS_ID_LEGACY_BUFFER = 16
PCI_BUS_ID_BUFFER = 32

# NVML_NVLINK_MAX_LINKS
NVLINK_MAX_LINKS = 18

# nvmlTemperatureSensors_t
TEMPERATURE_GPU = 0

# nvmlEnableState_t
FEATURE_ENABLED = 1

# nvmlIntNvLinkDeviceType_t
NVLINK_DEVICE_TYPE_GPU = 0x00
NVLINK_DEVICE_TYPE_SWITCH = 0x02

# nvmlGpuP2PCapsIndex_t
P2P_CAPS_INDEX_NVLINK = 2
# nvmlGpuP2PStatus_t
P2P_STATUS_OK = 0

# nvmlGpuTopologyLevel_t
TOPOLOGY_INTERNAL = 0
TOPOLOGY_SINGLE = 10
TOPOLOGY_MULTIPLE = 20
TOPOLOGY_HOSTBRIDGE = 30
TOPOLOGY_NODE = 40
TOPOLOGY_SYSTEM = 50

# nvmlEventTypeXidCriticalError
EVENT_TYPE_XID_CRITICAL_ERROR = 0x0000000000000008


class PciInfo(ctypes.Structure):
    """nvmlPciInfo_t (the layout of nvmlDeviceGetPciInfo_v3)."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * PCI_BUS_ID_LEGACY_BUFFER),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * PCI_BUS_ID_BUFFER),
    ]


class Memory(ctypes.Structure):
    """nvmlMemory_t (bytes)."""

    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class Utilization(ctypes.Structure):
    """nvmlUtilization_t (percent of the last sample period)."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class EventData(ctypes.Structure):
    """nvmlEventData_t; ``eventData`` carries the XID of an XID event."""

    _fields_ = [
        ("device", ctypes.c_void_p),
        ("eventType", ctypes.c_ulonglong),
        ("eventData", ctypes.c_ulonglong),
        ("gpuInstanceId", ctypes.c_uint),
        ("computeInstanceId", ctypes.c_uint),
    ]


class NvmlError(OSError):
    """A call that returned an ``nvmlReturn_t`` other than success;
    ``code`` is that value."""

    def __init__(self, code: int, call: str, text: str):
        super().__init__(code, f"{call}: {text}")
        self.code = code


_P = ctypes.c_void_p
_U = ctypes.c_uint
_PU = ctypes.POINTER(ctypes.c_uint)
_STR = ctypes.c_char_p

# Each bound function's argument types (nvmlDevice_t and nvmlEventSet_t are
# opaque pointers).
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlSystemGetDriverVersion": [_STR, _U],
    "nvmlDeviceGetCount_v2": [_PU],
    "nvmlDeviceGetHandleByIndex_v2": [_U, ctypes.POINTER(_P)],
    "nvmlDeviceGetUUID": [_P, _STR, _U],
    "nvmlDeviceGetName": [_P, _STR, _U],
    "nvmlDeviceGetPciInfo_v3": [_P, ctypes.POINTER(PciInfo)],
    "nvmlDeviceGetMinorNumber": [_P, _PU],
    "nvmlDeviceGetMemoryInfo": [_P, ctypes.POINTER(Memory)],
    "nvmlDeviceGetTemperature": [_P, ctypes.c_int, _PU],
    "nvmlDeviceGetPowerUsage": [_P, _PU],
    "nvmlDeviceGetEnforcedPowerLimit": [_P, _PU],
    "nvmlDeviceGetUtilizationRates": [_P, ctypes.POINTER(Utilization)],
    "nvmlDeviceGetNvLinkState": [_P, _U, ctypes.POINTER(ctypes.c_int)],
    "nvmlDeviceGetNvLinkRemoteDeviceType": [_P, _U, ctypes.POINTER(ctypes.c_int)],
    "nvmlDeviceGetNvLinkRemotePciInfo_v2": [_P, _U, ctypes.POINTER(PciInfo)],
    "nvmlDeviceGetP2PStatus": [_P, _P, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "nvmlDeviceGetTopologyCommonAncestor": [_P, _P, ctypes.POINTER(ctypes.c_int)],
    "nvmlEventSetCreate": [ctypes.POINTER(_P)],
    "nvmlDeviceRegisterEvents": [_P, ctypes.c_ulonglong, _P],
    "nvmlEventSetWait_v2": [_P, ctypes.POINTER(EventData), _U],
    "nvmlEventSetFree": [_P],
}


def sysfs_bus_id(bus_id: str) -> str:
    """NVML's bus ID (``00000000:18:00.0``, an 8-digit domain) in sysfs's
    form (``0000:18:00.0``), lower case, as the reference reads the card's
    sysfs directory (nvml.go:294-309)."""
    domain, rest = bus_id.split(":", 1)
    return f"{int(domain, 16):04x}:{rest.lower()}"


class Nvml:
    """The NVML library, initialised; ``shutdown()`` releases it. Raises ``OSError`` when the library cannot be
    loaded and ``NvmlError`` when it cannot be initialised."""

    def __init__(self, lib_path: str = LIBRARY):
        self._lib = ctypes.CDLL(lib_path)
        try:
            self._lib.nvmlErrorString.argtypes = [ctypes.c_int]
            self._lib.nvmlErrorString.restype = ctypes.c_char_p
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(self._lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except AttributeError as e:  # a driver too old for one of the calls
            raise OSError(38, f"{lib_path}: {e}") from e  # ENOSYS
        self._call("nvmlInit_v2")
        self._open = True

    def _call(self, name: str, *args) -> None:
        ret = getattr(self._lib, name)(*args)
        if ret != SUCCESS:
            text = self._lib.nvmlErrorString(ret) or b"unknown error"
            raise NvmlError(ret, name, text.decode(errors="replace"))

    def shutdown(self) -> None:
        if self._open:
            self._open = False
            self._call("nvmlShutdown")

    # -- system and devices ------------------------------------------------

    def driver_version(self) -> str:
        buf = ctypes.create_string_buffer(DRIVER_VERSION_BUFFER)
        self._call("nvmlSystemGetDriverVersion", buf, len(buf))
        return buf.value.decode()

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def uuid(self, h) -> str:
        buf = ctypes.create_string_buffer(UUID_BUFFER)
        self._call("nvmlDeviceGetUUID", h, buf, len(buf))
        return buf.value.decode()

    def name(self, h) -> str:
        buf = ctypes.create_string_buffer(NAME_BUFFER)
        self._call("nvmlDeviceGetName", h, buf, len(buf))
        return buf.value.decode()

    def bus_id(self, h) -> str:
        """The card's bus ID as NVML gives it (``00000000:18:00.0``)."""
        pci = PciInfo()
        self._call("nvmlDeviceGetPciInfo_v3", h, ctypes.byref(pci))
        return pci.busId.decode()

    def minor_number(self, h) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", h, ctypes.byref(n))
        return n.value

    def memory(self, h) -> Memory:
        mem = Memory()
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(mem))
        return mem

    def temperature_c(self, h) -> int:
        t = ctypes.c_uint()
        self._call("nvmlDeviceGetTemperature", h, TEMPERATURE_GPU, ctypes.byref(t))
        return t.value

    def power_mw(self, h) -> int:
        p = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerUsage", h, ctypes.byref(p))
        return p.value

    def power_limit_mw(self, h) -> int:
        p = ctypes.c_uint()
        self._call("nvmlDeviceGetEnforcedPowerLimit", h, ctypes.byref(p))
        return p.value

    def utilization(self, h) -> Utilization:
        u = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", h, ctypes.byref(u))
        return u

    # -- links -------------------------------------------------------------

    def nvlink_active(self, h, link: int) -> Optional[bool]:
        """Whether NVLink ``link`` is up; None where the card has no such
        link (NVML answers not supported or an invalid argument)."""
        state = ctypes.c_int()
        try:
            self._call("nvmlDeviceGetNvLinkState", h, link, ctypes.byref(state))
        except NvmlError as e:
            if e.code in (ERROR_NOT_SUPPORTED, ERROR_INVALID_ARGUMENT):
                return None
            raise
        return state.value == FEATURE_ENABLED

    def nvlink_remote_type(self, h, link: int) -> int:
        """What an active NVLink's far end is (``NVLINK_DEVICE_TYPE_*``)."""
        t = ctypes.c_int()
        self._call("nvmlDeviceGetNvLinkRemoteDeviceType", h, link, ctypes.byref(t))
        return t.value

    def nvlink_remote_bus_id(self, h, link: int) -> str:
        """The bus ID of an active NVLink's far end (NVML's form)."""
        pci = PciInfo()
        self._call("nvmlDeviceGetNvLinkRemotePciInfo_v2", h, link, ctypes.byref(pci))
        return pci.busId.decode()

    def p2p_status(self, a, b, caps_index: int) -> int:
        """``nvmlGpuP2PStatus_t`` of the pair for one capability."""
        s = ctypes.c_int()
        self._call("nvmlDeviceGetP2PStatus", a, b, caps_index, ctypes.byref(s))
        return s.value

    def common_ancestor(self, a, b) -> int:
        """The pair's ``nvmlGpuTopologyLevel_t``: the PCIe path between
        them."""
        level = ctypes.c_int()
        self._call("nvmlDeviceGetTopologyCommonAncestor", a, b, ctypes.byref(level))
        return level.value

    # -- events ------------------------------------------------------------

    def event_set_create(self) -> ctypes.c_void_p:
        s = ctypes.c_void_p()
        self._call("nvmlEventSetCreate", ctypes.byref(s))
        return s

    def register_events(self, h, event_types: int, event_set) -> None:
        self._call("nvmlDeviceRegisterEvents", h, event_types, event_set)

    def event_set_wait(self, event_set, timeout_ms: int) -> Optional[EventData]:
        """The next event, or None when none came within ``timeout_ms``."""
        data = EventData()
        try:
            self._call("nvmlEventSetWait_v2", event_set, ctypes.byref(data), timeout_ms)
        except NvmlError as e:
            if e.code == ERROR_TIMEOUT:
                return None
            raise
        return data

    def event_set_free(self, event_set) -> None:
        self._call("nvmlEventSetFree", event_set)
