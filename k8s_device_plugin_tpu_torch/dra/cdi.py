"""CDI (Container Device Interface) specs for DRA claims: the counterpart of
the JAX package's ``dra/cdi.py``.

DRA hands devices to the container runtime as CDI device ids
(``<vendor>/<class>=<name>``); the runtime resolves them against the spec
files in /var/run/cdi (or /etc/cdi) and applies their ``containerEdits``.
An NVIDIA container needs two edits a claim: its cards' ``/dev/nvidia<minor>``
nodes with ``/dev/nvidiactl``, and the env that names its cards
(``NVIDIA_VISIBLE_DEVICES``), the same edits the device-plugin plane puts
in its Allocate response (``server/plugin.py``: ``device_paths``,
``_gpu_env``). There is no library mount: the NVIDIA container runtime
brings the driver's libraries.

The env depends on the set of cards in the claim, so a static per-card
spec cannot carry it: the driver writes one CDI device per prepared claim
(``claim-<uid>``, or one per request of a multi-request claim,
``claim-<uid>-<request>``) at NodePrepareResources and removes the spec at
NodeUnprepareResources, the shape NVIDIA's DRA driver gives its per-claim
specs. The kind is ``nvidia.com/gpu``, which the NVIDIA Container Toolkit's
own specs use too; its device names (``0``, ``all``, a UUID) never start
with ``claim-``, and this registry reads and removes only its own files,
``nvidia.com-gpu-claim-*.json``. The annotations that carry a claim's cards,
requests and reference across a restart keep the JAX keys
(``tpu.google.com/...``), so a spec reads the same to either plane's tools.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence

from ..api import constants
from ..utils.logging import get_logger

log = get_logger(__name__)

# CDI spec version: 0.6.0 is what containerd 1.7+ and CRI-O 1.28+ read.
CDI_VERSION = "0.6.0"
DEFAULT_CDI_DIR = "/var/run/cdi"
KIND = constants.RESOURCE_NAME

CHIP_IDS_ANNOTATION = "tpu.google.com/chip-ids"
REQUEST_ANNOTATION = "tpu.google.com/request"
CLAIM_NAMESPACE_ANNOTATION = "tpu.google.com/claim-namespace"
CLAIM_NAME_ANNOTATION = "tpu.google.com/claim-name"


def _spec_filename(name: str) -> str:
    # "claim-x" -> "nvidia.com-gpu-claim-x.json"
    return re.sub(r"[^a-zA-Z0-9_.-]", "-", f"{KIND}-{name}") + ".json"


def _ids(ann: dict) -> List[str]:
    return [c for c in ann.get(CHIP_IDS_ANNOTATION, "").split(",") if c]


def spec_chip_ids(spec: Optional[dict]) -> List[str]:
    """Card ids recorded in a parsed claim spec's annotations, the union
    over its CDI devices (a multi-request claim writes one device a
    request); [] when the spec is missing or carries none."""
    seen: List[str] = []
    for dev in (spec or {}).get("devices", []):
        for cid in _ids(dev.get("annotations") or {}):
            if cid not in seen:
                seen.append(cid)
    return seen


def spec_request_groups(spec: Optional[dict]) -> List[tuple]:
    """[(request name, [card ids])] recorded per CDI device: how a restarted
    driver recovers which request of a claim holds which cards (a
    single-request spec gives one group with request '')."""
    groups = []
    for dev in (spec or {}).get("devices", []):
        ann = dev.get("annotations") or {}
        ids = _ids(ann)
        if ids:
            groups.append((ann.get(REQUEST_ANNOTATION, ""), ids))
    return groups


def spec_claim_ref(spec: Optional[dict]) -> Optional[tuple]:
    """(namespace, name) recorded in a parsed claim spec, or None."""
    for dev in (spec or {}).get("devices", []):
        ann = dev.get("annotations") or {}
        ns = ann.get(CLAIM_NAMESPACE_ANNOTATION)
        name = ann.get(CLAIM_NAME_ANNOTATION)
        if ns is not None and name is not None:
            return (ns, name)
    return None


class CdiRegistry:
    """Writes and removes per-claim CDI spec files, atomically."""

    def __init__(self, cdi_dir: str = DEFAULT_CDI_DIR):
        self.cdi_dir = cdi_dir

    @staticmethod
    def device_id(device_name: str) -> str:
        return f"{KIND}={device_name}"

    @staticmethod
    def claim_device_name(claim_uid: str, request: str = "") -> str:
        """The one source of the per-claim CDI device names. ``request``
        names the device of one request of a multi-request claim; it is
        empty for a single-request claim, and for the spec file's name,
        which is always per claim."""
        base = f"claim-{claim_uid}"
        if request:
            return base + "-" + re.sub(r"[^a-zA-Z0-9_.-]", "-", request)
        return base

    def claim_device_id(self, claim_uid: str, request: str = "") -> str:
        return self.device_id(self.claim_device_name(claim_uid, request))

    def _path(self, claim_uid: str) -> str:
        return os.path.join(self.cdi_dir, _spec_filename(self.claim_device_name(claim_uid)))

    def write_claim_device(
        self,
        claim_uid: str,
        dev_paths: Sequence[str],
        env: Dict[str, str],
        chip_ids: Sequence[str] = (),
        claim_ref: Optional[tuple] = None,
    ) -> str:
        """Write the spec of a single-request claim; returns the CDI device
        id the kubelet passes to the runtime."""
        ids = self.write_claim_devices(claim_uid, [("", dev_paths, env, chip_ids)],
                                       claim_ref=claim_ref)
        return ids[""]

    def write_claim_devices(
        self,
        claim_uid: str,
        groups: Sequence[tuple],
        claim_ref: Optional[tuple] = None,
    ) -> Dict[str, str]:
        """Write one claim's CDI spec; returns request → CDI device id.

        ``groups`` is [(request, dev_paths, env, chip_ids)]. With more than
        one group the spec carries one CDI device a request, so a container
        that references one request of a multi-request claim gets only that
        request's cards and env; one group keeps the per-claim device name.
        The request names and each device's card ids are kept in the spec's
        annotations, so a restarted driver rebuilds the association from
        disk (``spec_request_groups``), not only the union of the cards.
        """
        multi = len(groups) > 1
        devices = []
        ids: Dict[str, str] = {}
        for request, dev_paths, env, chip_ids in groups:
            name = self.claim_device_name(claim_uid, request if multi else "")
            edits = {
                "deviceNodes": [{"path": p, "hostPath": p} for p in dev_paths],
                "env": [f"{k}={v}" for k, v in sorted(env.items())],
            }
            device: Dict = {"name": name, "containerEdits": edits}
            annotations: Dict[str, str] = {}
            if chip_ids:
                annotations[CHIP_IDS_ANNOTATION] = ",".join(chip_ids)
            if request:
                annotations[REQUEST_ANNOTATION] = request
            if claim_ref is not None:
                annotations[CLAIM_NAMESPACE_ANNOTATION] = claim_ref[0]
                annotations[CLAIM_NAME_ANNOTATION] = claim_ref[1]
            if annotations:
                device["annotations"] = annotations
            devices.append(device)
            ids[request] = self.device_id(name)
        spec = {"cdiVersion": CDI_VERSION, "kind": KIND, "devices": devices}
        self._write_spec(claim_uid, spec)
        log.info("wrote CDI spec for claim %s (%d devices)", claim_uid, len(devices))
        return ids

    def _write_spec(self, claim_uid: str, spec: dict) -> None:
        os.makedirs(self.cdi_dir, exist_ok=True)
        # Atomic replace: the runtime may list the dir at any moment.
        fd, tmp = tempfile.mkstemp(dir=self.cdi_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(spec, f, indent=1)
            os.replace(tmp, self._path(claim_uid))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def update_claim_ref(self, claim_uid: str, claim_ref: tuple) -> bool:
        """Write a (namespace, name) resolved late into an existing claim
        spec's annotations (a spec written before the field existed), so
        the next restart recovers it from disk without an API call. False
        when no spec exists."""
        spec = self.read_claim_spec(claim_uid)
        if not spec or not spec.get("devices"):
            return False
        ann = spec["devices"][0].setdefault("annotations", {})
        ann[CLAIM_NAMESPACE_ANNOTATION] = claim_ref[0]
        ann[CLAIM_NAME_ANNOTATION] = claim_ref[1]
        self._write_spec(claim_uid, spec)
        return True

    def remove_claim_device(self, claim_uid: str) -> None:
        path = self._path(claim_uid)
        try:
            os.unlink(path)
            log.info("removed CDI spec %s", path)
        except FileNotFoundError:
            pass

    def read_claim_spec(self, claim_uid: str) -> Optional[dict]:
        """The spec written for a claim, or None."""
        try:
            with open(self._path(claim_uid)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def claim_ref(self, claim_uid: str) -> Optional[tuple]:
        """(namespace, name) recorded for a claim, or None."""
        return spec_claim_ref(self.read_claim_spec(claim_uid))

    def list_claim_uids(self) -> List[str]:
        """Uids of the claims whose spec files this registry wrote
        (``<kind>-claim-<uid>.json``); every other file in the dir, the
        NVIDIA Container Toolkit's specs among them, is left alone."""
        prefix = _spec_filename("claim-")[: -len(".json")]
        try:
            names = os.listdir(self.cdi_dir)
        except OSError:
            return []
        return sorted(n[len(prefix):-len(".json")] for n in names
                      if n.startswith(prefix) and n.endswith(".json"))
