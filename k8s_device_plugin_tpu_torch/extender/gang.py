"""The gang labels of the JAX package's ``extender/gang.py``: the scheduling
gate, the two labels and the two readers /filter and /prioritize use.

A GPU pod asks for at most one node's cards; a job over several nodes is a
gang of per-node pods. Workloads create every pod of a gang with the
scheduling gate ``tpu.google.com/gang`` and the labels
``tpu.google.com/gang-name`` (the shared identity) and
``tpu.google.com/gang-size`` (the pod count), the JAX extender's keys. Gang
admission (``GangAdmission``), which removes the gates once the whole gang
fits, comes with the extender's next slice; its capacity pool places each
member on one node, since a GPU node has no multi-host slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..api import constants
from ..utils.logging import get_logger

log = get_logger(__name__)

GATE_NAME = "tpu.google.com/gang"
GANG_NAME_LABEL = constants.GANG_NAME_LABEL
GANG_SIZE_LABEL = "tpu.google.com/gang-size"


def is_gated(pod: dict) -> bool:
    gates = (pod.get("spec") or {}).get("schedulingGates") or []
    return any(g.get("name") == GATE_NAME for g in gates)


def pod_gang(pod: dict) -> Optional[Tuple[str, str, int]]:
    """(namespace, gang_name, size) when the pod carries the gang labels,
    gated or not: released members keep counting toward the gang's
    completeness. A malformed size disqualifies the pod (logged)."""
    meta = pod.get("metadata") or {}
    labels = meta.get("labels") or {}
    name = labels.get(GANG_NAME_LABEL)
    raw_size = labels.get(GANG_SIZE_LABEL)
    if not name or raw_size is None:
        return None
    try:
        size = int(raw_size)
    except ValueError:
        log.warning(
            "pod %s/%s: bad %s=%r",
            meta.get("namespace", "default"), meta.get("name"),
            GANG_SIZE_LABEL, raw_size,
        )
        return None
    if size <= 0:
        return None
    return (meta.get("namespace", "default"), name, size)
