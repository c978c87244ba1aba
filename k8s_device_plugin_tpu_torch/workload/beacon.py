"""The checkpoint beacon: a workload's last durable save, published on its
pod for the control plane. The JAX package's ``CheckpointBeacon`` as it is.

This module imports no torch, so the scheduler extender (whose process loads
neither torch nor jax) reads the annotation through the same parser the
workload's ``TrainCheckpointer`` stamps it with: ``age_from`` is that one
parser, shared by the preemption planner's victim ranking
(``extender/preemption.py``). ``workload/checkpointing.py`` re-exports the
class.
"""

from __future__ import annotations

import os
import time
from collections.abc import Callable

from ..api.constants import CHECKPOINT_TS_ANNOTATION


class CheckpointBeacon:
    """Publishes checkpoint recency to the control plane.

    After every durable save, the beacon stamps the pod's
    ``tpu.google.com/last-checkpoint`` annotation (epoch seconds) so
    the extender's preemption planner (extender/preemption.py) can
    rank this gang's restart cost truthfully: a gang that saved
    seconds ago is a cheap victim, one an hour past its save is not.
    Best-effort by design — a failed stamp costs accuracy of the cost
    ranking, never the save.

    ``stamp`` is any ``(annotations: dict) -> None`` writer; the
    common wiring is ``KubeClient.patch_pod_annotations`` curried with
    this pod's identity (``CheckpointBeacon.for_pod``)."""

    ANNOTATION = CHECKPOINT_TS_ANNOTATION

    def __init__(self, stamp: Callable[[dict], None]):
        self._stamp = stamp
        self.last_stamped: float | None = None

    @staticmethod
    def for_pod(client, namespace: str = "", name: str = ""):
        """Beacon bound to this pod via the downward-API env vars
        (POD_NAMESPACE / POD_NAME) or explicit identity."""
        ns = namespace or os.environ.get("POD_NAMESPACE", "default")
        pod = name or os.environ.get("POD_NAME", "")
        if not pod:
            return None

        def stamp(ann: dict) -> None:
            client.patch_pod_annotations(ns, pod, ann)

        return CheckpointBeacon(stamp)

    @staticmethod
    def age_from(annotations: dict | None, now: float | None = None) -> float | None:
        """Seconds since the last durable save recorded on a pod's
        annotations, or None when never stamped / unparsable — the ONE
        parser of the beacon's annotation, shared by the preemption
        planner's victim ranking and the defrag engine's
        fresh-checkpoint preference so the two cost models can never
        read the same stamp differently. Clock skew that would read
        negative clamps to 0 (a save from "the future" is simply
        fresh)."""
        raw = (annotations or {}).get(CHECKPOINT_TS_ANNOTATION)
        if not raw:
            return None
        try:
            ts = float(raw)
        except (TypeError, ValueError):
            return None
        return max(0.0, (now if now is not None else time.time()) - ts)

    def note_saved(self, step: int) -> bool:
        ts = round(time.time(), 3)
        try:
            self._stamp({self.ANNOTATION: str(ts)})
        except Exception:  # noqa: BLE001 — recency is advisory; the
            # checkpoint itself already committed
            return False
        self.last_stamped = ts
        return True
