"""Pod resource inspection: the GPU twins of the JAX package's
``utils/podresources.py`` (``tpu_request``, ``is_tpu_pod``), keyed on
``nvidia.com/gpu``.

The reference's IsGPUTopoPod/GetGPUTopoNum (utils.go:10-31): how many of
the extended resource a pod requests, with the scheduler's semantics —
the sum over app containers, then the max with each init container (init
containers run one at a time, so the pod's effective request is the max;
utils.go:14-26 through the vendored scheduler Resource type).
"""

from __future__ import annotations

from ..api import constants


def _container_request(container: dict, resource_name: str) -> int:
    resources = container.get("resources") or {}
    req = resources.get("requests") or {}
    if resource_name not in req:
        # Extended-resource semantics: specifying only limits implies
        # requests (the API server defaults it, but raw/unsubmitted pod
        # specs carry only what was written).
        req = resources.get("limits") or {}
    try:
        return int(req.get(resource_name, 0))
    except (TypeError, ValueError):
        return 0


def gpu_request(pod: dict, resource_name: str = constants.RESOURCE_NAME) -> int:
    spec = pod.get("spec") or {}
    total = sum(_container_request(c, resource_name) for c in spec.get("containers") or [])
    for init in spec.get("initContainers") or []:
        total = max(total, _container_request(init, resource_name))
    return total


def is_gpu_pod(pod: dict, resource_name: str = constants.RESOURCE_NAME) -> bool:
    return gpu_request(pod, resource_name) > 0
