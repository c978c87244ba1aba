"""PyTorch/CUDA port of ``k8s_device_plugin_tpu``: the smoke workload the
plugin schedules, and the node daemon that hands out NVIDIA cards
(``python -m k8s_device_plugin_tpu_torch``).

The JAX package beside this one is the reference each module here is held
against. Module paths mirror it (``ops/attention.py``,
``workload/model.py``, ``server/plugin.py``, ...). This package imports
``torch``, ``numpy`` and, in the node daemon, ``grpc``, ``protobuf``,
``requests`` and ``yaml``: never ``jax`` and nothing of
``k8s_device_plugin_tpu``. The node daemon
reads the cards through NVML and never imports ``torch``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper uses its plain PyTorch
version instead of the hand-written CUDA kernel.
"""

__version__ = "0.1.0"
