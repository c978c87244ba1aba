"""PyTorch/CUDA port of the smoke workload of ``k8s_device_plugin_tpu``.

The JAX package beside this one is the reference each module here is held
against. Module paths mirror it (``ops/attention.py``,
``workload/model.py``, ...). This package imports ``torch`` and ``numpy``
only: never ``jax`` and nothing of ``k8s_device_plugin_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper uses its plain PyTorch
version instead of the hand-written CUDA kernel.
"""

__version__ = "0.1.0"
