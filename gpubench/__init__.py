"""The benchmark of ``k8s_device_plugin_tpu_torch``, the PyTorch and CUDA
port, on NVIDIA H100 cards: ``python3 -m gpubench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` (``run.py``), with its cells in
``BENCHMARK.json``. It imports nothing of JAX or of the JAX package."""
