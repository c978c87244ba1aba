"""Tools over the port's kernels: the ring-depth sweep (``kv_sweep.py``)
and the kernel leg of the bench (``bench_kernels.py``)."""
