"""Tools over the port: the ring-depth sweep (``kv_sweep.py``), the kernel
leg of the bench (``bench_kernels.py``) and the node's card tree with its
prepared DRA claims (``topo.py``)."""
