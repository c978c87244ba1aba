"""Workload utilities: the kernel build cache a restarted pod reuses
(``compilation_cache.py``) and the profiler trace of a training run
(``profiling.py``)."""
