"""Utilities: the kernel build cache a restarted pod reuses
(``compilation_cache.py``), the profiler trace of a training run and the
node daemon's loop supervision (``profiling.py``), and the node layers'
copies of the JAX package's logger, metrics, decision ledger, flight
recorder and trace context (``logging.py``, ``metrics.py``,
``decisions.py``, ``flightrecorder.py``, ``tracing.py``)."""
