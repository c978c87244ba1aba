"""Utilities: the kernel build cache a restarted pod reuses
(``compilation_cache.py``), the profiler trace of a training run and the
node daemon's handler timing and loop supervision (``profiling.py``), and
the node daemon's copies of the JAX package's logger, metrics, decision
ledger, flight recorder, spans, inotify calls, kube-call resilience layer
and pod resource requests (``logging.py``, ``metrics.py``,
``decisions.py``, ``flightrecorder.py``, ``tracing.py``, ``inotify.py``,
``resilience.py``, ``podresources.py``)."""
