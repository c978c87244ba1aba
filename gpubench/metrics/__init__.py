"""One reader a metric, ``metrics/<name>.py``, found by the metric's name
in ``BENCHMARK.json``, end-to-end and per-layer alike: ``read(ctx)`` takes
``run.Context`` and returns the metric's value, or None where it finds
nothing to read (then the run leaves the metric out of its line)."""
