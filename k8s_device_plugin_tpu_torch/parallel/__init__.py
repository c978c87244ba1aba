"""The parallel runtime: the process group (``distributed.py``), the
six-axis device mesh over its ranks (``mesh.py``), the collectives with
the gradients a split computation needs (``collectives.py``), ring
attention over the seq axis (``ring.py``), the GPipe schedule over the
pipe axis (``pipeline.py``) and the multi-process smoke (``mp_smoke.py``).
One rank per card: NCCL on the card, gloo on the CPU."""
