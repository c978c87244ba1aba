"""The parallel runtime: the process group (``distributed.py``), the
six-axis device mesh over its ranks (``mesh.py``) and the multi-process
smoke (``mp_smoke.py``). One rank per card: NCCL on the card, gloo on the
CPU."""
