"""The host's seconds of the CUDA graph's capture in the program's first
call (``GraphedTrainStep.capture_s``), part of ``setup_s``; None where the
run captured no graph (the CPU's eager loop, another kind of traffic)."""

from gpubench.kinds import train_graphed


def read(ctx):
    return train_graphed.LAST.get("capture_s")
