"""Device ms a traced step of NCCL's kernels on the first rank's card
(group ``collective``): the model axis's sums (``parallel/collectives.py``:
Megatron's pair around each split region, four a layer) and the loss's
mean over the mesh, each kernel's time with its wait for the other cards.
None where no NCCL kernel ran (a cell of one card)."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "collective")
