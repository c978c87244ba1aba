"""Device ms a traced step of the f32 products (the tied unembed and its backward; in the chunked loss its chunks)."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "matmul_f32")
