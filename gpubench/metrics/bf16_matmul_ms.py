"""Device ms a traced step of the bf16 products (projections, MLP) through cuBLAS."""

from ._groups import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "matmul")
