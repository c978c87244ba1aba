"""Shared fixtures of the benchmark's tests: a cell of ``BENCHMARK.json``
cut to a size the CPU runs in seconds (head_dim 64, as the card's flash
kernels take), and a traced window short enough for the CPU profiler."""

import dataclasses

import pytest

from gpubench import run

TINY = {"vocab_size": 256, "n_positions": 32, "n_embd": 128, "n_layer": 2, "n_head": 2,
        "n_inner": 256}


@pytest.fixture
def tiny_cell():
    def make(name: str = "smoke-bench.train", **traffic) -> run.Cell:
        cell = run.load_cell(name)
        # A chunked loss keeps its chunking, over a quarter of the tiny vocabulary.
        chunk = 64 if cell.traffic["xent_chunk"] else 0
        return dataclasses.replace(cell, config=dict(cell.config, **TINY),
                                   traffic={**cell.traffic, "batch": 4, "xent_chunk": chunk, **traffic})

    return make


@pytest.fixture
def short_trace(monkeypatch):
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.2)
