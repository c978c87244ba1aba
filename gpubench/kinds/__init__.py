"""One module a kind of traffic, named by a traffic file's ``kind`` key:
how a run starts the program under test, what one timed step is, what the
program counts, and how ``correct`` is decided. A module ``kinds/<kind>.py``
has

- ``start(cell, seed, device) -> Program``: the program made from the
  seed and driven through whatever ``check`` compares;
- ``counters() -> dict[str, float]``: the program's counters now, which a
  run reads before and after its untraced window;
- ``check(cell, seed, device, evidence, devices=None) -> dict[str,
  float]``: once the program is freed, each number compared against
  ``limits/<cell>.json``; over ``devices``, the cards of a cell of several.

A kind that runs on several cards (``ranks.py``) also takes the rank's
mesh as ``start(cell, seed, device, mesh)`` and has ``gather(evidence) ->
evidence``, the whole program's evidence from each rank's, by rank.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable


@dataclasses.dataclass
class Program:
    """A started program: ``step(pool[i])`` is one timed step, returning
    a value that is not finite where the step failed; ``units_per_step``
    the work a step does in the unit of the throughput metric (tokens);
    ``evidence`` what ``check`` reads once the program is freed."""

    step: Callable[[Any], Any]
    pool: Any
    units_per_step: float
    evidence: Any


def load(name: str):
    """The module ``kinds/<name>.py``."""
    return importlib.import_module(f"gpubench.kinds.{name}")
