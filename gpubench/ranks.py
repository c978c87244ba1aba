"""A cell of several cards (``chips`` > 1): one rank process a card, started
through the port's own launcher (``parallel.distributed.RankPool``, as the
smoke pod starts a pod's ranks), each on the cell's mesh (the traffic's
``mesh``: data, fsdp, model).

The launcher builds the kernels once (``ops._build.build_all``) and starts
the ranks. Each rank builds the mesh (``parallel.mesh.make_mesh``), starts
the program through the kind on it (the model loaded from the seed's
weights and laid out with ``train.shard_model``, its three checked steps
read on its own slices), and after a barrier outside the timed part runs
the window of ``run._window``. The first rank's clock ends the window:
``Team`` posts the count of steps that every rank takes to the launcher's
store, and the others poll it after each step near the window's end, with
no synchronise of the card (``agree_ms`` on standard error: their polls'
host ms a step of the untraced window). With
``--trace 1`` the first rank alone runs under the profiler
(``run._traced``) while the others follow (``follow_traced``).

Every rank hands back its window, its card's peak, the modules it loaded
and its evidence, and the ranks exit. Then the launcher puts the whole
program's evidence together (the kind's ``gather``), runs the kind's check
over the cards (the reference laid over them, ``families/<family>.place``),
and reads the metrics from the first rank's window and trace: the step
times, tokens a second (the global batch counted once) and ``setup_s``
(the launcher's start to the first rank's window) are the first rank's;
``memory_peak_bytes`` and ``peak_mem_gib`` the fullest card's, each card's
on standard error; ``count`` the cell's cards.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import os
import sys
import time

from . import run

# Steps that every rank takes past the one at which the first rank's clock
# ends a window. A rank's host runs at most its launch queue ahead of its
# card, and the cards at most one collective apart, so no rank has passed
# that step when it reads it.
MARGIN = 2
# Seconds before a window's end, by its own clock, from which a rank other
# than the first looks for the agreed step: the ranks open a window
# together, so their clocks agree to well within this.
EARLY_S = 2.0
# The longest a rank may take to join, or to run its part of a run.
RANK_TIMEOUT_S = 600.0


class Team:
    """The stop rule of a window over the ranks of one run: the first rank
    (``lead``) ends it by its own clock and posts the last step to the
    launcher's store; every other rank checks the store after each step of
    the window's last ``EARLY_S`` by its own clock, and stops at that step.
    ``poll_s``: a follower's host seconds in the checks."""

    def __init__(self, store, lead: bool):
        self.store, self.lead, self.poll_s = store, lead, 0.0

    def until(self, label: str, seconds: float, least: int = 0):
        """``done(steps, elapsed_s)`` of the window ``label``, as
        ``run._Solo.until`` decides it on the first rank."""
        key = f"gpubench.{label}.last"
        last = None

        def done(n: int, elapsed: float) -> bool:
            nonlocal last
            if last is None and self.lead:
                if elapsed >= seconds and n >= least:
                    last = n + MARGIN
                    self.store.set(key, str(last))
            elif last is None and elapsed >= seconds - EARLY_S:
                t = time.perf_counter()
                if self.store.check([key]):
                    last = int(self.store.get(key))
                    if n > last:
                        raise RuntimeError(f"window {label}: this rank took {n} steps, "
                                           f"past the agreed {last}")
                self.poll_s += time.perf_counter() - t
            return last is not None and n >= last

        return done

    def post(self, label: str, value: str) -> None:
        self.store.set(f"gpubench.{label}", value)

    def wait(self, label: str) -> str:
        return self.store.get(f"gpubench.{label}").decode()


def follow_traced(step, pool, first: int, cuda: bool, team: Team) -> None:
    """A rank other than the first through ``run._traced``'s windows: the
    same steps, unprofiled, each window's end agreed, and a window again
    where the first rank's trace lost a marker."""
    for attempt in (1, 2):
        done = team.until(f"trace{attempt}", run.TRACE_SECONDS)
        step(pool[first % len(pool)])
        run._sync(cuda)
        i = first + 1
        t0 = time.perf_counter()
        while True:
            step(pool[i % len(pool)])
            i += 1
            if done(i - first - 1, time.perf_counter() - t0):
                break
        run._sync(cuda)
        if team.wait(f"trace{attempt}") != "again":
            return
        first = i


def _store():
    """A client of the launcher's store, which ``RankPool`` names in the
    rank's environment."""
    import datetime

    import torch.distributed as dist

    return dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                         is_master=False, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


@functools.cache
def _mesh(shape: tuple[int, ...], device_type: str):
    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape=shape, device=device_type)


def _device(device_type: str):
    from k8s_device_plugin_tpu_torch.parallel.distributed import local_device

    return local_device(device_type)


def _planted(fault: str | None):
    import contextlib

    from . import faults

    return faults.planted(fault) if fault else contextlib.nullcontext()


def _evidence_off_card(evidence):
    """The evidence with its tensors on the host, to cross to the launcher."""
    return dataclasses.replace(evidence, batches=evidence.batches.cpu())


def rank_evidence(cell: run.Cell, seed: int, device_type: str, fault: str | None = None):
    """A rank's job for ``calibrate.py``: the program started on the mesh
    (its three checked steps) and its evidence, with the program freed."""
    import torch

    from . import kinds

    dev = _device(device_type)
    with _planted(fault):
        prog = kinds.load(cell.traffic["kind"]).start(cell, seed, dev,
                                                      _mesh(tuple(cell.traffic["mesh"]), dev.type))
        evidence = _evidence_off_card(prog.evidence)
    del prog
    if dev.type == "cuda":
        # The next seed's program starts on a card the last one has left.
        gc.collect()
        torch.cuda.empty_cache()
    return evidence


def rank_run(cell: run.Cell, seed: int, seconds: float, trace: bool, start: float,
             device_type: str, fault: str | None = None) -> dict:
    """A rank's part of one run (see the module's docstring)."""
    import torch
    import torch.distributed as dist

    from . import kinds

    dev = _device(device_type)
    cuda = dev.type == "cuda"
    lead = dist.get_rank() == 0
    kind = kinds.load(cell.traffic["kind"])
    with _planted(fault):
        prog = kind.start(cell, seed, dev, _mesh(tuple(cell.traffic["mesh"]), dev.type))
        started = time.monotonic()
        team = Team(_store(), lead)
        if cuda:
            dist.barrier(device_ids=[dev.index])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        else:
            dist.barrier()
        win = run._window(prog.step, prog.pool, 3, seconds, cuda, kind.counters, team)
        polled_s = team.poll_s
        peak = torch.cuda.max_memory_allocated() if cuda else None
        summary, spans = None, []
        if trace and lead:
            summary, spans = run._traced(prog.step, prog.pool, win["next"], cuda, team)
        elif trace:
            follow_traced(prog.step, prog.pool, win["next"], cuda, team)
        outputs = torch.stack([torch.as_tensor(o).float() for o in win.pop("outputs")])
        out = {"window": win, "units_per_step": prog.units_per_step, "peak": peak,
               "failed": int((~torch.isfinite(outputs)).sum()), "summary": summary,
               "spans": spans, "evidence": _evidence_off_card(prog.evidence),
               "started": started, "poll_s": polled_s}
    del prog, outputs
    out["loaded"] = run.forbidden_modules()
    return out


def run_cell(cell: run.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             start: float | None = None) -> dict:
    """One run of a cell of ``cell.chips`` cards (see the module's
    docstring): the result line's object, ``checks`` last."""
    import torch

    from k8s_device_plugin_tpu_torch.device import resolve_device
    from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool

    from . import families, faults, kinds

    start = time.monotonic() if start is None else start
    device_type = resolve_device(device).type
    cuda = device_type == "cuda"
    if cuda:
        from k8s_device_plugin_tpu_torch.ops._build import build_all

        build_all()  # once, before the ranks would each build
    parts = [("build", time.monotonic())]
    with RankPool(cell.chips, device_type, timeout_s=RANK_TIMEOUT_S) as pool:
        parts.append(("ranks", time.monotonic()))
        got = pool.run(rank_run, cell, seed, seconds, trace, start, device_type, faults.ACTIVE)
    lead = got[0]
    parts += [("program", lead["started"]), ("barrier", lead["window"]["opened"])]
    edges = [start] + [t for _, t in parts]
    print("setup_s " + ", ".join(f"{name} {b - a:.3f}" for (name, _), a, b
                                 in zip(parts, edges, edges[1:])), file=sys.stderr)
    loaded = sorted({m for r in got for m in r["loaded"]})
    if loaded:
        raise run.Forbidden(loaded)
    steps = [r["window"]["steps"] for r in got]
    if len(set(steps)) != 1:
        raise RuntimeError(f"the ranks took {steps} window steps, not one count")
    per_step = [r["poll_s"] * 1e3 / r["window"]["steps"] for r in got[1:]]
    print("agree_ms " + " ".join(f"{ms:.4f}" for ms in per_step), file=sys.stderr)
    peaks = [r["peak"] for r in got]
    if cuda:
        print("peak_bytes " + " ".join(f"card{i} {b}" for i, b in enumerate(peaks)),
              file=sys.stderr)

    kind = kinds.load(cell.traffic["kind"])
    fam = families.load(cell.config)
    devices = ([torch.device("cuda", i) for i in range(cell.chips)] if cuda
               else [torch.device("cpu")] * cell.chips)
    win = lead["window"]
    ctx = run.Context(window=win, units_per_step=lead["units_per_step"],
                      peak_bytes=max(peaks) if cuda else None, setup_s=win["opened"] - start,
                      family=fam, sizes=fam.sizes(cell.config), traffic=cell.traffic,
                      summary=lead["summary"], spans=lead["spans"], chips=cell.chips)
    evidence = kind.gather([r["evidence"] for r in got])
    found = kind.check(cell, seed, devices[0], evidence, devices)
    return run.result(cell, ctx, found, lead["failed"], trace, {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": max(peaks) if cuda else 0,
    })
