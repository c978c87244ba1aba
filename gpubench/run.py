"""Run one cell of the port's benchmark once.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. A
cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<name>.json``, whose ``family`` names the module of
``families/`` that builds the program's model and holds its plain
reference), a traffic (``traffic/<name>.json``, read by ``generator.py``,
whose ``kind`` names the module of ``kinds/`` that starts the program and
decides ``correct``) and the limits of its correctness check
(``limits/<cell>.json``).

A run starts the program through its kind (for ``train``: the weights and
batches made on the card from ``--seed``, loaded into the port's model,
``k8s_device_plugin_tpu_torch``, and the first three steps of the port's
``workload.train.train_step`` taken and read). That is its set-up, with
the kernels' build (into ``gpubench/.cache``, so only a checkout's first
run builds) and the card's start. Then it times ``--seconds`` of further
steps over inputs kept on the card, and with ``--trace 1`` traces a few
more. Then it frees the program's state, lets the kind check what the
program produced against the plain reference, and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones, each read by
``metrics/<name>.py`` from a ``Context``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each compared number beside its limit,
which also end standard error.

A cell of several cards (``chips`` > 1) runs one rank process a card
(``ranks.py``); the rest of this module is then what each rank and the
launcher share.

Exit codes: 0 with a result; 2 without the cell's cards; 3 when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``k8s_device_plugin_tpu`` was
loaded (in this process or in a rank); 1 on any other failure. No result
is printed unless the code is 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_device_plugin_tpu")
# Host seconds of steps in the traced window (``--trace 1``), after one
# traced step that is not read.
TRACE_SECONDS = 3.0


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = _json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(
        name=name, chips=w["chips"],
        config=_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock, from its start
    time since boot (``/proc``, 1/CLK_TCK s); now where that is unreadable."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - started)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Forbidden(RuntimeError):
    """A rank of the run loaded one of ``FORBIDDEN`` (``found``)."""

    def __init__(self, found: list[str]):
        super().__init__(", ".join(found))
        self.found = found


class _Solo:
    """When a window of a run in one process ends: by its own clock."""

    def until(self, label: str, seconds: float, least: int = 0):
        """``done(steps, elapsed_s)`` of the window ``label``: true once
        ``seconds`` have passed and at least ``least`` steps were taken."""
        return lambda n, elapsed: elapsed >= seconds and n >= least

    def post(self, label: str, value: str) -> None:
        """Tell the other ranks ``value`` under ``label``: no one to tell."""


SOLO = _Solo()


class _Marks:
    """Step ends: CUDA events recorded on the stream on the card, the host
    clock on the CPU (whose steps are synchronous)."""

    def __init__(self, cuda: bool):
        import torch

        self.cuda = cuda
        self.torch = torch

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def intervals_s(self, marks) -> list[float]:
        if not self.cuda:
            return [b - a for a, b in zip(marks, marks[1:])]
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]


def _sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def _window(step, pool, first: int, seconds: float, cuda: bool, counters, team=SOLO) -> dict:
    """Steps over ``pool`` from input ``first`` until ``seconds`` of host
    time have passed, and at least two steps for a percentile, then a
    synchronise; with the change of the program's ``counters()``. Over
    several ranks, ``team`` (``ranks.Team``) ends it on every rank after
    the same step."""
    done = team.until("window", seconds, 2)
    marks_of = _Marks(cuda)
    _sync(cuda)
    before = counters()
    marks, dispatch, outputs = [marks_of.mark()], [], []
    opened = time.monotonic()
    t0 = time.perf_counter()
    i = first
    while True:
        a = time.perf_counter()
        outputs.append(step(pool[i % len(pool)]))
        b = time.perf_counter()
        marks.append(marks_of.mark())
        dispatch.append(b - a)
        i += 1
        if done(i - first, b - t0):
            break
    _sync(cuda)
    t1 = time.perf_counter()
    after = counters()
    return {"opened": opened, "seconds": t1 - t0, "steps": i - first, "next": i,
            "step_s": marks_of.intervals_s(marks), "dispatch_s": dispatch, "outputs": outputs,
            "counters": {k: after[k] - before.get(k, 0) for k in after}}


@contextlib.contextmanager
def _port_spans():
    """The port's own spans (``utils.tracing``), recorded while the block
    runs: yields the list that holds, once the block is done, those that
    started in it."""
    from k8s_device_plugin_tpu_torch.utils import tracing

    was = tracing.enabled()
    tracing.enable()
    since = time.time_ns()
    found: list = []
    try:
        yield found
    finally:
        if not was:
            tracing.disable()
        found.extend(sp for sp in tracing.COLLECTOR.spans() if sp["start_ns"] >= since)


def _traced(step, pool, first: int, cuda: bool, team=SOLO):
    """``TRACE_SECONDS`` of steps under the profiler, after one traced step
    that is not read (``trace.py`` says how the window is marked); with the
    port's spans that started in the window. A trace that lost one of its
    markers (``trace.MarkerLost``) is taken once more, said on standard
    error; a second loss fails the run. Over several ranks this runs on the
    first, and ``team`` tells the others each attempt's end and outcome
    (``ranks.follow_traced``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    if cuda:
        import torch

        activities, mark = [ProfilerActivity.CUDA], lambda: torch.cuda._sleep(1)
    else:
        activities, mark = [ProfilerActivity.CPU], lambda: None
    for attempt in (1, 2):
        scope = None if cuda else record_function(trace.WINDOW)
        done = team.until(f"trace{attempt}", TRACE_SECONDS)
        with profile(activities=activities) as prof:
            step(pool[first % len(pool)])
            _sync(cuda)
            i = first + 1
            with scope or contextlib.nullcontext(), _port_spans() as spans:
                mark()
                t0 = time.perf_counter()
                while True:
                    step(pool[i % len(pool)])
                    i += 1
                    if done(i - first - 1, time.perf_counter() - t0):
                        break
                mark()
                _sync(cuda)
        try:
            summary = trace.summarize(prof, i - first - 1)
        except trace.MarkerLost as e:
            if attempt == 2:
                raise
            print(f"gpubench: {e}; tracing the window once more", file=sys.stderr)
            team.post(f"trace{attempt}", "again")
            first = i
            continue
        team.post(f"trace{attempt}", "done")
        return summary, spans


@dataclasses.dataclass
class Context:
    """What a metric's reader reads. Every run: ``window``, the untraced
    window (``seconds``, ``steps``, ``step_s`` between the step ends on the
    card, ``dispatch_s`` of each step's call on the host, ``counters``: the
    change of the kind's ``counters()``), the program's ``units_per_step``,
    ``peak_bytes`` over the window (None off the card), ``setup_s``, and
    the cell's ``family``, ``sizes`` and ``traffic``, and the ``chips`` it
    runs on. A traced run also: ``summary`` (``trace.Summary``: groups,
    flash kernels, every event of the traced window) and ``spans``, the
    port's own that started there. Over several cards all but ``chips`` and
    ``peak_bytes`` (the fullest card's) are the first rank's."""

    window: dict
    units_per_step: float
    peak_bytes: int | None
    setup_s: float
    family: object
    sizes: object
    traffic: dict
    summary: object = None
    spans: list = dataclasses.field(default_factory=list)
    chips: int = 1


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             start: float | None = None) -> dict:
    """One run of ``cell``: the result line's object, ``checks`` last."""
    if cell.chips > 1:
        from . import ranks

        return ranks.run_cell(cell, seed, seconds, trace, device, start)
    import torch

    from k8s_device_plugin_tpu_torch.device import resolve_device

    from . import families, kinds

    start = time.monotonic() if start is None else start
    kind = kinds.load(cell.traffic["kind"])
    parts = [("imports", time.monotonic())]
    fam = families.load(cell.config)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
    parts.append(("card", time.monotonic()))
    prog = kind.start(cell, seed, dev)
    parts.append(("program", time.monotonic()))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    win = _window(prog.step, prog.pool, 3, seconds, cuda, kind.counters)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # Where the set-up went, for the reader of standard error.
    edges = [start] + [t for _, t in parts]
    print("setup_s " + ", ".join(f"{name} {b - a:.3f}" for (name, _), a, b
                                 in zip(parts, edges, edges[1:])), file=sys.stderr)
    summary, spans = _traced(prog.step, prog.pool, win["next"], cuda) if trace else (None, [])
    outputs = torch.stack([torch.as_tensor(o).float() for o in win.pop("outputs")])
    failed = int((~torch.isfinite(outputs)).sum())
    ctx = Context(window=win, units_per_step=prog.units_per_step, peak_bytes=peak,
                  setup_s=win["opened"] - start, family=fam, sizes=fam.sizes(cell.config),
                  traffic=cell.traffic, summary=summary, spans=spans)
    evidence = prog.evidence
    del prog, outputs
    if cuda:
        torch.cuda.empty_cache()

    found = kind.check(cell, seed, dev, evidence)
    return result(cell, ctx, found, failed, trace, {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": peak or 0,
    })


def result(cell: Cell, ctx: Context, found: dict, failed: int, trace: bool, device: dict) -> dict:
    """The result line's object of a run that read ``ctx``, whose kind's
    check gave ``found`` and whose window had ``failed`` steps that were
    not finite; ``device`` as the line gives it. ``checks`` last."""
    from . import correct

    found = {**found, "failed_steps": failed}
    checks = correct.checks(found, {**cell.limits, "failed_steps": 0})

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    summary = ctx.summary
    out = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": ctx.window["steps"],
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    out["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else None,
                         "limit": c["limit"]} for k, c in checks.items()}
    return out


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    start = process_start()
    args = _parse(argv)
    # Every build and kernel cache stays at a fixed place in the checkout.
    os.environ["TPU_WORKLOAD_COMPILATION_CACHE_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
        found = forbidden_modules()
    except Forbidden as e:
        found = e.found
    if found:
        print(f"gpubench: loaded {', '.join(found)}: the port may not load JAX or its package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] is not None and c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
