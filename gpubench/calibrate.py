"""The readings that a training cell's correctness limits are set from, on
the card at the cell's own size:

    python3 -m gpubench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--head-seeds 1,2,3] [--fault-seeds 1,2,3]

For each seed: the program's three steps (as a run's set-up takes them)
against the plain reference's, ``correct.gaps`` of the two (the lower
readings); on ``--control-seeds`` the control, the reference computed one
precision step lower (``precision="control"``) put in the program's place;
on ``--head-seeds`` the reference with its head alone one step lower
(``precision="head_tf32"``); on ``--fault-seeds`` the program with half of
each batch left out (``faults.planted("half_batch")``) and, in a cell of
several cards, with the exchange between them left out (``no_exchange``).
A cell of several cards runs the program through one pool of rank
processes (``ranks.rank_evidence``, as a run's ranks start it) and the
reference over its cards, once every program side is read and the ranks
have exited. One JSON line a seed, with each side's loss a step, then a
summary: the largest program reading and the smallest reading of each
other side, number by number. A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--head-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at the CPU's pace")
    args = p.parse_args(argv)

    from . import run

    os.environ["TPU_WORKLOAD_COMPILATION_CACHE_DIR"] = str(run.CACHE / "kernels")
    cell = run.load_cell(args.workload)
    with contextlib.ExitStack() as stack:
        return _calibrate(cell, args, stack)


def _calibrate(cell, args, stack) -> int:
    import torch

    from . import correct, faults, families, kinds, ranks

    fam = families.load(cell.config)
    kind = kinds.load(cell.traffic["kind"])
    sz = fam.sizes(cell.config)
    dev = torch.device(args.device)
    devices = [dev]
    opt = cell.traffic["optimizer"]
    fault_kinds = ("half_batch",)

    if cell.chips > 1:
        from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool

        if dev.type == "cuda":
            from k8s_device_plugin_tpu_torch.ops._build import build_all

            build_all()
            devices = [torch.device("cuda", i) for i in range(cell.chips)]
        else:
            devices = [dev] * cell.chips
        pool = stack.enter_context(RankPool(cell.chips, dev.type, timeout_s=ranks.RANK_TIMEOUT_S))
        fault_kinds += faults.SPLIT_KINDS

        def program(seed):
            return kind.gather(pool.run(ranks.rank_evidence, cell, seed, dev.type, faults.ACTIVE))
    else:
        def program(seed):
            evidence = kind.start(cell, seed, dev).evidence
            torch.cuda.empty_cache()
            return evidence

    # Every program side first, then (the ranks gone) every reference, so
    # that the two never share a card's memory.
    seeds = sorted(set(args.seeds) | set(args.control_seeds) | set(args.head_seeds)
                   | set(args.fault_seeds))
    programs, faulted, took = {}, {}, {}
    for seed in seeds:
        t = time.monotonic()
        programs[seed] = program(seed)
        if seed in args.fault_seeds:
            for fault in fault_kinds:
                with faults.planted(fault):
                    faulted[seed, fault] = program(seed).readings
        took[seed] = time.monotonic() - t
    stack.close()

    lower = {"control": args.control_seeds, "head_tf32": args.head_seeds}
    worst: dict[str, dict[str, float]] = {side: {} for side in
                                          ("program", "control", "head_tf32", *fault_kinds)}
    for seed in seeds:
        line = {"seed": seed}
        t = time.monotonic()
        prog = programs[seed]
        batches = prog.batches.to(dev)
        ref = correct.reference_readings(fam, sz, seed, batches, opt, dev, devices=devices)
        sides = {"program": prog.readings}
        for precision, chosen in lower.items():
            if seed in chosen:
                sides[precision] = correct.reference_readings(fam, sz, seed, batches, opt, dev,
                                                              precision, devices)
        sides.update({fault: r for (s, fault), r in faulted.items() if s == seed})
        line.update({side: correct.gaps(r, ref, fam.HEAD_LEAVES) for side, r in sides.items()})
        line["head_leaves"] = {side: correct.leaf_gaps(r.grad_norms, ref.grad_norms,
                                                        fam.HEAD_LEAVES)
                               for side, r in sides.items()}
        line["losses"] = {"reference": ref.losses, **{s: r.losses for s, r in sides.items()}}
        for key, got, base in (("grad", prog.readings.grad_norms, ref.grad_norms),
                               ("change", prog.readings.change_norms, ref.change_norms)):
            leaf = max(base, key=lambda n: abs(got[n] - base[n]) / max(base[n], 1e-30))
            line[f"worst_{key}_leaf"] = [leaf, got[leaf], base[leaf]]
        line["seconds"] = {"program": took[seed], "reference": time.monotonic() - t}
        if dev.type == "cuda":
            line["memory_peak_bytes"] = [torch.cuda.max_memory_allocated(d) for d in
                                         dict.fromkeys(devices)]
        print(json.dumps(line), flush=True)
        for side in worst:
            pick = max if side == "program" else min
            for k, v in line.get(side, {}).items():
                worst[side][k] = pick(worst[side].get(k, v), v)
    print(json.dumps({"workload": cell.name, "largest_program": worst["program"],
                      **{f"smallest_{side}": worst[side] for side in worst if side != "program"}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
