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
each batch left out (``faults.planted("half_batch")``). One JSON line a
seed, with each side's loss a step, then a summary: the largest program
reading and the smallest reading of each other side, number by number. A
benchmark run never runs this.
"""

from __future__ import annotations

import argparse
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
    args = p.parse_args(argv)

    from . import run

    os.environ["TPU_WORKLOAD_COMPILATION_CACHE_DIR"] = str(run.CACHE / "kernels")
    import torch

    from . import correct, faults, families
    from .kinds import train

    cell = run.load_cell(args.workload)
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    dev = torch.device("cuda")
    opt = cell.traffic["optimizer"]

    def program(seed):
        evidence = train.start(cell, seed, dev).evidence
        torch.cuda.empty_cache()
        return evidence

    lower = {"control": args.control_seeds, "head_tf32": args.head_seeds}
    worst: dict[str, dict[str, float]] = {"program": {}, "control": {}, "head_tf32": {},
                                          "half_batch": {}}
    seeds = set(args.seeds) | set(args.control_seeds) | set(args.head_seeds) | set(args.fault_seeds)
    for seed in sorted(seeds):
        line = {"seed": seed}
        t = time.monotonic()
        prog = program(seed)
        ref = correct.reference_readings(fam, sz, seed, prog.batches, opt, dev)
        sides = {"program": prog.readings}
        for precision, chosen in lower.items():
            if seed in chosen:
                sides[precision] = correct.reference_readings(fam, sz, seed, prog.batches, opt,
                                                              dev, precision)
        if seed in args.fault_seeds:
            with faults.planted("half_batch"):
                sides["half_batch"] = program(seed).readings
        line.update({side: correct.gaps(r, ref, fam.HEAD_LEAVES) for side, r in sides.items()})
        line["head_leaves"] = {side: correct.leaf_gaps(r.grad_norms, ref.grad_norms,
                                                        fam.HEAD_LEAVES)
                               for side, r in sides.items()}
        line["losses"] = {"reference": ref.losses, **{s: r.losses for s, r in sides.items()}}
        for key, got, base in (("grad", prog.readings.grad_norms, ref.grad_norms),
                               ("change", prog.readings.change_norms, ref.change_norms)):
            leaf = max(base, key=lambda n: abs(got[n] - base[n]) / max(base[n], 1e-30))
            line[f"worst_{key}_leaf"] = [leaf, got[leaf], base[leaf]]
        line["seconds"] = time.monotonic() - t
        line["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
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
