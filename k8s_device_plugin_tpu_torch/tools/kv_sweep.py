"""Flash-attention ring-depth sweep on the card: the counterpart of the JAX
package's ``tools/kv_sweep.py``.

Times the flash kernels (``ops/attention.py``) fwd+bwd across pinned
(forward, backward) ring depths at one or more sequence lengths, with the
microbench's timing (``ops/microbench.py``: CUDA events around ``inner``
back-to-back calls, the median over ``iters`` windows). The depth of the
K/V ring (forward) and of the streamed tiles' ring (dQ, dK/dV) is the
Hopper kernels' counterpart of the TPU kernels' ``(block_q, block_kv)``
tiling: the rows of a tile are fixed by the warpgroup shape, and the depth
is what the shared memory leaves free to choose. Each row is emitted as
it completes, so a run cut short keeps its finished rows.

    python -m k8s_device_plugin_tpu_torch.tools.kv_sweep --seqs 2048
    python -m k8s_device_plugin_tpu_torch.tools.kv_sweep --seqs 2048,8192 \
        --stages 4x2,3x2,2x2,4x3,3x3,2x3

A depth pair whose instance fails to launch is an ``error`` row; when that
is the default pair, the main path's, the report says ``ok: false``. Each
sequence length's fastest pair is then held against the dense
``reference_attention`` (max |diff| < 0.05, the JAX tool's guard) and
against the kernels' plain version (``bf16_agreement``): a fast but wrong
instance flips ``ok`` to false.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..device import resolve_device
from ..ops import attention
from ..ops.microbench import _bench_side, _grad_step, _randn


def _sweep_case(seq: int, fwd_stages: int, bwd_stages: int, batch: int, heads: int, d: int,
                iters: int, inner: int, dev: torch.device) -> dict:
    """One pinned-depth fwd+bwd timing row (the flash side only; the
    microbench owns the flash-vs-dense comparison)."""
    shape = (batch, heads, seq, d)
    q, k, v = (_randn(shape, s, dev) for s in (0, 1, 2))

    def flash(q, k, v):
        return attention.flash_attention(q, k, v, fwd_stages=fwd_stages, bwd_stages=bwd_stages)

    timing = _bench_side(_grad_step(flash, q, k, v, wrt=3), inner, iters, dev)
    if "error" in timing:
        return {"seq": seq, "fwd_stages": fwd_stages, "bwd_stages": bwd_stages,
                "error": timing["error"]}
    # Causal fwd+bwd FLOPs, the model of microbench._attention_case.
    flops = 3.5 * 2.0 * batch * heads * seq * seq * d
    timing["tflops"] = round(flops / (timing["ms"] * 1e-3) / 1e12, 2)
    return {"seq": seq, "fwd_stages": fwd_stages, "bwd_stages": bwd_stages,
            "shape": list(shape), "timing": timing}


def _agreement(seq: int, fwd_stages: int, bwd_stages: int, d: int, dev: torch.device) -> dict:
    """The winning instance's forward at (1, 2, seq, d) against the dense
    oracle (max |diff| < 0.05) and against the kernels' plain version
    (``bf16_agreement``)."""
    shape = (1, 2, seq, d)
    q, k, v = (_randn(shape, s, dev) for s in (7, 8, 9))
    with torch.no_grad():
        f = attention.flash_attention(q, k, v, fwd_stages=fwd_stages, bwd_stages=bwd_stages)
        r = attention.reference_attention(q, k, v)
        plain = attention.flash_attention_fwd_plain(q, k, v)[0]
    max_diff = float((f.float() - r.float()).abs().max())
    plain_agree = attention.bf16_agreement(f, plain)
    return {"max_abs_diff": round(max_diff, 5), "ok": max_diff < 0.05 and plain_agree["ok"],
            "vs_plain": plain_agree}


def run_sweep(seqs: list, stages: list, iters: int = 5, inner: int = 16, batch: int = 0,
              heads: int = 8, d: int = 128, emit=None, device=None) -> dict:
    """Time every ``(fwd_stages, bwd_stages)`` pair of ``stages`` at every
    seq of ``seqs``; the report has the JAX tool's keys, with the depths in
    the place of its tiling. ``device`` defaults to the card (raising
    without one); ``device="cpu"`` runs the plain version, which has no
    ring, for the schema and the guards only. A depth the kernels are not
    built for raises before anything runs."""
    for fwd_stages, bwd_stages in stages:
        attention.check_stages(fwd_stages, bwd_stages)
    dev = resolve_device(device)
    t0 = time.monotonic()
    report = {
        "ok": True,
        "tool": "kv_sweep",
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "iters": iters,
        "inner": inner,
        "rows": [],
    }
    default = (attention.DEFAULT_FWD_STAGES, attention.DEFAULT_BWD_STAGES)
    for seq in seqs:
        b = batch or max(1, min(4, 8192 // seq))
        for fwd_stages, bwd_stages in stages:
            row = _sweep_case(seq, fwd_stages, bwd_stages, b, heads, d, iters, inner, dev)
            if "error" in row and (fwd_stages, bwd_stages) == default:
                report["ok"] = False  # the main path's instance failed
            report["rows"].append(row)
            report["wall_s"] = round(time.monotonic() - t0, 1)
            if emit:
                emit(report)
    best = {}
    for row in report["rows"]:
        ms = row.get("timing", {}).get("ms")
        if ms and (row["seq"] not in best or ms < best[row["seq"]]["ms"]):
            best[row["seq"]] = {"ms": ms, "fwd_stages": row["fwd_stages"],
                                "bwd_stages": row["bwd_stages"]}
    report["best_by_seq"] = {str(s): v for s, v in best.items()}
    report["agreement"] = {}
    for seq_s, win in report["best_by_seq"].items():
        report["agreement"][seq_s] = _agreement(int(seq_s), win["fwd_stages"],
                                                win["bwd_stages"], d, dev)
        if emit:
            emit(report)
    if any(a.get("ok") is False for a in report["agreement"].values()):
        report["ok"] = False
    report["wall_s"] = round(time.monotonic() - t0, 1)
    return report


def parse_stages(text: str) -> list:
    """``"4x2,3x2"`` -> ``[(4, 2), (3, 2)]``."""
    return [tuple(int(x) for x in pair.split("x")) for pair in text.split(",") if pair]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seqs", type=str, default="2048")
    p.add_argument("--stages", type=str, default="4x2,3x2,2x2,4x3,3x3,2x3",
                   help="comma-separated forward x backward ring depths")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--inner", type=int, default=16)
    p.add_argument("--batch", type=int, default=0,
                   help="0 = scale inversely with seq (the microbench's rule)")
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu' for the plain PyTorch path")
    args = p.parse_args(argv)
    report = run_sweep(
        [int(s) for s in args.seqs.split(",") if s], parse_stages(args.stages),
        iters=args.iters, inner=args.inner, batch=args.batch, heads=args.heads,
        d=args.head_dim, emit=lambda r: print(json.dumps(r), flush=True), device=args.device,
    )
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
