"""Smoke workload on the CUDA card: validate the allocated device end to
end and measure training throughput. The counterpart of the JAX package's
``workload/smoke.py`` (single-step path); the pod entry point is

    python -m k8s_device_plugin_tpu_torch.workload.smoke --bench

Checks performed:
1. torch initialises CUDA and sees the device count the allocation promised
   (CUDA_VISIBLE_DEVICES / NVIDIA_VISIBLE_DEVICES / TPU_PLUGIN_ALLOCATED_CHIPS);
2. the transformer LM trains a few AdamW steps on one device, its first
   loss is not below ln(vocab) and the loss decreases;
3. step time, tokens/s and MFU are measured, and each hand-written
   kernel's launch count over the run is reported.

``--xent-chunk N`` trains with the chunked-vocab loss (``ops/xent.py``).
Not carried yet (ROADMAP.md, Queue 1): inner_steps > 1 with the
chunked-vocab A/B, and training over more than one device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

import torch

from ..device import resolve_device
from ..ops import LAUNCHES
from . import train
from .chips import expected_device_count, peak_flops_for
from .model import ModelConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_smoke(
    steps: int = 20,
    cfg: ModelConfig | None = None,
    batch_per_device: int = 8,
    seed: int = 0,
    device: str | torch.device | None = None,
    xent_chunk: int = 0,
    emit=None,
) -> dict:
    """Train ``steps`` timed steps after one untimed first step on one
    device and return the report. ``device`` defaults to the CUDA card
    (raising when there is none); pass ``device="cpu"`` for the plain
    PyTorch path. ``xent_chunk`` > 0 sets the config's chunked-vocab loss
    at that chunk size.

    ``emit``, when given, is called with a snapshot of the report after
    each milestone (devices up, first step), tagged ``partial``, so a
    caller that must kill the process keeps the best partial report."""
    report: dict = {"ok": None}

    def _emit(stage: str) -> None:
        if emit is not None:
            snap = dict(report)
            snap["partial"] = stage
            emit(snap)

    t0 = time.monotonic()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        n_devices = torch.cuda.device_count()
        torch.empty(1, device=dev)  # the context is up
        kind = torch.cuda.get_device_name(dev)
    else:
        n_devices, kind = 1, "cpu"
    t_devices = time.monotonic() - t0
    expected = expected_device_count() if dev.type == "cuda" else None

    cfg = cfg or ModelConfig()
    if xent_chunk:
        cfg = dataclasses.replace(cfg, xent_chunk=xent_chunk)
    launches0 = dict(LAUNCHES)
    report.update(
        {
            "backend": dev.type,
            "devices": n_devices,
            "devices_used": 1,
            "device_kind": kind,
            "expected_devices": expected,
            "devices_match": expected is None or expected == n_devices,
            "time_to_devices_s": round(t_devices, 3),
            "xent_chunk": cfg.xent_chunk,
        }
    )
    _emit("devices_up")

    model, optimizer = train.make_train_state(cfg, dev, seed)
    batch = batch_per_device
    # Tokens are uniform random, so the step-1 loss of an untrained model
    # cannot be below ln(vocab) (cross entropy vs independent logits); a
    # value below the floor means the computation is wrong.
    loss_floor = math.log(cfg.vocab_size)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen
    ).to(dev)

    t1 = time.monotonic()
    first_loss = float(train.train_step(model, optimizer, tokens))
    t_first = time.monotonic() - t1
    report.update(
        {
            "time_to_first_step_s": round(t_first, 3),
            "time_to_ready_s": round(t_first, 3),
            "first_loss": round(first_loss, 4),
            "first_loss_floor": round(loss_floor, 4),
            "first_loss_sane": first_loss > loss_floor - 0.25,
        }
    )
    _emit("first_step")

    # The same batch every step: memorising it makes the loss fall even
    # on a short run (fresh data would pin it at the ln(vocab) floor).
    _sync(dev)
    t2 = time.monotonic()
    loss = torch.tensor(first_loss)
    for _ in range(steps):
        loss = train.train_step(model, optimizer, tokens)
    _sync(dev)
    step_time = (time.monotonic() - t2) / max(steps, 1)
    final_loss = float(loss)

    flops_step = cfg.train_flops_per_step(batch)
    peak = peak_flops_for(kind) if dev.type == "cuda" else None
    mfu = flops_step / step_time / peak if peak else None
    report.update(
        {
            "step_time_s": round(step_time, 5),
            "tokens_per_s": round(batch * cfg.max_seq_len / step_time, 1),
            "model_flops_per_step": flops_step,
            "peak_flops_bf16": peak,
            "mfu": round(mfu, 4) if mfu is not None else None,
            "final_loss": round(final_loss, 4),
            "loss_decreased": final_loss < first_loss,
            "measured_steps": steps,
            "kernel_launches": {
                name: LAUNCHES[name] - launches0[name] for name in LAUNCHES
            },
        }
    )
    report["ok"] = (
        bool(report["devices_match"])
        and report["loss_decreased"]
        and report["first_loss_sane"]
        and math.isfinite(final_loss)
    )
    return report


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-per-device", type=int, default=8)
    p.add_argument(
        "--bench", action="store_true",
        help="use the ModelConfig.bench() shape (d_model 2048, seq 2048)",
    )
    p.add_argument(
        "--xent-chunk", type=int, default=0,
        help="train with the chunked-vocab CE (ops/xent.py) at this chunk "
        "size (0 = full-logits loss)",
    )
    p.add_argument(
        "--device", default=None,
        help="'cuda' (the default) or 'cpu' for the plain PyTorch path",
    )
    p.add_argument(
        "--no-stream", action="store_true",
        help="suppress the per-milestone partial JSON lines (the final "
        "report line is always printed)",
    )
    args = p.parse_args(argv)

    def emit(snapshot: dict) -> None:
        print(json.dumps(snapshot), flush=True)

    report = run_smoke(
        steps=args.steps,
        cfg=ModelConfig.bench() if args.bench else None,
        batch_per_device=args.batch_per_device,
        device=args.device,
        xent_chunk=args.xent_chunk,
        emit=None if args.no_stream else emit,
    )
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
