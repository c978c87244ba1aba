"""Where the time of one training step goes on the card.

    python -m k8s_device_plugin_tpu_torch.workload.step_profile --bench \
        [--pallas-norm] [--config {dense,moe,ring,ring-chunked}]

Trains the model (through a size-1 mesh, as ``run_smoke`` on one card
does, which the ring needs) for a few warm-up steps, then traces
``--steps`` more
with ``torch.profiler`` (CPU and CUDA activity) and prints one JSON line:
the step time from the host clock (synchronised), the device time of
every kernel summed by group (flash kernels, the RMSNorm kernel, f32 and
other matmuls, optimizer, softmax/cross-entropy, other),
the top kernels by device time, and the device's idle share over the
traced window (1 - kernel time / wall time). Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time

import torch

from ..device import resolve_device
from . import train
from .model import ModelConfig

# The config tweaks of chip_smoke.py's phase 11 paths, by ``--config``.
_RING = {"use_flash_attention": False, "use_ring_attention": True}
CONFIGS = {
    "dense": {},
    "moe": {"n_experts": 4},
    "ring": _RING,
    "ring-chunked": dict(_RING, ring_q_chunk=512),
}

# Kernel-name patterns, checked in order; the first match names the group.
# Every kernel of flash_bwd.cu (the delta prepass, dQ, dK/dV) lives in
# namespace flash and names itself after its pass, so the backward group
# comes before "matmul", whose pattern also matches cutlass and sm90_.
GROUPS = (
    ("flash_fwd", re.compile(r"flash::fwd_kernel")),
    ("flash_bwd", re.compile(r"flash::\w*(dq|dkv|bwd)\w*")),
    ("rmsnorm", re.compile(r"rmsnorm::fwd_kernel")),
    ("matmul_f32", re.compile(r"sgemm|gemm_f32f32", re.I)),
    ("matmul", re.compile(r"gemm|xmma|cutlass|cublas|nvjet|sm90_", re.I)),
    ("optimizer", re.compile(r"multi_tensor|adam", re.I)),
    ("softmax_xent", re.compile(r"softmax|nll|log_softmax", re.I)),
)


def _group(name: str) -> str:
    for group, pattern in GROUPS:
        if pattern.search(name):
            return group
    return "other"


def profile_steps(cfg: ModelConfig, steps: int = 3, warmup: int = 2,
                  batch: int = 8, seed: int = 0) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.mesh import make_mesh

    dev = resolve_device("cuda")
    model, optimizer = train.make_train_state(cfg, dev, seed, mesh=make_mesh(1, device=dev))
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen).to(dev)
    for _ in range(warmup):
        train.train_step(model, optimizer, tokens)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            train.train_step(model, optimizer, tokens)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0

    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)  # Optimizer.step ranges
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "device_kind": torch.cuda.get_device_name(dev),
        "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "seq": cfg.max_seq_len, "batch": batch,
                   "use_pallas_norm": cfg.use_pallas_norm, "n_experts": cfg.n_experts,
                   "use_ring_attention": cfg.use_ring_attention,
                   "ring_q_chunk": cfg.ring_q_chunk},
        "traced_steps": steps,
        "step_time_ms": wall_s * 1e3 / steps,
        "kernel_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s) if busy_us else None,
        "group_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": e.key[:120], "calls_per_step": e.count / steps,
             "ms_per_step": e.self_device_time_total / 1e3 / steps}
            for e in top
        ],
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bench", action="store_true",
                   help="use the ModelConfig.bench() shape")
    p.add_argument("--pallas-norm", action="store_true",
                   help="run the norms through the RMSNorm kernel (use_pallas_norm)")
    p.add_argument("--config", choices=sorted(CONFIGS), default="dense",
                   help="the parallel path of chip_smoke.py's phase 11 to profile")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)
    cfg = ModelConfig.bench() if args.bench else ModelConfig()
    cfg = dataclasses.replace(cfg, use_pallas_norm=args.pallas_norm, **CONFIGS[args.config])
    try:
        result = profile_steps(cfg, steps=args.steps, batch=args.batch)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(json.dumps(result), flush=True)
    return 0 if result["kernel_ms_per_step"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
