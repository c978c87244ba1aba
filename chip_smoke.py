"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's exception is
caught while the run goes on:

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: every CUDA kernel of the port from ``ops/csrc`` (nvcc, sm_90a),
   with ptxas' registers, spills and any serialised ``wgmma`` per kernel.
3. Kernels vs plain: each hand-written kernel against its own plain
   PyTorch version on the card, element by element (``bf16_agreement`` in
   ``ops/attention.py``). The flash kernels (forward, the backward's delta
   prepass, dQ, dK/dV) at the bench shape (8, 16, 2048, 128), the
   multi-step path's (4, 16, 2048, 128) and a ragged one (2, 4, 100, 64),
   bf16 (timed at the bench shape only), with dQ and dK/dV given the
   prepass's delta
   as the main path runs them, and delta (f32) within relative 1e-5; then
   one line setting the three backward kernels beside SDPA's backward (the
   forward's line carries its own ratio to SDPA's forward).
   The RMSNorm kernel at the bench model's (16384, 2048) with an f32 scale,
   the microbench's (8192, 4096) with a bf16 scale, and a ragged
   (300, 2048), bf16 x; rrms within relative 1e-5. One JSON line per kernel
   and shape: errors, tolerance, and at the full shapes kernel, plain and
   library times (CUDA events, median) beside the bound.
4. Model: the flash and the dense attention paths of a small model on the
   card agree on the same weights and tokens.
5. Main path: ``run_smoke`` at ``ModelConfig.bench()`` (10 timed AdamW
   steps, batch 8), with every launch count set to 0 just before and read
   just after; each flash kernel must have launched, and the RMSNorm
   kernel (off in this config) not at all. Like every ``run_smoke`` below,
   it brings up (the first time) a one-rank NCCL process group and trains
   through a size-1 six-axis mesh, which leaves the model unsharded.
6. Norm path: the same at ``ModelConfig.bench()`` with
   ``use_pallas_norm=True``: the RMSNorm kernel must launch 9 times per
   step (two norms per block and the final one) and each flash kernel 4.
   Its step time, tokens/s and MFU are printed beside phase 5's.
7. Multi-step path: ``run_smoke`` at ``ModelConfig.bench()`` as the JAX
   bench leg drives it, cut to 24 steps (batch 4, ``inner_steps`` 8, so
   each call replays a CUDA graph of the step, and the chunked-CE A/B at
   chunk 4096 on a second graph), counts set to 0 just before and read
   just after. It must report ok with ``ab.vs_plain_step`` and no
   ``ab.error``, and each flash kernel must have launched ``n_layers``
   times per step actually run (main and A/B, replays included). Then,
   from one seed and one stack, 8 graphed steps against 8 eager steps:
   every loss within 1e-6 relative. Its line
   carries the gaps, the capture times, the peak device memory, and the
   eager step's time at the same batch (a single-step ``run_smoke`` just
   before, outside the counted window).
8. Generation: ``run_generation_smoke`` at ``ModelConfig.bench()`` widths,
   batch 8, prompt 256, 32 new tokens, counts set to 0 around each call:
   (a) dense attention, whose KV decoder must be ok (prefill logits within
   0.1 of the full forward's) with no flash launch; (b) flash attention
   with ``use_pallas_norm``, forward only: ``flash_fwd`` exactly
   ``n_layers`` x 32 launches, ``rmsnorm`` (2 ``n_layers`` + 1) x 32, no
   backward kernel, the prompt preserved. Tokens/s of each decoder.
9. Microbench: ``run_microbench(tier="full")`` at its defaults (attention
   seq 8192 and 2048, chunked CE 8192 x 2048 x 32768 with chunk 4096,
   RMSNorm (8192, 4096), matmul 4096). It must report ok, no suspect
   timing and no case or side in error or skipped, and must have launched
   every kernel.
10. Sharded path, a world of one: (a) phase 5's report must show the mesh
   all ones, ``devices_used`` 1 and ok, and its step time is set beside an
   unsharded eager loop's (same batch, 10 steps after 1, timed here);
   (b) the same seed's weights with ``apply_tp`` and ``apply_fsdp``
   applied explicitly over the size-1 axes (FSDP2's all-gather and
   reduce-scatter over NCCL, the tensor-parallel sums around the flash
   kernels on local tensors) train 5 steps after 1 on the same tokens:
   every loss within 1e-5 relative of the unsharded loop's, each flash
   kernel and delta launched exactly ``n_layers`` x 6 times, with counts set
   to 0 just before and read just after. Its line carries both step times,
   the peak device memory and the group's bring-up.

11. Parallel paths on one card, through a size-1 mesh, at bench widths:
   (a) MoE: ``run_smoke`` at ``ModelConfig.bench()`` with ``n_experts=4``
   (top-2, capacity factor 2.0), batch 8, 6 timed steps after 1, counts
   set to 0 just before and read just after: ok (first loss sane, loss
   falling, finite), each flash kernel and delta launched exactly
   ``n_layers`` x 7 times, the RMSNorm kernel not at all; one line with
   the step time, MFU (the MoE FLOP count), peak memory and the aux loss
   of the first batch at the seed's weights (within [n_layers, n_layers x
   e]). (b) Ring attention over the size-1 ``seq`` axis: first the ring
   op alone, f32 at (1, 16, 2048, 128), against the plain attention's
   output and autograd gradients (each within 1e-4 of the largest
   reference value: the one check on the card of the ring's hand-written
   backward); then ``bench()`` with flash off and the ring on, at
   ``ring_q_chunk`` 0 and 512: the first batch's logits against the dense
   model's on the same weights (max |diff| < 0.15, mean < 0.02, the JAX
   ring test's bounds), then 2 train steps each: the chunked first loss
   within 1e-5 relative of the unchunked one, the loss falling in both,
   and no kernel launched (counts set to 0 before the ring's op check and
   read after its last step). The second losses' gap is reported, not
   held: the chunked backward sums dK/dV in another order, and Adam's
   first update magnifies that rounding (1.3e-5 on an NVIDIA H100 80GB
   HBM3 at 700 W).
12. Resume: the resumable loop (``workload/loop.run_training``) at
   ``ModelConfig.bench()``, batch 8, on one card: 6 steps without a
   checkpoint; then 3 steps saving into a temporary directory
   (``save_every`` 100, so steps 0 and 2 are saved), then 6 steps on the
   same directory, which must resume at step 3. The stitched losses must
   equal the uninterrupted ones within 1e-6 relative, and each flash kernel
   and delta must launch ``n_layers`` times per resumed step (counts set
   to 0 just before the resumed call and read just after). One line with
   the save and restore seconds, the bytes of a checkpoint, the time from
   the restart to the first resumed step, the loop's step time beside
   phase 5's, the peak device memory, and the card's name and power limit.
   The directory is deleted afterwards.

13. The node's card, as the node daemon sees it through NVML
   (``discovery/scanner.NvmlInfo``, never ``nvidia-smi``): the card torch
   runs on is among the scanned cards, found by its UUID (NVML ignores
   ``CUDA_VISIBLE_DEVICES``, so never by index), with the UUID, name, PCI
   bus ID (or its absence, where the container hides the PCI tree) and
   memory total that ``nvidia-smi --query-gpu=index,uuid,name,pci.bus_id,
   memory.total`` gives for it, and torch's bus where NVML gives one; its
   telemetry, read while a 1 GiB
   tensor is held and the forward kernel runs for about a second, shows at
   least 1 GiB in use and a power in (0, the limit nvidia-smi reports]; one
   sweep of the health watcher makes no transition; the XID event source
   either opens and its 100 ms wait sees no event, or its ``OSError`` is
   printed (``"events": false``); and the link classes of every pair of
   the scanned cards are printed.
14. The kv sweep: ``tools/kv_sweep.run_sweep`` at seq 2048 and 8192 over
   all six (forward, backward) ring depths at the JAX tool's defaults
   (heads 8, head_dim 128, batch by its rule), counts set to 0 just before
   and read just after: every row printed, a timing or a recorded error,
   each seq's winner beside the default (4, 2) row; the report ok, both
   winners' agreements ok (the dense oracle and the plain version). The
   default row at seq 2048 is printed beside phase 3's K1 + K2 + K3 +
   delta at the bench shape scaled by b*h (a sanity print: the sweep times
   fwd+bwd through autograd).
15. The bench leg: ``tools/bench_kernels.run_kernels(budget_s=120)``, the
   microbench in subprocesses (the micro tier, then the full tier, merged):
   the micro tier must capture numbers, and no captured case may carry an
   agreement of false or a suspect timing. Its attempts and the merged
   cases' times are printed.

Then one ``{"kernels": [...]}`` line (each kernel's launches from the path
that runs it: K1-K3 from phase 5, K4 from phase 6; every path's counts
under ``launches_by_path``, phase 10's as ``sharded``, phase 11's as
``moe`` and ``ring``, phase 12's as ``resume``, phase 14's as
``kv_sweep``) and, last, the device line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is not available or the port's package is not beside
this file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "k8s_device_plugin_tpu_torch"

BENCH_SHAPE = (8, 16, 2048, 128)
# The bench widths at the multi-step path's batch 4: the persistent forward
# deals its (b*h, q block) items to the blocks differently at b*h = 64.
MULTI_STEP_SHAPE = (4, 16, 2048, 128)
RAGGED_SHAPE = (2, 4, 100, 64)
# bf16 outputs are held element by element to the rule of
# ops/attention.py (A.bf16_agreement); lse is f32 in both versions.
LSE_ATOL = 1e-4
# Back-to-back calls per timing window of a flash kernel or its SDPA
# yardstick at the bench shape: the window opens on an idle card, so the
# host's time to issue the first call is spread over this many.
FLASH_ITERS = 30
# (x shape, scale dtype, timed) of the RMSNorm kernel's checks, x in bf16:
# the bench model's norms (batch 8 x seq 2048 rows), the microbench's case,
# and a row count no 256-row block divides. The first is the main path's.
NORM_CASES = (
    ((16384, 2048), torch.float32, True),
    ((8192, 4096), torch.bfloat16, True),
    ((300, 2048), torch.float32, False),
)
NORM_EPS = 1e-6
RRMS_RTOL = 1e-5

# Each kernel's source and the TPU kernel it replaces.
KERNELS = {
    "flash_fwd": ("ops/csrc/flash_fwd.cu", "k8s_device_plugin_tpu/ops/attention.py:102"),
    "flash_dq": ("ops/csrc/flash_bwd.cu", "k8s_device_plugin_tpu/ops/attention.py:166"),
    "flash_dkv": ("ops/csrc/flash_bwd.cu", "k8s_device_plugin_tpu/ops/attention.py:212"),
    # delta = rowsum(dO * O), which both TPU backward kernels recompute per tile
    "flash_bwd_delta": ("ops/csrc/flash_bwd.cu",
                        "k8s_device_plugin_tpu/ops/attention.py:197,249"),
    "rmsnorm": ("ops/csrc/rmsnorm.cu", "k8s_device_plugin_tpu/ops/rmsnorm.py:41"),
}
FLASH = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def card():
    """This card's published rates (``workload/chips.py``)."""
    from k8s_device_plugin_tpu_torch.workload.chips import card_spec

    spec = card_spec(torch.cuda.get_device_name(0))
    if spec is None:
        fail(f"{torch.cuda.get_device_name(0)} is not in workload/chips.py's table")
    return spec


def bound(flops: float, peak_flops: float, nbytes: float) -> tuple[float, str]:
    """The larger of the operations over their peak and the bytes over the
    memory rate, in ms, and which of the two it is."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / card().memory_bytes_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(shape, kind: str) -> tuple[float, str]:
    """Least time in ms for the pass on this data: the larger of its
    tensor-core operations over the bf16 peak (2 per multiply-add over the
    unmasked causal pairs; fwd: QK^T, PV; dq: QK^T, dO V^T, dS K; dkv:
    QK^T, dO V^T, P^T dO, dS^T Q) and its bytes over the memory rate (each
    input read once, each output written once)."""
    b, h, seq, d = shape
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2.0 * products * d * b * h * causal_pairs(seq)
    rows = b * h * seq
    tensor = rows * d * 2  # one bf16 (b, h, seq, d) tensor
    n_in, n_out = {"fwd": (3, 1), "dq": (5, 1), "dkv": (5, 2)}[kind]
    lse = rows * 4
    return bound(flops, card().peak_bf16_flops, (n_in + n_out) * tensor + lse)


def delta_bound(shape) -> tuple[float, str]:
    """Least time in ms for the delta prepass: O and dO (bf16) read once
    and delta (f32) written once, over the memory rate; against one f32
    multiply-add per element on the CUDA cores."""
    b, h, seq, d = shape
    rows = b * h * seq
    return bound(2.0 * rows * d, card().peak_f32_flops, 2 * rows * d * 2 + rows * 4)


def norm_bound(x, scale) -> tuple[float, str]:
    """Least time in ms for the RMSNorm forward on these inputs: x read
    once, y (x's dtype) written once, scale read and rrms (f32) written,
    over the memory rate; against about four f32 operations per element
    (square, sum, two products) on the CUDA cores."""
    rows, d = x.shape
    nbytes = 2 * x.numel() * x.element_size() + scale.numel() * scale.element_size() + rows * 4
    return bound(4.0 * rows * d, card().peak_f32_flops, nbytes)


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, from CUDA events around each group (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def phase_device() -> None:
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)


def phase_build() -> None:
    from k8s_device_plugin_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build_all()
    print(f"build: {time.monotonic() - t0:.2f} s, sources {sorted(logs)}", flush=True)
    for stem, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:48]  # the mangled name's head
            elif "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  ptxas {stem} {entry}: {line.strip()}", flush=True)


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the bench-shape
    entries of the kernels line (all but the launch counts)."""
    import torch.nn.functional as F
    from k8s_device_plugin_tpu_torch.ops import attention as A

    entries = {}
    for shape in (RAGGED_SHAPE, MULTI_STEP_SHAPE, BENCH_SHAPE):
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        q, k, v, do = (
            torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4)
        )
        o_p, lse_p = A.flash_attention_fwd_plain(q, k, v)
        bwd = (q, k, v, o_p, lse_p, do)
        # dQ and dK/dV take the prepass's delta, as flash_attention_bwd
        # hands it to them; their plain versions compute their own.
        delta = A.flash_bwd_delta_kernel(o_p, do)
        runs = {
            "flash_fwd": (lambda: A.flash_fwd_kernel(q, k, v),
                          lambda: A.flash_attention_fwd_plain(q, k, v), ("o", "lse")),
            "flash_bwd_delta": (lambda: (A.flash_bwd_delta_kernel(o_p, do),),
                                lambda: (A.flash_bwd_delta_plain(o_p, do),), ("delta",)),
            "flash_dq": (lambda: (A.flash_dq_kernel(*bwd, delta=delta),),
                         lambda: (A.flash_dq_plain(*bwd),), ("dq",)),
            "flash_dkv": (lambda: A.flash_dkv_kernel(*bwd, delta=delta),
                          lambda: A.flash_dkv_plain(*bwd), ("dk", "dv")),
        }
        timed = shape == BENCH_SHAPE
        for name, (kernel, plain, labels) in runs.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            line = {"kernel": name, "shape": list(shape), "dtype": "bfloat16"}
            bad = []
            worst, worst_rel = 0.0, 0.0
            for label, g, w in zip(labels, got, want):
                if label == "lse":
                    err = float((g - w).abs().max())
                    line.update(max_abs_err_lse=err, tol_lse=LSE_ATOL)
                    if not err <= LSE_ATOL:
                        bad.append(f"lse max err {err} > {LSE_ATOL}")
                    continue
                if label == "delta":
                    err = float((g - w).abs().max())
                    rel = err / float(w.abs().max())
                    line.update(max_abs_err_delta=err, rel_err_delta=rel,
                                tol_delta=f"max |kernel - plain| <= {A.DELTA_RTOL} max |plain|")
                    if not (g.dtype == torch.float32 and rel <= A.DELTA_RTOL):
                        bad.append(f"delta relative err {rel} > {A.DELTA_RTOL}")
                    worst, worst_rel = err, rel
                    continue
                agree = A.bf16_agreement(g, w)
                for key in ("max_abs_err", "worst_share", "rms_share_needed", "rel_err"):
                    line[f"{key}_{label}"] = agree[key]
                if not agree["ok"]:
                    bad.append(f"{label} {agree}")
                worst = max(worst, agree["max_abs_err"])
                worst_rel = max(worst_rel, agree["rel_err"])
            if name != "flash_bwd_delta":
                line["tolerance"] = (
                    f"|kernel - plain| <= {A.BF16_ULP_SHARE} |plain| + "
                    f"{A.BF16_RMS_SHARE} rms(plain) per element, and relative "
                    f"Frobenius error <= {A.BF16_REL_NORM}"
                )
            del got, want
            if timed:
                src, replaces = KERNELS[name]
                if name == "flash_bwd_delta":
                    bound_ms, bound_by = delta_bound(shape)
                else:
                    bound_ms, bound_by = attention_bound(shape, name.removeprefix("flash_"))
                line.update(
                    kernel_ms=time_ms(kernel, 50 if name == "flash_bwd_delta" else FLASH_ITERS),
                    plain_ms=time_ms(plain, 1, reps=3),
                    library_ms=None,
                    bound_ms=bound_ms,
                    bound_by=bound_by,
                )
                if name == "flash_fwd":
                    def sdpa_fwd():
                        with torch.no_grad():
                            F.scaled_dot_product_attention(q, k, v, is_causal=True)

                    line["library_ms"] = time_ms(sdpa_fwd, FLASH_ITERS)
                    line["library_call"] = "scaled_dot_product_attention(is_causal=True) fwd"
                    line["kernel_over_library"] = line["kernel_ms"] / line["library_ms"]
                entries[name] = {
                    "name": name,
                    "route": "cuda",
                    "source": f"k8s_device_plugin_tpu_torch/{src}",
                    "replaces": replaces,
                    "max_abs_err": worst,
                    "rel_err": worst_rel,
                    "ms": line["kernel_ms"],
                    "plain_ms": line["plain_ms"],
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": line["library_ms"],
                }
            emit(line)
            if bad:
                fail(f"{name} at {shape} disagrees with its plain version: {bad}")
        if timed:
            emit(backward_yardstick(q, k, v, do, entries))
        del q, k, v, do, o_p, lse_p, bwd, delta, runs
        torch.cuda.empty_cache()
    entries["rmsnorm"] = phase_norm_kernel()
    return entries


def phase_norm_kernel() -> dict:
    """The RMSNorm kernel against its plain version at NORM_CASES; returns
    the main path's shape's entry of the kernels line."""
    import torch.nn.functional as F
    from k8s_device_plugin_tpu_torch.ops import attention as A
    from k8s_device_plugin_tpu_torch.ops import rmsnorm as R

    entry = None
    for shape, scale_dtype, timed in NORM_CASES:
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale = (1.0 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")).to(scale_dtype)
        (y, rrms), (y_p, rrms_p) = (R.rmsnorm_fwd_kernel(x, scale, NORM_EPS),
                                    R.rmsnorm_fwd_plain(x, scale, NORM_EPS))
        torch.cuda.synchronize()
        agree = A.bf16_agreement(y, y_p)
        rrms_rel = float(((rrms - rrms_p).abs() / rrms_p.abs()).max())
        line = {"kernel": "rmsnorm", "shape": list(shape), "dtype": "bfloat16",
                "scale_dtype": str(scale_dtype).removeprefix("torch."),
                **{f"{key}_y": agree[key] for key in
                   ("max_abs_err", "worst_share", "rms_share_needed", "rel_err")},
                "rel_err_rrms": rrms_rel, "tol_rrms": RRMS_RTOL,
                "y_dtype": str(y.dtype).removeprefix("torch."),
                "tolerance": "y: bf16_agreement; rrms: relative error <= 1e-5"}
        if timed:
            bound_ms, bound_by = norm_bound(x, scale)
            line.update(
                kernel_ms=time_ms(lambda: R.rmsnorm_fwd_kernel(x, scale, NORM_EPS), 50),
                plain_ms=time_ms(lambda: R.rmsnorm_fwd_plain(x, scale, NORM_EPS), 10),
                library_ms=time_ms(lambda: F.rms_norm(x, (shape[1],), scale, NORM_EPS), 50),
                library_call="torch.nn.functional.rms_norm (yardstick only)",
                bound_ms=bound_ms,
                bound_by=bound_by,
            )
            if entry is None:
                entry = {
                    "name": "rmsnorm",
                    "route": "cuda",
                    "source": "k8s_device_plugin_tpu_torch/" + KERNELS["rmsnorm"][0],
                    "replaces": KERNELS["rmsnorm"][1],
                    "shape": list(shape),
                    "max_abs_err": agree["max_abs_err"],
                    "rel_err": agree["rel_err"],
                    "ms": line["kernel_ms"],
                    "plain_ms": line["plain_ms"],
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": line["library_ms"],
                }
        emit(line)
        if not (agree["ok"] and rrms_rel <= RRMS_RTOL and y.dtype == x.dtype):
            fail(f"rmsnorm at {shape} disagrees with its plain version: {line}")
        del x, scale, y, rrms, y_p, rrms_p
        torch.cuda.empty_cache()
    return entry


def backward_yardstick(q, k, v, do, entries) -> dict:
    """No library call computes dQ alone, dK/dV alone or delta in f32 alone,
    so the backward kernels' line carries library_ms null; this one line
    sets the three together (the prepass, dQ, dK/dV: the port's whole
    backward) beside SDPA's backward (dQ, dK and dV in one pass) and its
    forward plus backward. A yardstick only: the port never calls SDPA."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    backward = ("flash_bwd_delta", "flash_dq", "flash_dkv")
    kernels_ms = sum(entries[name]["ms"] for name in backward)
    library_bwd_ms = time_ms(sdpa_bwd, FLASH_ITERS)
    return {
        "yardstick": "attention backward at the bench shape",
        "kernels": list(backward),
        "kernels_ms": kernels_ms,
        "plain_ms": sum(entries[name]["plain_ms"] for name in backward),
        "library_bwd_ms": library_bwd_ms,
        "kernels_over_library_bwd": kernels_ms / library_bwd_ms,
        "library_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, FLASH_ITERS),
        "library_call": "scaled_dot_product_attention(is_causal=True)",
    }


def phase_model() -> None:
    """The flash path against the dense path of the same model on the card
    (bf16): the loss within 1e-2 and the logits within 0.1, the JAX
    package's bf16 tolerance for two attention formulations."""
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model

    cfg = ModelConfig(
        vocab_size=1024, d_model=256, n_heads=2, n_layers=2, d_ff=1024,
        max_seq_len=200, use_flash_attention=True,
    )
    flash = init_model(cfg, seed=3, device="cuda")
    dense = init_model(dataclasses.replace(cfg, use_flash_attention=False), 4, "cuda")
    dense.load_state_dict(flash.state_dict())
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=gen).cuda()
    with torch.no_grad():
        lf, ld = flash(tokens), dense(tokens)
        loss_f, loss_d = float(train.loss_fn(flash, tokens)), float(train.loss_fn(dense, tokens))
    diff = float((lf - ld).abs().max())
    emit({"model_check": "flash vs dense", "logits_max_diff": diff,
          "loss_flash": loss_f, "loss_dense": loss_d})
    if not (bool(torch.isfinite(lf).all()) and diff < 0.1 and abs(loss_f - loss_d) <= 1e-2):
        fail(f"flash and dense model paths disagree: logits {diff}, "
             f"loss {loss_f} vs {loss_d}")


def drive_path(cfg, steps: int = 10) -> tuple[dict, dict, int]:
    """``run_smoke`` at ``cfg`` (``steps`` timed steps, batch 8) with every
    launch count set to 0 just before and read just after: (report,
    launches, steps run, the untimed first step included)."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.workload.smoke import run_smoke

    reset_launches()
    report = run_smoke(steps=steps, cfg=cfg, batch_per_device=8, device="cuda", emit=emit)
    launches = dict(LAUNCHES)
    emit(report)
    torch.cuda.empty_cache()
    if not (report["ok"] and report["first_loss_sane"] and report["loss_decreased"]):
        fail(f"run_smoke at {cfg} not ok: {report}")
    return report, launches, report["measured_steps"] + 1


def phase_main() -> tuple[dict, dict, int]:
    """The bench step: each flash kernel launched, the RMSNorm kernel (off
    in ``ModelConfig.bench()``) not at all."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    report, launches, steps = drive_path(ModelConfig.bench())
    for name in FLASH:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the main path")
    if launches["rmsnorm"] != 0:
        fail(f"the RMSNorm kernel launched {launches['rmsnorm']} times with use_pallas_norm off")
    return report, launches, steps


def phase_norm_path(main_report: dict) -> tuple[dict, int]:
    """The bench step with ``use_pallas_norm``: 2 norms per block and the
    final one launch the RMSNorm kernel each step, and attention stays on
    the flash kernels."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    cfg = dataclasses.replace(ModelConfig.bench(), use_pallas_norm=True)
    report, launches, steps = drive_path(cfg)
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * steps,
            **{name: cfg.n_layers * steps for name in FLASH}}
    if launches != want:
        fail(f"norm path launches {launches}, expected {want}")
    keys = ("step_time_s", "tokens_per_s", "mfu", "first_loss", "final_loss")
    emit({"norm_path": {k: report[k] for k in keys},
          "plain_norm_path": {k: main_report[k] for k in keys},
          "norm_path_launches": launches, "steps": steps})
    return launches, steps


# The JAX bench leg's multi-step smoke (--batch-per-device 4 --inner-steps 40
# --ab-xent-chunk 4096), cut from 80 to 24 steps and 8 steps a call. The
# stack's 8 distinct random batches are learnt slowly: the mean loss of the
# second pass over them rises above the first loss (Adam's first steps at
# lr 1e-3 grow the logits) and comes back under it only from the fourth,
# so 16 steps (three passes) would fail the falling-loss check.
MULTI_STEP = dict(steps=24, batch_per_device=4, inner_steps=8, ab_xent_chunk=4096)
# The replays run the eager step's kernels on the same inputs, and no kernel
# of the step sums with atomics: every reading so far was equal bit for bit.
GRAPH_RTOL = 1e-6
GENERATION = dict(batch=8, prompt_len=256, steps=32, seed=0)
DECODE_LOGITS_TOL = 0.1  # the JAX generation smoke's bf16 tolerance


def phase_multi_step() -> tuple[dict, int]:
    """The multi-step path (CUDA graphs of the step) with the chunked-CE
    A/B, then graphed against eager steps from one seed."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
    from k8s_device_plugin_tpu_torch.workload.smoke import run_smoke

    cfg = ModelConfig.bench()
    # The eager step at the same batch, for the graph's step time.
    eager = run_smoke(cfg=cfg, device="cuda", steps=MULTI_STEP["steps"],
                      batch_per_device=MULTI_STEP["batch_per_device"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    report = run_smoke(cfg=cfg, device="cuda", emit=emit, **MULTI_STEP)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    emit(report)
    torch.cuda.empty_cache()
    ab = report.get("ab", {})
    if not (report["ok"] and "vs_plain_step" in ab and "error" not in ab):
        fail(f"multi-step run_smoke not ok: {report}")
    steps = report["steps_run"]
    want = {"rmsnorm": 0, **{name: cfg.n_layers * steps for name in FLASH}}
    if launches != want or report["kernel_launches"] != launches:
        fail(f"multi-step launches {launches} (reported {report['kernel_launches']}), "
             f"expected {want} over {steps} steps")
    gaps = graph_vs_eager(cfg, MULTI_STEP["batch_per_device"], MULTI_STEP["inner_steps"])
    emit({"multi_step": {k: report[k] for k in (
              "step_time_s", "tokens_per_s", "mfu", "time_to_first_step_s", "time_to_ready_s",
              "capture_s", "first_loss", "final_loss", "steps_run")},
          "eager_step_time_s": eager["step_time_s"],
          "graph_over_eager_step": report["step_time_s"] / eager["step_time_s"],
          "ab": ab, "launches": launches,
          "max_memory_allocated_gib": peak / 2 ** 30,
          "graph_vs_eager": gaps})
    return launches, steps


def graph_vs_eager(cfg, batch: int, steps: int) -> dict:
    """``steps`` eager train steps, then as many graphed steps (one call of
    the multi-step) on a fresh model from the same seed, over one stack:
    the relative gap of each loss."""
    from k8s_device_plugin_tpu_torch.workload import train

    gen = torch.Generator().manual_seed(1)
    stack = torch.randint(0, cfg.vocab_size, (steps, batch, cfg.max_seq_len),
                          generator=gen).cuda()
    model, optimizer = train.make_train_state(cfg, "cuda", seed=0)
    eager = torch.stack([train.train_step(model, optimizer, t) for t in stack]).cpu()
    del model, optimizer
    torch.cuda.empty_cache()
    model, optimizer = train.make_train_state(cfg, "cuda", seed=0)
    step = train.make_multi_train_step(model, optimizer, steps)
    graphed = step(stack).cpu()
    rel = ((graphed - eager).abs() / eager.abs()).tolist()
    out = {"steps": steps, "warmup_steps": train.WARMUP_STEPS, "capture_s": step.capture_s,
           "eager_losses": eager.tolist(), "graph_losses": graphed.tolist(), "rel_gaps": rel,
           "tolerance": f"each <= {GRAPH_RTOL} relative"}
    del model, optimizer, step
    torch.cuda.empty_cache()
    if not max(rel) <= GRAPH_RTOL:
        fail(f"graphed steps disagree with eager steps: {out}")
    return out


def phase_generation() -> tuple[dict, dict]:
    """Greedy decoding at the bench widths: the dense KV decoder against the
    full forward, and the flash + RMSNorm kernel path forward only."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.workload import generate
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model

    new_tokens = GENERATION["batch"] * GENERATION["steps"]
    dense = dataclasses.replace(ModelConfig.bench(), use_flash_attention=False)
    reset_launches()
    report = generate.run_generation_smoke(dense, device="cuda", **GENERATION)
    dense_launches = dict(LAUNCHES)
    torch.cuda.empty_cache()
    emit({"generation": "dense", "report": report, "launches": dense_launches,
          "kv_tokens_per_s": new_tokens / report["kv_decode_s"],
          "full_tokens_per_s": new_tokens / report["full_decode_s"]})
    if not (report["ok"] is True and report["kv_prefill_logits_maxdiff"] < DECODE_LOGITS_TOL
            and report["prompt_preserved"] and report["tokens_in_vocab"]):
        fail(f"dense generation not ok: {report}")
    if any(dense_launches.values()):
        fail(f"dense generation launched a kernel: {dense_launches}")

    cfg = dataclasses.replace(ModelConfig.bench(), use_pallas_norm=True)
    reset_launches()
    report = generate.run_generation_smoke(cfg, device="cuda", **GENERATION)
    flash_launches = dict(LAUNCHES)
    n = GENERATION["steps"]
    want = {"flash_fwd": cfg.n_layers * n, "flash_dq": 0, "flash_dkv": 0,
            "flash_bwd_delta": 0, "rmsnorm": (2 * cfg.n_layers + 1) * n}
    shape = [GENERATION["batch"], GENERATION["prompt_len"] + n]
    if not (report["prompt_preserved"] and report["tokens_in_vocab"]
            and report["output_shape"] == shape):
        fail(f"flash generation not ok: {report}")
    if flash_launches != want:
        fail(f"flash generation launches {flash_launches}, expected {want}")
    # Its tokens/s from one more call after that (warm) one, outside the
    # counted window.
    model = init_model(cfg, GENERATION["seed"], "cuda")
    gen = torch.Generator().manual_seed(GENERATION["seed"] + 1)
    prompt = torch.randint(0, cfg.vocab_size, (GENERATION["batch"], GENERATION["prompt_len"]),
                           generator=gen).cuda()
    t0 = time.monotonic()
    generate.greedy_generate(model, prompt, n)
    torch.cuda.synchronize()
    full_s = time.monotonic() - t0
    del model
    torch.cuda.empty_cache()
    emit({"generation": "flash+pallas_norm", "report": report, "launches": flash_launches,
          "full_decode_s": full_s, "full_tokens_per_s": new_tokens / full_s})
    return dense_launches, flash_launches


def phase_microbench() -> None:
    """The port's microbench, full tier at its defaults, with the launch
    counts read around it."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.ops.microbench import run_microbench

    reset_launches()
    report = run_microbench(tier="full", device="cuda")
    launches = dict(LAUNCHES)
    emit({"microbench": report, "launches": launches})
    bad = [f"{case}: {body}" for case, body in report["kernels"].items()
           if "error" in body or "skipped" in body
           or any(isinstance(side, dict) and ("error" in side or "skipped" in side)
                  for side in body.values())]
    norm = report["kernels"].get("rmsnorm_8192x4096", {})
    if not (report["ok"] and not report.get("timing_suspect") and not bad
            and report["kernels"]["attention_agreement"].get("ok")
            and report["kernels"]["xent_8192x2048x32768"].get("ok")
            and {"kernel", "plain", "speedup_vs_plain"} <= set(norm)):
        fail(f"microbench not ok: {bad or report}")
    if min(launches.values()) <= 0:
        fail(f"the microbench did not launch every kernel: {launches}")


# Phase 10: steps of the explicitly sharded model after its first, the
# unsharded loop's timed steps after its first (phase 5's count), and the
# loss tolerance: a size-1 axis splits nothing, and its collectives copy.
SHARDED_STEPS = 5
PLAIN_STEPS = 10
SHARDED_RTOL = 1e-5


def phase_sharded(main_report: dict) -> tuple[dict, int]:
    """The sharded path on a one-rank NCCL group and a size-1 mesh."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.parallel.mesh import AXES, axis_sizes, make_mesh
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model

    ones = {axis: 1 for axis in AXES}
    if not (main_report["ok"] and main_report["mesh"] == ones
            and main_report["devices_used"] == 1 and main_report["devices"] == 1):
        fail(f"the main path's run_smoke did not run on a size-1 mesh: {main_report}")
    mesh = make_mesh(1, device="cuda")  # the group is up since phase 5
    if not (axis_sizes(mesh) == ones and dist.get_backend() == "nccl"):
        fail(f"expected a size-1 mesh over NCCL: {axis_sizes(mesh)}, {dist.get_backend()}")
    # NCCL builds its communicator at the group's first collective.
    t0 = time.monotonic()
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    torch.cuda.synchronize()
    first_collective_s = time.monotonic() - t0

    cfg = ModelConfig.bench()
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len), generator=gen).cuda()

    def steps(model, optimizer, n: int) -> tuple[list, float]:
        """One untimed step, then n timed: every loss, and s a timed step."""
        first = float(train.train_step(model, optimizer, tokens))
        torch.cuda.synchronize()
        t = time.monotonic()
        losses = [train.train_step(model, optimizer, tokens) for _ in range(n)]
        torch.cuda.synchronize()
        return [first] + [float(x) for x in losses], (time.monotonic() - t) / n

    torch.cuda.reset_peak_memory_stats()
    model, optimizer = train.make_train_state(cfg, "cuda", seed=0)
    plain, plain_s = steps(model, optimizer, PLAIN_STEPS)
    plain_peak = torch.cuda.max_memory_allocated()
    del model, optimizer
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, 0, "cuda")
    train.apply_tp(model, mesh["model"])
    train.apply_fsdp(model, mesh)
    optimizer = train.make_optimizer(model)
    reset_launches()
    sharded, sharded_s = steps(model, optimizer, SHARDED_STEPS)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del model, optimizer
    torch.cuda.empty_cache()
    n_steps = 1 + SHARDED_STEPS
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded, plain)]
    want = {"rmsnorm": 0, **{name: cfg.n_layers * n_steps for name in FLASH}}
    emit({"sharded": {
        "mesh": axis_sizes(mesh), "backend": dist.get_backend(),
        "main_path_mesh": main_report["mesh"],
        "main_path_step_s": main_report["step_time_s"],
        "unsharded_step_s": plain_s,
        "main_over_unsharded_step": main_report["step_time_s"] / plain_s,
        "sharded_step_s": sharded_s,
        "sharded_over_unsharded_step": sharded_s / plain_s,
        "unsharded_losses": plain, "sharded_losses": sharded, "rel_gaps": rel,
        "tolerance": f"each <= {SHARDED_RTOL} relative",
        "launches": launches, "steps": n_steps,
        "max_memory_allocated_gib": peak / 2 ** 30,
        "unsharded_max_memory_allocated_gib": plain_peak / 2 ** 30,
        "time_to_mesh_s": main_report["time_to_mesh_s"],
        "first_collective_s": first_collective_s,
    }})
    if not max(rel) <= SHARDED_RTOL:
        fail(f"the explicitly sharded steps disagree with the unsharded ones: {rel}")
    if launches != want:
        fail(f"sharded path launches {launches}, expected {want}")
    return launches, n_steps


# Phase 11: MoE's timed steps after its first, and the expert count of
# dryrun plan B; the ring's q chunk, train steps and bounds.
MOE_STEPS = 6
MOE_EXPERTS = 4
RING_Q_CHUNK = 512
RING_STEPS = 2
RING_OP_SHAPE = (1, 16, 2048, 128)
RING_OP_RTOL = 1e-4  # of the largest reference value
RING_LOGITS_MAX, RING_LOGITS_MEAN = 0.15, 0.02
RING_RTOL = 1e-5


def phase_moe() -> tuple[dict, int]:
    """The MoE bench step: the flash kernels 4 a step, MFU by the MoE FLOP
    count, and the aux loss."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, forward_with_aux, init_model

    cfg = dataclasses.replace(ModelConfig.bench(), n_experts=MOE_EXPERTS)
    torch.cuda.reset_peak_memory_stats()
    report, launches, steps = drive_path(cfg, MOE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    want = {"rmsnorm": 0, **{name: cfg.n_layers * steps for name in FLASH}}
    # The aux loss of run_smoke's first batch at its seed's weights.
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8, cfg.max_seq_len), generator=gen)[0].cuda()
    model = init_model(cfg, 0, "cuda")
    with torch.no_grad():
        aux = float(forward_with_aux(model, tokens)[1])
    del model
    torch.cuda.empty_cache()
    emit({"moe": {k: report[k] for k in ("step_time_s", "tokens_per_s", "mfu", "first_loss",
                                         "final_loss", "model_flops_per_step")},
          "batch": 8, "n_experts": MOE_EXPERTS, "top_k": cfg.moe_top_k,
          "capacity_factor": cfg.moe_capacity_factor, "aux": aux,
          "max_memory_allocated_gib": peak / 2 ** 30, "launches": launches, "steps": steps})
    if launches != want:
        fail(f"MoE path launches {launches}, expected {want}")
    if not cfg.n_layers - 1e-3 <= aux <= cfg.n_layers * MOE_EXPERTS + 1e-3:
        fail(f"MoE aux loss {aux} outside [{cfg.n_layers}, {cfg.n_layers * MOE_EXPERTS}]")
    return launches, steps


def ring_op_check(group) -> dict:
    """The ring op alone (f32, size-1 seq group, chunked at RING_Q_CHUNK)
    against the plain attention: output and the three gradients of
    sum(out * dO)."""
    from k8s_device_plugin_tpu_torch.ops import reference_attention
    from k8s_device_plugin_tpu_torch.parallel.ring import ring_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(RING_OP_SHAPE, generator=gen, device="cuda") for _ in range(4))
    errs = {}
    for chunk in (0, RING_Q_CHUNK):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ring_attention(*ins, group, chunk)
        ref = reference_attention(*ref_ins)
        got = [out.detach()] + list(torch.autograd.grad(out, ins, do))
        want = [ref.detach()] + list(torch.autograd.grad(ref, ref_ins, do))
        for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            errs[f"q_chunk{chunk}_{label}"] = float((g - w).abs().max() / w.abs().max())
    del q, k, v, do
    torch.cuda.empty_cache()
    return errs


def phase_ring() -> tuple[dict, int]:
    """Ring attention at bench widths over a size-1 seq axis: the op's
    gradients, the model's logits against the dense path, and the chunked
    against the unchunked training steps."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model

    mesh = make_mesh(1, device="cuda")
    dense_cfg = dataclasses.replace(ModelConfig.bench(), use_flash_attention=False)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, dense_cfg.vocab_size, (8, dense_cfg.max_seq_len),
                           generator=gen).cuda()
    with torch.no_grad():
        dense_logits = init_model(dense_cfg, 0, "cuda")(tokens)
    torch.cuda.empty_cache()
    reset_launches()
    op_errs = ring_op_check(mesh["seq"].get_group())
    runs = {}
    for chunk in (0, RING_Q_CHUNK):
        cfg = dataclasses.replace(dense_cfg, use_ring_attention=True, ring_q_chunk=chunk)
        model, optimizer = train.make_train_state(cfg, "cuda", seed=0, mesh=mesh)
        with torch.no_grad():
            diff = (model(tokens) - dense_logits).abs()
        run = {"logits_max_diff": float(diff.max()), "logits_mean_diff": float(diff.mean())}
        del diff
        losses, times = [], []
        for _ in range(RING_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses.append(float(train.train_step(model, optimizer, tokens)))
            times.append(time.monotonic() - t0)
        run.update(losses=losses, step_s=times)
        runs[chunk] = run
        del model, optimizer
        torch.cuda.empty_cache()
    launches = dict(LAUNCHES)
    del dense_logits
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(runs[RING_Q_CHUNK]["losses"], runs[0]["losses"])]
    # The first losses come from one forward on the same weights; the
    # later ones follow updates from two summation orders of dK/dV.
    emit({"ring": {f"q_chunk_{c}": r for c, r in runs.items()}, "op_rel_errs": op_errs,
          "op_shape": list(RING_OP_SHAPE), "chunked_rel_gaps": rel, "launches": launches,
          "tolerance": f"op: each <= {RING_OP_RTOL} of max |reference|; logits max < "
                       f"{RING_LOGITS_MAX}, mean < {RING_LOGITS_MEAN}; chunked first loss "
                       f"<= {RING_RTOL} relative; losses falling"})
    if max(op_errs.values()) > RING_OP_RTOL:
        fail(f"the ring op disagrees with the plain attention: {op_errs}")
    for chunk, run in runs.items():
        if not (run["logits_max_diff"] < RING_LOGITS_MAX
                and run["logits_mean_diff"] < RING_LOGITS_MEAN
                and all(math.isfinite(x) for x in run["losses"])
                and run["losses"][-1] < run["losses"][0]):
            fail(f"the ring model at q_chunk {chunk} disagrees with the dense one: {run}")
    if rel[0] > RING_RTOL:
        fail(f"the chunked ring's first loss disagrees with the unchunked one: {rel}")
    if any(launches.values()):
        fail(f"the ring path launched a kernel: {launches}")
    return launches, 2 * RING_STEPS


# Phase 12: the loop's steps without a stop, the step it stops after, the
# loss tolerance (every reading so far was equal bit for bit: the restore
# copies the whole state, and no kernel of the step sums with atomics), and
# the checkpoints the temporary directory holds at the end (steps 0, 2, 5:
# the loop's TrainCheckpointer keeps 3, as the JAX loop's does).
RESUME_STEPS = 6
RESUME_STOP = 3
RESUME_RTOL = 1e-6
RESUME_CHECKPOINTS = 3


def directory_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_resume(main_report: dict) -> tuple[dict, int]:
    """Checkpoint/resume through the resumable loop at bench widths: the
    resumed loss stream against the uninterrupted one, the resumed steps'
    launches, and the save, restore and restart times."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.workload.loop import run_training
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, TransformerLM

    cfg = ModelConfig.bench()
    kw = dict(cfg=cfg, batch_per_device=8, device="cuda")
    n_params = sum(p.numel() for p in TransformerLM(cfg, device="meta").parameters())
    torch.cuda.reset_peak_memory_stats()
    full = run_training(steps=RESUME_STEPS, **kw)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume-") as d:
        free = shutil.disk_usage(d).free
        need = RESUME_CHECKPOINTS * n_params * 12  # f32 parameters and two moments
        if free < need:
            fail(f"{d} has {free} bytes free; phase 12's checkpoints take about {need}")
        first = run_training(steps=RESUME_STOP, checkpoint_dir=d, save_every=100, **kw)
        torch.cuda.empty_cache()
        step_bytes = {int(p.name): directory_bytes(p) for p in Path(d).iterdir()}
        reset_launches()
        second = run_training(steps=RESUME_STEPS, checkpoint_dir=d, save_every=100, **kw)
        launches = dict(LAUNCHES)
        kept = sorted(int(p.name) for p in Path(d).iterdir())
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    stitched = first["losses"] + second["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(stitched, full["losses"])]
    resumed_steps = RESUME_STEPS - RESUME_STOP
    want = {"rmsnorm": 0, **{name: cfg.n_layers * resumed_steps for name in FLASH}}
    loop_step_s = statistics.median(full["step_s"][1:])
    emit({"resume": {
        "card": nvidia_smi(),
        "save_s": first["save_s"] + second["save_s"],
        "restore_s": second["restore_s"],
        "checkpoint_bytes": step_bytes,
        "parameters": n_params,
        "time_to_first_resumed_step_s": second["time_to_first_step_s"],
        "time_to_first_step_s": full["time_to_first_step_s"],
        "loop_step_s": loop_step_s,
        "loop_step_times_s": full["step_s"],
        "eager_step_s": main_report["step_time_s"],
        "loop_over_eager_step": loop_step_s / main_report["step_time_s"],
        "max_memory_allocated_gib": peak / 2 ** 30,
        "start_step": second["start_step"], "kept_steps": kept,
        "uninterrupted_losses": full["losses"], "stitched_losses": stitched,
        "max_rel_gap": max(rel), "tolerance": f"each <= {RESUME_RTOL} relative",
        "launches": launches, "resumed_steps": resumed_steps,
    }})
    if first["resumed"] or not (second["resumed"] and second["start_step"] == RESUME_STOP):
        fail(f"expected a fresh run, then a resume at step {RESUME_STOP}: "
             f"{first['start_step']}, {second['start_step']}")
    if not (len(stitched) == RESUME_STEPS and max(rel) <= RESUME_RTOL):
        fail(f"the resumed losses {stitched} disagree with the uninterrupted {full['losses']}")
    if launches != want:
        fail(f"resumed launches {launches}, expected {want}")
    return launches, resumed_steps


def phase_node_card() -> None:
    """The node daemon's view of this card through NVML, held against
    nvidia-smi and torch."""
    from k8s_device_plugin_tpu_torch.discovery import nvml
    from k8s_device_plugin_tpu_torch.discovery.scanner import (
        DEFAULT_DEV, DEFAULT_SYSFS_PCI, NvmlInfo)
    from k8s_device_plugin_tpu_torch.health.watcher import HealthWatcher
    from k8s_device_plugin_tpu_torch.ops import attention as A
    from k8s_device_plugin_tpu_torch.topology.links import LinkTopology

    props = torch.cuda.get_device_properties(0)
    uuid = f"GPU-{props.uuid}"
    smi = {}  # nvidia-smi's reading of each card, by its index (NVML's)
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=index,uuid,name,pci.bus_id,memory.total,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines():
        fields = [f.strip() for f in line.split(",")]
        smi[int(fields[0])] = fields[1:]
    with NvmlInfo() as info:
        t0 = time.monotonic()
        chips = info.scan(DEFAULT_SYSFS_PCI, DEFAULT_DEV)
        scan_s = time.monotonic() - t0
        mine = [c for c in chips if c.uuid == uuid]
        if not mine:
            fail(f"NVML's scan {[c.uuid for c in chips]} does not hold torch's card {uuid}")
        chip = mine[0]
        if chip.index not in smi:
            fail(f"nvidia-smi lists no card {chip.index}: {smi}")
        smi_uuid, smi_name, smi_bus, smi_mib, smi_limit = smi[chip.index]
        # Telemetry while 1 GiB is held and the forward kernel runs: the
        # launches queue about a second of work, read in its middle.
        hold = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(13)
        q, k, v = (torch.randn(BENCH_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(3000):
            A.flash_fwd_kernel(q, k, v)
        time.sleep(0.2)
        tel = info.chip_telemetry(DEFAULT_SYSFS_PCI, chip.index)
        torch.cuda.synchronize()
        busy_s = time.monotonic() - t0
        del hold, q, k, v
        torch.cuda.empty_cache()
        transitions = []
        HealthWatcher(info, DEFAULT_SYSFS_PCI, DEFAULT_DEV, chips,
                      lambda cid, ok: transitions.append((cid, ok))).poll_once()
        health = {c.device_id_str: info.chip_health_detail(DEFAULT_SYSFS_PCI, DEFAULT_DEV,
                                                           c.index) for c in chips}
        try:
            handle = info.health_events_open(DEFAULT_SYSFS_PCI, DEFAULT_DEV)
        except OSError as e:
            events = {"events": False, "error": str(e)}
        else:
            try:
                events = {"events": True, "event_in_100ms": info.health_events_wait(handle, 100)}
            finally:
                info.health_events_close(handle)
        topo = LinkTopology(chips, info)
        line = {"node_card": {
            "nvml": info.version(), "scan_s": scan_s, "cards": [c.to_dict() for c in chips],
            "torch_uuid": uuid, "torch_pci_bus": props.pci_bus_id,
            "nvidia_smi": smi[chip.index],
            "telemetry": tel.to_dict(chip.hbm_bytes), "telemetry_window_s": busy_s,
            "power_limit_w": info.power_limit_w(chip.index), "health": health,
            "transitions": transitions, **events,
            "pair_classes": topo.pair_classes(),
            "pair_scores": {f"{a.index}-{b.index}": topo.score_pair(a.device_id_str,
                                                                    b.device_id_str)
                            for a in chips for b in chips if a.index < b.index},
        }}
    emit(line)
    # nvidia-smi prints "[N/A]" for a bus ID NVML will not give ("" here).
    smi_addr = nvml.sysfs_bus_id(smi_bus) if ":" in smi_bus else ""
    if (chip.uuid, chip.name, chip.pci_addr, chip.hbm_bytes // 2 ** 20) != (
            smi_uuid, smi_name, smi_addr, int(smi_mib)):
        fail(f"NVML reads {chip} where nvidia-smi reads {smi[chip.index]}")
    if chip.pci_addr and int(chip.pci_addr.split(":")[1], 16) != props.pci_bus_id:
        fail(f"NVML's bus {chip.pci_addr} is not torch's card's bus {props.pci_bus_id}")
    if not (tel.hbm_used_bytes is not None and tel.hbm_used_bytes >= 2 ** 30):
        fail(f"NVML reads {tel.hbm_used_bytes} bytes in use with 1 GiB held")
    if not (tel.power_w is not None and 0 < tel.power_w <= float(smi_limit)):
        fail(f"NVML reads {tel.power_w} W against nvidia-smi's limit of {smi_limit} W")
    if transitions:
        fail(f"the health watcher's sweep made transitions: {transitions}")
    if events.get("event_in_100ms"):
        fail("the XID event source reported an event on a healthy card")


# The sweep: every (forward, backward) ring depth the kernels are built
# for, at the JAX tool's defaults, and the seqs of the bench and the
# microbench.
SWEEP_SEQS = [2048, 8192]
SWEEP_STAGES = [(4, 2), (3, 2), (2, 2), (4, 3), (3, 3), (2, 3)]


def phase_kv_sweep(entries: dict) -> dict:
    """The ring-depth sweep on the card; returns its launch counts."""
    from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
    from k8s_device_plugin_tpu_torch.ops import attention as A
    from k8s_device_plugin_tpu_torch.tools.kv_sweep import run_sweep

    reset_launches()
    report = run_sweep(SWEEP_SEQS, SWEEP_STAGES, device="cuda")
    launches = dict(LAUNCHES)
    torch.cuda.empty_cache()
    for row in report["rows"]:
        emit({"kv_sweep_row": row})
    default = (A.DEFAULT_FWD_STAGES, A.DEFAULT_BWD_STAGES)
    by_seq = {}
    for seq in SWEEP_SEQS:
        rows = {(r["fwd_stages"], r["bwd_stages"]): r for r in report["rows"] if r["seq"] == seq}
        by_seq[seq] = {"winner": report["best_by_seq"].get(str(seq)),
                       "default_ms": rows.get(default, {}).get("timing", {}).get("ms"),
                       "agreement": report["agreement"].get(str(seq))}
    # Phase 3's four kernels at the bench shape (seq 2048), scaled from its
    # b*h to the sweep's at the same seq.
    b = max(1, min(4, 8192 // BENCH_SHAPE[2]))  # the sweep's batch rule
    scaled_ms = (sum(entries[name]["ms"] for name in FLASH) * b * 8
                 / (BENCH_SHAPE[0] * BENCH_SHAPE[1]))
    emit({"kv_sweep": {k: report[k] for k in ("ok", "device_kind", "iters", "inner",
                                              "wall_s", "best_by_seq")},
          "by_seq": by_seq, "launches": launches,
          "sanity": {"seq": BENCH_SHAPE[2],
                     "default_row_ms": by_seq[BENCH_SHAPE[2]]["default_ms"],
                     "phase3_kernels_ms_scaled_by_bh": scaled_ms,
                     "note": "the row times fwd+bwd through autograd"}})
    if len(report["rows"]) != len(SWEEP_SEQS) * len(SWEEP_STAGES):
        fail(f"the sweep gave {len(report['rows'])} rows")
    if not (report["ok"] and all(by_seq[s]["agreement"] and by_seq[s]["agreement"]["ok"]
                                 for s in SWEEP_SEQS)):
        fail(f"the kv sweep is not ok: {by_seq}")
    timed = sum("timing" in r for r in report["rows"])
    calls = timed * (1 + report["iters"] * report["inner"])
    want = {"flash_fwd": calls + len(SWEEP_SEQS), "flash_dq": calls, "flash_dkv": calls,
            "flash_bwd_delta": calls, "rmsnorm": 0}
    if launches != want:
        fail(f"kv sweep launches {launches}, expected {want}")
    return launches


BENCH_LEG_BUDGET_S = 120


def phase_bench_leg() -> None:
    """The bench's kernel leg: the microbench's micro and full tiers in
    subprocesses, merged."""
    from k8s_device_plugin_tpu_torch.tools.bench_kernels import _case_captured, run_kernels

    report = run_kernels(BENCH_LEG_BUDGET_S)
    cases = report.get("kernels") or {}
    captured = {name: case for name, case in cases.items() if _case_captured(case)}
    emit({"bench_leg": {
        "attempts": report.get("attempts"), "tier": report.get("tier"),
        "ok": report.get("ok"), "timing_suspect": report.get("timing_suspect", False),
        "error": report.get("error"), "skipped": report.get("skipped"),
        "cases_ms": {name: {side: body["ms"] for side, body in case.items()
                            if isinstance(body, dict) and "ms" in body}
                     for name, case in cases.items()},
        "not_captured": sorted(set(cases) - set(captured)),
    }})
    micro = [a for a in report.get("attempts") or [] if a["tier"] == "micro" and a["ok"]]
    if not micro:
        fail(f"the bench leg's micro tier captured nothing: {report.get('attempts')}")
    suspect = [name for name, case in captured.items()
               if any(isinstance(side, dict) and side.get("suspect") for side in case.values())]
    wrong = [name for name, case in captured.items() if case.get("ok") is False]
    if report.get("timing_suspect") or suspect or wrong:
        fail(f"the bench leg's captured cases: suspect {suspect}, agreement false {wrong}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    if not (PACKAGE / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside this script "
              f"({PACKAGE})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from k8s_device_plugin_tpu_torch.device import resolve_device

    resolve_device("cuda")  # also pins float32 matmuls to full float32
    phase_device()
    phase_build()
    entries = phase_kernels()
    phase_model()
    main_report, launches, steps = phase_main()
    norm_launches, norm_steps = phase_norm_path(main_report)
    multi_launches, multi_steps = phase_multi_step()
    dense_gen, flash_gen = phase_generation()
    phase_microbench()
    sharded_launches, _ = phase_sharded(main_report)
    moe_launches, _ = phase_moe()
    ring_launches, _ = phase_ring()
    resume_launches, _ = phase_resume(main_report)
    phase_node_card()
    sweep_launches = phase_kv_sweep(entries)
    phase_bench_leg()
    dist.destroy_process_group()
    path_launches = {name: (launches[name], steps) for name in FLASH}
    path_launches["rmsnorm"] = (norm_launches["rmsnorm"], norm_steps)
    by_path = {"bench": launches, "norm": norm_launches, "multi_step": multi_launches,
               "generate_dense": dense_gen, "generate_flash": flash_gen,
               "sharded": sharded_launches, "moe": moe_launches, "ring": ring_launches,
               "resume": resume_launches, "kv_sweep": sweep_launches}
    emit({"kernels": [
        dict(entries[name], launches=n, launches_per_step=n / per,
             launches_by_path={path: counts[name] for path, counts in by_path.items()})
        for name, (n, per) in path_launches.items()
    ], "multi_step_steps": multi_steps})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
