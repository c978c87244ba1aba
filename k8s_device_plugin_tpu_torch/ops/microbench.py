"""Kernel microbenchmarks: the port's hand-written kernels against plain
PyTorch formulations of the same functions, on one card. The counterpart
of the JAX package's ``ops/microbench.py``.

    python -m k8s_device_plugin_tpu_torch.ops.microbench

Cases, in order (most valuable first, so a budget cut drops the tail):

- ``matmul_<n>``: one bare (n, n, n) bf16 product, the physics anchor
  every other number is read against;
- ``attention_seq<s>``: causal flash attention fwd+bwd (the CUDA kernels)
  against the dense ``reference_attention`` under autograd, bf16, head_dim
  128, at seq 8192 and 2048 (full tier) or the shortest seq (micro tier);
- ``attention_agreement``: max |flash - dense| of the forward at a small
  shape, so a fast but wrong kernel cannot pass;
- ``xent_<rows>x<d>x<vocab>``: the chunked-vocab CE (``ops/xent.py``)
  against the full-logits loss, fwd+bwd in (hidden, embed), at the bench
  model's LM head, with a same-loss guard;
- ``rmsnorm_<rows>x<d>``: the RMSNorm kernel (``ops/rmsnorm.py``) fwd+bwd
  against the plain PyTorch formulation under autograd, bf16. The baseline
  here is that plain formulation, not a compiler's fusion, so the sides are
  ``kernel`` and ``plain`` and the ratio ``speedup_vs_plain``;
- ``head_<layout>_<m>x<n>x<k>``: the LM head's 3xTF32 GEMM (``ops/head.py``)
  in each of its three layouts at the full-logits cells' shapes (smoke
  bench, gpt2-xl), against its plain version (the same three TF32 passes as
  PyTorch products) and the ``library`` f32 product (``torch.matmul``, TF32
  off), with the bound 3 * 2mnk / 495 TFLOP/s and its share, and each
  side's error against an f64 product of the same inputs (RMS and largest,
  over the f64 result's RMS). The full tier runs them.

Output is one JSON line (plus, with ``--stream``, a partial line after
every case). Each side reports its median ms per call; the ratio of the
two sides; achieved TFLOP/s (matmul, attention, xent) or GB/s (rmsnorm).

Timing: on the card, CUDA events around ``inner`` back-to-back calls, the
median over ``iters`` such windows after one warm-up call (which also
builds the kernels); on the CPU, ``time.perf_counter`` around the same
windows. Each timed side is checked against the card's published physics
from ``workload/chips.py`` (TFLOP/s above 1.15x the bf16 peak, rmsnorm
GB/s above 2x the memory rate: the traffic model counts four full-tensor
transits, which a fused side may beat) and an implausible side is marked
``suspect``, which sets the report's ``timing_suspect``.

Failures: a side that errors is recorded as ``error`` for that side only.
On a ``dense`` or ``plain`` side that is a result (dense attention at seq
8192 may run out of memory). On a side that runs a hand-written kernel
(``flash``, the RMSNorm ``kernel``) it sets ``ok: false``, as does a case
that raises outside its sides or a failed agreement or same-loss guard.
``--budget-s`` is checked before each case; a case that does not fit is
recorded as skipped, which keeps ``ok``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..workload.chips import card_spec

# Sides that run a hand-written kernel: an error there is a failure.
KERNEL_SIDES = ("flash", "kernel")


def _time_calls(fn: Callable, inner: int, iters: int, device: torch.device) -> list:
    """ms per call of ``iters`` windows of ``inner`` back-to-back calls."""
    samples = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / inner)
    return samples


def _bench_side(fn: Callable, inner: int, iters: int, device: torch.device) -> dict:
    """Warm one side up (the first call also builds its kernels), then time
    it. An error (out of memory, a kernel that refuses its inputs) is
    contained to this side."""
    try:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
        ms = statistics.median(_time_calls(fn, inner, iters, device))
        return {"first_call_s": round(first_s, 3), "inner": inner, "ms": round(ms, 4)}
    except Exception as e:  # noqa: BLE001 - one side failing is a result
        return {"error": f"{type(e).__name__}: {str(e)[:300]}"}
    finally:
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _flops_check(side: dict, flops: float, peak_flops: float) -> None:
    if side.get("ms"):
        tflops = flops / (side["ms"] * 1e-3) / 1e12
        side["tflops"] = round(tflops, 2)
        if peak_flops:
            side["frac_of_peak"] = round(tflops / (peak_flops / 1e12), 3)
            if tflops > 1.15 * peak_flops / 1e12:
                side["suspect"] = True  # faster than the card's peak


def _speedup(out: dict, base: str, side: str, key: str) -> None:
    if out[base].get("ms") and out[side].get("ms"):
        out[key] = round(out[base]["ms"] / out[side]["ms"], 3)


def _randn(shape, seed: int, device, dtype=torch.bfloat16, scale: float = 1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _grad_step(fn: Callable, *inputs: torch.Tensor, wrt: int) -> Callable:
    """A call that runs ``fn`` forward and backward: the gradients of
    ``fn(*inputs).float().mean()`` in the first ``wrt`` inputs."""
    leaves = [t.detach().requires_grad_() for t in inputs[:wrt]]
    rest = inputs[wrt:]

    def step():
        out = fn(*leaves, *rest)
        return torch.autograd.grad(out.float().mean(), leaves)

    return step


def _matmul_case(n: int, iters: int, inner: int, peak_flops: float,
                 device: torch.device) -> dict:
    """One bare (n, n, n) bf16 product (f32 accumulation, bf16 result):
    on a healthy card with honest timing this lands at a large fraction of
    the bf16 peak."""
    a = _randn((n, n), 5, device)
    b = _randn((n, n), 6, device)
    out = {"shape": [n, n, n], "dtype": "bfloat16",
           "matmul": _bench_side(lambda: a @ b, inner, iters, device)}
    _flops_check(out["matmul"], 2.0 * n * n * n, peak_flops)
    return out


def _attention_case(seq: int, batch: int, heads: int, d: int, iters: int, inner: int,
                    peak_flops: float, device: torch.device) -> dict:
    from .attention import flash_attention, reference_attention

    shape = (batch, heads, seq, d)
    q, k, v = (_randn(shape, s, device) for s in (0, 1, 2))
    out = {
        "shape": list(shape),
        "dtype": "bfloat16",
        "flash": _bench_side(_grad_step(flash_attention, q, k, v, wrt=3), inner, iters, device),
        "dense": _bench_side(_grad_step(reference_attention, q, k, v, wrt=3), inner, iters,
                             device),
    }
    # Causal fwd ~ 2 products * 2*b*h*seq^2*d / 2, and fwd+bwd ~ 3.5x fwd;
    # the causal count for both sides keeps the ratio a like-for-like
    # time comparison.
    flops = 3.5 * 2.0 * batch * heads * seq * seq * d
    for side in ("flash", "dense"):
        _flops_check(out[side], flops, peak_flops)
    _speedup(out, "dense", "flash", "speedup_vs_dense")
    return out


def _attention_agreement(batch: int, heads: int, seq: int, d: int,
                         device: torch.device) -> dict:
    """Max |flash - dense| of the forward at a small shape: the timed
    results cannot hide a wrong kernel."""
    from .attention import flash_attention, reference_attention

    shape = (batch, heads, seq, d)
    q, k, v = (_randn(shape, s, device) for s in (7, 8, 9))
    with torch.no_grad():
        f = flash_attention(q, k, v).float()
        r = reference_attention(q, k, v).float()
    max_diff = float((f - r).abs().max())
    # bf16 inputs: about one ulp between the online and the two-pass
    # softmax is expected; anything beyond is a fault.
    return {"max_abs_diff": round(max_diff, 5), "ok": max_diff < 0.05}


def _xent_case(rows: int, d: int, vocab: int, chunk: int, iters: int, inner: int,
               peak_flops: float, device: torch.device) -> dict:
    """The chunked-vocab CE against the full-logits loss, fwd+bwd in
    (hidden, embed), at the bench model's LM-head shape."""
    from .xent import chunked_softmax_xent, reference_softmax_xent

    hidden = _randn((rows, d), 3, device)
    embed = _randn((vocab, d), 4, device, torch.float32, 0.02)
    gen = torch.Generator(device=device).manual_seed(10)
    targets = torch.randint(0, vocab, (rows,), generator=gen, device=device)

    def chunked(h, e, t):
        return chunked_softmax_xent(h, e, t, chunk)

    out = {
        "shape": [rows, d, vocab],
        "chunk": chunk,
        "chunked": _bench_side(_grad_step(chunked, hidden, embed, targets, wrt=2), inner,
                               iters, device),
        "dense": _bench_side(_grad_step(reference_softmax_xent, hidden, embed, targets,
                                        wrt=2), inner, iters, device),
    }
    # fwd+bwd of the logits product is about three products of
    # 2*rows*d*vocab (the chunked side recomputes and does more).
    flops = 3 * 2.0 * rows * d * vocab
    for side in ("chunked", "dense"):
        _flops_check(out[side], flops, peak_flops)
    _speedup(out, "dense", "chunked", "speedup_vs_dense")
    # Same-loss guard at the timed shape. A dense side out of memory costs
    # only the guard, never the chunked side's timings.
    try:
        with torch.no_grad():
            a = float(chunked_softmax_xent(hidden, embed, targets, chunk))
            b = float(reference_softmax_xent(hidden, embed, targets))
        out["loss_abs_diff"] = round(abs(a - b), 6)
        out["ok"] = abs(a - b) < 1e-2
    except Exception as e:  # noqa: BLE001 - typically a dense OOM
        out["loss_guard_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def _rmsnorm_case(rows: int, d: int, iters: int, inner: int, hbm_gbps: float,
                  device: torch.device) -> dict:
    """The RMSNorm kernel (with its plain backward) against the kernel's
    plain version differentiated by autograd."""
    from .rmsnorm import rmsnorm, rmsnorm_fwd_plain

    def plain(x, scale):
        return rmsnorm_fwd_plain(x, scale, 1e-6)[0]

    x = _randn((rows, d), 1, device)
    scale = torch.ones(d, dtype=torch.bfloat16, device=device)
    out = {
        "shape": [rows, d],
        "dtype": "bfloat16",
        "kernel": _bench_side(_grad_step(rmsnorm, x, scale, wrt=2), inner, iters, device),
        "plain": _bench_side(_grad_step(plain, x, scale, wrt=2), inner, iters, device),
    }
    # Bytes-bound: the forward reads x and writes y, the backward reads x
    # and g and writes dx: about four full-tensor transits at bf16.
    traffic_bytes = 4 * rows * d * 2
    for side in ("kernel", "plain"):
        if out[side].get("ms"):
            gbps = traffic_bytes / (out[side]["ms"] * 1e-3) / 1e9
            out[side]["gb_per_s"] = round(gbps, 1)
            if hbm_gbps and gbps > 2.0 * hbm_gbps:
                out[side]["suspect"] = True
    _speedup(out, "plain", "kernel", "speedup_vs_plain")
    return out


# The LM head's (rows, d, vocab) at the full-logits cells (gpubench/):
# smoke-bench.train and gpt2-xl.train.
HEAD_CELLS = ((16384, 2048, 32768), (8192, 1600, 50257))
TF32_PEAK_FLOPS = 495e12


def _head_case(layout: str, rows: int, d: int, vocab: int, iters: int, inner: int,
               device: torch.device) -> dict:
    """One of the head's three products at (rows, d, vocab): ``nt`` the
    logits X E^T, ``nn`` dX = G E, ``tn`` dE = G^T X."""
    from . import head

    m, n, k = {"nt": (rows, vocab, d), "nn": (rows, d, vocab), "tn": (vocab, d, rows)}[layout]
    x = _randn((rows, d), 21, device, torch.float32)
    e = _randn((vocab, d), 22, device, torch.float32, 0.02)
    if layout == "nt":
        a, b = x, e
    else:
        g = _randn((rows, vocab), 23, device, torch.float32, 1e-4)
        a, b = (g, e) if layout == "nn" else (g, x)
    del x, e
    kernel = getattr(head, f"head_matmul_{layout}")
    plain = getattr(head, f"head_matmul_{layout}_plain")

    def library(a_, b_):
        return {"nt": lambda: a_ @ b_.T, "nn": lambda: a_ @ b_, "tn": lambda: a_.T @ b_}[layout]()

    flops = 2.0 * m * n * k
    out = {"shape": [m, n, k], "layout": layout, "dtype": "float32",
           "bound_ms": float(f"{3 * flops / TF32_PEAK_FLOPS * 1e3:.4g}")}
    for side, fn in (("kernel", kernel), ("plain", plain), ("library", library)):
        out[side] = _bench_side(lambda fn=fn: fn(a, b), inner, iters, device)
        _flops_check(out[side], flops, 0.0)
    if out["kernel"].get("ms"):
        out["bound_share"] = float(f"{out['bound_ms'] / out['kernel']['ms']:.4g}")
    _speedup(out, "library", "kernel", "speedup_vs_library")
    # Errors against f64 of the same inputs, after the timings (the f64
    # product and a difference hold four times the output's bytes).
    want = library(a.double(), b.double())
    scale = want.square().mean().sqrt()
    for side, fn in (("kernel", kernel), ("library", library)):
        if "error" in out[side]:
            continue
        diff = fn(a, b).double() - want
        out[side]["rms_err"] = float(diff.square().mean().sqrt() / scale)
        out[side]["max_err"] = float(diff.abs().max() / scale)
        del diff
    del want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _update_verdict(report: dict) -> None:
    """Set ``ok`` false on a failed guard, a failed case or a failed kernel
    side, and ``timing_suspect`` on an implausible side."""
    for case in report["kernels"].values():
        if case.get("ok") is False or "error" in case:
            report["ok"] = False
        for name, side in case.items():
            if not isinstance(side, dict):
                continue
            if name in KERNEL_SIDES and "error" in side:
                report["ok"] = False
            if side.get("suspect"):
                report["timing_suspect"] = True


def run_microbench(
    iters: int = 5,
    budget_s: float = 0.0,
    seqs: Optional[list] = None,
    rmsnorm_shape: tuple = (8192, 4096),
    stream: bool = False,
    inner: Optional[int] = None,
    tier: str = "full",
    matmul_n: int = 4096,
    device: str | torch.device | None = None,
) -> dict:
    """Run the cases and return the report. ``device`` defaults to the
    CUDA card (raising when there is none); ``device="cpu"`` runs the
    plain versions, for the schema and the agreement checks only.

    ``inner`` overrides every case's number of back-to-back calls per
    timed window. ``stream=True`` prints the partial report after every
    case, so a caller that must kill this process keeps what finished.
    ``tier="micro"`` is the short capture: the matmul anchor, one
    flash-vs-dense case at the shortest seq and the agreement check."""
    t_start = time.monotonic()

    def budget_left() -> float:
        if budget_s <= 0:
            return float("inf")
        return budget_s - (time.monotonic() - t_start)

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        device_kind, n_devices = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        device_kind, n_devices = "cpu", 1
    t_devices = time.monotonic() - t_start
    spec = card_spec(device_kind)
    peak_flops = spec.peak_bf16_flops if spec else 0.0
    hbm_gbps = spec.memory_bytes_per_s / 1e9 if spec else 0.0
    # Calls per timed window: enough that one window is long against the
    # events' resolution (fast ops need more).
    inner_attn = inner or 16
    inner_xent = inner or 8
    inner_norm = inner or 128
    inner_matmul = inner or 64
    inner_head = inner or 2
    if tier == "micro":
        iters = min(iters, 3)
    report = {
        "ok": True,
        "backend": dev.type,
        "device_kind": device_kind,
        "devices": n_devices,
        "time_to_devices_s": round(t_devices, 3),
        "iters": iters,
        "tier": tier,
        "timing": ("CUDA events around back-to-back calls" if dev.type == "cuda"
                   else "perf_counter around back-to-back calls (CPU)"),
        "kernels": {},
    }
    if stream:
        print(json.dumps({**report, "ok": None, "partial": "devices_up"}), flush=True)

    # Batch scales inversely with seq so every attention case moves about
    # the same number of tokens.
    seqs = sorted(seqs or ([2048] if tier == "micro" else [8192, 2048]), reverse=True)
    cases = [(
        f"matmul_{matmul_n}",
        lambda: _matmul_case(matmul_n, iters, inner_matmul, peak_flops, dev),
        8.0,
    )]
    agree_seq = min(1024, seqs[-1])
    agreement = ("attention_agreement",
                 lambda: _attention_agreement(1, 4, agree_seq, 128, dev))
    if tier == "micro":
        seq = seqs[-1]
        batch = max(1, min(4, 8192 // seq))
        cases += [
            (f"attention_seq{seq}",
             lambda: _attention_case(seq, batch, 8, 128, iters, inner_attn, peak_flops, dev),
             12.0),
            (*agreement, 8.0),
        ]
    else:
        for seq in seqs:
            batch = max(1, min(4, 8192 // seq))
            cases.append((
                f"attention_seq{seq}",
                (lambda s=seq, b=batch: _attention_case(
                    s, b, 8, 128, iters, inner_attn, peak_flops, dev)),
                60.0 if seq >= 8192 else 40.0,
            ))
        # xent at the bench model's LM-head shape, scaled down with the
        # attention seqs so CPU runs stay cheap.
        xv = 32768 if seqs[0] >= 2048 else 128
        xr, xd, xc = (8192, 2048, 4096) if seqs[0] >= 2048 else (64, 32, 32)
        cases += [
            (*agreement, 15.0),
            (f"xent_{xr}x{xd}x{xv}",
             lambda: _xent_case(xr, xd, xv, xc, iters, inner_xent, peak_flops, dev),
             30.0),
            ("rmsnorm_%dx%d" % rmsnorm_shape,
             lambda: _rmsnorm_case(*rmsnorm_shape, iters, inner_norm, hbm_gbps, dev),
             30.0),
        ]
    # The head at the cells' shapes on the card, at the xent case's tiny
    # shape on the CPU.
    head_shapes = HEAD_CELLS if dev.type == "cuda" else ((64, 32, 128),)
    head_cases = [
        (f"head_{layout}_%dx%dx%d" % {"nt": (r, v, d), "nn": (r, d, v), "tn": (v, d, r)}[layout],
         (lambda lay=layout, r=r, d=d, v=v: _head_case(lay, r, d, v, iters, inner_head, dev)),
         20.0)
        for r, d, v in head_shapes for layout in ("nt", "nn", "tn")
    ]
    if tier == "full":
        cases += head_cases
    for name, fn, min_budget in cases:
        if budget_left() < min_budget:
            report["kernels"][name] = {"skipped": "budget exhausted"}
            continue
        try:
            report["kernels"][name] = fn()
        except Exception as e:  # noqa: BLE001 - recorded, and it fails the run
            report["kernels"][name] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        # Before the streamed print: a partial line must never say ok
        # past a failed check.
        _update_verdict(report)
        if stream:
            report["wall_s"] = round(time.monotonic() - t_start, 2)
            print(json.dumps(report), flush=True)
    report["wall_s"] = round(time.monotonic() - t_start, 2)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--inner", type=int, default=0,
                   help="back-to-back calls per timed window (0 = per-case defaults)")
    p.add_argument("--budget-s", type=float, default=0.0,
                   help="soft wall-clock budget; cases that don't fit are skipped")
    p.add_argument("--seqs", type=str, default="",
                   help="comma-separated attention sequence lengths (default: per "
                   "tier, 8192,2048 full / 2048 micro)")
    p.add_argument("--stream", action="store_true",
                   help="print the partial report line after every completed case")
    p.add_argument("--tier", choices=("micro", "full"), default="full",
                   help="micro = matmul anchor + one flash-vs-dense at the shortest "
                   "seq + agreement; full = every case")
    p.add_argument("--matmul-n", type=int, default=4096,
                   help="side length of the bare-matmul physics anchor")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu' for the plain PyTorch path")
    args = p.parse_args(argv)
    seqs = [int(s) for s in args.seqs.split(",") if s] or None
    report = run_microbench(
        iters=args.iters,
        budget_s=args.budget_s,
        seqs=seqs,
        stream=args.stream,
        inner=args.inner or None,
        tier=args.tier,
        matmul_n=args.matmul_n,
        device=args.device,
    )
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
