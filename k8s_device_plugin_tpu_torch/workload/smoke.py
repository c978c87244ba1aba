"""Smoke workload on the CUDA cards: validate the allocated devices end to
end and measure training throughput. The counterpart of the JAX package's
``workload/smoke.py``; the pod entry point is

    python -m k8s_device_plugin_tpu_torch.workload.smoke --bench

It trains over every card it is given, one rank per card: with more than
one visible card, or on a multi-host slice (``TPU_WORKER_HOSTNAMES``),
``main`` starts a rank per local card against one store
(``parallel/distributed.py``), rank 0 streams the report, and a rank that
fails stops them all. With one card it runs in its own process, a world of
one.

Checks performed:
1. torch initialises CUDA, the ranks join one process group and build the
   six-axis mesh over it, and the world matches the device count the
   allocation promised this host (CUDA_VISIBLE_DEVICES /
   NVIDIA_VISIBLE_DEVICES / TPU_PLUGIN_ALLOCATED_CHIPS);
2. the transformer LM, sharded over the mesh, trains a few AdamW steps on
   a global batch of ``batch_per_device`` x world rows; its first loss is
   not below ln(vocab) and the loss decreases;
3. step time, tokens/s and MFU (over the world's peak) are measured, and
   each hand-written kernel's launch count over the run (on rank 0) is
   reported.

``--xent-chunk N`` trains with the chunked-vocab loss (``ops/xent.py``).
``--inner-steps N`` takes N steps per call of ``train.make_multi_train_step``
(on the card, replays of one CUDA graph of the step of an unsharded
model), and ``--ab-xent-chunk N`` then A/Bs the other cross-entropy
formulation in the same process.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import LAUNCHES
from ..ops._build import build_all
from ..parallel import distributed
from ..parallel.mesh import axis_sizes, batch_shard, make_mesh
from . import train
from .chips import expected_device_count, peak_flops_for
from .model import ModelConfig

# Interleaved main/variant call pairs of the chunked-CE A/B.
AB_PAIRS = 3
# Seconds the launcher gives its ranks to finish the whole run.
SMOKE_TIMEOUT_S = 3600.0


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
    inner_steps: int = 1,
    ab_xent_chunk: int = 0,
) -> dict:
    """Train over every rank of the process group and return the report
    (every rank returns it). ``device`` defaults to the CUDA card of this
    rank (raising when there is none); pass ``device="cpu"`` for the plain
    PyTorch path over gloo. Outside a launcher's rank the world is this
    process alone. ``xent_chunk`` > 0 sets the config's chunked-vocab loss
    at that chunk size.

    The mesh is ``factorize``'s over the world, the global batch
    ``batch_per_device`` x world rows, drawn whole from the seed on every
    rank, of which each rank trains its own (a world of one trains the
    rows a one-device run trains). ``time_to_mesh_s`` is the process
    group's and the mesh's bring-up.

    With ``inner_steps`` == 1, ``steps`` timed steps follow one untimed
    first step. With ``inner_steps`` > 1 every call of
    ``train.make_multi_train_step`` takes ``inner_steps`` steps over one
    fixed stack of ``inner_steps`` distinct batches, with one host sync a
    call; ``steps`` rounds up to whole calls, which follow one untimed
    first call (on the card: the warm-up steps, the capture of the graph
    and its first replays).

    ``emit``, when given, is called on rank 0 with a snapshot of the
    report after each milestone (devices up, first step, each measured
    window but the last), tagged ``partial``, so a caller that must kill
    the process keeps the best partial report. Partial snapshots carry ``ok: None``,
    except the ``ab_pending`` one, emitted before the A/B below, which
    carries the final verdict already (only ``ab`` missing).

    ``ab_xent_chunk`` > 0 (with ``inner_steps`` > 1) measures the other
    cross-entropy formulation on the same model, optimizer and stack,
    interleaved with the main one (``_ab_xent``); reported under ``ab``
    with ``vs_plain_step`` (> 1: the chunked loss is faster)."""
    report: dict = {"ok": None}

    def _emit(stage: str) -> None:
        if emit is not None and dist.get_rank() == 0:
            snap = dict(report)
            snap["partial"] = stage
            emit(snap)

    t0 = time.monotonic()
    dev = distributed.local_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)  # the context is up
        kind = torch.cuda.get_device_name(dev)
        # The card's NVML UUID, as nvidia-smi and the device plugin name it:
        # a caller checks that the pod runs on the card it was given.
        uuid = f"GPU-{torch.cuda.get_device_properties(dev).uuid}"
    else:
        kind, uuid = "cpu", None
    t_devices = time.monotonic() - t0
    distributed.initialize(dev)
    world = dist.get_world_size()
    mesh = make_mesh(world, device=dev)
    t_mesh = time.monotonic() - t0 - t_devices
    expected = expected_device_count() if dev.type == "cuda" else None
    # The allocation counts this host's cards: the world on one host.
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))

    cfg = cfg or ModelConfig()
    if xent_chunk:
        cfg = dataclasses.replace(cfg, xent_chunk=xent_chunk)
    inner_steps = max(inner_steps, 1)
    launches0 = dict(LAUNCHES)
    report.update(
        {
            "backend": dev.type,
            "devices": world,
            "devices_used": world,
            "device_kind": kind,
            "device_uuid": uuid,
            "expected_devices": expected,
            "devices_match": expected is None or expected == local_world,
            "mesh": axis_sizes(mesh),
            "time_to_devices_s": round(t_devices, 3),
            "time_to_mesh_s": round(t_mesh, 3),
            "inner_steps": inner_steps,
            "xent_chunk": cfg.xent_chunk,
        }
    )
    _emit("devices_up")

    model, optimizer = train.make_train_state(cfg, dev, seed, mesh=mesh)
    batch = batch_per_device * world
    # Tokens are uniform random, so the step-1 loss of an untrained model
    # cannot be below ln(vocab) (cross entropy vs independent logits); a
    # value below the floor means the computation is wrong.
    loss_floor = math.log(cfg.vocab_size)
    gen = torch.Generator().manual_seed(seed + 1)

    def token_batches(n: int) -> torch.Tensor:
        """``n`` global batches, this rank's rows of each."""
        full = torch.randint(0, cfg.vocab_size, (n, batch, cfg.max_seq_len), generator=gen)
        return batch_shard(full, mesh, dim=1).to(dev)

    def note_first_step(first_loss: float, t_first_step: float) -> None:
        report.update(
            {
                "time_to_first_step_s": round(t_first_step, 3),
                # Until a steady-state rate exists, readiness is the whole
                # first call; refined after the windows.
                "time_to_ready_s": round(t_first_step, 3),
                "first_loss": round(first_loss, 4),
                "first_loss_floor": round(loss_floor, 4),
                "first_loss_sane": first_loss > loss_floor - 0.25,
            }
        )
        _emit("first_step")

    def note_window(loss: float, step_time: float, windows_done: int, windows: int) -> None:
        flops_step = cfg.train_flops_per_step(batch)
        peak = peak_flops_for(kind, world) if dev.type == "cuda" else None
        mfu = flops_step / step_time / peak if peak else None
        report.update(
            {
                # Readiness, not throughput: the first call takes one step
                # and then inner_steps - 1 more before the host sees
                # anything; those run at the steady rate, so they are
                # subtracted at the measured rate (never below 0).
                "time_to_ready_s": round(
                    max(report["time_to_first_step_s"] - (inner_steps - 1) * step_time, 0.0),
                    3,
                ),
                "step_time_s": round(step_time, 5),
                "tokens_per_s": round(batch * cfg.max_seq_len / step_time, 1),
                "model_flops_per_step": flops_step,
                "peak_flops_bf16": peak,
                "mfu": round(mfu, 4) if mfu is not None else None,
                "final_loss": round(loss, 4),
                "loss_decreased": loss < report["first_loss"],
                "measured_windows": f"{windows_done}/{windows}",
            }
        )
        if windows_done < windows:
            _emit(f"window_{windows_done}/{windows}")

    stack = mstep = None
    if inner_steps > 1:
        mstep = train.make_multi_train_step(model, optimizer, inner_steps)
        # One fixed stack of inner_steps distinct batches, reused every
        # call: memorising them makes the loss fall even on a short run
        # (fresh data would pin it at the ln(vocab) floor).
        stack = token_batches(inner_steps)

        t1 = time.monotonic()
        first_loss = float(mstep(stack)[0])
        note_first_step(first_loss, time.monotonic() - t1)
        report["capture_s"] = _capture_s(mstep)
        report["graphed"] = isinstance(mstep, train.GraphedTrainStep)

        calls = max((steps + inner_steps - 1) // inner_steps, 1)
        t2 = time.monotonic()
        for i in range(calls):
            # The mean over the pass: one batch's loss is noisy, and the
            # mean sits below the first (pre-update) loss once the stack is
            # being learned. float() is the window's one host sync.
            loss = float(mstep(stack).mean())
            step_time = (time.monotonic() - t2) / ((i + 1) * inner_steps)
            note_window(loss, step_time, i + 1, calls)
        measured = calls * inner_steps
        report["steps_run"] = measured + inner_steps
    else:
        # The same batch every step: memorising it makes the loss fall.
        tokens = token_batches(1)[0]
        t1 = time.monotonic()
        first_loss = float(train.train_step(model, optimizer, tokens))
        note_first_step(first_loss, time.monotonic() - t1)

        _sync(dev)
        t2 = time.monotonic()
        loss_t = torch.tensor(first_loss)
        for _ in range(steps):
            loss_t = train.train_step(model, optimizer, tokens)
        _sync(dev)
        loss = float(loss_t)
        measured = steps
        report["steps_run"] = steps + 1
        note_window(loss, (time.monotonic() - t2) / max(steps, 1), 1, 1)
    report["measured_steps"] = measured

    report["ok"] = (
        bool(report["devices_match"])
        and report["loss_decreased"]
        and report["first_loss_sane"]
        and math.isfinite(loss)
    )

    if ab_xent_chunk > 0 and stack is not None:
        if cfg.xent_chunk not in (0, ab_xent_chunk):
            # A main run chunked at another size would make the "plain"
            # side of vs_plain_step a second chunked variant.
            report["ab"] = {
                "skipped": f"main xent_chunk {cfg.xent_chunk} != ab chunk "
                f"{ab_xent_chunk}; vs_plain_step would compare two chunked variants"
            }
        else:
            # The verdict above is final: stream it before the A/B, so a
            # kill in there costs the A/B alone.
            _emit("ab_pending")
            report["ab"] = _ab_xent(
                model, optimizer, cfg.xent_chunk, stack, inner_steps, ab_xent_chunk,
                report.get("step_time_s"), mstep,
            )
            report["steps_run"] += report["ab"]["steps_run"]
    elif ab_xent_chunk > 0:
        report["ab"] = {"skipped": "A/B needs inner_steps > 1 (the multi-step path)"}
    report["kernel_launches"] = {
        name: LAUNCHES[name] - launches0[name] for name in LAUNCHES
    }
    return report


def _rank_smoke(kwargs: dict, stream: bool) -> dict:
    """One rank's ``run_smoke`` under ``main``'s launcher."""
    return run_smoke(**kwargs, emit=_print_json if stream else None)


def _print_json(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _capture_s(step) -> float | None:
    """The host time of a graphed step's capture; None for the eager loop."""
    t = getattr(step, "capture_s", None)
    return round(t, 3) if t is not None else None


def _ab_xent(
    model, optimizer, main_chunk: int, stack, inner_steps: int, chunk: int,
    main_step_time, main_step,
) -> dict:
    """Measure the other cross-entropy formulation on the same model,
    optimizer and stack, interleaved with the one the main run used: when
    the main run trained full-logits, the variant is the chunked CE at
    ``chunk``; when it trained chunked at ``chunk``, full-logits.

    Interleaved because on a shared card the drift between two sequential
    phases can exceed the effect: calls alternate main/variant for
    ``AB_PAIRS`` pairs and each side takes its median. Every call chains
    from the previous one's parameters and optimizer state (the loss
    trajectory does not matter to the timing). On the card the variant is
    a second CUDA graph over the same parameters and optimizer state
    (``train.GraphedTrainStep`` says how the two hold their gradients and
    pools).

    ``vs_plain_step`` is plain step time over chunked step time, so > 1
    means the chunked loss is faster. ``main_phase_step_s`` (the main
    phase's own windows) is reported for drift, not used in the ratio.
    ``first_call_s`` is the variant's first call: on the card its warm-up
    steps, capture and first replays. An exception here becomes ``error``
    and does not void the run's verdict."""
    variant_chunk = 0 if main_chunk == chunk else chunk
    out = {
        "xent_chunk": chunk,
        "main_xent_chunk": main_chunk,
        "variant_xent_chunk": variant_chunk,
        "interleaved": True,
        "main_phase_step_s": main_step_time,
        "steps_run": 0,
    }
    try:
        var_step = train.make_multi_train_step(model, optimizer, inner_steps, variant_chunk)
        t0 = time.monotonic()
        first = float(var_step(stack)[0])
        out["first_call_s"] = round(time.monotonic() - t0, 3)
        out["capture_s"] = _capture_s(var_step)
        out["first_loss"] = round(first, 4)
        out["steps_run"] += inner_steps

        def timed(step_fn) -> float:
            t = time.monotonic()
            float(step_fn(stack).mean())  # the call's host sync
            return (time.monotonic() - t) / inner_steps

        main_ts, var_ts = [], []
        for _ in range(AB_PAIRS):
            main_ts.append(timed(main_step))
            var_ts.append(timed(var_step))
            out["steps_run"] += 2 * inner_steps
        main_t = sorted(main_ts)[AB_PAIRS // 2]
        var_t = sorted(var_ts)[AB_PAIRS // 2]
        out["step_time_s"] = round(var_t, 5)
        out["interleaved_main_step_s"] = round(main_t, 5)
        plain_t, chunked_t = (main_t, var_t) if variant_chunk > 0 else (var_t, main_t)
        out["vs_plain_step"] = round(plain_t / chunked_t, 3)
    except Exception as e:  # noqa: BLE001 -- the A/B must not void the run
        out["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-per-device", type=int, default=8)
    p.add_argument(
        "--inner-steps", type=int, default=1,
        help="steps per call of the multi-step dispatch (on the card, replays "
        "of one CUDA graph of the step; 1 = the eager host loop)",
    )
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
        "--ab-xent-chunk", type=int, default=0,
        help="after the main measurement, A/B the chunked-vocab CE at this "
        "chunk size in-process (reports ab.vs_plain_step; needs --inner-steps > 1)",
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
    kwargs = dict(
        steps=args.steps,
        cfg=ModelConfig.bench() if args.bench else None,
        batch_per_device=args.batch_per_device,
        device=args.device,
        xent_chunk=args.xent_chunk,
        inner_steps=args.inner_steps,
        ab_xent_chunk=args.ab_xent_chunk,
    )
    stream = not args.no_stream
    env = distributed.slice_env()
    local = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 1
    if "WORLD_SIZE" in os.environ or (local == 1 and (env is None or env.num_hosts == 1)):
        try:
            report = _rank_smoke(kwargs, stream)  # this process is the rank
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    else:
        if local > 1:
            build_all()  # once, before the ranks would each build
        # One rank per local card; this host's first rank's report.
        report = distributed.spawn_local(_rank_smoke, local, args.device, (kwargs, stream),
                                         env=env, timeout_s=SMOKE_TIMEOUT_S)[0]
    _print_json(report)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
