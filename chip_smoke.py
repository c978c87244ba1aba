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
16. Plugin → pod: this script serves the kubelet's Registration service
   on ``<tmp>/kubelet.sock`` and its PodResources service on
   ``<tmp>/pod-resources/kubelet.sock`` (the port's ``api/grpc_defs.py``),
   starts ``tests/fake_apiserver.FakeApiServer`` (standard library only)
   on localhost with a node, writes a kube config naming it (as JSON), and
   starts the node daemon, ``python -m k8s_device_plugin_tpu_torch
   --device-plugin-dir <tmp> --node-name <node> --kubeconfig <file>
   --podresources-socket <socket> --metrics-port <free port>
   --telemetry-interval-s 0.5 --audit-interval-s 2 --trace --decisions
   --profile-hz 19 --lockdep --flight-dir <tmp> --blackbox-dir <tmp>
   --blackbox-fsync-s 0.5 --capture-dir <tmp> --capture-p99-ms 0.05``,
   over the real NVML and ``/dev``. From its start to SIGTERM this script
   polls the daemon's HTTP plane every 0.5 s: ``/healthz`` must answer 200
   on every poll from its first answer on, ``/metrics`` must parse as the
   Prometheus text format with ``tpu_plugin_chips{state="total"}`` equal
   to nvidia-smi's card count, and ``/debug/telemetry`` and
   ``/debug/audit`` must answer JSON (``/debug/resilience`` once). The
   daemon must register (version v1beta1, ``nvidia.com/gpu``, its
   endpoint, GetPreferredAllocation available); its first ListAndWatch
   answer must hold every card ``nvidia-smi --query-gpu=uuid`` lists, each
   Healthy. Before Allocate the node's ``nvidia.com/gpu-topology``
   annotation must list those cards with ``nvidia-smi``'s memory.total,
   all available and none failed, and the node condition ``GPUsHealthy``
   must be True. GetPreferredAllocation(size 1) must give one of the cards
   (the median of 20 calls is printed); Allocate of it must name its UUID
   in ``NVIDIA_VISIBLE_DEVICES`` with device specs whose host paths exist,
   and an unknown id must get INVALID_ARGUMENT. Then, as the API server and
   the kubelet would, the pod (on the node, Pending, requesting
   ``nvidia.com/gpu: 1``), its PodResources entry, and the pod Running: the
   pod's ``nvidia.com/gpu-devices`` annotation must become the UUID and
   the node annotation's ``available`` must lose it. Then the pod: ``python -m
   k8s_device_plugin_tpu_torch.workload.smoke --bench --steps 25`` with the
   response's env, and ``CUDA_VISIBLE_DEVICES`` set from
   ``NVIDIA_VISIBLE_DEVICES`` as the NVIDIA container runtime would. Its
   report must be ok with one expected device, each flash kernel and delta
   launched ``n_layers`` times a step it ran and the RMSNorm kernel not at
   all. The daemon must hold no CUDA context: the card's used memory may
   grow by less than 64 MiB from before its start to its first device
   list, and while the pod trains (at its first step) ``nvidia-smi
   --query-compute-apps`` must list two processes (this script and the
   pod) and the daemon must not map ``libtorch`` (the pod must). NVML's
   own init maps ``libcuda`` and opens ``/dev/nvidia-uvm``, so those are
   printed, not held. The ListAndWatch stream must send no new list while
   the pod runs; the API-server writes made while it trains are counted.
   While its timed steps run (after its first step, before its report), at
   least one poll must show the card's ``tpu_chip_*`` series labelled with
   the pod's ``pod``, ``namespace`` and ``container``, a duty cycle of 50%
   or more, memory used within 2% of memory.total of ``nvidia-smi``'s
   memory.used read in the same poll, and a power reading no higher than
   the card's power limit; every such poll must read
   ``tpu_node_free_chips`` one below the card count.
   After it exits its PodResources entry goes and the pod is deleted from
   the API server: the card must come back into ``available``, its series
   must lose the pod's labels within one sampler interval and 1 s, and
   ``tpu_node_free_chips`` must return to the card count. While the pod's
   timed steps run, ``/debug/profile?seconds=2&format=collapsed`` must hold
   samples of the daemon's named threads: the card telemetry sampler, the
   auditor, the supervisor loop (the main thread) and a gRPC worker. After
   the pod has gone the stand-in kubelet sends 40 more ``Allocate``s for
   its card, as a kubelet does on each container restart: with
   ``--capture-p99-ms 0.05``, below every ``Allocate`` measured on an H100
   node (0.86–3.19 ms), the windowed p99 crosses once, and exactly one capture bundle
   (``slo_allocate``) must be in the capture dir, with a profile section
   holding samples, the flight ring, the ledger tail, the heartbeat table
   and a metrics snapshot (the DaemonSet's 250 ms is the deployed value).
   ``/debug/lockdep`` must read enabled with no cycle. Last,
   SIGHUP must lead to a new registration and a new node annotation, and
   SIGTERM to an exit with code 0, the daemon's socket removed and no
   controller thread left draining; before it, the audit must have swept 3
   times or more, every sweep clean (``tpu_audit_sweeps_total`` has no
   ``findings`` or ``error`` outcome, every polled ``/debug/audit`` lists
   no finding and runs ``lock_order``) and
   ``tpu_audit_last_clean_sweep_timestamp`` must have advanced; no loop may
   have counted a stall and the black box no drop. After SIGTERM the flight
   dir must hold the ``shutdown`` dump, and the black box's segments must
   all read clean through the port's ``utils/blackbox.read_dir``, the
   newest ending in ``stop``, holding the ``Allocate`` flight events, the
   allocate decisions, ``plugin.Allocate`` spans, and heartbeat and metrics
   snapshots. One line with the times to
   registration and to the first node annotation, of the two RPCs, from
   Allocate to the pod's annotation, to the republish, to the pod's first
   step and to its report, from the pod's delete to the republish, of
   SIGHUP and SIGTERM, the pod's report beside phase 5's step time, the
   footprint, the API-server writes; the start to the first ``/healthz``
   200, the median ``/metrics`` scrape, sampler pass and audit sweep, the
   card's duty, power, temperature and memory during the pod's steps beside
   nvidia-smi's; the median of the 41 ``Allocate``s, the profiler's passes
   in its window against 19 Hz times the window, the bundle's bytes, the
   black box's records, bytes and rotations; and the card's name and power
   limit.

17. DRA claim → pod: a second daemon, ``python -m k8s_device_plugin_tpu_torch
   --dra`` with phase 16's evidence flags (``--profile-hz 19 --lockdep
   --flight-dir --blackbox-dir --blackbox-fsync-s 0.5 --capture-dir
   --capture-p99-ms 0.05``), ``--kubeconfig`` naming a new
   ``FakeApiServer``, ``--podresources-socket ""``, and its device-plugin,
   ``--plugins-dir``, ``--plugins-registry-dir`` and ``--cdi-dir`` dirs
   under one short temporary dir in /tmp (a unix socket path holds 107
   bytes), beside a stand-in kubelet's Registration service. A stand-in
   plugin watcher dials ``gpu.nvidia.com-reg.sock``: ``GetInfo`` must
   answer type ``DRAPlugin``, the driver's name, its ``dra.sock`` and both
   service names, and it sends ``NotifyRegistrationStatus``. The node's
   ResourceSlice must list one device a card nvidia-smi lists, named
   ``gpu-<index>``, with nvidia-smi's UUID as ``chipId`` and ``hbm`` within
   1% of its memory.total. Then a ResourceClaim allocated to this card (its
   UUID from torch, its index from nvidia-smi) and ``NodePrepareResources``
   on the GA method path: the response names the device and the claim's CDI
   id, and the CDI spec names this card: every device node's host path
   exists, ``NVIDIA_VISIBLE_DEVICES`` is its UUID and
   ``TPU_PLUGIN_ALLOCATED_CHIPS`` 1. While the claim is prepared the
   classic plane's ``GetPreferredAllocation`` offers nothing and
   ``Allocate`` of the card answers RESOURCE_EXHAUSTED, and
   ``tpu_plugin_dra_prepared_claims`` reads 1. The pod is
   ``workload.smoke --bench --steps 5`` with the spec's env and
   ``CUDA_VISIBLE_DEVICES`` from ``NVIDIA_VISIBLE_DEVICES``, in its own
   process: ok, on one expected device, the UUID it reports equal to the
   claim's card, each flash kernel and delta launched ``n_layers`` times a
   step it ran (its own counts) and the RMSNorm kernel not at all.
   ``NodeUnprepareResources`` must remove the spec, the gauge must read 0,
   and a classic ``Allocate`` of the card must then succeed;
   ``/metrics`` must export the heartbeat age of ``dra_slice_publisher``.
   SIGTERM must end the daemon with code 0 and its DRA sockets removed,
   and its black box must read clean, end in ``stop`` and hold the
   publisher's heartbeat. One line with the times from the start to
   ``Register`` and to the first ResourceSlice, of the two DRA RPCs, from
   the prepare to the pod's ``devices_up``, first step and report, the
   pod's step beside phase 5's, SIGTERM's, and the card's name and power
   limit.

18. The scheduler extender over this card's annotation (it runs no kernel):
   a daemon over the real NVML as in phase 17 (the same short dir,
   ``--metrics-port 0``, no evidence flags, and phase 16's stand-in
   PodResources) publishes ``nvidia.com/gpu-topology`` to a new
   ``FakeApiServer``; then ``python -m k8s_device_plugin_tpu_torch.extender
   --node-cache --kubeconfig <it> --port <free>`` in its own process, timed
   from its start to ``/readyz`` 200. Object mode: ``/filter`` and
   ``/prioritize`` for a pod asking 1 ``nvidia.com/gpu`` pass the card's node
   with score 2 on a one-card node (the packing bonus; 0 on a node of more
   cards), and a pod asking count + 1 is rejected on it
   (``no_slice_peers``'s message on one card, ``not_chip_multiple``'s on
   more). Name-only mode (``NodeNames``) must give the same verdicts,
   messages and scores; 50 calls of each verb in each mode give the median
   and p99. Then the stand-in kubelet's ``Allocate`` of one card (and the
   pod bound to the node): the time from its response until the name-only
   ``/filter`` rejects a pod asking every card with ``<count-1> chips
   available, <count> needed`` ("0 chips available, 1 needed" on one card),
   polled every 10 ms within 10 s; then the pod's delete, and the time
   until that pod passes again. Then 999 synthetic 8-card HGX nodes (every
   pair NV18, score 9, availability drawn from a seed) join the API server;
   once the extender's index holds all 1,000 nodes (``/debug/telemetry``'s
   cluster panel), the name-only ``/filter`` and ``/prioritize`` median and
   p99 over the 1,000 candidates for a 1-card pod (50 calls each, the
   vectorized filter) and a 4-card pod (50 calls each), and the object
   mode's over the 1,000 node objects (20 calls each); every name-only call
   must count its candidates in ``tpu_extender_parse_avoided_total{reason=
   "indexed_rpc"}``, and the name-only answers must equal the object
   answers. ``/metrics`` must parse and count every ``/filter`` and
   ``/prioritize`` this phase sent, and SIGTERM must end both processes with
   code 0. One line with every time, beside the card's name and power
   limit; the 1,000-node times are the host CPU's.

Then one ``{"kernels": [...]}`` line (each kernel's launches from the path
that runs it: K1-K3 from phase 5, K4 from phase 6; every path's counts
under ``launches_by_path``, phase 10's as ``sharded``, phase 11's as
``moe`` and ``ring``, phase 12's as ``resume``, phase 14's as
``kv_sweep``, phase 16's, from the pod's report, as ``plugin_pod``,
phase 17's, from its pod's report, as ``dra_pod``) and,
last, the device line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is not available or the port's package is not beside
this file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import re
import tempfile
import threading
import time
import urllib.error
import urllib.request
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


# The pod's training run, as a user's pod spec would start it.
POD_ARGS = ("-m", "k8s_device_plugin_tpu_torch.workload.smoke", "--bench", "--steps", "25")
PLUGIN_WAIT_S = 60


def mapped(pid: int) -> dict:
    """Which of torch and the CUDA driver library process ``pid`` maps, and
    whether it holds the UVM device open. NVML's own init maps libcuda and
    opens /dev/nvidia-uvm (NVIDIA driver 580), so only torch tells a context's
    maker from an NVML reader here."""
    maps = Path(f"/proc/{pid}/maps").read_text()
    fds = []
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            fds.append(os.readlink(fd))
        except OSError:  # closed between the listing and the read
            continue
    return {"libtorch": "libtorch" in maps, "libcuda": "libcuda.so" in maps,
            "nvidia_uvm_open": any(p.startswith("/dev/nvidia-uvm") for p in fds)}


def compute_apps() -> list:
    """The card's processes holding a CUDA context, as nvidia-smi lists
    them (in a container their pids read as the host's, or 1)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def memory_used_mib() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return int(out.split()[0])


# A CUDA context costs hundreds of MiB of device memory; the daemon's
# start may move the card's used memory by less than this.
DAEMON_MEMORY_MIB = 64

# The daemon's observability plane in this phase: the sampler's and the
# auditor's cadence, and how often this script polls the HTTP plane.
TELEMETRY_INTERVAL_S = 0.5
AUDIT_INTERVAL_S = 2.0
POLL_S = 0.5
# The daemon's evidence planes in this phase: the sampling profiler's rate
# (the DaemonSet's), the black box's fsync cadence, the Allocate p99
# threshold of the SLO capture, and the Allocates the stand-in kubelet
# sends again for the pod's card after the pod has gone (as a kubelet does
# each time a container restarts). The threshold is below every Allocate
# measured on an H100 node (0.86–3.19 ms), so the windowed p99 crosses it
# once and exactly one bundle is written; the DaemonSet's 250 ms is the
# deployed value.
PROFILE_HZ = 19
BLACKBOX_FSYNC_S = 0.5
CAPTURE_P99_MS = 0.05
REPEAT_ALLOCATES = 40
# The seconds of samples /debug/profile is asked for while the pod trains.
PROFILE_WINDOW_S = 2.0
SAMPLE_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')


def parse_metrics(text: str) -> list:
    """Every sample of a Prometheus text exposition, as (name, labels,
    value); a line that is neither a comment nor a well-formed sample
    raises ValueError."""
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = SAMPLE_LINE.match(line)
        if m is None:
            raise ValueError(f"/metrics line is not the Prometheus text format: {line!r}")
        name, raw, value = m.groups()
        labels, pos = {}, 0
        for lm in LABEL_PAIR.finditer(raw or ""):
            if lm.start() != pos:
                break
            labels[lm.group(1)] = lm.group(2)
            pos = lm.end()
        if pos != len(raw or ""):
            raise ValueError(f"/metrics labels are not the Prometheus text format: {line!r}")
        samples.append((name, labels, float(value)))
    return samples


def http_get(url: str) -> tuple[int, bytes]:
    """(status, body) of one GET; a refused connection reads as status 0."""
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return 0, b""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Observer(threading.Thread):
    """Polls the daemon's HTTP plane from its start until ``stop()``:
    ``/healthz`` every 10 ms until its first answer, then every ``POLL_S``
    ``/healthz``, ``/metrics`` (timed and parsed), ``/debug/telemetry``,
    ``/debug/audit`` and, while ``smi`` is set, nvidia-smi's memory and
    power limit right after the scrape. A poll that raises ends the thread
    with its message in ``error``; ``check`` fails the run on it."""

    def __init__(self, base: str):
        super().__init__(name="observer", daemon=True)
        self.base = base
        self.t_first_ok = None
        self.healthz: list = []  # status of every poll from the first answer on
        self.polls: list = []
        self.error = None
        self.smi = threading.Event()
        self._stop_evt = threading.Event()

    def stop(self) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=30)

    def check(self, daemon_fail) -> None:
        """Fails the run if a poll raised, or if the thread ended before
        ``stop()`` or outlived it."""
        if self.error is not None:
            daemon_fail(f"the HTTP plane's poll failed: {self.error}")
        if self.is_alive() == self._stop_evt.is_set():
            daemon_fail(f"the HTTP poller is alive: {self.is_alive()}, "
                        f"stopped: {self._stop_evt.is_set()}")

    def run(self) -> None:
        try:
            self._poll()
        except Exception as e:  # noqa: BLE001 - reported by check()
            self.error = f"{type(e).__name__}: {e}"

    def _poll(self) -> None:
        while not self._stop_evt.is_set() and self.t_first_ok is None:
            if http_get(self.base + "/healthz")[0] == 200:
                self.t_first_ok = time.monotonic()
                self.healthz.append(200)
            else:
                time.sleep(0.01)
        while not self._stop_evt.wait(POLL_S):
            self.healthz.append(http_get(self.base + "/healthz")[0])
            t0 = time.monotonic()
            status, body = http_get(self.base + "/metrics")
            poll = {"t": time.monotonic(), "metrics_status": status,
                    "scrape_ms": (time.monotonic() - t0) * 1e3,
                    "samples": parse_metrics(body.decode()) if status == 200 else None}
            if self.smi.is_set():
                row = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used,memory.total,power.limit",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=60, check=True).stdout
                used, total, limit = (float(v) for v in row.splitlines()[0].split(","))
                poll["smi"] = {"memory_used_mib": used, "memory_total_mib": total,
                               "power_limit_w": limit}
            for name in ("telemetry", "audit"):
                status, body = http_get(f"{self.base}/debug/{name}")
                poll[name] = json.loads(body) if status == 200 else {"status": status}
            self.polls.append(poll)


def card_series(samples, uuid: str) -> dict:
    """family → (labels, value) of the card's ``tpu_chip_*`` series (the
    links left out)."""
    return {name: (labels, value) for name, labels, value in samples
            if name.startswith("tpu_chip_") and labels.get("chip") == uuid
            and "link" not in labels}


def sample_value(samples, name: str, **labels):
    """The value of one series, or None."""
    for n, lab, value in samples:
        if n == name and all(lab.get(k) == v for k, v in labels.items()):
            return value
    return None


class Kubelet:
    """The kubelet's Registration service on ``<dir>/kubelet.sock``, built
    on the port's ``api/grpc_defs.py``: every RegisterRequest is queued
    with the time it came and what ``mark()`` read then."""

    def __init__(self, directory: str, mark=lambda: None):
        import grpc
        from concurrent import futures

        from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
        from k8s_device_plugin_tpu_torch.api.grpc_defs import (
            RegistrationServicer, add_registration_servicer)

        registrations = self.registrations = queue.Queue()

        class Registration(RegistrationServicer):
            def Register(self, request, context):
                registrations.put((time.monotonic(), request, mark()))
                return pb.Empty()

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        add_registration_servicer(Registration(), self.server)
        self.server.add_insecure_port(f"unix:{directory}/kubelet.sock")
        self.server.start()

    def next_registration(self):
        try:
            return self.registrations.get(timeout=PLUGIN_WAIT_S)
        except queue.Empty:
            fail(f"the daemon did not register within {PLUGIN_WAIT_S} s")


class PodResources:
    """The kubelet's PodResources service on ``socket_path``, built on the
    port's ``api/grpc_defs.py``: each pod's ``nvidia.com/gpu`` ids in one
    container, as ``set`` records them."""

    def __init__(self, socket_path: str):
        import grpc
        from concurrent import futures

        from k8s_device_plugin_tpu_torch.api import constants
        from k8s_device_plugin_tpu_torch.api import podresources_pb2 as prpb
        from k8s_device_plugin_tpu_torch.api.grpc_defs import (
            PodResourcesListerServicer, add_pod_resources_servicer)

        self.socket_path = socket_path
        lock = self._lock = threading.Lock()
        pods = self._pods = {}

        def message(key, ids):
            return prpb.PodResources(namespace=key[0], name=key[1], containers=[
                prpb.ContainerResources(name="main", devices=[prpb.ContainerDevices(
                    resource_name=constants.RESOURCE_NAME, device_ids=ids)])])

        class Lister(PodResourcesListerServicer):
            def List(self, request, context):
                with lock:
                    items = list(pods.items())
                return prpb.ListPodResourcesResponse(
                    pod_resources=[message(k, v) for k, v in items])

            def Get(self, request, context):
                key = (request.pod_namespace, request.pod_name)
                with lock:
                    ids = pods.get(key)
                if ids is None:  # the kubelet's answer for a pod it has not admitted
                    context.abort(grpc.StatusCode.UNKNOWN, f"pod {key} not found")
                return prpb.GetPodResourcesResponse(pod_resources=message(key, ids))

        os.makedirs(os.path.dirname(socket_path), exist_ok=True)
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        add_pod_resources_servicer(Lister(), self.server)
        self.server.add_insecure_port(f"unix:{socket_path}")
        self.server.start()

    def set(self, namespace: str, name: str, ids) -> None:
        with self._lock:
            self._pods[(namespace, name)] = list(ids)

    def drop(self, namespace: str, name: str) -> None:
        with self._lock:
            self._pods.pop((namespace, name), None)


NODE_NAME = "smoke-node"
POD_NAME = "smoke-pod"


def pod_telemetry(observer: Observer, t_steps, uuid: str, n_cards: int,
                  daemon_fail) -> dict:
    """The polls made while the pod's timed steps ran: each must read one
    free card fewer than the node has, and at least one must show the card
    attributed to the pod, busy, with NVML's memory used within 2% of
    memory.total of nvidia-smi's and a power reading within the limit."""
    observer.check(daemon_fail)
    if t_steps is None or t_steps[1] is None:
        daemon_fail("the pod's timed steps were not seen")
    inside = [p for p in list(observer.polls) if t_steps[0] < p["t"] < t_steps[1]
              and p["samples"] is not None and "smi" in p]
    rows, good = [], 0
    for p in inside:
        series = card_series(p["samples"], uuid)
        labels = series.get("tpu_chip_duty_cycle", ({}, None))[0]
        value = {name: v for name, (_, v) in series.items()}
        smi = p["smi"]
        used_mib = value.get("tpu_chip_hbm_used_bytes", -1) / 2 ** 20
        row = {"duty_pct": value.get("tpu_chip_duty_cycle"),
               "power_w": value.get("tpu_chip_power_watts"),
               "temp_c": value.get("tpu_chip_temperature_celsius"),
               "memory_used_mib": used_mib, "smi_memory_used_mib": smi["memory_used_mib"],
               "free_cards": sample_value(p["samples"], "tpu_node_free_chips"),
               "attributed": {k: labels.get(k) for k in ("pod", "namespace", "container")}}
        rows.append(row)
        if row["free_cards"] != n_cards - 1:
            daemon_fail(f"tpu_node_free_chips read {row['free_cards']} while the pod held "
                        f"its card ({n_cards} cards)")
        if (row["attributed"] == {"pod": POD_NAME, "namespace": "default", "container": "main"}
                and (row["duty_pct"] or 0) >= 50
                and abs(used_mib - smi["memory_used_mib"]) <= 0.02 * smi["memory_total_mib"]
                and row["power_w"] is not None and row["power_w"] <= smi["power_limit_w"]):
            good += 1
    if not good:
        daemon_fail(f"no poll during the pod's steps showed its card attributed, busy, its "
                    f"memory and power right: {rows}")
    return {"polls_during_steps": len(rows), "polls_meeting_every_limit": good,
            "power_limit_w": inside[0]["smi"]["power_limit_w"], "samples": rows}


def observability(observer: Observer, t_start: float, n_cards: int, daemon_fail) -> dict:
    """The daemon's HTTP plane over the phase: /healthz 200 on every poll
    from its first answer, /metrics in the text format with the card count,
    JSON from /debug/*, and an audit that swept 3 times or more and was clean
    every time, its last-clean stamp advancing. The medians of the scrape,
    the sampler's pass and the audit's sweep. Stops the polls."""
    observer.stop()
    observer.check(daemon_fail)
    status, body = http_get(observer.base + "/debug/resilience")
    resilience = json.loads(body) if status == 200 else None
    polls = [p for p in observer.polls if p["samples"] is not None]
    if observer.t_first_ok is None or not polls:
        daemon_fail("the daemon's /healthz or /metrics never answered")
    bad = [code for code in observer.healthz if code != 200]
    if bad:
        daemon_fail(f"/healthz answered {bad} after its first 200")
    if any(p["metrics_status"] != 200 for p in observer.polls):
        daemon_fail("a /metrics poll did not answer 200")
    last = polls[-1]["samples"]
    total = sample_value(last, "tpu_plugin_chips", state="total")
    if total != n_cards:
        daemon_fail(f'tpu_plugin_chips{{state="total"}} is {total}, nvidia-smi lists {n_cards}')
    if any("enabled" not in p["telemetry"] or "enabled" not in p["audit"]
           for p in observer.polls):
        daemon_fail("/debug/telemetry or /debug/audit did not answer its JSON")
    if resilience is None or "call_outcomes" not in resilience:
        daemon_fail(f"/debug/resilience answered {status}")
    # Each generation's sampler counts its own passes: (pass, its ms).
    passes = {(p["telemetry"]["ticks"], p["telemetry"]["last_pass_ms"])
              for p in observer.polls if p["telemetry"].get("ticks")}
    sweeps = {}
    for p in observer.polls:
        a = p["audit"]
        if a.get("findings") or a.get("errors"):
            daemon_fail(f"an audit sweep found {a.get('findings')} (errors {a.get('errors')})")
        if a.get("sweeps"):
            sweeps[a["last_sweep_ts"]] = a["last_duration_ms"]
    outcomes = {lab["outcome"]: v for n, lab, v in last if n == "tpu_audit_sweeps_total"}
    stamps = [sample_value(p["samples"], "tpu_audit_last_clean_sweep_timestamp") for p in polls]
    stamps = [v for v in stamps if v]
    if (outcomes.get("clean", 0) < 3 or outcomes.get("findings", 0) or outcomes.get("error", 0)
            or len(stamps) < 2 or stamps[-1] <= stamps[0]):
        daemon_fail(f"the audit: sweeps {outcomes}, last-clean stamps {stamps[:1]}..{stamps[-1:]}")
    return {
        "start_to_healthz_s": observer.t_first_ok - t_start,
        "healthz_polls": len(observer.healthz),
        "metrics_scrape_ms_median": statistics.median(p["scrape_ms"] for p in polls),
        "metrics_samples": len(last),
        "sampler_pass_ms_median": statistics.median(ms for _, ms in passes),
        "sampler_passes_seen": len(passes),
        "audit_sweep_ms_median": statistics.median(sweeps.values()),
        "audit_sweeps": outcomes,
        "audit_sweep_seconds_mean": (
            sample_value(last, "tpu_audit_sweep_seconds_sum")
            / sample_value(last, "tpu_audit_sweep_seconds_count")),
        "audit_last_clean_advanced_s": stamps[-1] - stamps[0],
        "resilience_call_outcomes": resilience["call_outcomes"],
    }


class ProfileProbe(threading.Thread):
    """While the pod trains: the sampler's pass count, then
    ``PROFILE_WINDOW_S`` seconds of samples from ``/debug/profile`` in the
    collapsed format, then the pass count again."""

    def __init__(self, base: str):
        super().__init__(name="profile-probe", daemon=True)
        self.base = base
        self.result = None
        self.error = None

    def run(self) -> None:
        try:
            t1 = time.monotonic()
            s1 = json.loads(http_get(self.base + "/debug/profile")[1])
            status, body = http_get(
                f"{self.base}/debug/profile?seconds={PROFILE_WINDOW_S}&format=collapsed")
            window = json.loads(body) if status == 200 else {"status": status}
            t2 = time.monotonic()
            self.result = (t1, t2, s1, window)
        except Exception as e:  # noqa: BLE001 - reported by check()
            self.error = f"{type(e).__name__}: {e}"

    def check(self, t_steps, daemon_fail) -> dict:
        """The window must fall inside the pod's timed steps and hold samples
        of the daemon's named threads: the card telemetry sampler, the
        auditor, the supervisor loop (the main thread) and gRPC's workers."""
        self.join(timeout=PROFILE_WINDOW_S + 30)
        if self.error is not None or self.result is None:
            daemon_fail(f"/debug/profile during the pod's steps: {self.error}")
        t1, t2, s1, window = self.result
        if not (s1.get("enabled") and window.get("enabled") and window.get("folded")):
            daemon_fail(f"/debug/profile answered {s1} then {str(window)[:400]}")
        if not t_steps[0] <= t1 < t_steps[1]:
            daemon_fail("the profile window began outside the pod's timed steps")
        counts: dict = {}
        for row in window["folded"].splitlines():
            stack, n = row.rsplit(" ", 1)
            thread = stack.split(";", 1)[0].removeprefix("thread:")
            counts[thread] = counts.get(thread, 0) + int(n)
        named = {"tpu-telemetry-sampler", "tpu-audit", "MainThread"}
        grpc_workers = [t for t in counts if t.startswith("ThreadPoolExecutor")]
        if not named <= set(counts) or not grpc_workers:
            daemon_fail(f"the profile's threads {sorted(counts)} lack the sampler, the "
                        f"auditor, the supervisor or a gRPC worker")
        passes = window["stats"]["samples"] - s1["stats"]["samples"]
        return {"window_s": t2 - t1, "window_end_after_steps_s": t2 - t_steps[1],
                "passes": passes,
                "passes_expected": PROFILE_HZ * (t2 - t1),
                "pass_rate_hz": passes / (t2 - t1),
                "samples_by_thread": counts,
                "samples_total": window["stats"]["samples"]}


def capture_bundle(capture_dir: Path, daemon_fail) -> dict:
    """Exactly one SLO bundle, ``slo_allocate``, with a profile section
    holding samples, the flight ring, the ledger tail, the heartbeat table
    (the supervisor's and the running watchdog's own) and a metrics
    snapshot."""
    # The crossing writes its bundle inside the Allocate that evaluates it,
    # before that RPC answers: it is on disk once the last Allocate returned.
    bundles = sorted(capture_dir.glob("capture-*.json"))
    if len(bundles) != 1 or not bundles[0].name.endswith("-slo_allocate.json"):
        daemon_fail(f"capture bundles: {[b.name for b in bundles]}")
    doc = json.loads(bundles[0].read_text())
    prof = doc.get("profile") or {}
    flight = [e["kind"] for e in (doc.get("flight") or {}).get("events", [])]
    records = [r["kind"] for r in (doc.get("decisions") or {}).get("records", [])]
    loops = [h["name"] for h in doc.get("heartbeats") or []]
    if not (prof.get("enabled") and prof["stats"]["samples"] > 0 and prof.get("folded")
            and "allocate" in flight and "allocate_substitution" in records
            and {"supervisor", "stall_watchdog"} <= set(loops)
            and "tpu_plugin_uptime_seconds" in doc.get("metrics", "")):
        daemon_fail(f"the capture bundle lacks a section: profile {prof.get('stats')}, "
                    f"flight {sorted(set(flight))}, decisions {sorted(set(records))}, "
                    f"heartbeats {loops}")
    return {"bytes": bundles[0].stat().st_size, "reason": doc["reason"],
            "windowed_p99_ms": doc["windows"]["allocate"]["p99_ms"],
            "profile_samples": prof["stats"]["samples"], "flight_events": len(flight),
            "decisions": len(records), "heartbeats": loops}


def evidence(observer: Observer, bb_live: dict, flight_dir: Path, blackbox_dir: Path,
             daemon_fail) -> dict:
    """After SIGTERM: the ``shutdown`` flight dump; a black box whose
    segments all read clean through the port's ``read_dir``, the newest
    ending in ``stop``, holding the Allocate flight events, the allocate
    decisions, ``plugin.Allocate`` spans and heartbeat and metrics
    snapshots; a running stall watchdog, which alone exports the heartbeat
    ages, so that "no loop stalled" has a watchdog behind it; no loop
    stalled and no black-box record dropped."""
    from k8s_device_plugin_tpu_torch.utils.blackbox import read_dir

    dumps = sorted(flight_dir.glob("flight-plugin-*-shutdown.json"))
    if len(dumps) != 1:
        daemon_fail(f"flight dumps: {sorted(p.name for p in flight_dir.glob('*'))}")
    records, meta = read_dir(str(blackbox_dir))
    statuses = {seg["status"] for seg in meta["segments"]}
    kinds: dict = {}
    for rec in records:
        key = rec["kind"]
        if key in ("flight", "decision", "span"):
            key = f"{key}:{rec['data'].get('kind') or rec['data'].get('name')}"
        kinds[key] = kinds.get(key, 0) + 1
    if (statuses != {"clean"} or not records or records[-1]["kind"] != "stop"
            or not all(kinds.get(k) for k in ("flight:allocate",
                                              "decision:allocate_substitution",
                                              "span:plugin.Allocate", "heartbeats",
                                              "metrics"))):
        daemon_fail(f"the black box: segments {meta['segments']}, records {kinds}")
    invariants = [{i["name"] for i in p["audit"].get("invariants", [])} for p in observer.polls
                  if p["audit"].get("sweeps")]
    if not invariants or not all("lock_order" in names for names in invariants):
        daemon_fail(f"the audit's invariants {invariants[-1:]} lack lock_order")
    last = [p["samples"] for p in observer.polls if p["samples"] is not None][-1]
    aged = {lab["loop"] for n, lab, v in last
            if n == "tpu_thread_heartbeat_age_seconds" and "loop" in lab}
    if not {"supervisor", "stall_watchdog"} <= aged:
        daemon_fail(f"the last /metrics poll has heartbeat ages of {sorted(aged)}: "
                    f"the stall watchdog is not running")
    stalled = [lab for n, lab, v in last if n == "tpu_loop_stall_total" and v
               and lab.get("reason") == "stalled"]
    dropped = [lab for n, lab, v in last if n == "tpu_blackbox_dropped_total" and v]
    if stalled or dropped or bb_live.get("enabled") is not True or bb_live.get("drops"):
        daemon_fail(f"stalled loops {stalled}, black-box drops {dropped} "
                    f"{bb_live.get('drops')}, black box enabled {bb_live.get('enabled')}")
    return {"flight_dump_bytes": dumps[0].stat().st_size,
            "heartbeat_ages_of": sorted(aged),
            "blackbox": {"segments": len(meta["segments"]), "records_read": len(records),
                         "records_written": bb_live["records_written"],
                         "bytes_written": bb_live["bytes_written"],
                         "rotations": bb_live["rotations"], "by_kind": kinds}}


def phase_plugin_pod(main_report: dict) -> dict:
    """The node daemon hands this card to a pod, which trains on it, and
    tells a fake API server which card the pod holds."""
    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_device_plugin_tpu_torch.api.grpc_defs import DevicePluginStub
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
    from tests.fake_apiserver import FakeApiServer

    torch.cuda.empty_cache()
    smi_memory = {}
    for row in subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,memory.total", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines():
        uuid, mib = (v.strip() for v in row.split(","))
        smi_memory[uuid] = int(mib)
    smi_uuids = list(smi_memory)
    work = Path(tempfile.mkdtemp(prefix="plugin_pod_"))
    api = FakeApiServer()
    # Each registration carries how many node patches had landed by then.
    kubelet = Kubelet(str(work), mark=lambda: len(api.node_patches))
    podres = PodResources(str(work / "pod-resources" / "kubelet.sock"))
    api_url = api.start()
    api.add_node(NODE_NAME)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke"}}],
    }))

    def writes() -> int:
        """The API server's writes so far: node, node status and pod
        patches, Events, evictions."""
        return (len(api.node_patches) + len(api.node_status_patches) + len(api.pod_patches)
                + len(api.events) + len(api.evictions))

    def node_topology():
        raw = api.nodes[NODE_NAME]["metadata"].get("annotations", {}).get(
            constants.TOPOLOGY_ANNOTATION)
        return json.loads(raw) if raw else None

    def node_condition():
        conds = (api.nodes[NODE_NAME].get("status") or {}).get("conditions") or []
        return next((c for c in conds if c.get("type") == "GPUsHealthy"), None)

    def pod_devices():
        pod = api.pods.get(("default", POD_NAME)) or {}
        return (pod.get("metadata", {}).get("annotations") or {}).get(
            constants.POD_DEVICES_ANNOTATION)

    log_path = work / "daemon.log"
    flight_dir, blackbox_dir, capture_dir = work / "flight", work / "blackbox", work / "captures"
    line: dict = {"nvidia_smi": nvidia_smi()}
    channel = None
    used_before = memory_used_mib()
    port = free_port()
    observer = Observer(f"http://127.0.0.1:{port}")
    with open(log_path, "w") as log_file:
        t_start = time.monotonic()
        daemon = subprocess.Popen([sys.executable, "-m", "k8s_device_plugin_tpu_torch",
                                   "--device-plugin-dir", str(work), "--node-name", NODE_NAME,
                                   "--kubeconfig", str(kubeconfig),
                                   "--podresources-socket", podres.socket_path,
                                   "--metrics-port", str(port),
                                   "--telemetry-interval-s", str(TELEMETRY_INTERVAL_S),
                                   "--audit-interval-s", str(AUDIT_INTERVAL_S),
                                   "--trace", "--decisions",
                                   "--profile-hz", str(PROFILE_HZ), "--lockdep",
                                   "--flight-dir", str(flight_dir),
                                   "--blackbox-dir", str(blackbox_dir),
                                   "--blackbox-fsync-s", str(BLACKBOX_FSYNC_S),
                                   "--capture-dir", str(capture_dir),
                                   "--capture-p99-ms", str(CAPTURE_P99_MS)],
                                  cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    observer.start()
    try:
        def daemon_fail(msg: str) -> None:
            print(log_path.read_text()[-4000:], file=sys.stderr, flush=True)
            fail(msg)

        def seen(**preds) -> dict:
            """Poll every predicate every 2 ms until each has held once:
            the first time each held, and what it gave."""
            got: dict = {}
            deadline = time.monotonic() + PLUGIN_WAIT_S
            while len(got) < len(preds):
                for name, pred in preds.items():
                    if name not in got and (value := pred()):
                        got[name] = (time.monotonic(), value)
                if time.monotonic() > deadline:
                    daemon_fail(f"not seen within {PLUGIN_WAIT_S} s: "
                                f"{sorted(set(preds) - set(got))}")
                time.sleep(0.002)
            return got

        t_reg, req, _ = kubelet.next_registration()
        line["register_s"] = t_reg - t_start
        if (req.version, req.resource_name, req.endpoint,
                req.options.get_preferred_allocation_available) != (
                "v1beta1", constants.RESOURCE_NAME, constants.PLUGIN_SOCKET_NAME, True):
            daemon_fail(f"RegisterRequest {req}")
        channel = grpc.insecure_channel(f"unix:{work / req.endpoint}")
        stub = DevicePluginStub(channel)
        lists: queue.Queue = queue.Queue()

        def watch(stream) -> None:
            """The kubelet's ListAndWatch stream, each answer queued; its
            end (the daemon's rebuild or exit) is queued as None."""
            try:
                for resp in stream:
                    lists.put(resp)
            except grpc.RpcError as e:
                lists.put(e)
            lists.put(None)

        threading.Thread(target=watch, args=(stub.ListAndWatch(pb.Empty()),),
                         daemon=True).start()
        first = lists.get(timeout=PLUGIN_WAIT_S)
        line["card_memory_used_mib"] = {"before_daemon": used_before,
                                        "daemon_serving": memory_used_mib()}
        devices = {d.ID: d.health for d in first.devices}
        line["devices"] = len(devices)
        if sorted(devices) != sorted(smi_uuids) or set(devices.values()) != {constants.HEALTHY}:
            daemon_fail(f"ListAndWatch sent {devices}; nvidia-smi lists {len(smi_uuids)} cards")

        # What the node told the cluster before any allocation.
        first_pub = seen(annotation=node_topology, condition=node_condition)
        t_ann, topo = first_pub["annotation"]
        line["start_to_annotation_s"] = t_ann - t_start
        cards = {c["id"]: c["hbm_bytes"] // 2 ** 20 for c in topo["chips"]}
        condition = first_pub["condition"][1]
        line["node"] = {"cards": len(cards), "product": topo["product"],
                        "labels": api.nodes[NODE_NAME]["metadata"].get("labels", {}),
                        "condition": condition["status"]}
        if cards != smi_memory:
            daemon_fail(f"the node annotation's cards and memory {cards}; "
                        f"nvidia-smi: {smi_memory}")
        if sorted(topo["available"]) != sorted(smi_uuids) or topo["failed"]:
            daemon_fail(f"before Allocate the annotation has available {topo['available']}, "
                        f"failed {topo['failed']}")
        if condition["status"] != "True":
            daemon_fail(f"the node condition before Allocate: {condition}")
        status_patches = len(api.node_status_patches)

        preq = pb.PreferredAllocationRequest()
        preq.container_requests.add(available_deviceIDs=list(devices), allocation_size=1)
        gpa_ms = []
        for _ in range(20):
            t0 = time.monotonic()
            pref = stub.GetPreferredAllocation(preq, timeout=PLUGIN_WAIT_S)
            gpa_ms.append((time.monotonic() - t0) * 1e3)
        picked = list(pref.container_responses[0].deviceIDs)
        line["get_preferred_allocation_ms_median"] = statistics.median(gpa_ms)
        if len(picked) != 1 or picked[0] not in devices:
            daemon_fail(f"GetPreferredAllocation(size 1) gave {picked}")

        areq = pb.AllocateRequest()
        areq.container_requests.add(devicesIDs=picked)
        t_alloc = time.monotonic()
        cresp = stub.Allocate(areq, timeout=PLUGIN_WAIT_S).container_responses[0]
        line["allocate_ms"] = (time.monotonic() - t_alloc) * 1e3
        allocate_ms = [line["allocate_ms"]]
        paths = [d.host_path for d in cresp.devices]
        line["device_specs"] = paths
        if cresp.envs.get(constants.NVIDIA_VISIBLE_DEVICES) != picked[0]:
            daemon_fail(f"Allocate's env {dict(cresp.envs)} does not name {picked}")
        if not paths or not all(os.path.exists(p) for p in paths):
            daemon_fail(f"Allocate's device specs {paths} are not all on the host")
        bogus = pb.AllocateRequest()
        bogus.container_requests.add(devicesIDs=["GPU-not-a-card"])
        try:
            stub.Allocate(bogus, timeout=PLUGIN_WAIT_S)
            code = grpc.StatusCode.OK
        except grpc.RpcError as e:
            code = e.code()
        if code != grpc.StatusCode.INVALID_ARGUMENT:
            daemon_fail(f"an unknown id got {code}, not INVALID_ARGUMENT")

        # The pod is bound to the node, the kubelet records the assignment
        # and starts it; the controller writes its card, the publisher
        # withdraws it. (In this order no audit sweep can find the kubelet
        # holding a card for a pod the API server does not know.)
        api.add_pod({
            "metadata": {"name": POD_NAME, "namespace": "default", "uid": "smoke-pod-uid",
                         "annotations": {}},
            "spec": {"nodeName": NODE_NAME, "containers": [{"name": "main", "resources": {
                "requests": {constants.RESOURCE_NAME: "1"}}}]},
            "status": {"phase": "Pending"},
        })
        podres.set("default", POD_NAME, picked)
        running = api.pods[("default", POD_NAME)]
        running["status"] = {"phase": "Running"}
        api.update_pod(running)
        after = seen(pod_annotation=pod_devices,
                     # the whole publish: the annotation, the labels, the condition
                     republish=lambda: ((t := node_topology()) and picked[0] not in t["available"]
                                        and len(api.node_status_patches) > status_patches))
        line["allocate_to_pod_annotation_s"] = after["pod_annotation"][0] - t_alloc
        line["allocate_to_republish_s"] = after["republish"][0] - t_alloc
        if after["pod_annotation"][1] != picked[0]:
            daemon_fail(f"the pod's {constants.POD_DEVICES_ANNOTATION} is "
                        f"{after['pod_annotation'][1]}, not {picked[0]}")
        writes_before_pod = writes()

        # The pod, with the response's env; CUDA_VISIBLE_DEVICES stands in
        # for what the NVIDIA container runtime makes of
        # NVIDIA_VISIBLE_DEVICES for a real pod.
        env = dict(os.environ, **cresp.envs)
        env["CUDA_VISIBLE_DEVICES"] = cresp.envs[constants.NVIDIA_VISIBLE_DEVICES]
        pod = subprocess.Popen([sys.executable, *POD_ARGS], cwd=ROOT, env=env, text=True,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        pod_lines: queue.Queue = queue.Queue()

        def read_pod() -> None:
            for raw in pod.stdout:
                pod_lines.put((time.monotonic(), raw))
            pod_lines.put(None)

        threading.Thread(target=read_pod, daemon=True).start()
        profile_probe = ProfileProbe(observer.base)
        report, footprint = None, None
        t_steps = None
        while (item := pod_lines.get(timeout=600)) is not None:
            t_line, raw = item
            if not raw.startswith("{"):
                continue
            snap = json.loads(raw)
            if "partial" in snap:
                line.setdefault("allocate_to_stage_s", {})[snap["partial"]] = t_line - t_alloc
            if snap.get("partial") == "first_step" and footprint is None:
                line["allocate_to_first_step_s"] = t_line - t_alloc
                # The timed steps start: each poll also reads nvidia-smi.
                t_steps = [t_line, None]
                observer.smi.set()
                profile_probe.start()
                # While the pod trains: the card's context holders (this
                # script and the pod, not the daemon) and what each maps.
                footprint = {"compute_apps": compute_apps(), "daemon": mapped(daemon.pid),
                             "pod": mapped(pod.pid)}
            elif "partial" not in snap:
                report = snap
                line["allocate_to_report_s"] = t_line - t_alloc
                if t_steps is not None:
                    t_steps[1] = t_line
                observer.smi.clear()
        rc = pod.wait(timeout=60)
        line["api_writes"] = {"before_pod": writes_before_pod,
                              "while_pod_trained": writes() - writes_before_pod}
        err = pod.stderr.read()
        pod.stderr.close()
        if rc != 0 or report is None:
            print(err[-4000:], file=sys.stderr, flush=True)
            fail(f"the pod exited {rc} with report {report}")
        n_layers = ModelConfig.bench().n_layers
        launches = report["kernel_launches"]
        line.update({
            "pod": {k: report.get(k) for k in (
                "ok", "device_kind", "expected_devices", "devices_match", "steps_run",
                "time_to_devices_s", "time_to_first_step_s", "step_time_s", "mfu",
                "first_loss", "kernel_launches")},
            "main_path_step_time_s": main_report.get("step_time_s"),
            "footprint": footprint,
        })
        if not (report["ok"] and report["expected_devices"] == 1 and report["devices_match"]):
            fail(f"the pod's report is not ok on the allocated card: {line['pod']}")
        want = {name: n_layers * report["steps_run"] for name in FLASH}
        want["rmsnorm"] = 0
        if launches != want:
            fail(f"the pod launched {launches}, expected {want}")
        if footprint is None:
            fail("the pod never reported its first step")
        grown = line["card_memory_used_mib"]["daemon_serving"] - used_before
        if (len(footprint["compute_apps"]) != 2 or footprint["daemon"]["libtorch"]
                or not footprint["pod"]["libtorch"] or grown > DAEMON_MEMORY_MIB):
            fail(f"the daemon may hold a CUDA context: {footprint}, card memory +{grown} MiB "
                 f"with it serving (2 context holders expected: this script and the pod)")
        if not lists.empty():
            fail(f"the daemon re-sent its device list while the pod ran: {lists.get()}")
        line["telemetry"] = pod_telemetry(observer, t_steps, picked[0], len(smi_uuids),
                                          daemon_fail)
        line["profile"] = profile_probe.check(t_steps, daemon_fail)

        # The pod is gone: the kubelet drops its entry, the API server its
        # object, and the card comes back.
        podres.drop("default", POD_NAME)
        status_patches = len(api.node_status_patches)
        t0 = time.monotonic()
        api.delete_pod("default", POD_NAME)
        back = seen(back=lambda: (t := node_topology()) and picked[0] in t["available"] and t,
                    # the publish ends with the condition: its labels are in by then
                    settled=lambda: len(api.node_status_patches) > status_patches)
        t_back, topo = back["back"]
        line["delete_to_republish_s"] = t_back - t0
        if sorted(topo["available"]) != sorted(smi_uuids):
            daemon_fail(f"after the pod's delete the annotation has available "
                        f"{topo['available']}")

        def scrape():
            status, body = http_get(f"{observer.base}/metrics")
            try:
                return parse_metrics(body.decode()) if status == 200 else []
            except ValueError as e:
                daemon_fail(str(e))

        # The card's series lose the pod's labels by the next sample plus
        # 1 s, and the free-card gauge counts the card again.
        unlabelled = seen(
            unlabelled=lambda: (m := scrape()) and card_series(m, picked[0]) and not any(
                "pod" in lab for lab, _ in card_series(m, picked[0]).values()),
            free=lambda: sample_value(scrape(), "tpu_node_free_chips") == len(smi_uuids))
        line["delete_to_unlabelled_s"] = unlabelled["unlabelled"][0] - t0
        line["delete_to_free_gauge_s"] = unlabelled["free"][0] - t0
        if line["delete_to_unlabelled_s"] > TELEMETRY_INTERVAL_S + 1.0:
            daemon_fail(f"the card's series kept the pod's labels "
                        f"{line['delete_to_unlabelled_s']:.3f} s after its delete")

        # The kubelet asks again for the pod's card, as on a container
        # restart: the windowed Allocate p99 crosses --capture-p99-ms once.
        for _ in range(REPEAT_ALLOCATES):
            t0 = time.monotonic()
            stub.Allocate(areq, timeout=PLUGIN_WAIT_S)
            allocate_ms.append((time.monotonic() - t0) * 1e3)
        line["allocate_ms_median"] = statistics.median(allocate_ms)
        # The slowest is the Allocate whose crossing wrote the bundle.
        line["allocate_ms_max"] = max(allocate_ms)
        line["allocates"] = len(allocate_ms)
        line["capture"] = capture_bundle(capture_dir, daemon_fail)
        status, body = http_get(observer.base + "/debug/lockdep")
        lockdep = json.loads(body) if status == 200 else {}
        if lockdep.get("enabled") is not True or lockdep.get("cycles") != []:
            daemon_fail(f"/debug/lockdep answered {status}: {body[:400]!r}")
        line["lockdep"] = {"edges": len(lockdep["edges"]),
                           "dropped_edges": lockdep["dropped_edges"]}

        # SIGHUP: the new generation registers, then publishes the node's
        # annotation anew. Only a node patch that carries the annotation
        # and landed after the registration counts.
        published = len(api.node_patches)
        t0 = time.monotonic()
        daemon.send_signal(signal.SIGHUP)
        t_reg, req, patches_at_reg = kubelet.next_registration()
        line["sighup_to_register_s"] = t_reg - t0

        def annotation_patch_from(start: int):
            """The first node patch from index ``start`` on that writes
            the topology annotation, as a 1-tuple, or None."""
            for i, (_, body) in enumerate(api.node_patches[start:], start):
                if constants.TOPOLOGY_ANNOTATION in (
                        (body.get("metadata") or {}).get("annotations") or {}):
                    return (i,)
            return None

        t_pub, _ = seen(republish=lambda: annotation_patch_from(patches_at_reg))["republish"]
        line["sighup_to_republish_s"] = t_pub - t0
        line["sighup_node_patches_before_register"] = patches_at_reg - published
        line["observability"] = observability(observer, t_start, len(smi_uuids), daemon_fail)
        status, body = http_get(observer.base + "/debug/blackbox")
        bb_live = json.loads(body) if status == 200 else {}
        t0 = time.monotonic()
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=PLUGIN_WAIT_S)
        line["sigterm_to_exit_s"] = time.monotonic() - t0
        line["evidence"] = evidence(observer, bb_live, flight_dir, blackbox_dir, daemon_fail)
        socket_left = (work / constants.PLUGIN_SOCKET_NAME).exists()
        draining = "still draining" in log_path.read_text()
        line["daemon_rc"] = rc
        line["api_writes"]["total"] = writes()
        emit({"plugin_pod": line})
        if rc != 0 or socket_left or draining:
            daemon_fail(f"SIGTERM: the daemon exited {rc}, its socket left: {socket_left}, "
                        f"controller threads left draining: {draining}")
    finally:
        observer.stop()
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        if channel is not None:
            channel.close()
        kubelet.server.stop(grace=0)
        podres.server.stop(grace=0)
        api.stop()
        shutil.rmtree(work, ignore_errors=True)
    return launches


DRA_POD_ARGS = ("-m", "k8s_device_plugin_tpu_torch.workload.smoke", "--bench", "--steps", "5")
DRA_DRIVER = "gpu.nvidia.com"
DRA_NODE = "dra-node"
DRA_CLAIM_UID = "dra-claim-uid"
# The slice's memory capacity against nvidia-smi's memory.total (MiB).
DRA_HBM_RTOL = 0.01


def phase_dra_pod(main_report: dict) -> dict:
    """A ResourceClaim's pod: the DRA plane stages this card through a CDI
    spec, the classic plane refuses the card while the claim holds it, and
    the pod trains on the card the claim names."""
    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_device_plugin_tpu_torch.api import dra_pb2 as drapb
    from k8s_device_plugin_tpu_torch.api import pluginregistration_pb2 as regpb
    from k8s_device_plugin_tpu_torch.api.grpc_defs import (
        DRA_PLUGIN_SERVICE_V1, DRA_PLUGIN_SERVICES, DevicePluginStub, DraPluginStub,
        WatcherRegistrationStub)
    from k8s_device_plugin_tpu_torch.utils.blackbox import read_dir
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
    from tests.fake_apiserver import FakeApiServer

    torch.cuda.empty_cache()
    smi = {}
    for row in subprocess.run(
            ["nvidia-smi", "--query-gpu=index,uuid,memory.total", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines():
        index, uuid, mib = (v.strip() for v in row.split(","))
        smi[uuid] = (int(index), int(mib))
    uuid = f"GPU-{torch.cuda.get_device_properties(torch.cuda.current_device()).uuid}"
    if uuid not in smi:
        fail(f"the run's card {uuid} is not among nvidia-smi's {sorted(smi)}")
    device = f"gpu-{smi[uuid][0]}"
    # Every socket under one short dir: a unix socket path holds 107 bytes.
    work = Path(tempfile.mkdtemp(prefix="dra", dir="/tmp"))
    dp_dir, plugins, registry, cdi_dir = (work / n for n in ("dp", "plugins", "registry", "cdi"))
    dp_dir.mkdir()
    flight_dir, blackbox_dir, capture_dir = work / "flight", work / "blackbox", work / "captures"
    api = FakeApiServer()
    kubelet = Kubelet(str(dp_dir))
    api_url = api.start()
    api.add_node(DRA_NODE)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke"}}],
    }))
    slice_name = re.sub(r"[^a-z0-9.-]", "-", f"{DRA_NODE}-{DRA_DRIVER}")
    log_path = work / "daemon.log"
    line: dict = {"nvidia_smi": nvidia_smi(), "card": uuid, "device": device}
    channels = []
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log_file:
        t_start = time.monotonic()
        daemon = subprocess.Popen([sys.executable, "-m", "k8s_device_plugin_tpu_torch", "--dra",
                                   "--device-plugin-dir", str(dp_dir), "--node-name", DRA_NODE,
                                   "--kubeconfig", str(kubeconfig), "--podresources-socket", "",
                                   "--plugins-dir", str(plugins),
                                   "--plugins-registry-dir", str(registry),
                                   "--cdi-dir", str(cdi_dir), "--metrics-port", str(port),
                                   "--profile-hz", str(PROFILE_HZ), "--lockdep",
                                   "--flight-dir", str(flight_dir),
                                   "--blackbox-dir", str(blackbox_dir),
                                   "--blackbox-fsync-s", str(BLACKBOX_FSYNC_S),
                                   "--capture-dir", str(capture_dir),
                                   "--capture-p99-ms", str(CAPTURE_P99_MS)],
                                  cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        def daemon_fail(msg: str) -> None:
            print(log_path.read_text()[-4000:], file=sys.stderr, flush=True)
            fail(msg)

        def until(pred, what: str):
            """Poll ``pred`` every 2 ms until it gives a value: (time, value)."""
            deadline = time.monotonic() + PLUGIN_WAIT_S
            while not (value := pred()):
                if time.monotonic() > deadline:
                    daemon_fail(f"not seen within {PLUGIN_WAIT_S} s: {what}")
                time.sleep(0.002)
            return time.monotonic(), value

        def channel(path: Path):
            ch = grpc.insecure_channel(f"unix:{path}")
            channels.append(ch)
            grpc.channel_ready_future(ch).result(timeout=PLUGIN_WAIT_S)
            return ch

        def metric(name: str, **labels):
            status, body = http_get(base + "/metrics")
            return sample_value(parse_metrics(body.decode()), name, **labels) if status == 200 \
                else None

        # 1. The classic plane registers with the kubelet; the DRA plane
        # is dialled by a stand-in plugin watcher on its registry socket.
        t_reg, req, _ = kubelet.next_registration()
        line["start_to_register_s"] = t_reg - t_start
        reg_sock = registry / f"{DRA_DRIVER}-reg.sock"
        dra_sock = plugins / DRA_DRIVER / "dra.sock"
        until(reg_sock.exists, str(reg_sock))
        watcher = WatcherRegistrationStub(channel(reg_sock))
        info = watcher.GetInfo(regpb.InfoRequest(), timeout=PLUGIN_WAIT_S)
        if (info.type, info.name, info.endpoint, list(info.supported_versions)) != (
                "DRAPlugin", DRA_DRIVER, str(dra_sock), list(DRA_PLUGIN_SERVICES)):
            daemon_fail(f"the registry socket's PluginInfo: {info}")
        watcher.NotifyRegistrationStatus(regpb.RegistrationStatus(plugin_registered=True),
                                         timeout=PLUGIN_WAIT_S)
        classic = DevicePluginStub(channel(dp_dir / req.endpoint))

        # 2. The node's ResourceSlice: every card nvidia-smi lists.
        t_slice, obj = until(lambda: api.resourceslices.get(slice_name), "the ResourceSlice")
        line["start_to_slice_s"] = t_slice - t_start
        devices = {d["name"]: d for d in obj["spec"]["devices"]}
        published = {d["attributes"]["chipId"]["string"]: (
            name, int(d["capacity"]["hbm"]["value"])) for name, d in devices.items()}
        line["slice"] = {"api_version": obj["apiVersion"], "devices": sorted(devices),
                         "generation": obj["spec"]["pool"]["generation"]}
        if sorted(published) != sorted(smi) or any(
                published[u][0] != f"gpu-{i}"
                or abs(published[u][1] / 2 ** 20 - mib) > DRA_HBM_RTOL * mib
                for u, (i, mib) in smi.items()):
            daemon_fail(f"the slice's devices {published}; nvidia-smi: {smi}")

        # 3. The scheduler's allocation of this card to a claim, and the
        # kubelet's prepare (on the GA method path).
        api.add_resource_claim({
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": "smoke-claim", "namespace": "default", "uid": DRA_CLAIM_UID},
            "status": {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": DRA_DRIVER, "pool": DRA_NODE, "device": device}]}}},
        })
        dra = DraPluginStub(channel(dra_sock), service=DRA_PLUGIN_SERVICE_V1)
        preq = drapb.NodePrepareResourcesRequest()
        preq.claims.add(namespace="default", name="smoke-claim", uid=DRA_CLAIM_UID)
        t_prepare = time.monotonic()
        result = dra.NodePrepareResources(preq, timeout=PLUGIN_WAIT_S).claims[DRA_CLAIM_UID]
        line["prepare_ms"] = (time.monotonic() - t_prepare) * 1e3
        cdi_id = f"nvidia.com/gpu=claim-{DRA_CLAIM_UID}"
        if result.error or [(d.device_name, list(d.cdi_device_ids)) for d in result.devices] != [
                (device, [cdi_id])]:
            daemon_fail(f"NodePrepareResources answered {result}")

        # 4. The claim's CDI spec names this card; the classic plane refuses it.
        spec_path = cdi_dir / f"nvidia.com-gpu-claim-{DRA_CLAIM_UID}.json"
        spec = json.loads(spec_path.read_text())
        (cdi_dev,) = spec["devices"]
        edits = cdi_dev["containerEdits"]
        env = dict(e.split("=", 1) for e in edits["env"])
        nodes = [n["hostPath"] for n in edits["deviceNodes"]]
        line["cdi"] = {"kind": spec["kind"], "device": cdi_dev["name"], "device_nodes": nodes,
                       "env": env}
        if (spec["kind"] != "nvidia.com/gpu" or cdi_dev["name"] != f"claim-{DRA_CLAIM_UID}"
                or not nodes or not all(os.path.exists(n) for n in nodes)
                or env != {constants.NVIDIA_VISIBLE_DEVICES: uuid,
                           "TPU_PLUGIN_ALLOCATED_CHIPS": "1"}):
            daemon_fail(f"the claim's CDI spec {spec}")
        pref = pb.PreferredAllocationRequest()
        pref.container_requests.add(available_deviceIDs=[uuid], allocation_size=1)
        offered = list(classic.GetPreferredAllocation(pref, timeout=PLUGIN_WAIT_S)
                       .container_responses[0].deviceIDs)
        areq = pb.AllocateRequest()
        areq.container_requests.add(devicesIDs=[uuid])
        try:
            classic.Allocate(areq, timeout=PLUGIN_WAIT_S)
            code = grpc.StatusCode.OK
        except grpc.RpcError as e:
            code = e.code()
        line["classic_while_prepared"] = {"preferred": offered, "allocate": code.name}
        if offered or code != grpc.StatusCode.RESOURCE_EXHAUSTED:
            daemon_fail(f"the classic plane offered {offered} and answered {code} for the "
                        f"claim's card")
        if metric("tpu_plugin_dra_prepared_claims") != 1:
            daemon_fail("tpu_plugin_dra_prepared_claims does not read 1 with the claim prepared")

        # 5. The pod, with the spec's env; CUDA_VISIBLE_DEVICES stands in
        # for what the NVIDIA container runtime makes of
        # NVIDIA_VISIBLE_DEVICES.
        pod_env = dict(os.environ, **env)
        pod_env["CUDA_VISIBLE_DEVICES"] = env[constants.NVIDIA_VISIBLE_DEVICES]
        pod = subprocess.Popen([sys.executable, *DRA_POD_ARGS], cwd=ROOT, env=pod_env,
                               text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        report = None
        for raw in pod.stdout:  # stderr is read after it exits, as in phase 16
            if not raw.startswith("{"):
                continue
            snap = json.loads(raw)
            if "partial" in snap:
                line.setdefault("prepare_to_stage_s", {}).setdefault(
                    snap["partial"], time.monotonic() - t_prepare)
            else:
                report = snap
                line["prepare_to_report_s"] = time.monotonic() - t_prepare
        rc = pod.wait(timeout=60)
        err = pod.stderr.read()
        pod.stderr.close()
        if rc != 0 or report is None:
            print(err[-4000:], file=sys.stderr, flush=True)
            fail(f"the claim's pod exited {rc} with report {report}")
        n_layers = ModelConfig.bench().n_layers
        launches = report["kernel_launches"]
        line["pod"] = {k: report.get(k) for k in (
            "ok", "device_kind", "device_uuid", "expected_devices", "devices_match", "steps_run",
            "time_to_devices_s", "time_to_first_step_s", "step_time_s", "mfu", "first_loss",
            "kernel_launches")}
        line["main_path_step_time_s"] = main_report.get("step_time_s")
        if not (report["ok"] and report["expected_devices"] == 1 and report["devices_match"]):
            fail(f"the claim's pod is not ok: {line['pod']}")
        if report.get("device_uuid") != uuid:
            fail(f"the claim's pod ran on {report.get('device_uuid')}, not the claim's {uuid}")
        want = {name: n_layers * report["steps_run"] for name in FLASH}
        want["rmsnorm"] = 0
        if launches != want:
            fail(f"the claim's pod launched {launches}, expected {want}")

        # 6. Unprepare: the spec goes, the gauge reads 0, the classic plane
        # hands the card out again.
        ureq = drapb.NodeUnprepareResourcesRequest()
        ureq.claims.add(namespace="default", name="smoke-claim", uid=DRA_CLAIM_UID)
        t0 = time.monotonic()
        uresult = dra.NodeUnprepareResources(ureq, timeout=PLUGIN_WAIT_S).claims[DRA_CLAIM_UID]
        line["unprepare_ms"] = (time.monotonic() - t0) * 1e3
        if uresult.error or spec_path.exists():
            daemon_fail(f"NodeUnprepareResources answered {uresult}; spec left: "
                        f"{spec_path.exists()}")
        if metric("tpu_plugin_dra_prepared_claims") != 0:
            daemon_fail("tpu_plugin_dra_prepared_claims does not read 0 after the unprepare")
        cresp = classic.Allocate(areq, timeout=PLUGIN_WAIT_S).container_responses[0]
        if cresp.envs.get(constants.NVIDIA_VISIBLE_DEVICES) != uuid:
            daemon_fail(f"the classic Allocate after the unprepare: {dict(cresp.envs)}")
        # The stall watchdog exports every loop's heartbeat age on its tick.
        _, (line["publisher_heartbeat_age_s"],) = until(
            lambda: (age := metric("tpu_thread_heartbeat_age_seconds",
                                   loop="dra_slice_publisher")) is not None and (age,),
            "dra_slice_publisher's heartbeat age on /metrics")

        # 7. SIGTERM: exit 0; the black box ends in stop and holds the
        # publisher's heartbeat.
        t0 = time.monotonic()
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=PLUGIN_WAIT_S)
        line["sigterm_to_exit_s"] = time.monotonic() - t0
        line["daemon_rc"] = rc
        records, meta = read_dir(str(blackbox_dir))
        beats = {b["name"] for r in records if r["kind"] == "heartbeats"
                 for b in r["data"]["beats"]}
        line["blackbox"] = {"records": len(records), "segments": len(meta["segments"]),
                            "heartbeat_loops": sorted(beats)}
        emit({"dra_pod": line})
        if rc != 0 or dra_sock.exists() or reg_sock.exists():
            daemon_fail(f"SIGTERM: the daemon exited {rc}; DRA sockets left: "
                        f"{dra_sock.exists()}, {reg_sock.exists()}")
        if ({seg["status"] for seg in meta["segments"]} != {"clean"} or not records
                or records[-1]["kind"] != "stop" or "dra_slice_publisher" not in beats):
            daemon_fail(f"the black box: segments {meta['segments']}, heartbeat loops "
                        f"{sorted(beats)}, last record {records[-1:] and records[-1]['kind']}")
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        for ch in channels:
            ch.close()
        kubelet.server.stop(grace=0)
        api.stop()
        shutil.rmtree(work, ignore_errors=True)
    return launches


# Phase 18: the extender's candidates at scale, the calls timed per verb
# and mode, the poll of the Allocate and free times, and the bound on them.
EXT_NODES = 1000
EXT_CALLS = 50
EXT_OBJECT_CALLS_AT_SCALE = 20
EXT_POLL_S = 0.01
EXT_SETTLE_S = 10.0
EXT_SEED = 18
EXT_NODE = "ext-node"


def hgx_annotation(name: str, index: int, available_idx) -> str:
    """A synthetic 8-card HGX node's nvidia.com/gpu-topology: every pair NV18
    through NVSwitches (score 9), the layout NVML reads on an HGX H100 board."""
    from k8s_device_plugin_tpu_torch.topology.links import score_for
    from k8s_device_plugin_tpu_torch.topology.schema import (
        SCHEMA_VERSION, CardInfo, NodeTopology, PairInfo)

    cards = [CardInfo(id=f"GPU-{index:08x}-0000-4000-8000-{i:012x}",
                      index=i, minor=i, dev_path=f"/dev/nvidia{i}", pci_addr="",
                      numa_node=i // 4, hbm_bytes=81559 * 2 ** 20,
                      name="NVIDIA H100 80GB HBM3") for i in range(8)]
    return NodeTopology(
        version=SCHEMA_VERSION, hostname=name, chip_type="H100",
        product="NVIDIA H100 80GB HBM3", chip_count=8, numa_nodes=2, chips=cards,
        pairs=[PairInfo(a=a.id, b=b.id, link="NV18", score=score_for(18, None))
               for i, a in enumerate(cards) for b in cards[i + 1:]],
        available=sorted(cards[i].id for i in available_idx)).to_json()


def phase_extender() -> None:
    """The scheduler extender filters and scores pods onto this card's node
    from the annotation a daemon over the real NVML publishes, follows the
    card taken and freed through its node watch, and answers over 1,000
    nodes."""
    import random

    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_device_plugin_tpu_torch.api.grpc_defs import DevicePluginStub
    from tests.fake_apiserver import FakeApiServer

    work = Path(tempfile.mkdtemp(prefix="ext", dir="/tmp"))
    dp_dir = work / "dp"
    dp_dir.mkdir()
    api = FakeApiServer()
    kubelet = Kubelet(str(dp_dir))
    podres = PodResources(str(work / "pod-resources" / "kubelet.sock"))
    api_url = api.start()
    api.add_node(EXT_NODE)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke"}}],
    }))
    daemon_log, ext_log = work / "daemon.log", work / "extender.log"
    line: dict = {"nvidia_smi": nvidia_smi()}
    channel = None
    extender = None
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    with open(daemon_log, "w") as log_file:
        daemon = subprocess.Popen([sys.executable, "-m", "k8s_device_plugin_tpu_torch",
                                   "--device-plugin-dir", str(dp_dir), "--node-name", EXT_NODE,
                                   "--kubeconfig", str(kubeconfig),
                                   "--podresources-socket", podres.socket_path,
                                   "--metrics-port", "0"],
                                  cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        def ext_fail(msg: str) -> None:
            for path in (daemon_log, ext_log):
                if path.exists():
                    print(f"{path.name}:", path.read_text()[-3000:], file=sys.stderr, flush=True)
            fail(msg)

        def until(pred, what: str, bound_s: float = PLUGIN_WAIT_S, every_s: float = 0.002):
            """Poll ``pred`` until it gives a value: (time, value)."""
            deadline = time.monotonic() + bound_s
            while not (value := pred()):
                if time.monotonic() > deadline:
                    ext_fail(f"not seen within {bound_s} s: {what}")
                time.sleep(every_s)
            return time.monotonic(), value

        def post(path: str, body: dict) -> dict:
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        sent = {"filter": 0, "prioritize": 0}

        def call(verb: str, body: dict) -> tuple[float, dict]:
            t0 = time.perf_counter()
            out = post("/" + verb, body)
            sent[verb] += 1
            return (time.perf_counter() - t0) * 1e3, out

        def timed(verb: str, body: dict, n: int) -> tuple[dict, dict]:
            """The median and p99 (ms) of n calls, and the last answer."""
            ms = []
            for _ in range(n):
                t, out = call(verb, body)
                ms.append(t)
            ms.sort()
            return {"median_ms": statistics.median(ms),
                    "p99_ms": ms[min(len(ms) - 1, math.ceil(0.99 * len(ms)) - 1)],
                    "calls": n}, out

        def gpu_pod(n: int, name: str = "ext-pod") -> dict:
            return {"metadata": {"name": name, "namespace": "default", "uid": f"{name}-uid"},
                    "spec": {"containers": [{"name": "main", "resources": {
                        "requests": {constants.RESOURCE_NAME: str(n)}}}]}}

        def annotation():
            return api.nodes[EXT_NODE]["metadata"].get("annotations", {}).get(
                constants.TOPOLOGY_ANNOTATION)

        def scrape() -> list:
            status, body = http_get(base + "/metrics")
            if status != 200:
                ext_fail(f"/metrics answered {status}")
            try:
                return parse_metrics(body.decode())
            except ValueError as e:
                ext_fail(str(e))

        # 1. The daemon publishes the card's annotation.
        _, req, _ = kubelet.next_registration()
        _, raw = until(annotation, "the node's nvidia.com/gpu-topology annotation")
        topo = json.loads(raw)
        count = topo["chip_count"]
        line["node"] = {"cards": count, "available": len(topo["available"]),
                        "product": topo["product"]}
        if count < 1 or len(topo["available"]) != count:
            ext_fail(f"the node's annotation before any allocation: {topo}")

        # 2. The extender, timed from its start to /readyz 200.
        with open(ext_log, "w") as log_file:
            t_start = time.monotonic()
            extender = subprocess.Popen(
                [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--node-cache",
                 "--kubeconfig", str(kubeconfig), "--host", "127.0.0.1", "--port", str(port)],
                cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
        t_ready, _ = until(lambda: http_get(base + "/readyz")[0] == 200, "/readyz 200")
        line["start_to_readyz_s"] = t_ready - t_start

        # 3 and 4. One node, object and name-only mode.
        node_obj = json.loads(json.dumps(api.nodes[EXT_NODE]))
        one, over = gpu_pod(1), gpu_pod(count + 1, "ext-over")
        modes = {"object": {"nodes": {"items": [node_obj]}}, "names": {"nodenames": [EXT_NODE]}}
        answers = {}
        for mode, cands in modes.items():
            f = call("filter", {"pod": one, **cands})[1]
            passed = [n["metadata"]["name"] for n in (f["nodes"] or {}).get("items", [])] \
                if mode == "object" else f["nodenames"]
            scores = call("prioritize", {"pod": one, **cands})[1]
            rej = call("filter", {"pod": over, **cands})[1]
            answers[mode] = (passed, f["failedNodes"], scores, rej["failedNodes"])
        passed, failed, scores, rejected = answers["object"]
        want_score = 2 if count == 1 else 0
        want_word = "no multi-node NVLink domain" if count == 1 else "not a multiple"
        line["one_node"] = {"passed": passed, "scores": scores, "rejected": rejected}
        if passed != [EXT_NODE] or failed or scores != [{"host": EXT_NODE,
                                                          "score": want_score}]:
            ext_fail(f"a 1-card pod on the card's node: passed {passed}, failed {failed}, "
                     f"scores {scores} (score {want_score} expected)")
        if want_word not in rejected.get(EXT_NODE, ""):
            ext_fail(f"a {count + 1}-card pod on the node: {rejected}")
        if answers["names"] != answers["object"]:
            ext_fail(f"name-only mode answered {answers['names']}, object mode "
                     f"{answers['object']}")
        line["one_node_ms"] = {}
        for mode, cands in modes.items():
            for verb in ("filter", "prioritize"):
                line["one_node_ms"][f"{mode}_{verb}"] = timed(verb, {"pod": one, **cands},
                                                              EXT_CALLS)[0]

        # 5. Allocate of one card, then the pod's delete: the extender
        # follows both through its node watch, which its relist loop opens
        # after its first interval.
        until(lambda: any(m == "GET" and p.startswith("/api/v1/nodes?") and "watch=true" in p
                          for m, p in list(api.requests)), "the extender's node watch")
        channel = grpc.insecure_channel(f"unix:{dp_dir / req.endpoint}")
        stub = DevicePluginStub(channel)
        all_cards = gpu_pod(count, "ext-all")
        names = {"nodenames": [EXT_NODE]}
        areq = pb.AllocateRequest()
        areq.container_requests.add(devicesIDs=[topo["available"][0]])
        stub.Allocate(areq, timeout=PLUGIN_WAIT_S)
        t_alloc = time.monotonic()
        api.add_pod({
            "metadata": {"name": POD_NAME, "namespace": "default", "uid": "ext-pod-uid",
                         "annotations": {}},
            "spec": {"nodeName": EXT_NODE, "containers": [{"name": "main", "resources": {
                "requests": {constants.RESOURCE_NAME: "1"}}}]},
            "status": {"phase": "Running"},
        })
        podres.set("default", POD_NAME, [topo["available"][0]])
        want = f"{count - 1} chips available, {count} needed"
        t_rej, _ = until(lambda: call("filter", {"pod": all_cards, **names})[1][
            "failedNodes"].get(EXT_NODE) == want, f"/filter rejecting with '{want}'",
            EXT_SETTLE_S, EXT_POLL_S)
        line["allocate_to_reject_s"] = t_rej - t_alloc
        podres.drop("default", POD_NAME)
        t_free = time.monotonic()
        api.delete_pod("default", POD_NAME)
        t_pass, _ = until(lambda: call("filter", {"pod": all_cards, **names})[1][
            "nodenames"] == [EXT_NODE], "/filter passing the node again", EXT_SETTLE_S,
            EXT_POLL_S)
        line["free_to_pass_s"] = t_pass - t_free

        # 6. 999 synthetic HGX nodes join: the index holds 1,000 nodes.
        rng = random.Random(EXT_SEED)
        synthetic = [f"hgx-{i:03d}" for i in range(EXT_NODES - 1)]
        t_add = time.monotonic()
        for i, name in enumerate(synthetic):
            free = sorted(rng.sample(range(8), rng.randint(0, 8)))
            api.add_node(name, {"metadata": {"name": name, "labels": {}, "annotations": {
                constants.TOPOLOGY_ANNOTATION: hgx_annotation(name, i, free)}}})

        def indexed():
            status, body = http_get(base + "/debug/telemetry")
            cluster = (json.loads(body).get("cluster") or {}) if status == 200 else {}
            return cluster.get("nodes_with_topology") == EXT_NODES and cluster
        t_idx, cluster = until(indexed, f"the index holding {EXT_NODES} nodes", 300, 0.1)
        line["join_to_indexed_s"] = t_idx - t_add
        line["placeable_nodes"] = cluster["placeable_nodes"]
        every = [EXT_NODE] + synthetic
        objects = {"nodes": {"items": [json.loads(json.dumps(api.nodes[n])) for n in every]}}

        def avoided() -> float:
            return sample_value(scrape(), "tpu_extender_parse_avoided_total",
                                reason="indexed_rpc") or 0.0

        line["scale_ms"] = {}
        for n in (1, 4):
            p = gpu_pod(n, f"ext-scale-{n}")
            # First calls (the score memo's misses), then the timed ones.
            first = {}
            for verb in ("filter", "prioritize"):
                first[verb] = call(verb, {"pod": p, "nodenames": every})
            before = avoided()
            f_stats, f_names = timed("filter", {"pod": p, "nodenames": every}, EXT_CALLS)
            p_stats, p_names = timed("prioritize", {"pod": p, "nodenames": every}, EXT_CALLS)
            grown = avoided() - before
            if grown < 2 * EXT_CALLS * EXT_NODES:
                ext_fail(f"indexed_rpc grew {grown} over {2 * EXT_CALLS} name-only calls of "
                         f"{EXT_NODES} candidates")
            fo_stats, f_obj = timed("filter", {"pod": p, **objects}, EXT_OBJECT_CALLS_AT_SCALE)
            po_stats, p_obj = timed("prioritize", {"pod": p, **objects},
                                    EXT_OBJECT_CALLS_AT_SCALE)
            obj_passed = [x["metadata"]["name"] for x in f_obj["nodes"]["items"]]
            if (f_names["nodenames"], f_names["failedNodes"]) != (obj_passed,
                                                                   f_obj["failedNodes"]) \
                    or p_names != p_obj:
                ext_fail(f"at {EXT_NODES} nodes the name-only and object answers differ for "
                         f"a {n}-card pod")
            line["scale_ms"][f"{n}_card"] = {
                "first_filter_ms": first["filter"][0], "first_prioritize_ms": first["prioritize"][0],
                "names_filter": f_stats, "names_prioritize": p_stats,
                "object_filter": fo_stats, "object_prioritize": po_stats,
                "passed": len(f_names["nodenames"]),
                "top_score": max(s["score"] for s in p_names)}

        # 7. /metrics counts every request (the handler counts one after it
        # has answered it); SIGTERM ends both with code 0.
        want_counts = {verb: float(n) for verb, n in sent.items()}

        def counted():
            samples = scrape()
            got = {verb: sample_value(samples, "tpu_extender_requests_total", verb=verb,
                                      outcome="ok") for verb in sent}
            line["requests"] = {"sent": dict(sent), "counted": got}
            return got == want_counts

        until(counted, f"tpu_extender_requests_total counting {dict(sent)}", 5.0, 0.01)
        t0 = time.monotonic()
        extender.send_signal(signal.SIGTERM)
        ext_rc = extender.wait(timeout=PLUGIN_WAIT_S)
        line["extender_sigterm_to_exit_s"] = time.monotonic() - t0
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=PLUGIN_WAIT_S)
        line["rc"] = {"extender": ext_rc, "daemon": rc}
        emit({"extender": line})
        if ext_rc != 0 or rc != 0:
            ext_fail(f"SIGTERM: the extender exited {ext_rc}, the daemon {rc}")
    finally:
        for proc in (extender, daemon):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        if channel is not None:
            channel.close()
        kubelet.server.stop(grace=0)
        podres.server.stop(grace=0)
        api.stop()
        shutil.rmtree(work, ignore_errors=True)


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
    pod_launches = phase_plugin_pod(main_report)
    dra_launches = phase_dra_pod(main_report)
    phase_extender()
    dist.destroy_process_group()
    path_launches = {name: (launches[name], steps) for name in FLASH}
    path_launches["rmsnorm"] = (norm_launches["rmsnorm"], norm_steps)
    by_path = {"bench": launches, "norm": norm_launches, "multi_step": multi_launches,
               "generate_dense": dense_gen, "generate_flash": flash_gen,
               "sharded": sharded_launches, "moe": moe_launches, "ring": ring_launches,
               "resume": resume_launches, "kv_sweep": sweep_launches,
               "plugin_pod": pod_launches, "dra_pod": dra_launches}
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
