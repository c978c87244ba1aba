"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's exception is
caught while the run goes on:

1. Device: the card's name, and its name and power limit from nvidia-smi.
   Then the port's lint over this checkout, each run in its own process
   and on its own line with its wall time: ``python -m
   k8s_device_plugin_tpu_torch.tools.lint --self-test`` must exit 0 with
   every rule proven, and ``--json`` must exit 0 with nothing new and no
   stale baseline entry.
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
   (300, 2048), bf16 x; rrms within relative 1e-5. The LM head's GEMM
   (``ops/head.py``, 3xTF32) in its three layouts (logits X E^T, dX = G E,
   dE = G^T X) at the two full-logits cells' (rows, d, vocab): the bench
   model's (16384, 2048, 32768) and gpt2-xl's (8192, 1600, 50257), whose G
   rows are not 16-byte aligned. The kernel and its plain version (the same
   three TF32 passes as PyTorch products) are each held to an f64 product
   of the same inputs: RMS error at most 2x, largest at most 4x, those of
   ``torch.matmul`` in f32 with TF32 off. One JSON line per kernel
   and shape: errors, tolerance, and at the full shapes (the head's at the
   bench model's) kernel, plain and library times (CUDA events, median)
   beside the bound.
4. Model: the flash and the dense attention paths of a small model on the
   card agree on the same weights and tokens.
5. Main path: ``run_smoke`` at ``ModelConfig.bench()`` (10 timed AdamW
   steps, batch 8), with every launch count set to 0 just before and read
   just after; each flash kernel must have launched ``n_layers`` times a
   step, the head's GEMM 3 (the logits, dX, dE), and the RMSNorm kernel
   (off in this config) not at all. Like every ``run_smoke`` below,
   it brings up (the first time) a one-rank NCCL process group and trains
   through a size-1 six-axis mesh, which leaves the model unsharded.
6. Norm path: the same at ``ModelConfig.bench()`` with
   ``use_pallas_norm=True``: the RMSNorm kernel must launch 9 times per
   step (two norms per block and the final one), each flash kernel 4 and
   the head's GEMM 3.
   Its step time, tokens/s and MFU are printed beside phase 5's.
7. Multi-step path: ``run_smoke`` at ``ModelConfig.bench()`` as the JAX
   bench leg drives it, cut to 24 steps (batch 4, ``inner_steps`` 8, so
   each call replays a CUDA graph of the step, and the chunked-CE A/B at
   chunk 4096 on a second graph), counts set to 0 just before and read
   just after. It must report ok with ``ab.vs_plain_step`` and no
   ``ab.error``, and each flash kernel must have launched ``n_layers``
   times per step actually run (main and A/B, replays included), the LM
   head's GEMM (``ops/head.py``) three times per full-logits step and none
   in the A/B's chunked steps. Then,
   from one seed and one stack, 8 graphed steps against 8 eager steps:
   every loss within 1e-6 relative. Its line
   carries the gaps, the capture times, the peak device memory, and the
   eager step's time at the same batch (a single-step ``run_smoke`` just
   before, outside the counted window).
8. Generation: ``run_generation_smoke`` at ``ModelConfig.bench()`` widths,
   batch 8, prompt 256, 32 new tokens, counts set to 0 around each call:
   (a) dense attention, whose KV decoder must be ok (prefill logits within
   0.1 of the full forward's) with no flash launch, and the head's GEMM
   once a full forward (its 16384 and 2048 rows reach ``ops/head.py``'s
   ``MIN_ROWS``; the KV decoder's 8 do not); (b) flash attention
   with ``use_pallas_norm``, forward only: ``flash_fwd`` exactly
   ``n_layers`` x 32 launches, ``rmsnorm`` (2 ``n_layers`` + 1) x 32, the
   head's GEMM 32, no backward kernel, the prompt preserved. Tokens/s of each decoder.
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
   kernel and delta launched exactly ``n_layers`` x 6 times and the head's
   GEMM 3 x 6 (FSDP2 hands the loss whole parameters), with counts set
   to 0 just before and read just after. Its line carries both step times,
   the peak device memory and the group's bring-up.

11. Parallel paths on one card, through a size-1 mesh, at bench widths:
   (a) MoE: ``run_smoke`` at ``ModelConfig.bench()`` with ``n_experts=4``
   (top-2, capacity factor 2.0), batch 8, 6 timed steps after 1, counts
   set to 0 just before and read just after: ok (first loss sane, loss
   falling, finite), each flash kernel and delta launched exactly
   ``n_layers`` x 7 times, the head's GEMM 3 x 7, the RMSNorm kernel not
   at all; one line with
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
   and no kernel launched but the head's GEMM, once for each logits
   forward and three times a train step (counts set to 0 before the ring's
   op check and read after its last step). The second losses' gap is reported, not
   held: the chunked backward sums dK/dV in another order, and Adam's
   first update magnifies that rounding (1.3e-5 on an NVIDIA H100 80GB
   HBM3 at 700 W).
12. Resume: the resumable loop (``workload/loop.run_training``) at
   ``ModelConfig.bench()``, batch 8, on one card: 6 steps without a
   checkpoint; then 3 steps saving into a temporary directory
   (``save_every`` 100, so steps 0 and 2 are saved), then 6 steps on the
   same directory, which must resume at step 3. The stitched losses must
   equal the uninterrupted ones within 1e-6 relative, and each flash kernel
   and delta must launch ``n_layers`` times per resumed step and the head's
   GEMM 3 (counts set
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
   each seq's winner beside the default (4, 2) row (no RMSNorm or head
   launch); the report ok, both
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
   no finding and runs ``lock_order`` and ``loop_inventory``, so a loop
   named where the lint's scanner cannot see it fails the phase) and
   ``tpu_audit_last_clean_sweep_timestamp`` must have advanced; no loop may
   have counted a stall and the black box no drop. After SIGTERM the flight
   dir must hold the ``shutdown`` dump, and the black box's segments must
   all read clean through the port's ``utils/blackbox.read_dir``, the
   newest ending in ``stop``, holding the ``Allocate`` flight events, the
   allocate decisions, ``plugin.Allocate`` spans, and heartbeat and metrics
   snapshots. The operator's tools, each in its own process
   (``python -m k8s_device_plugin_tpu_torch.tools.<name>``) against the live
   daemon: while the pod's timed steps run, ``tputop --url`` until the
   card's row (its UUID) names the pod with a duty above 0, its memory
   within 2% of memory.total of nvidia-smi's memory.used read just before
   (plus half the table's 0.1 GiB step) and its power within the limit, then
   ``tpu-flame --url .../debug/profile?seconds=1`` with a frame in its top
   table; after the 41 ``Allocate``s, ``tpu-trace -`` over ``/debug/traces``
   renders a tree holding ``plugin.Allocate``, ``tpu-doctor check --url``
   exits 0 and ``tpu-doctor bundle --url -o`` holds ``/metrics`` and every
   ``DEBUG_ENDPOINTS`` surface; after SIGTERM, ``tpu-doctor postmortem
   <black box>`` exits 0 and names the last ``Allocate``'s decision by its
   trace. Every tool must exit as said. One line with the times to
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
   limit, the first sweep's time (it builds the static loop inventory) and
   the inventory's build time from the daemon's log.

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

19. Gang admission (host code; a released member's pod runs the kernels):
   phase 18's stand-ins (a short dir in /tmp, a new ``FakeApiServer`` and
   its kube config, a daemon over the real NVML publishing this card's
   node, the stand-in kubelet and PodResources) and a synthetic HGX node of
   as many cards as this node, every pair NV18, none free. The extender is
   ``python -m k8s_device_plugin_tpu_torch.extender --node-cache
   --gang-admission --journal-dir <dir> --audit-interval-s 1 --decisions
   --kubeconfig <it> --port <free>`` with HOSTNAME fixed (the lease's
   identity, kept across a container's restart; the extender's address). In order: (1) the
   times from its start to ``tpu_extender_lease_held`` 1 and to ``/readyz``
   200; a second extender of another HOSTNAME must exit nonzero and leave
   the lease's ``holderIdentity`` as it was; the extender's log gives the
   static loop inventory's build time (before ``/readyz``), and its first
   audit sweep must be clean and run ``loop_inventory``, its time
   printed. (2) A gang of 2 gated pods,
   each asking this node's card count, stays gated while the synthetic node
   has no free card: ``tpu_gang_waiting{tier="standard"}`` 1 and a
   ``gang_waiting`` record on ``/debug/decisions``. (3) The synthetic node's
   annotation frees its cards (after the extender's node watch opened): the
   time until both gates are gone, and a 1-card non-gang pod rejected on
   both nodes by the name-only ``/filter`` with the hold's note. (4)
   SIGKILL before any member binds, and the same command again over the
   same journal dir: its start to ``/readyz`` 200, polled every 0.5 ms,
   with ``replaying`` read before ``ready``; the competitor still rejected
   and ``tpu_gang_reserved_chips`` at the gang's demand. (5) The stand-in
   kubelet's ``Allocate`` of this node's cards for member 0 through the
   daemon, the member bound, and its pod ``workload.smoke --bench --steps
   5`` in its own process with the response's env and
   ``CUDA_VISIBLE_DEVICES`` from ``NVIDIA_VISIBLE_DEVICES``: ok, its
   ``device_uuid`` an allocated card, each flash kernel and delta launched
   ``n_layers`` times a step (its own counts) and the RMSNorm kernel not at
   all. (6) Member 1 bound on the synthetic node: the hold drops
   (``tpu_gang_reservations`` 0) and the competitor passes there. (7) Two
   audit sweeps or more, every one clean and running ``loop_inventory``;
   SIGTERM ends the extender and the daemon with code 0 and the lease's
   ``holderIdentity`` reads "". The
   operator's tools, each in its own process: while the gang waits (2),
   ``tools.gang --kubeconfig --extender-url --json`` reports it blocked on
   GPU capacity, both members gated, and ``tools.explain --gang --url``
   shows its ``gang_waiting`` record with the shortfall; once released (3),
   both report the release, ``tpu-doctor fleet --kubeconfig`` lists one row,
   the extender from its lease, at the holder's address (the fixed
   HOSTNAME, ``127.0.0.1``), healthy, exit 0, ``tpu-doctor bundle --url
   --journal-dir`` holds the journal's metadata (clean), and ``tpu-simreport
   report --url`` prints the extender's ``/debug/simreport`` (no replay in
   its process: ``enabled: false`` and the simulator's note). One line
   with every time beside the card's name and power limit; the times are
   the host CPU's except the pod's step, which stands beside phase 5's.
20. Sharded gang admission (host code; a taken-over gang's member runs the
   kernels): phase 19's stand-ins (a short dir ``/tmp/shard*``, a new
   ``FakeApiServer``, a daemon over the real NVML publishing this card's
   node under the machine's own name, the stand-in kubelet and
   PodResources) and two replicas of ``python -m
   k8s_device_plugin_tpu_torch.extender --node-cache --gang-admission
   --shards 2 --journal-dir <dir> --audit-interval-s 1 --decisions
   --lease-seconds 6 --gang-resync-s 1 --kubeconfig <it> --port <free>``
   with HOSTNAME ``nvidia-scheduler-extender-0`` and ``-1`` (shard 0's with
   ``--shard-index 0``, shard 1's from the ordinal). X is the shard the ring
   gives this node, Y the other; SX is a synthetic HGX node on X of as many
   cards, none free, SY one on Y of 8, all free, and the gangs' names are
   picked onto their shards. In order: (1) each replica's start to
   ``tpu_extender_shard_owned{shard}`` 1 and to ``/readyz`` 200 owning its
   home; a third replica of home X and another HOSTNAME exits nonzero and
   X's holder stays. (2) G_Y (2 pods of 2 cards) released by Y onto SY:
   replica X's name-only ``/filter`` then refuses an 8-card pod on SY with
   the hold's note (the overlay alone: SY's annotation has 8 free) and its
   ``tpu_extender_shard_peer_held_chips`` reads 4. G_Y is submitted just
   after one of X's scans, so the time from the release to that refusal is
   near its worst case, one scan; it must stay within a scan plus 0.5 s,
   and the hold must reach Y's lease within 0.5 s of the release. (3) G_X (member 0 of this node's card count,
   member 1 of SX's) waits until SX's cards come free, then X releases it
   and journals it under ``shard-X/``; Y's ``/filter`` refuses a 1-card
   competitor on this node. (4) SIGKILL of X before any member binds; G_Y2
   (2 pods of 2 cards) is released by Y while Y owns only Y, and the dead
   shard's overlay still refuses the competitor. (5) Y takes shard X over
   (within 2 x 6 s plus a scan): ``tpu_extender_shard_takeovers_total
   {shard=X}`` 1, ``owned`` [X, Y], ``tpu_gang_reserved_chips`` at G_X's
   demand, G_X's hold replayed with its original age, the competitor
   refused on this node. (6) Member 0 through the stand-in kubelet's
   ``Allocate`` and bound; its pod ``workload.smoke --bench --steps 5`` in
   its own process as in phase 19: ok, on the allocated card, each flash
   kernel and delta ``n_layers`` times a step, RMSNorm not at all. (7) X
   restarted (same HOSTNAME and journal dir) parks its standby lease, Y
   hands shard X back, X owns it with G_X's hold at its original age; member
   1 bound on SX drops the hold (``tpu_gang_reservations`` 0) and the
   competitor passes there. (8) Two clean audit sweeps or more on each
   replica, ``reservation_shard_ownership`` among the invariants. (9)
   ``python -m k8s_device_plugin_tpu_torch.extender.sharding
   --shard-self-test`` exits 0. (10) SIGTERM ends both replicas and the
   daemon with code 0, every shard and standby lease released. One line
   with every time beside the card's name and power limit; the times are
   the host CPU's except the pod's step, which stands beside phase 5's.
21. Preemption on the card: phase 19's stand-ins (sockets under
   ``/tmp/pre*``), a new fake API server holding the PriorityClasses
   ``batch`` (-10) and ``prod`` (1,000,000), the daemon over the real NVML
   publishing this node N, a synthetic HGX node S of 8 cards, and ``python
   -m k8s_device_plugin_tpu_torch.extender --node-cache --gang-admission
   --journal-dir D --audit-interval-s 1 --decisions --gang-resync-s 1``
   (preemption on by default), HOSTNAME ``127.0.0.1``. (1) V_card, one
   member of N's card count of class ``batch``, released onto N, allocated
   through the daemon and bound, its pod ``workload.smoke --bench --steps
   600`` stepping on the card in its own process; V_syn, two 4-card pods
   of class ``batch`` bound to S, holding all its cards; each pod's
   checkpoint stamped through the port's ``workload.beacon.CheckpointBeacon``
   over the kube client, V_card's 60 s back, V_syn's 3,000 s. (2) A gang of
   no class (standard tier) asking N's cards stays gated over three ticks,
   nothing evicted, ``tpu_gang_waiting{tier="standard"}`` 1; it is deleted.
   (3) ``/preemption`` for a bare ``prod`` pod of N's cards names N with
   V_card's member alone, and nothing is evicted. (4) G_P, one gated member
   of N's cards of class ``prod``: V_card's member evicted, V_syn not, G_P's
   gates gone; the ledger's ``preempt_victim selected`` for V_card and
   ``preemption executed`` for G_P; ``tpu_extender_preemptions_total{tier=
   "critical",outcome="executed"}`` and ``tpu_extender_preemption_victims_
   total{victim_tier="batch"}`` 1; the journal's ``preempt_intent``,
   ``preempt_evicted``, ``preempt_done`` for G_P in order; a
   ``GPUGangPreempted`` Event on V_card's pod. (5) The stand-in kubelet,
   seeing V_card's pod deleted, sends its process SIGTERM (it must still be
   stepping) and clears its PodResources entry; its context leaves the card
   (``compute_apps``). (6) G_P's member through ``Allocate`` on N's cards
   and bound, its pod as phase 19's (ok, on an allocated card, its own
   launch counts), no other process than the script's on the card while it
   steps, the hold dropped. (7) ``tools.explain --evicted vcard --url``
   exits 0 naming G_P, the victim tier and the last checkpoint. (8) ``python
   -m k8s_device_plugin_tpu_torch.extender.preemption --self-test`` exits 0.
   (9) Two clean audit sweeps or more; SIGTERM ends the extender and the
   daemon with code 0 and releases the lease. One line with every time
   beside the card's name and power limit; the times are the host CPU's
   except the pod's step, which stands beside phase 5's.
22. Defragmentation on the card: phase 21's stand-ins (sockets under
   ``/tmp/dfg*``, a fresh fake API server with the PriorityClass ``batch``,
   the daemon over the real NVML publishing this node N with
   ``--resync-interval 2``), synthetic HGX nodes S and S2 of 8 cards, the
   extender as phase 21 runs it (preemption, defragmentation and rescue on
   by default). (1) V, a batch gang of two: V-b (4 cards) bound to S, V-a
   (N's cards) released onto N, allocated and bound, its pod stepping on the
   card; W, a standard gang of one 4-card member bound to S2; V's beacon
   stamped 60 s back; ``tools.defrag status`` shows no stranded demand. (2)
   X, gated, one member of 8 cards of no class: 4 cards free on S and on S2,
   none on N, no node places 8. Timed from the submission:
   ``tpu_extender_stranded_demand{size="8"}`` 1, V's two evictions, X's
   gates gone; W untouched, ``defrag executed`` for X and ``defrag_victim``
   for V in the ledger, the budget at 10, the journal's ``defrag_intent``,
   ``defrag_evicted``, ``defrag_done`` in order, X's hold all of S (X then
   bound there), a ``GPUGangMigrated`` Event on V's pod. (3) The stand-in
   kubelet clears V-a's PodResources entry and sends it SIGTERM; timed from
   the eviction: its exit, its context off the card, the card published
   free. (4) V's job controller recreates both members gated: the 4-card one
   lands on S2, the other on N and runs ``workload.smoke --bench --steps 5``
   as phase 19's pods (ok, on an allocated card, its own launch counts). (5)
   ``tools.defrag plan``, ``tools.explain --migrated v`` (naming S and
   default/x) and ``tools.tputop``'s defrag footer (the budget) against the
   extender exit 0. (6) ``extender.defrag`` and ``tools.defrag``
   ``--self-test`` exit 0. (7) Two clean audit sweeps or more,
   ``defrag_vs_reservations`` among the invariants; SIGTERM ends every
   process with code 0.
23. Drain and rescue on the card: phase 22's stand-ins (``/tmp/rsc*``),
   synthetic nodes H and F of N's card count, R a standard gang of one
   member bound to F. (1) D, a standard gang of one member of N's cards,
   released onto N, its pod stepping; H joins, all free; ``python -m
   k8s_device_plugin_tpu_torch.tools.doctor drain N --url``, timed from the
   POST: N cordoned and tainted ``tpu.google.com/maintenance=drain``, D's
   eviction, its exit, its context off the card, the drain-complete
   annotation, the doctor's exit 0. D's recreated member is released by
   the rescue fence on H and bound there; ``rescue executed`` names
   ``draining``, the journal holds ``rescue_intent``, ``rescue_evicted``,
   ``rescue_done`` in order, ``tpu_node_cordoned{node=N}`` 1, no other pod
   evicted; ``doctor drain --uncordon N`` exits 0 and takes the cordon, the
   taint, the stamp and the gauge away. (2) F's cards moved to ``failed`` in
   its annotation, as a daemon publishes a health withdrawal: timed from
   there, R's eviction and its recreated member released by the fence on N
   (the only free healthy node), which runs the kernels as in (4) of phase
   22. (3) ``tools.explain --rescued r`` names F and ``chip_failed``,
   ``--rescued d`` names ``draining``; ``extender.rescue --self-test`` exits
   0. (4) Two clean audit sweeps or more, ``rescue_vs_health`` among the
   invariants; SIGTERM ends every process with code 0. Each phase prints one
   line with every time beside the card's name and power limit; the times
   are the host CPU's except the pods' steps, which stand beside phase 5's.
   Phases 22 and 23 fail past limits derived from the ticks: submission to
   the evictions within ``--defrag-stranded-ticks`` ticks plus 1 s, the
   drain's POST to the eviction and the withdrawal to the eviction within
   ``--rescue-grace-ticks`` ticks plus 1 s (the 10 s waits are timeouts).
24. An API-server brownout and a partition on the card: phase 22's
   stand-ins (``/tmp/brw*``), the daemon over the real NVML with its HTTP
   plane and ``--audit-interval-s 1``, the extender as phase 22 runs it
   (``--gang-resync-s 1``, its default 30 s lease). Every limit is derived
   from the code's settings (``brownout_limits``: the default
   ``RetryPolicy`` and ``CircuitBreaker``, the lease's renew deadline and
   cadence, the resyncs, the daemon's watch backoff cap) and the phase fails
   past it. (1) G, a standard gang of one member of this node's cards,
   released onto it and allocated; its pod ``workload.smoke --bench --steps
   400`` steps on the card; just before, the same pod ran there alone
   as the control. (2) Just after a lease renewal,
   ``tests/chaos_plans/brownout.json`` is loaded into the fake API server
   for W = 10 s (under the 20 s renew budget, no longer than the breaker's
   10 s reset), and G's member is bound inside it (its PodResources entry
   recorded with the bind, as a kubelet records a pod bound to its node).
   Timed from the load, on
   each process's own ``/metrics``: both ``*_kube_circuit_state`` open and
   both ``*_kube_degraded_mode`` at 1. Inside W, polled every second: the
   name-only ``/filter`` for a new one-card pod answers as before W,
   ``/readyz`` 200, G's pod alive and the card's NVML duty 50% or more;
   no pod, node or status patch, Event, eviction or lease write lands, and
   the lease's holder stays. (3) The plan cleared; timed from there: both
   breakers closed, both degraded gauges at 0, and the daemon's queued
   writes (``tpu_plugin_kube_queued_writes``) delivered with G's devices
   annotation in place; then two clean audit sweeps of each process after
   recovery, the extender's with ``degraded_consistency`` and
   ``placeable_recount``. (4) Just after a renewal, every request reset
   until the extender exits non-zero, within the renew deadline plus one
   wake of its renew loop after a failure, plus 1 s; meanwhile the daemon's
   ``ListAndWatch`` stays open and sends nothing, ``tpu_node_free_chips``
   reads 0 and G's pod steps. The plan cleared, the extender restarted and
   timed to ``/readyz``. (5) ``python -m
   k8s_device_plugin_tpu_torch.utils.resilience --resilience-self-test
   --chaos-plan tests/chaos_plans/brownout.json`` exits 0. (6) G's pod's
   report: ok, on an allocated card, each flash kernel and delta launched
   ``n_layers`` times a step and the RMSNorm kernel not at all, its timed
   steps spanning W and the partition, its step within 1% of the control
   pod's (phase 5's beside it).
   Two clean sweeps of the restarted extender; SIGTERM ends it and the
   daemon with code 0. One line with every time beside the card's name and
   power limit.

25. The scheduling-quality simulator (host code only; no card work): in
   their own processes ``python -m k8s_device_plugin_tpu_torch.tools.simreport
   --self-test`` (exit 0, a deterministic replay) and ``run --json`` over the
   four canned traces, each scorecard's sha256 equal to the port's golden
   (``extender/sim_traces/golden.json``, written on a CPU) and every delta
   0: the replay is the same on this machine's interpreter. Then each
   canned trace replayed in this process, timed, its bytes equal to the
   CLI's, and ``hgx_su`` (one DGX SuperPOD scalable unit: 32 nodes of 8
   cards, 480 ticks of 60 s) replayed twice, byte-identical. One line per
   replay: trace, wall s, arrivals, admitted ratio, utilisation, evictions,
   sha256, and the card's name and power limit.
26. The control-plane scale bench (host code only; no card work):
   ``python -m k8s_device_plugin_tpu_torch.extender.scale_bench`` with
   ``--cold-start-self-test``, ``--profile-self-test`` and
   ``--placement-self-test``, each in its own process, must exit 0 with its
   JSON line, and ``--placement-kernel`` (no twin: the TPU box kernel's
   probe) must exit 2 with one line on stderr naming it. Then, in this
   process, at the tier-1 tests' sizes and held to their bounds (the JAX
   ``tests/test_scale_bench.py``'s, copied into ``SCALE_BENCH_BOUNDS``),
   each with the suite's one full re-run: ``run(1000, 100, 20, 2)``,
   ``shard_scaling(300, 30, 3, 20)``, ``defrag_planning(1000, samples=20)``,
   ``cold_start(1000, 101, 7)``, and the telemetry, audit, profiler and
   black-box overhead probes at 60 nodes and 101 samples and the resilience
   probe at 101 calls of 50, each arm within 1.05x + 0.3 ms of its control.
   One line per probe with its key numbers and the card's name and power
   limit, then the phase's wall time, which must stay under 60 s. The 5,000
   and 50,000-node runs are not made here.

Then one ``{"tools": ...}`` line: the card's name and power limit, and
each tool run of phases 16, 19 and 21 to 23 with its phase, exit code and
wall time.
Then one ``{"kernels": [...]}`` line (each kernel's launches from the path
that runs it: K1-K3 and the head's GEMM (K5) from phase 5, K4 from
phase 6; every path's counts
under ``launches_by_path``, phase 10's as ``sharded``, phase 11's as
``moe`` and ``ring``, phase 12's as ``resume``, phase 14's as
``kv_sweep``, phase 16's, from the pod's report, as ``plugin_pod``,
phase 17's, from its pod's report, as ``dra_pod``, phase 19's, from
member 0's pod's report, as ``gang_pod``, phase 20's, from the taken-over
member's pod's report, as ``shard_pod``, phase 21's, from the preemptor's
pod's report, as ``preempt_pod``, phases 22's and 23's, from the replacement
members' pods' reports, as ``defrag_pod`` and ``rescue_pod``, phase 24's,
from G's pod's report, as ``brownout_pod``) and,
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
    # none: the JAX unembed's f32 einsum, which XLA compiles
    "head_gemm": ("ops/csrc/head_gemm.cu", "k8s_device_plugin_tpu/workload/model.py:378-380"),
}
FLASH = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")
# The LM head's GEMM (ops/head.py) launches a full-logits training step:
# the logits, dX and dE. Every step and full forward here has 2048 rows or
# more, which take the kernel; a forward without gradients launches one.
HEAD_A_STEP = 3


def step_launches(cfg, steps: int, full_logits_steps: int | None = None,
                  forwards: int = 0) -> dict:
    """Each kernel's launches over ``steps`` training steps of ``cfg`` (all
    full-logits unless ``full_logits_steps`` says how many are) and
    ``forwards`` full forwards without gradients: the flash kernels once a
    layer a step where ``cfg`` takes them, the RMSNorm kernel at each
    block's two norms and the final one where ``use_pallas_norm``, the
    head's GEMM three times a full-logits step and once a forward."""
    flash = cfg.n_layers * steps if cfg.use_flash_attention else 0
    want = {name: flash for name in FLASH}
    want["rmsnorm"] = (2 * cfg.n_layers + 1) * steps if cfg.use_pallas_norm else 0
    full = steps if full_logits_steps is None else full_logits_steps
    want["head_gemm"] = HEAD_A_STEP * full + forwards
    return want


def bench_pod_launches(steps: int) -> dict:
    """A ``smoke --bench`` pod's kernel launches over its ``steps`` eager
    full-logits steps."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    return step_launches(ModelConfig.bench(), steps)


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


def phase_lint() -> None:
    """The port's lint over this checkout: ``--self-test`` proves every rule
    on the fixture corpus, ``--json`` finds nothing new and no stale
    baseline entry. One line per run, with its wall time."""
    from k8s_device_plugin_tpu_torch.analysis.rules import RULES_BY_ID

    smi = nvidia_smi()
    for mode in ("self_test", "json"):
        t0 = time.monotonic()
        out = subprocess.run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.tools.lint",
                              "--" + mode.replace("_", "-")],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        wall = time.monotonic() - t0
        try:
            doc = json.loads(out.stdout)
        except ValueError:
            doc = {}
        if mode == "self_test":
            proven = doc.get("rules_proven") or []
            got = {"corpus": doc.get("corpus"), "rules_proven": len(proven),
                   "failures": doc.get("failures")}
            ok = doc.get("lint_self_test") == "ok" and sorted(proven) == sorted(RULES_BY_ID)
        else:
            got = {"new": doc.get("new"), "stale_baseline": doc.get("stale_baseline"),
                   "grandfathered": len(doc.get("grandfathered") or []),
                   "unjustified": len(doc.get("unjustified_baseline") or [])}
            ok = doc.get("new") == [] and doc.get("stale_baseline") == []
        emit({"lint": {"mode": mode, "rc": out.returncode, "wall_s": wall, **got,
                       "nvidia_smi": smi}})
        if out.returncode != 0 or not ok:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr, flush=True)
            fail(f"tpu-lint --{mode.replace('_', '-')} exited {out.returncode}: {got}")


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
    entries["head_gemm"] = phase_head_kernel()
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


# The LM head's GEMM (ops/head.py) at the two full-logits cells' (rows, d,
# vocab): the bench model's (timed; the kernels line's entry) and gpt2-xl's,
# whose G rows (50,257 values, not 16-byte aligned) load through registers.
HEAD_CELLS = {"smoke-bench": (16384, 2048, 32768), "gpt2-xl": (8192, 1600, 50257)}
HEAD_TIMED = "smoke-bench"
HEAD_ITERS = 5
# Against an f64 product of the same inputs, over its RMS: the RMS error at
# most 2x, the largest at most 4x, those of torch.matmul in f32 (TF32 off).
HEAD_RMS_RATIO, HEAD_MAX_RATIO = 2.0, 4.0


def head_operands(layout: str, rows: int, d: int, vocab: int) -> tuple:
    """A product's operands as the head forms them: X (rows, d) at a norm's
    scale and E (vocab, d) at GPT-2's init for the logits X . E^T (nt); G
    (rows, vocab) at a mean loss's gradient scale with E for dX = G . E
    (nn), with X for dE = G^T . X (tn)."""
    gen = torch.Generator(device="cuda").manual_seed(rows + d + vocab)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, e = randn(rows, d), randn(vocab, d, scale=0.02)
    if layout == "nt":
        return x, e
    g = randn(rows, vocab, scale=1e-4)
    return (g, e) if layout == "nn" else (g, x)


def head_library(layout: str, a, b):
    """The product by torch.matmul: f32 on the CUDA cores, or f64."""
    return {"nt": lambda: a @ b.T, "nn": lambda: a @ b, "tn": lambda: a.T @ b}[layout]()


def head_errors(got, want) -> tuple[float, float]:
    """RMS and largest |got - want| over want's RMS."""
    diff = got.double() - want
    rms = want.square().mean().sqrt()
    return float(diff.square().mean().sqrt() / rms), float(diff.abs().max() / rms)


def phase_head_kernel() -> dict:
    """The head's GEMM in its three layouts, and its plain version (the
    same three TF32 passes as PyTorch products), against f64 at
    HEAD_CELLS, each held to the f32 product's own error; returns the
    kernels line's entry: the three layouts at the bench model's shape,
    summed as one full-logits step runs them."""
    from k8s_device_plugin_tpu_torch.ops import head
    from k8s_device_plugin_tpu_torch.ops.microbench import TF32_PEAK_FLOPS

    entry = None
    for cell, (rows, d, vocab) in HEAD_CELLS.items():
        timed = cell == HEAD_TIMED
        layouts = {}
        for layout in ("nt", "nn", "tn"):
            m, n, k = {"nt": (rows, vocab, d), "nn": (rows, d, vocab),
                       "tn": (vocab, d, rows)}[layout]
            a, b = head_operands(layout, rows, d, vocab)
            kernel = getattr(head, f"head_matmul_{layout}")
            plain = getattr(head, f"head_matmul_{layout}_plain")
            want = head_library(layout, a.double(), b.double())
            errs = {}
            for side, fn in (("kernel", kernel), ("plain", plain),
                             ("library", lambda a, b: head_library(layout, a, b))):
                got = fn(a, b)
                torch.cuda.synchronize()
                errs[side] = head_errors(got, want)
                del got
            del want
            line = {"kernel": "head_gemm", "cell": cell, "layout": layout, "shape": [m, n, k],
                    "dtype": "float32",
                    **{f"{key}_{side}": errs[side][i] for side in errs
                       for i, key in enumerate(("rms_err", "max_err"))},
                    "tolerance": f"against f64: RMS error <= {HEAD_RMS_RATIO}x, largest <= "
                                 f"{HEAD_MAX_RATIO}x torch.matmul f32's (TF32 off)"}
            if timed:
                bound_ms, bound_by = bound(3 * 2.0 * m * n * k, TF32_PEAK_FLOPS,
                                           4.0 * (a.numel() + b.numel() + m * n))
                line.update(
                    kernel_ms=time_ms(lambda: kernel(a, b), HEAD_ITERS),
                    plain_ms=time_ms(lambda: plain(a, b), 1, reps=3),
                    library_ms=time_ms(lambda: head_library(layout, a, b), HEAD_ITERS),
                    library_call="torch.matmul f32, TF32 off (cuBLAS sgemm)",
                    bound_ms=bound_ms, bound_by=bound_by)
                line["bound_share"] = bound_ms / line["kernel_ms"]
                layouts[layout] = line
            emit(line)
            lib_rms, lib_max = errs["library"]
            bad = [side for side in ("kernel", "plain")
                   if not (errs[side][0] <= HEAD_RMS_RATIO * lib_rms
                           and errs[side][1] <= HEAD_MAX_RATIO * lib_max)]
            if bad:
                fail(f"head_gemm {layout} at {cell}'s shape: {bad} against f64 beyond "
                     f"the f32 product's error: {line}")
            del a, b
            torch.cuda.empty_cache()
        if timed:
            keys = ("kernel_ms", "plain_ms", "bound_ms", "library_ms")
            sums = {key: sum(line[key] for line in layouts.values()) for key in keys}
            entry = {
                "name": "head_gemm",
                "route": "cuda",
                "source": "k8s_device_plugin_tpu_torch/" + KERNELS["head_gemm"][0],
                "replaces": KERNELS["head_gemm"][1],
                "shape": [rows, d, vocab],
                "rms_err": max(line["rms_err_kernel"] for line in layouts.values()),
                "max_err": max(line["max_err_kernel"] for line in layouts.values()),
                "ms": sums["kernel_ms"],
                "plain_ms": sums["plain_ms"],
                "bound_ms": sums["bound_ms"],
                "bound_by": "/".join(sorted({line["bound_by"] for line in layouts.values()})),
                "library_ms": sums["library_ms"],
                "by_layout": {lay: {key: line[key] for key in keys + ("bound_share",)}
                              for lay, line in layouts.items()},
            }
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
    """The bench step: each flash kernel once a layer a step, the head's
    GEMM three times a step, the RMSNorm kernel (off in
    ``ModelConfig.bench()``) not at all."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    cfg = ModelConfig.bench()
    report, launches, steps = drive_path(cfg)
    want = step_launches(cfg, steps)
    if launches != want:
        fail(f"main path launches {launches}, expected {want}")
    return report, launches, steps


def phase_norm_path(main_report: dict) -> tuple[dict, int]:
    """The bench step with ``use_pallas_norm``: 2 norms per block and the
    final one launch the RMSNorm kernel each step, and attention stays on
    the flash kernels."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    cfg = dataclasses.replace(ModelConfig.bench(), use_pallas_norm=True)
    report, launches, steps = drive_path(cfg)
    want = step_launches(cfg, steps)
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
    from k8s_device_plugin_tpu_torch.workload.smoke import AB_PAIRS, run_smoke

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
    # The head's GEMM in every full-logits step: the main run's and the
    # A/B's AB_PAIRS windows of main steps; none in the chunked variant's.
    chunked_steps = ab["steps_run"] - AB_PAIRS * MULTI_STEP["inner_steps"]
    want = step_launches(cfg, steps, steps - chunked_steps)
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
    # The full forward's logits (16384 rows a token, then the prompt's 2048
    # for the prefill parity check) take the head's GEMM; the KV decoder's
    # 8 rows a token keep the einsum.
    want = step_launches(dense, 0, forwards=2 * GENERATION["steps"] + 1)
    if dense_launches != want:
        fail(f"dense generation launches {dense_launches}, expected {want}")

    cfg = dataclasses.replace(ModelConfig.bench(), use_pallas_norm=True)
    reset_launches()
    report = generate.run_generation_smoke(cfg, device="cuda", **GENERATION)
    flash_launches = dict(LAUNCHES)
    n = GENERATION["steps"]
    want = {"flash_fwd": cfg.n_layers * n, "flash_dq": 0, "flash_dkv": 0,
            "flash_bwd_delta": 0, "rmsnorm": (2 * cfg.n_layers + 1) * n, "head_gemm": n}
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
    # FSDP2 hands the loss whole (plain) parameters, so the head's GEMM runs.
    want = step_launches(cfg, n_steps)
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
    want = step_launches(cfg, steps)
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
    # Per q chunk: one forward for the logits, then the train steps.
    want = step_launches(dense_cfg, 2 * RING_STEPS, forwards=2)
    if launches != want:
        fail(f"ring path launches {launches}, expected {want}")
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
    want = step_launches(cfg, resumed_steps)
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
            "flash_bwd_delta": calls, "rmsnorm": 0, "head_gemm": 0}
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


def loop_inventory_ms(log_path: Path):
    """The time a daemon or extender logged for building the audit's static
    loop inventory (one parse of the package), or None where it logged
    none."""
    m = re.search(r"static loop inventory: \d+ names, \d+ prefixes in (\d+) ms",
                  log_path.read_text())
    return int(m.group(1)) if m else None


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
    # The first sweep parses the package for the static loop inventory.
    first_sweep_ms = next((p["audit"]["last_duration_ms"] for p in observer.polls
                           if p["audit"].get("sweeps") == 1), None)
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
        "audit_first_sweep_ms": first_sweep_ms,
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


# Every run of an operator tool (phases 16 and 19): its phase, tool,
# arguments, exit code and wall time, printed on the ``tools`` line.
TOOL_RUNS: list = []
# While the pod trains, tputop is first run this long after its first step
# (two sampler passes, so the card's series carry the pod), then every
# TOOL_RETRY_S until the card's row names the pod with a duty above 0 or
# the steps end.
TOOL_FIRST_S = 1.0
TOOL_RETRY_S = 0.5


def run_tool(phase: str, tool: str, *args, stdin: str = "") -> subprocess.CompletedProcess:
    """``python -m k8s_device_plugin_tpu_torch.tools.<tool> args`` in its own
    process, as an operator runs it; its exit code and wall time go into
    TOOL_RUNS."""
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", f"k8s_device_plugin_tpu_torch.tools.{tool}",
                          *args], cwd=ROOT, input=stdin, capture_output=True, text=True,
                         timeout=120)
    TOOL_RUNS.append({"phase": phase, "tool": tool, "args": list(args),
                      "rc": out.returncode, "wall_s": time.monotonic() - t0})
    return out


def tool_fail(out: subprocess.CompletedProcess, what: str, fail_with) -> None:
    fail_with(f"{what}: rc {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")


def tputop_row(text: str, uuid: str):
    """The card's row of a tputop table: its holder, container, gang, duty,
    memory (MiB, at the table's 0.1 GiB step), temperature, power and
    NVLink column; None when the table has no row for the card."""
    for line in text.splitlines():
        cells = line.split()
        if not cells or cells[0] != uuid:
            continue
        rest = cells[5:]
        mem = rest.pop(0)
        if rest and rest[0].startswith("("):
            rest.pop(0)
        mib = (float(mem[:-2]) * 1024 if mem.endswith("Gi")
               else float(mem[:-2]) if mem.endswith("Mi") else None)
        num = (lambda v, unit: float(v[:-len(unit)]) if v.endswith(unit) else None)
        return {"pod": cells[1], "container": cells[2], "gang": cells[3],
                "duty": float(cells[4]) if cells[4] != "-" else None, "memory_mib": mib,
                "temp_c": num(rest[0], "C"), "power_w": num(rest[1], "W"), "nvlinks": rest[2]}
    return None


def flame_top_rows(text: str) -> int:
    """Frames in the top table ``tpu-flame`` prints before its flamegraph."""
    lines = text.splitlines()
    if not lines or lines[0].split() != ["SELF", "SELF%", "TOTAL", "TOT%", "FRAME"]:
        return 0
    return sum(1 for line in lines[1:lines.index("")] if line.strip())


class ToolProbe(threading.Thread):
    """While the pod trains: ``tputop --url`` (nvidia-smi's memory and power
    limit read just before each run) until the card's row names the pod with
    a duty above 0, then ``tpu-flame --url .../debug/profile?seconds=1``."""

    def __init__(self, base: str, uuid: str, t_end):
        super().__init__(name="tool-probe", daemon=True)
        self.base, self.uuid, self.t_end = base, uuid, t_end
        self.attempts: list = []
        self.flame = None
        self.error = None

    def run(self) -> None:
        try:
            time.sleep(TOOL_FIRST_S)
            while True:
                row = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used,memory.total,power.limit",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=60, check=True).stdout
                used, total, limit = (float(v) for v in row.splitlines()[0].split(","))
                t = time.monotonic()
                out = run_tool("plugin_pod", "tputop", "--url", self.base)
                self.attempts.append({
                    "t": t, "out": out, "row": tputop_row(out.stdout, self.uuid),
                    "smi": {"memory_used_mib": used, "memory_total_mib": total,
                            "power_limit_w": limit}})
                row = self.attempts[-1]["row"]
                if (out.returncode != 0 or self.t_end() is not None
                        or (row and row["pod"] == f"default/{POD_NAME}" and row["duty"])):
                    break
                time.sleep(TOOL_RETRY_S)
            self.flame = run_tool("plugin_pod", "flame", "--url",
                                  f"{self.base}/debug/profile?seconds=1")
        except Exception as e:  # noqa: BLE001 - reported by check()
            self.error = f"{type(e).__name__}: {e}"

    def check(self, t_steps, daemon_fail) -> dict:
        """Every run exits 0; the last tputop, taken inside the pod's timed
        steps, shows the card held by the pod (container main) with a duty
        above 0, memory within 2% of memory.total of nvidia-smi's
        memory.used (plus half the table's 0.1 GiB step) and a power no
        higher than the limit; the flamegraph's top table holds a frame."""
        self.join(timeout=120)
        if self.error is not None or not self.attempts or self.flame is None:
            daemon_fail(f"the tools while the pod trained: {self.error}")
        for a in self.attempts:
            if a["out"].returncode != 0:
                tool_fail(a["out"], "tputop --url", daemon_fail)
        last = self.attempts[-1]
        row, smi = last["row"], last["smi"]
        memory_slack = 0.02 * smi["memory_total_mib"] + 0.05 * 1024
        if not (t_steps[0] < last["t"] < t_steps[1] and row
                and (row["pod"], row["container"]) == (f"default/{POD_NAME}", "main")
                and (row["duty"] or 0) > 0
                and abs(row["memory_mib"] - smi["memory_used_mib"]) <= memory_slack
                and row["power_w"] is not None and row["power_w"] <= smi["power_limit_w"]):
            daemon_fail(f"tputop's row for {self.uuid} during the pod's steps: {row}, "
                        f"nvidia-smi {smi}\n{last['out'].stdout[-3000:]}")
        frames = flame_top_rows(self.flame.stdout)
        if self.flame.returncode != 0 or frames < 1:
            tool_fail(self.flame, "tpu-flame --url /debug/profile", daemon_fail)
        return {"tputop": {"runs": len(self.attempts), "row": row, "nvidia_smi": smi},
                "flame_top_frames": frames}


def daemon_tools(base: str, work: Path, daemon_fail) -> dict:
    """With the daemon serving, after its Allocates: ``tpu-trace -`` over
    its /debug/traces must render a tree holding ``plugin.Allocate``;
    ``tpu-doctor check --url`` must exit 0 (a clean audit); ``tpu-doctor
    bundle --url -o`` must write a tarball holding /metrics and every
    surface of ``DEBUG_ENDPOINTS``, each ok in its manifest."""
    import tarfile

    from k8s_device_plugin_tpu_torch.utils.metrics import DEBUG_ENDPOINTS

    status, body = http_get(base + "/debug/traces")
    out = run_tool("plugin_pod", "trace", "-", stdin=body.decode() if status == 200 else "")
    trees = [line for line in out.stdout.splitlines() if line.startswith("trace ")]
    if out.returncode != 0 or not trees or "plugin.Allocate [plugin]" not in out.stdout:
        tool_fail(out, "tpu-trace - over /debug/traces", daemon_fail)
    check = run_tool("plugin_pod", "doctor", "check", "--url", base)
    if check.returncode != 0 or "no findings" not in check.stdout:
        tool_fail(check, "tpu-doctor check --url", daemon_fail)
    tarball = work / "doctor-bundle.tar.gz"
    bundle = run_tool("plugin_pod", "doctor", "bundle", "--url", base, "-o", str(tarball))
    if bundle.returncode != 0 or not tarball.exists():
        tool_fail(bundle, "tpu-doctor bundle", daemon_fail)
    with tarfile.open(tarball) as tar:
        names = set(tar.getnames())
        manifest = json.load(tar.extractfile("manifest.json"))
    prefix = base.split("://", 1)[1].replace(":", "_")
    want = {"/metrics": "metrics.txt", **{e: e.rsplit("/", 1)[-1] + ".json"
                                          for e in DEBUG_ENDPOINTS}}
    missing = {e for e, f in want.items() if f"{prefix}/{f}" not in names
               or manifest["sources"][0]["files"].get(f) != "ok"}
    if missing:
        daemon_fail(f"the doctor's bundle lacks {sorted(missing)}: {sorted(names)}")
    return {"trace_trees": len(trees), "bundle_bytes": tarball.stat().st_size,
            "bundle_files": len(names), "bundle_endpoints": len(want)}


def postmortem_tool(blackbox_dir: Path, daemon_fail) -> dict:
    """After SIGTERM: ``tpu-doctor postmortem <dir>`` must exit 0 (a clean
    stop) and name the daemon's last Allocate decision, by its trace."""
    from k8s_device_plugin_tpu_torch.utils.blackbox import read_dir

    allocs = [r["data"] for r in read_dir(str(blackbox_dir))[0] if r["kind"] == "decision"
              and r["data"].get("kind") == "allocate_substitution"]
    out = run_tool("plugin_pod", "doctor", "postmortem", str(blackbox_dir))
    last = allocs[-1] if allocs else {}
    named = [line for line in out.stdout.splitlines()
             if "allocate_substitution/" in line and last.get("trace_id", "-") in line]
    if (out.returncode != 0 or "verdict: clean shutdown" not in out.stdout or not named):
        tool_fail(out, f"tpu-doctor postmortem (the last Allocate {last})", daemon_fail)
    return {"last_allocate_trace": last["trace_id"], "lines_naming_it": len(named),
            "timeline_lines": sum(1 for line in out.stdout.splitlines()
                                  if line.startswith("  ") and line[2:3].isdigit())}


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
    if not invariants or not all({"lock_order", "loop_inventory"} <= names
                                 for names in invariants):
        daemon_fail(f"the audit's invariants {invariants[-1:]} lack lock_order or "
                    f"loop_inventory")
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
        tool_probe = None
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
                tool_probe = ToolProbe(observer.base, picked[0], lambda: t_steps[1])
                tool_probe.start()
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
        want = bench_pod_launches(report["steps_run"])
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
        if tool_probe is None:
            daemon_fail("the tools never ran while the pod trained")
        line["tools"] = tool_probe.check(t_steps, daemon_fail)

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
        line["tools"].update(daemon_tools(observer.base, work, daemon_fail))

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
        line["tools"]["postmortem"] = postmortem_tool(blackbox_dir, daemon_fail)
        socket_left = (work / constants.PLUGIN_SOCKET_NAME).exists()
        draining = "still draining" in log_path.read_text()
        line["loop_inventory_ms"] = loop_inventory_ms(log_path)
        if line["loop_inventory_ms"] is None:
            daemon_fail("the daemon logged no static loop inventory")
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
        want = bench_pod_launches(report["steps_run"])
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


def hgx_annotation(name: str, index: int, available_idx, count: int = 8) -> str:
    """A synthetic HGX node's nvidia.com/gpu-topology (8 cards unless
    ``count`` says otherwise): every pair NV18 through NVSwitches (score 9),
    the layout NVML reads on an HGX H100 board."""
    from k8s_device_plugin_tpu_torch.topology.links import score_for
    from k8s_device_plugin_tpu_torch.topology.schema import (
        SCHEMA_VERSION, CardInfo, NodeTopology, PairInfo)

    cards = [CardInfo(id=f"GPU-{index:08x}-0000-4000-8000-{i:012x}",
                      index=i, minor=i, dev_path=f"/dev/nvidia{i}", pci_addr="",
                      numa_node=i // 4, hbm_bytes=81559 * 2 ** 20,
                      name="NVIDIA H100 80GB HBM3") for i in range(count)]
    return NodeTopology(
        version=SCHEMA_VERSION, hostname=name, chip_type="H100",
        product="NVIDIA H100 80GB HBM3", chip_count=count,
        numa_nodes=(count + 3) // 4, chips=cards,
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


# Phase 19: gang admission over this card's node and a synthetic HGX node of
# as many cards. The extender's lease identity (a pod's HOSTNAME, the same
# across its container's restarts) and a second replica's; the gang's name
# and the pods of its members; the card count a competitor asks. The
# identity is the extender's own address, so that ``tpu-doctor fleet``
# reaches the lease's holder without resolving a name, as a cluster's DNS
# resolves a pod's.
GANG_NODE = "gang-node"
GANG_HGX = "gang-hgx"
GANG_IDENTITY = "127.0.0.1"
GANG_SECOND = "nvidia-scheduler-extender-1"
GANG_NAME = "g"
GANG_AUDIT_INTERVAL_S = 1
LEASE_KEY = ("kube-system", "nvidia-scheduler-extender")


def gang_tools(base: str, kubeconfig: Path, count: int, released: bool, gang_fail) -> dict:
    """``tools.gang --kubeconfig --extender-url --json`` and ``tools.explain
    --gang --url``: while the gang waits, the first must report it blocked
    on GPU capacity, both members gated, each asking ``count`` cards, and the
    second must show its ``gang_waiting`` record with the shortfall; once
    it is released, the first must report it released and the second its
    admission."""
    out = run_tool("gang", "gang", "--kubeconfig", str(kubeconfig), "--extender-url", base,
                   "--json")
    reports = json.loads(out.stdout) if out.returncode == 0 else []
    report = next((r for r in reports if r["gang"] == GANG_NAME), None)
    if released:
        ok = report and report["status"] == "released" and report["gated"] == 0
    else:
        ok = (report and report["status"].startswith("blocked: insufficient GPU capacity")
              and report["gated"] == 2 and report["demands"] == [count, count])
    if out.returncode != 0 or "WARNING" in out.stderr or not ok:
        tool_fail(out, f"tools.gang for the {'released' if released else 'waiting'} gang",
                  gang_fail)
    explained = run_tool("gang", "explain", "--gang", GANG_NAME, "--url", base)
    text = explained.stdout
    head = text.splitlines()[0] if text else ""
    if released:
        ok = ", admitted" in head and "gang_admitted" in text
    else:
        ok = "gang_waiting" in text and "short " in text and "admitted" not in head
    if explained.returncode != 0 or not head.startswith(f"gang {GANG_NAME}: ") or not ok:
        tool_fail(explained, "tools.explain --gang", gang_fail)
    return {"gang_status": report["status"], "explain_head": head,
            "explain_records": sum(1 for line in text.splitlines() if line.startswith("  "))}


def extender_tools(base: str, kubeconfig: Path, journal_dir: Path, work: Path,
                   gang_fail) -> dict:
    """``tpu-doctor fleet --kubeconfig`` must list the extender from its
    lease (the endpoint the holder, the fixed HOSTNAME, on the extender's
    port), healthy, exit 0; ``tpu-doctor bundle --url --journal-dir`` must
    hold the journal's metadata."""
    import tarfile

    from k8s_device_plugin_tpu_torch.extender.leader import LEASE_NAME

    port = base.rsplit(":", 1)[1]
    out = run_tool("gang", "doctor", "fleet", "--kubeconfig", str(kubeconfig),
                   "--extender-port", port)
    rows = [line.split() for line in out.stdout.splitlines()[2:-1]]
    if (out.returncode != 0 or len(rows) != 1 or rows[0][0] != "extender"
            or rows[0][1] != f"http://{GANG_IDENTITY}:{port}" or rows[0][-1] != LEASE_NAME):
        tool_fail(out, "tpu-doctor fleet", gang_fail)
    tarball = work / "doctor-bundle.tar.gz"
    bundle = run_tool("gang", "doctor", "bundle", "--url", base, "--journal-dir",
                      str(journal_dir), "-o", str(tarball))
    if bundle.returncode != 0:
        tool_fail(bundle, "tpu-doctor bundle --journal-dir", gang_fail)
    with tarfile.open(tarball) as tar:
        journal = json.load(tar.extractfile("manifest.json")).get("journal") or {}
    if (journal.get("status") != "clean" or "admission.journal" not in journal.get("files", {})
            or journal.get("records_past_snapshot", 0) < 1):
        gang_fail(f"the doctor's bundle's journal metadata: {journal}")
    # No replay ran in the extender's process: /debug/simreport says so.
    from k8s_device_plugin_tpu_torch.extender import simulator

    report = run_tool("gang", "simreport", "report", "--url", base)
    note = simulator.debug_snapshot()["note"]
    if report.returncode != 0 or report.stdout.strip() != f"simreport: {note}":
        tool_fail(report, "tpu-simreport report --url", gang_fail)
    return {"fleet_row": rows[0], "journal": {k: journal[k] for k in (
        "status", "seq", "records_past_snapshot", "has_snapshot")},
        "simreport": report.stdout.strip()}


def phase_gang(main_report: dict) -> dict:
    """Gang admission over a daemon on the real NVML and a synthetic node:
    the lease, a gang waiting, released and fenced, the extender killed and
    recovered from its journal, a member's pod on this card, the fence
    dropping, the audit and SIGTERM."""
    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api.grpc_defs import DevicePluginStub
    from k8s_device_plugin_tpu_torch.extender import gang as gang_mod
    from tests.fake_apiserver import FakeApiServer

    work = Path(tempfile.mkdtemp(prefix="gang", dir="/tmp"))
    dp_dir = work / "dp"
    dp_dir.mkdir()
    journal_dir = work / "journal"
    api = FakeApiServer()
    kubelet = Kubelet(str(dp_dir))
    podres = PodResources(str(work / "pod-resources" / "kubelet.sock"))
    api_url = api.start()
    api.add_node(GANG_NODE)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke"}}],
    }))
    daemon_log = work / "daemon.log"
    line: dict = {"nvidia_smi": nvidia_smi()}
    channel = None
    procs: list = []
    with open(daemon_log, "w") as log_file:
        daemon = subprocess.Popen([sys.executable, "-m", "k8s_device_plugin_tpu_torch",
                                   "--device-plugin-dir", str(dp_dir), "--node-name", GANG_NODE,
                                   "--kubeconfig", str(kubeconfig),
                                   "--podresources-socket", podres.socket_path,
                                   "--metrics-port", "0"],
                                  cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    procs.append(daemon)
    try:
        def gang_fail(msg: str) -> None:
            for path in sorted(work.glob("*.log")):
                print(f"{path.name}:", path.read_text()[-3000:], file=sys.stderr, flush=True)
            fail(msg)

        def until(pred, what: str, bound_s: float = PLUGIN_WAIT_S, every_s: float = 0.002):
            """Poll ``pred`` until it gives a value: (time, value)."""
            deadline = time.monotonic() + bound_s
            while not (value := pred()):
                if time.monotonic() > deadline:
                    gang_fail(f"not seen within {bound_s} s: {what}")
                time.sleep(every_s)
            return time.monotonic(), value

        def extender(identity: str, port: int, log_name: str) -> subprocess.Popen:
            with open(work / log_name, "w") as log_file:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--node-cache",
                     "--gang-admission", "--journal-dir", str(journal_dir), "--audit-interval-s",
                     str(GANG_AUDIT_INTERVAL_S), "--decisions", "--kubeconfig", str(kubeconfig),
                     "--host", "127.0.0.1", "--port", str(port)],
                    cwd=ROOT, env=dict(os.environ, HOSTNAME=identity), stdout=log_file,
                    stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc

        def metric(base: str, name: str, **labels):
            status, body = http_get(base + "/metrics")
            if status != 200:
                return None
            try:
                return sample_value(parse_metrics(body.decode()), name, **labels)
            except ValueError as e:
                gang_fail(str(e))

        def post(base: str, path: str, body: dict) -> dict:
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        def gpu_pod(name: str, n: int, gang: bool) -> dict:
            meta = {"name": name, "namespace": "default", "uid": f"{name}-uid",
                    "annotations": {}}
            spec = {"containers": [{"name": "main", "resources": {
                "requests": {constants.RESOURCE_NAME: str(n)}}}]}
            if gang:
                meta["labels"] = {gang_mod.GANG_NAME_LABEL: GANG_NAME,
                                  gang_mod.GANG_SIZE_LABEL: "2"}
                spec["schedulingGates"] = [{"name": gang_mod.GATE_NAME}]
            return {"metadata": meta, "spec": spec, "status": {"phase": "Pending"}}

        members = [f"{GANG_NAME}-{i}" for i in range(2)]
        competitor = gpu_pod("competitor", 1, gang=False)
        both = {"nodenames": [GANG_NODE, GANG_HGX]}

        def gated(name: str) -> bool:
            return gang_mod.is_gated(api.pods[("default", name)])

        def filtered(base: str) -> dict:
            return post(base, "/filter", {"pod": competitor, **both})

        def lease_holder() -> str:
            return api.leases[LEASE_KEY]["spec"].get("holderIdentity", "")

        def bind(name: str, node: str) -> None:
            """The scheduler's bind of a member, as a watch sees it."""
            pod = json.loads(json.dumps(api.pods[("default", name)]))
            pod["spec"]["nodeName"] = node
            pod["status"] = {"phase": "Running"}
            api.update_pod(pod)

        # The daemon publishes the card's node; the synthetic node has as
        # many cards, none free.
        _, req, _ = kubelet.next_registration()
        _, raw = until(lambda: api.nodes[GANG_NODE]["metadata"].get("annotations", {}).get(
            constants.TOPOLOGY_ANNOTATION), "the node's nvidia.com/gpu-topology annotation")
        topo = json.loads(raw)
        count = topo["chip_count"]
        line["node"] = {"cards": count, "available": len(topo["available"])}
        if count < 1 or len(topo["available"]) != count:
            gang_fail(f"the node's annotation before any allocation: {topo}")
        api.add_node(GANG_HGX, {"metadata": {"name": GANG_HGX, "labels": {}, "annotations": {
            constants.TOPOLOGY_ANNOTATION: hgx_annotation(GANG_HGX, 19, [], count)}}})

        # 1. The start: the lease, then /readyz; a second replica exits
        # nonzero and leaves the holder as it was.
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        t_start = time.monotonic()
        ext = extender(GANG_IDENTITY, port, "extender.log")
        t_lease, _ = until(lambda: metric(base, "tpu_extender_lease_held") == 1,
                           "tpu_extender_lease_held 1")
        t_ready, _ = until(lambda: http_get(base + "/readyz")[0] == 200, "/readyz 200")
        line["start_to_lease_s"] = t_lease - t_start
        line["start_to_readyz_s"] = t_ready - t_start
        # The static loop inventory was built before /readyz; the first
        # sweep (on the admission tick) runs loop_inventory over it.
        _, first = until(lambda: (snap := json.loads(http_get(base + "/debug/audit")[1]))
                         .get("sweeps", 0) >= 1 and snap, "the first audit sweep", every_s=0.05)
        line["first_sweep"] = {"sweeps_seen": first["sweeps"],
                               "ms": first["last_duration_ms"] if first["sweeps"] == 1 else None,
                               "findings": first["findings"], "errors": first["errors"],
                               "loop_inventory_ms": loop_inventory_ms(work / "extender.log")}
        if (first["findings"] or first["errors"] or line["first_sweep"]["loop_inventory_ms"] is None
                or "loop_inventory" not in {i["name"] for i in first["invariants"]}):
            gang_fail(f"the first audit sweep: {line['first_sweep']}, invariants "
                      f"{[i['name'] for i in first['invariants']]}")
        second = extender(GANG_SECOND, free_port(), "second.log")
        t0 = time.monotonic()
        second_rc = second.wait(timeout=PLUGIN_WAIT_S)
        line["second_replica"] = {"rc": second_rc, "exit_s": time.monotonic() - t0,
                                  "holder": lease_holder()}
        if second_rc == 0 or lease_holder() != GANG_IDENTITY:
            gang_fail(f"a second replica: {line['second_replica']}")

        # 2. The gang arrives while the synthetic node has no free card: it
        # waits, gated. The node watch opens after the relist's first
        # interval; the release below is timed through it.
        until(lambda: any(m == "GET" and p.startswith("/api/v1/nodes?") and "watch=true" in p
                          for m, p in list(api.requests)), "the extender's node watch")
        for name in members:
            api.add_pod(gpu_pod(name, count, gang=True))

        def waiting_record():
            status, body = http_get(base + "/debug/decisions?kind=gang_waiting")
            recs = json.loads(body).get("records", []) if status == 200 else []
            return [r for r in recs if r.get("gang") == f"default/{GANG_NAME}"]
        _, recs = until(lambda: metric(base, "tpu_gang_waiting", tier="standard") == 1
                        and waiting_record(), "tpu_gang_waiting 1 and a gang_waiting record")
        line["waiting"] = {"shortfall": recs[-1]["message"]}
        if not all(gated(n) for n in members):
            gang_fail("a member of the waiting gang lost its gate")
        line["tools"] = {"waiting": gang_tools(base, kubeconfig, count, False, gang_fail)}

        # 3. The synthetic node's cards come free: the gang is released and
        # fenced; a 1-card competitor is rejected on both nodes.
        t_patch = time.monotonic()
        api.add_node(GANG_HGX, {"metadata": {"name": GANG_HGX, "labels": {}, "annotations": {
            constants.TOPOLOGY_ANNOTATION: hgx_annotation(GANG_HGX, 19, range(count), count)}}})
        t_released, _ = until(lambda: not any(gated(n) for n in members),
                              "the gang's gates removed")
        line["free_to_released_s"] = t_released - t_patch
        def fenced_out(answer: dict) -> bool:
            """The competitor rejected on both nodes for the gang's hold."""
            failed = answer["failedNodes"]
            return (not answer["nodenames"] and set(failed) == {GANG_NODE, GANG_HGX}
                    and all("reserved for a released gang" in m for m in failed.values()))

        fenced = filtered(base)
        line["fence"] = {"passed": fenced["nodenames"], "failed": fenced["failedNodes"]}
        if not fenced_out(fenced):
            gang_fail(f"the competitor against the released gang: {line['fence']}")
        line["tools"]["released"] = gang_tools(base, kubeconfig, count, True, gang_fail)
        line["tools"].update(extender_tools(base, kubeconfig, journal_dir, work, gang_fail))

        # 4. SIGKILL before any member binds; the restart replays the
        # journal (/readyz reads "replaying" first) and the fence stands.
        ext.kill()
        ext.wait()
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        phases = []
        t_restart = time.monotonic()
        ext = extender(GANG_IDENTITY, port, "restarted.log")

        def ready_again():
            status, body = http_get(base + "/readyz")
            if status:
                phases.append(json.loads(body).get("phase"))
            return status == 200
        t_ready2, _ = until(ready_again, "/readyz 200 after the restart", every_s=0.0005)
        line["restart_to_readyz_s"] = t_ready2 - t_restart
        line["restart_phases"] = sorted(set(phases), key=phases.index)
        if "replaying" not in phases or phases.index("replaying") > phases.index("ready"):
            gang_fail(f"/readyz phases after the restart: {phases}")
        refenced = filtered(base)
        line["recovered"] = {"failed": refenced["failedNodes"],
                             "rehydrations": metric(base, "tpu_extender_state_rehydrations_total",
                                                    outcome="clean")}
        if not fenced_out(refenced):
            gang_fail(f"the fence after the restart: {line['recovered']}")
        # The gauge is published at the end of the restarted loop's first tick.
        _, line["recovered"]["reserved_chips"] = until(
            lambda: (v := metric(base, "tpu_gang_reserved_chips")) == 2 * count and v,
            f"tpu_gang_reserved_chips {2 * count} after the restart")

        # 5. Member 0 binds on this card's node: the stand-in kubelet's
        # Allocate through the daemon, then its pod on the allocated card.
        channel = grpc.insecure_channel(f"unix:{dp_dir / req.endpoint}")
        launches = run_member_pod(DevicePluginStub(channel), podres, bind, members[0], GANG_NODE,
                                  topo["available"], count, main_report, line, fail)

        # 6. Member 1 binds on the synthetic node: the hold drops and the
        # competitor passes there.
        t_bind = time.monotonic()
        bind(members[1], GANG_HGX)
        t_drop, _ = until(lambda: metric(base, "tpu_gang_reservations") == 0
                          and GANG_HGX in filtered(base)["nodenames"],
                          "the hold dropped and the competitor passing")
        line["bind_to_fence_dropped_s"] = t_drop - t_bind

        # 7. The audit swept at least twice, every sweep clean; SIGTERM ends
        # both processes with code 0 and clears the lease's holder.
        def audited():
            status, body = http_get(base + "/debug/audit")
            snap = json.loads(body) if status == 200 else {}
            return snap.get("sweeps", 0) >= 2 and snap
        _, audit_snap = until(audited, "two audit sweeps", every_s=0.1)
        outcomes = {o: metric(base, "tpu_audit_sweeps_total", outcome=o)
                    for o in ("clean", "findings", "error")}
        line["audit"] = {"sweeps": audit_snap["sweeps"], "outcomes": outcomes,
                         "findings": audit_snap["findings"], "errors": audit_snap["errors"],
                         "invariants": [i["name"] for i in audit_snap["invariants"]],
                         "restart_loop_inventory_ms": loop_inventory_ms(work / "restarted.log")}
        if (audit_snap["findings"] or audit_snap["errors"] or outcomes["findings"]
                or outcomes["error"] or (outcomes["clean"] or 0) < 2
                or "loop_inventory" not in line["audit"]["invariants"]):
            gang_fail(f"the audit: {line['audit']}")
        t0 = time.monotonic()
        ext.send_signal(signal.SIGTERM)
        ext_rc = ext.wait(timeout=PLUGIN_WAIT_S)
        line["extender_sigterm_to_exit_s"] = time.monotonic() - t0
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=PLUGIN_WAIT_S)
        line["rc"] = {"extender": ext_rc, "daemon": rc}
        line["lease_holder_after"] = lease_holder()
        emit({"gang": line})
        if ext_rc != 0 or rc != 0 or lease_holder() != "":
            gang_fail(f"SIGTERM: the extender exited {ext_rc}, the daemon {rc}; the lease's "
                      f"holder reads {lease_holder()!r}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if channel is not None:
            channel.close()
        kubelet.server.stop(grace=0)
        podres.server.stop(grace=0)
        api.stop()
        shutil.rmtree(work, ignore_errors=True)
    return launches


SHARDS = 2
SHARD_LEASE_S = 6
SHARD_RESYNC_S = 1
SHARD_IDENTITY = "nvidia-scheduler-extender-{}"
SHARD_DUP = "nvidia-scheduler-extender-dup"
SHARD_SY_CARDS = 8
SHARD_POLL_S = 0.01
# The peer scan's period (the manager's max(1, lease / 3)): the overlay's
# staleness is at most one scan after the publish.
SHARD_SCAN_S = max(1.0, SHARD_LEASE_S / 3.0)
# A reserve wakes the publisher at once; the lease's own renew (lease / 3
# or less) would publish up to 1.33 s late.
SHARD_PUBLISH_LIMIT_S = 0.5
SHARD_STALENESS_LIMIT_S = SHARD_SCAN_S + SHARD_PUBLISH_LIMIT_S
AGE_SLACK_S = 0.5  # a hold's age_s is rounded to 0.1 s and read over HTTP


def allocate_and_bind(stub, podres, bind, member: str, node: str, ids) -> dict:
    """A released gang member's admission on this card: the stand-in
    kubelet's ``Allocate`` of ``ids`` through the daemon, its PodResources
    entry (none with ``podres`` None: the caller records it), the member
    bound to ``node``. Returns its container's env: the response's, with
    ``CUDA_VISIBLE_DEVICES`` from ``NVIDIA_VISIBLE_DEVICES``."""
    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb

    areq = pb.AllocateRequest()
    areq.container_requests.add(devicesIDs=ids)
    resp = stub.Allocate(areq, timeout=PLUGIN_WAIT_S).container_responses[0]
    env = dict(resp.envs)
    if podres is not None:
        podres.set("default", member, ids)
    bind(member, node)
    pod_env = dict(os.environ, **env)
    pod_env["CUDA_VISIBLE_DEVICES"] = env[constants.NVIDIA_VISIBLE_DEVICES]
    return pod_env


def run_member_pod(stub, podres, bind, member: str, node: str, ids, count: int,
                   main_report: dict, line: dict, fail_with) -> dict:
    """A released gang member's pod on this card: ``allocate_and_bind``,
    then ``workload.smoke --bench --steps 5`` in its own process with the
    container's env. It must report ok on ``count`` cards, on an allocated
    one, each flash kernel and delta launched ``n_layers`` times a step it
    ran (its own counts) and the RMSNorm kernel not at all. The report's
    launch counts are returned."""
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    t_alloc = time.monotonic()
    pod_env = allocate_and_bind(stub, podres, bind, member, node, ids)
    pod = subprocess.Popen([sys.executable, *DRA_POD_ARGS], cwd=ROOT, env=pod_env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    report = None
    try:
        for raw_line in pod.stdout:
            if raw_line.startswith("{") and "partial" not in (snap := json.loads(raw_line)):
                report = snap
                line["allocate_to_report_s"] = time.monotonic() - t_alloc
        rc = pod.wait(timeout=60)
        err = pod.stderr.read()
    finally:
        if pod.poll() is None:
            pod.kill()
            pod.wait()
        pod.stdout.close()
        pod.stderr.close()
    if rc != 0 or report is None:
        print(err[-4000:], file=sys.stderr, flush=True)
        fail_with(f"{member}'s pod exited {rc} with report {report}")
    launches = report["kernel_launches"]
    line["pod"] = {k: report.get(k) for k in (
        "ok", "device_kind", "device_uuid", "expected_devices", "devices_match", "steps_run",
        "time_to_devices_s", "step_time_s", "mfu", "first_loss", "kernel_launches")}
    line["main_path_step_time_s"] = main_report.get("step_time_s")
    if not (report["ok"] and report["expected_devices"] == count and report["devices_match"]):
        fail_with(f"{member}'s pod is not ok: {line['pod']}")
    if report.get("device_uuid") not in ids:
        fail_with(f"{member}'s pod ran on {report.get('device_uuid')}, not on an allocated "
                  f"card {ids}")
    want = bench_pod_launches(report["steps_run"])
    if launches != want:
        fail_with(f"{member}'s pod launched {launches}, expected {want}")
    return launches


def phase_shards(main_report: dict) -> dict:
    """Sharded gang admission over a daemon on the real NVML: two extender
    replicas of two shards, the overlay, a SIGKILL stalling only its shard,
    the takeover replaying its journal, a taken-over gang's member on this
    card, the handback, the audits and SIGTERM."""
    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api.grpc_defs import DevicePluginStub
    from k8s_device_plugin_tpu_torch.extender import gang as gang_mod
    from k8s_device_plugin_tpu_torch.extender.holdscodec import decode_holds
    from k8s_device_plugin_tpu_torch.extender.sharding import (
        HOLDS_ANNOTATION, ShardRing, pick_key, shard_lease_name, standby_lease_name)
    from tests.fake_apiserver import FakeApiServer

    node = os.uname().nodename  # the card machine's own name, as the daemon's default
    ring = ShardRing(SHARDS)
    x = ring.shard_of(node)
    y = 1 - x
    sx = pick_key(ring, x, "hgx-sx-{0:03d}")
    sy = pick_key(ring, y, "hgx-sy-{0:03d}")
    g_x, g_y, g_y2 = (pick_key(ring, s, f"default/{p}-{{0:03d}}").split("/", 1)[1]
                      for s, p in ((x, "gx"), (y, "gy"), (y, "gy2")))
    work = Path(tempfile.mkdtemp(prefix="shard", dir="/tmp"))
    dp_dir = work / "dp"
    dp_dir.mkdir()
    journal_dir = work / "journal"
    api = FakeApiServer()
    kubelet = Kubelet(str(dp_dir))
    podres = PodResources(str(work / "pod-resources" / "kubelet.sock"))
    api_url = api.start()
    api.add_node(node)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke"}}],
    }))
    line: dict = {"nvidia_smi": nvidia_smi(), "node": node, "x": x, "y": y,
                  "nodes": {"sx": sx, "sy": sy}, "gangs": {"x": g_x, "y": g_y, "y2": g_y2}}
    channel = None
    procs: list = []
    with open(work / "daemon.log", "w") as log_file:
        daemon = subprocess.Popen([sys.executable, "-m", "k8s_device_plugin_tpu_torch",
                                   "--device-plugin-dir", str(dp_dir), "--node-name", node,
                                   "--kubeconfig", str(kubeconfig),
                                   "--podresources-socket", podres.socket_path,
                                   "--metrics-port", "0"],
                                  cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    procs.append(daemon)
    try:
        def shard_fail(msg: str) -> None:
            for path in sorted(work.glob("*.log")):
                print(f"{path.name}:", path.read_text()[-3000:], file=sys.stderr, flush=True)
            fail(msg)

        def until(pred, what: str, bound_s: float = PLUGIN_WAIT_S,
                  every_s: float = SHARD_POLL_S):
            """Poll ``pred`` until it gives a value: (time, value)."""
            deadline = time.monotonic() + bound_s
            while not (value := pred()):
                if time.monotonic() > deadline:
                    shard_fail(f"not seen within {bound_s} s: {what}")
                time.sleep(every_s)
            return time.monotonic(), value

        def extender(shard: int, port: int, log_name: str, identity: str = "",
                     explicit_index: bool = False) -> subprocess.Popen:
            """A sharded replica whose HOSTNAME is ``identity`` (by default
            the StatefulSet pod name of ``shard``); the home shard from the
            name's ordinal unless ``explicit_index``."""
            index = ["--shard-index", str(shard)] if explicit_index else []
            with open(work / log_name, "w") as log_file:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--node-cache",
                     "--gang-admission", "--shards", str(SHARDS), *index, "--journal-dir",
                     str(journal_dir), "--audit-interval-s", str(GANG_AUDIT_INTERVAL_S),
                     "--decisions", "--lease-seconds", str(SHARD_LEASE_S), "--gang-resync-s",
                     str(SHARD_RESYNC_S), "--kubeconfig", str(kubeconfig), "--host",
                     "127.0.0.1", "--port", str(port)],
                    cwd=ROOT, env=dict(os.environ, HOSTNAME=identity or SHARD_IDENTITY.format(shard)),
                    stdout=log_file, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc

        def metric(base: str, name: str, **labels):
            status, body = http_get(base + "/metrics")
            if status != 200:
                return None
            try:
                return sample_value(parse_metrics(body.decode()), name, **labels)
            except ValueError as e:
                shard_fail(str(e))

        def readyz(base: str) -> dict:
            status, body = http_get(base + "/readyz")
            return json.loads(body) if status == 200 else {}

        def owned(base: str):
            return (readyz(base).get("shard") or {}).get("owned")

        def post(base: str, path: str, body: dict) -> dict:
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        def gpu_pod(name: str, n: int, gang: str = "") -> dict:
            meta = {"name": name, "namespace": "default", "uid": f"{name}-uid", "annotations": {}}
            spec = {"containers": [{"name": "main", "resources": {
                "requests": {constants.RESOURCE_NAME: str(n)}}}]}
            if gang:
                meta["labels"] = {gang_mod.GANG_NAME_LABEL: gang, gang_mod.GANG_SIZE_LABEL: "2"}
                spec["schedulingGates"] = [{"name": gang_mod.GATE_NAME}]
            return {"metadata": meta, "spec": spec, "status": {"phase": "Pending"}}

        def add_gang(gang: str, n: int) -> list:
            members = [f"{gang}-{i}" for i in range(2)]
            for name in members:
                api.add_pod(gpu_pod(name, n, gang))
            return members

        def released(members) -> bool:
            return not any(gang_mod.is_gated(api.pods[("default", m)]) for m in members)

        def bind(name: str, on: str) -> None:
            """The scheduler's bind of a member, as a watch sees it."""
            pod = json.loads(json.dumps(api.pods[("default", name)]))
            pod["spec"]["nodeName"] = on
            pod["status"] = {"phase": "Running"}
            api.update_pod(pod)

        def verdict(base: str, pod: dict, on: str):
            """The name-only /filter's answer for ``pod`` on ``on``: None
            passes, else the failure message."""
            answer = post(base, "/filter", {"pod": pod, "nodenames": [on]})
            return None if on in answer["nodenames"] else answer["failedNodes"].get(on, "?")

        def fenced(base: str, pod: dict, on: str):
            msg = verdict(base, pod, on)
            return msg if msg and "reserved for a released gang" in msg else None

        def holder(shard: int) -> str:
            lease = api.leases.get(("kube-system", shard_lease_name(shard, SHARDS)), {})
            return (lease.get("spec") or {}).get("holderIdentity", "")

        def published(shard: int, gang: str) -> bool:
            """``gang``'s hold on ``shard``'s lease, as a peer's scan reads it."""
            lease = api.leases.get(("kube-system", shard_lease_name(shard, SHARDS)), {})
            ann = (lease.get("metadata") or {}).get("annotations") or {}
            return any(r.get("gang") == gang for r in decode_holds(ann.get(HOLDS_ANNOTATION, "")))

        def hold_of(base: str, gang: str):
            status, body = http_get(base + "/reservations")
            holds = json.loads(body).get("holds", []) if status == 200 else []
            return next((h for h in holds if h["gang"] == gang), None)

        # The daemon publishes this card's node; SX (shard X) has as many
        # cards, none free; SY (shard Y) 8, all free.
        _, req, _ = kubelet.next_registration()
        _, raw = until(lambda: api.nodes[node]["metadata"].get("annotations", {}).get(
            constants.TOPOLOGY_ANNOTATION), "the node's nvidia.com/gpu-topology annotation")
        topo = json.loads(raw)
        count = topo["chip_count"]
        if count < 1 or len(topo["available"]) != count:
            shard_fail(f"the node's annotation before any allocation: {topo}")
        line["cards"] = count

        def hgx(name: str, index: int, free, cards: int) -> None:
            api.add_node(name, {"metadata": {"name": name, "labels": {}, "annotations": {
                constants.TOPOLOGY_ANNOTATION: hgx_annotation(name, index, free, cards)}}})
        hgx(sx, 20, [], count)
        hgx(sy, 21, range(SHARD_SY_CARDS), SHARD_SY_CARDS)

        # 1. Both replicas: the start to their shard's gauge and to /readyz,
        # each owning its home; a third replica of home X exits nonzero and
        # leaves X's holder as it was.
        ports = {s: free_port() for s in (x, y)}
        base = {s: f"http://127.0.0.1:{ports[s]}" for s in (x, y)}
        t_start = time.monotonic()
        ext = {s: extender(s, ports[s], f"extender-{s}.log", explicit_index=(s == 0))
               for s in (x, y)}
        line["start"] = {}
        for s in (x, y):
            t_owned, _ = until(lambda: metric(base[s], "tpu_extender_shard_owned",
                                              shard=str(s)) == 1,
                               f"tpu_extender_shard_owned{{shard={s}}} 1")
            t_ready, _ = until(lambda: readyz(base[s]).get("ok"), f"/readyz 200 of shard {s}")
            line["start"][str(s)] = {"to_owned_s": t_owned - t_start,
                                     "to_readyz_s": t_ready - t_start,
                                     "owned": owned(base[s])}
            if owned(base[s]) != [s] or holder(s) != SHARD_IDENTITY.format(s):
                shard_fail(f"replica {s} at ready: {readyz(base[s])}, holder {holder(s)!r}")
        dup = extender(x, free_port(), "dup.log", identity=SHARD_DUP, explicit_index=True)
        t0 = time.monotonic()
        dup_rc = dup.wait(timeout=PLUGIN_WAIT_S)
        line["duplicate"] = {"rc": dup_rc, "exit_s": time.monotonic() - t0, "holder": holder(x)}
        if dup_rc == 0 or holder(x) != SHARD_IDENTITY.format(x):
            shard_fail(f"a second replica of home {x}: {line['duplicate']}")

        # 2. G_Y (2 pods of 2 cards) goes onto SY through replica Y; replica
        # X's /filter then refuses an 8-card pod on SY for the overlay alone.
        # G_Y is submitted just after one of X's scans (seen as X's lease-age
        # gauge, which every scan rewrites, moving), so the release lands
        # early in X's scan period and the reading is near the staleness's
        # worst case, not wherever the two replicas' start phases put it.
        wide = gpu_pod("wide", SHARD_SY_CARDS)
        if verdict(base[x], wide, sy) is not None:
            shard_fail(f"an 8-card pod on the free SY before any hold: "
                       f"{verdict(base[x], wide, sy)}")
        age_x = metric(base[x], "tpu_extender_shard_lease_age_seconds", shard=str(x))
        t_scan, _ = until(lambda: metric(base[x], "tpu_extender_shard_lease_age_seconds",
                                         shard=str(x)) not in (None, age_x),
                          "a scan of replica X", bound_s=2 * SHARD_SCAN_S + 1)
        members_y = add_gang(g_y, 2)
        t_rel_y, _ = until(lambda: released(members_y), f"G_Y ({g_y}) released by replica {y}")
        t_pub, _ = until(lambda: published(y, g_y), f"G_Y's hold on shard {y}'s lease")
        t_seen, note = until(lambda: fenced(base[x], wide, sy),
                             "replica X's /filter refusing the 8-card pod on SY")
        _, peer = until(lambda: metric(base[x], "tpu_extender_shard_peer_held_chips") == 4 and 4,
                        "tpu_extender_shard_peer_held_chips 4 on replica X")
        line["overlay"] = {"x_scan_to_release_s": t_rel_y - t_scan,
                           "release_to_published_s": t_pub - t_rel_y,
                           "release_to_peer_reject_s": t_seen - t_rel_y,
                           "limit_s": SHARD_STALENESS_LIMIT_S, "note": note,
                           "peer_held_chips": peer}
        if (t_pub - t_rel_y > SHARD_PUBLISH_LIMIT_S
                or t_seen - t_rel_y > SHARD_STALENESS_LIMIT_S):
            shard_fail(f"the overlay published or read past its limit: {line['overlay']}")
        for m in members_y:
            bind(m, sy)

        # 3. G_X: member 0 asks this node's cards, member 1 SX's; it waits
        # until SX's cards come free, then replica X releases it and
        # journals the hold under shard-X/.
        members_x = add_gang(g_x, count)
        until(lambda: metric(base[x], "tpu_gang_waiting", tier="standard") == 1,
              "G_X waiting on replica X")
        t_free = time.monotonic()
        hgx(sx, 20, range(count), count)
        t_rel_x, _ = until(lambda: released(members_x), f"G_X ({g_x}) released by replica {x}")
        hold_x = hold_of(base[x], g_x)
        journal_x = journal_dir / f"shard-{x}" / "admission.journal"
        # Replica Y refuses a 1-card competitor on this node for X's overlay.
        competitor = gpu_pod("competitor", 1)
        t_seen_x, _ = until(lambda: fenced(base[y], competitor, node),
                            "replica Y's /filter refusing the competitor on this node")
        line["gang_x"] = {"free_to_released_s": t_rel_x - t_free, "hold": hold_x,
                          "release_to_peer_reject_s": t_seen_x - t_rel_x,
                          "journal_bytes": journal_x.stat().st_size if journal_x.exists() else 0}
        if not hold_x or sum(hold_x["hosts"].values()) != 2 * count or not line["gang_x"][
                "journal_bytes"]:
            shard_fail(f"G_X's hold on replica X and its journal: {line['gang_x']}")

        # 4. SIGKILL replica X before any member binds; G_Y2 then goes onto
        # SY through replica Y before Y owns shard X, and the dead shard's
        # overlay still fences this node.
        ext[x].kill()
        ext[x].wait()
        t_kill = time.monotonic()
        stall_note = fenced(base[y], competitor, node)
        members_y2 = add_gang(g_y2, 2)
        t_rel_y2, _ = until(lambda: released(members_y2), f"G_Y2 ({g_y2}) released")
        owned_at_y2 = owned(base[y])
        takeovers_at_y2 = metric(base[y], "tpu_extender_shard_takeovers_total", shard=str(x))
        line["stall"] = {"kill_to_y2_released_s": t_rel_y2 - t_kill, "owned": owned_at_y2,
                         "takeovers": takeovers_at_y2, "competitor_note": stall_note}
        if owned_at_y2 != [y] or takeovers_at_y2 or not stall_note:
            shard_fail(f"G_Y2 against the stalled shard: {line['stall']}")
        for m in members_y2:
            bind(m, sy)

        # 5. Replica Y takes shard X over and replays shard-X/: G_X's hold
        # back, the competitor refused on this node.
        t_to, _ = until(lambda: metric(base[y], "tpu_extender_shard_takeovers_total",
                                       shard=str(x)) == 1,
                        f"tpu_extender_shard_takeovers_total{{shard={x}}} 1 on replica Y",
                        every_s=0.05)
        t_both, _ = until(lambda: owned(base[y]) == sorted((x, y)), "replica Y owning both",
                          every_s=0.05)
        # One gauge for the process: each shard's admitter sets it at its
        # tick's end, so it reads G_X's demand after the taken-over shard's.
        _, reserved = until(lambda: (v := metric(base[y], "tpu_gang_reserved_chips")) == 2 * count
                            and v, f"tpu_gang_reserved_chips {2 * count} on replica Y")
        t_read = time.monotonic()
        hold_y = hold_of(base[y], g_x)
        note_y = fenced(base[y], competitor, node)
        line["takeover"] = {"kill_to_takeover_s": t_to - t_kill, "kill_to_owned_s": t_both - t_kill,
                            "bound_s": 2 * SHARD_LEASE_S + SHARD_LEASE_S / 3,
                            "reserved_chips": reserved, "hold": hold_y, "competitor_note": note_y}
        if (t_to - t_kill > 2 * SHARD_LEASE_S + SHARD_LEASE_S / 3 or not hold_y
                or hold_y["hosts"] != hold_x["hosts"] or not note_y
                or hold_y["age_s"] < t_read - t_rel_x - AGE_SLACK_S):
            shard_fail(f"the takeover: {line['takeover']}")

        # 6. Member 0 binds on this card's node: its pod on the allocated card.
        channel = grpc.insecure_channel(f"unix:{dp_dir / req.endpoint}")
        launches = run_member_pod(DevicePluginStub(channel), podres, bind, members_x[0], node,
                                  topo["available"], count, main_report, line, shard_fail)

        # 7. Replica X again, same HOSTNAME and journal dir: it stands by,
        # Y hands shard X back, and X owns it with G_X's hold at its first
        # age; member 1 binds on SX and the hold drops.
        ports[x] = free_port()
        base[x] = f"http://127.0.0.1:{ports[x]}"
        t_restart = time.monotonic()
        ext[x] = extender(x, ports[x], f"restarted-{x}.log", explicit_index=(x == 0))
        standby_seen = []

        def handed_back():
            lease = api.leases.get(("kube-system", standby_lease_name(x, SHARDS)), {})
            if (lease.get("spec") or {}).get("holderIdentity"):
                standby_seen.append(True)
            return owned(base[x]) == [x] and owned(base[y]) == [y]
        t_back, _ = until(handed_back, "shard X handed back to replica X", every_s=0.05)
        t_read, hold_back = until(lambda: hold_of(base[x], g_x), "G_X's hold on replica X again")
        line["handback"] = {"restart_to_owned_s": t_back - t_restart, "standby_seen": any(
            standby_seen), "hold": hold_back, "released_to_read_s": t_read - t_rel_x}
        if (not standby_seen or hold_back["age_s"] < t_read - t_rel_x - AGE_SLACK_S
                or holder(x) != SHARD_IDENTITY.format(x)):
            shard_fail(f"the handback: {line['handback']}")
        t_bind = time.monotonic()
        bind(members_x[1], sx)
        t_drop, _ = until(lambda: metric(base[x], "tpu_gang_reservations") == 0
                          and verdict(base[x], competitor, sx) is None,
                          "G_X's hold dropped and the competitor passing on SX")
        line["bind_to_fence_dropped_s"] = t_drop - t_bind

        # 8. Two clean audit sweeps or more on each replica, the ownership
        # invariant among them.
        line["audit"] = {}
        for s in (x, y):
            def audited():
                status, body = http_get(base[s] + "/debug/audit")
                snap = json.loads(body) if status == 200 else {}
                return snap.get("sweeps", 0) >= 2 and snap
            _, snap = until(audited, f"two audit sweeps on replica {s}", every_s=0.1)
            outcomes = {o: metric(base[s], "tpu_audit_sweeps_total", outcome=o)
                        for o in ("clean", "findings", "error")}
            names = [i["name"] for i in snap["invariants"]]
            line["audit"][str(s)] = {"sweeps": snap["sweeps"], "outcomes": outcomes,
                                     "findings": snap["findings"], "errors": snap["errors"],
                                     "invariants": names}
            if (snap["findings"] or snap["errors"] or outcomes["findings"] or outcomes["error"]
                    or (outcomes["clean"] or 0) < 2 or "reservation_shard_ownership" not in names):
                shard_fail(f"the audit on replica {s}: {line['audit'][str(s)]}")

        # 9. The self-test.
        t0 = time.monotonic()
        self_test = subprocess.run([sys.executable, "-m",
                                    "k8s_device_plugin_tpu_torch.extender.sharding",
                                    "--shard-self-test"], cwd=ROOT, capture_output=True,
                                   text=True, timeout=PLUGIN_WAIT_S)
        line["self_test"] = {"rc": self_test.returncode, "s": time.monotonic() - t0}
        if self_test.returncode != 0:
            print(self_test.stdout[-2000:], self_test.stderr[-2000:], file=sys.stderr)
            shard_fail(f"--shard-self-test exited {self_test.returncode}")

        # 10. SIGTERM: both replicas and the daemon exit 0, every shard and
        # standby lease released.
        t0 = time.monotonic()
        for proc in (*ext.values(), daemon):
            proc.send_signal(signal.SIGTERM)
        rcs = {str(s): ext[s].wait(timeout=PLUGIN_WAIT_S) for s in (x, y)}
        rcs["daemon"] = daemon.wait(timeout=PLUGIN_WAIT_S)
        line["sigterm_s"] = time.monotonic() - t0
        line["rc"] = rcs
        leases = {name: (lease.get("spec") or {}).get("holderIdentity", "")
                  for (_, name), lease in api.leases.items()}
        line["leases_after"] = leases
        line["phase_s"] = time.monotonic() - t_start
        emit({"shards": line})
        if any(rcs.values()) or any(leases.values()) or len(leases) < SHARDS + 1:
            shard_fail(f"SIGTERM: exits {rcs}, lease holders {leases}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if channel is not None:
            channel.close()
        kubelet.server.stop(grace=0)
        podres.server.stop(grace=0)
        api.stop()
        shutil.rmtree(work, ignore_errors=True)
    return launches


PREEMPT_NODE = "preempt-node"
PREEMPT_HGX = "preempt-hgx"
PREEMPT_RESYNC_S = 1
PREEMPT_SYN_CARDS = 8
# The classes of the phase: the victims' and the preemptor's.
PREEMPT_CLASSES = {"batch": -10, "prod": 1_000_000}
# Checkpoint ages stamped on the victims: V_card saved a minute ago, V_syn
# fifty minutes ago (the costlier victim).
VICTIM_CKPT_AGE_S = {"card": 60.0, "syn": 3000.0}
# Enough steps (about 0.2 s each at bench widths) that the victim's pod is
# still stepping when it is evicted; it is stopped there, not run out.
VICTIM_POD_ARGS = ("-m", "k8s_device_plugin_tpu_torch.workload.smoke", "--bench", "--steps",
                   "600")
STANDARD_WAIT_TICKS = 3


def phase_preemption(main_report: dict) -> dict:
    """Preemption on the card: a batch gang's pod running the kernels is
    evicted for a critical gang, whose pod then runs on the same card."""
    import grpc

    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api.grpc_defs import DevicePluginStub
    from k8s_device_plugin_tpu_torch.extender import gang as gang_mod
    from k8s_device_plugin_tpu_torch.kube.client import KubeClient
    from k8s_device_plugin_tpu_torch.utils import statestore
    from k8s_device_plugin_tpu_torch.workload.beacon import CheckpointBeacon
    from tests.fake_apiserver import FakeApiServer

    work = Path(tempfile.mkdtemp(prefix="pre", dir="/tmp"))
    dp_dir = work / "dp"
    dp_dir.mkdir()
    journal_dir = work / "journal"
    api = FakeApiServer()
    kubelet = Kubelet(str(dp_dir))
    podres = PodResources(str(work / "pod-resources" / "kubelet.sock"))
    api_url = api.start()
    api.add_node(PREEMPT_NODE)
    for name, value in PREEMPT_CLASSES.items():
        api.add_priority_class(name, value)
    client = KubeClient(api_url)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
        "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke"}}],
    }))
    line: dict = {"nvidia_smi": nvidia_smi()}
    t_phase = time.monotonic()
    channel = None
    procs: list = []
    with open(work / "daemon.log", "w") as log_file:
        daemon = subprocess.Popen([sys.executable, "-m", "k8s_device_plugin_tpu_torch",
                                   "--device-plugin-dir", str(dp_dir), "--node-name",
                                   PREEMPT_NODE, "--kubeconfig", str(kubeconfig),
                                   "--podresources-socket", podres.socket_path,
                                   "--metrics-port", "0"],
                                  cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    procs.append(daemon)
    try:
        def preempt_fail(msg: str) -> None:
            for path in sorted(work.glob("*.log")):
                print(f"{path.name}:", path.read_text()[-3000:], file=sys.stderr, flush=True)
            fail(msg)

        def until(pred, what: str, bound_s: float = PLUGIN_WAIT_S, every_s: float = 0.002):
            """Poll ``pred`` until it gives a value: (time, value)."""
            deadline = time.monotonic() + bound_s
            while not (value := pred()):
                if time.monotonic() > deadline:
                    preempt_fail(f"not seen within {bound_s} s: {what}")
                time.sleep(every_s)
            return time.monotonic(), value

        def metric(name: str, **labels):
            status, body = http_get(base + "/metrics")
            if status != 200:
                return None
            try:
                return sample_value(parse_metrics(body.decode()), name, **labels)
            except ValueError as e:
                preempt_fail(str(e))

        def gpu_pod(name: str, gang: str, size: int, n: int, class_name: str = "",
                    node: str = "") -> dict:
            """A pod of ``n`` cards: a gated member of ``gang`` (of ``size``),
            or, bound to ``node``, a running one; a bare pod without
            ``gang``."""
            meta = {"name": name, "namespace": "default", "uid": f"{name}-uid",
                    "annotations": {}}
            spec = {"containers": [{"name": "main", "resources": {
                "requests": {constants.RESOURCE_NAME: str(n)}}}]}
            status = {"phase": "Pending"}
            if gang:
                meta["labels"] = {gang_mod.GANG_NAME_LABEL: gang,
                                  gang_mod.GANG_SIZE_LABEL: str(size)}
                if node:
                    spec["nodeName"] = node
                    status = {"phase": "Running"}
                else:
                    spec["schedulingGates"] = [{"name": gang_mod.GATE_NAME}]
            if class_name:
                spec["priorityClassName"] = class_name
            return {"metadata": meta, "spec": spec, "status": status}

        def gated(name: str) -> bool:
            return gang_mod.is_gated(api.pods[("default", name)])

        def bind(name: str, node: str) -> None:
            """The scheduler's bind of a member, as a watch sees it."""
            pod = json.loads(json.dumps(api.pods[("default", name)]))
            pod["spec"]["nodeName"] = node
            pod["status"] = {"phase": "Running"}
            api.update_pod(pod)

        def stamp_checkpoint(name: str, age_s: float) -> None:
            """A save ``age_s`` ago, stamped through the port's beacon over
            the kube client."""
            ts = time.time() - age_s
            beacon = CheckpointBeacon(lambda ann: client.patch_pod_annotations(
                "default", name, {k: str(ts) for k in ann}))
            if not beacon.note_saved(0):
                preempt_fail(f"the checkpoint beacon could not stamp {name}")

        # The daemon publishes this card's node N; the synthetic node S has
        # 8 cards, none free.
        _, req, _ = kubelet.next_registration()
        _, raw = until(lambda: api.nodes[PREEMPT_NODE]["metadata"].get("annotations", {}).get(
            constants.TOPOLOGY_ANNOTATION), "the node's nvidia.com/gpu-topology annotation")
        topo = json.loads(raw)
        count = topo["chip_count"]
        ids = topo["available"]
        line["node"] = {"cards": count, "available": len(ids)}
        if count < 1 or len(ids) != count:
            preempt_fail(f"the node's annotation before any allocation: {topo}")
        api.add_node(PREEMPT_HGX, {"metadata": {"name": PREEMPT_HGX, "labels": {},
                                                "annotations": {
            constants.TOPOLOGY_ANNOTATION: hgx_annotation(PREEMPT_HGX, 21, [],
                                                          PREEMPT_SYN_CARDS)}}})
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        with open(work / "extender.log", "w") as log_file:
            ext = subprocess.Popen(
                [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--node-cache",
                 "--gang-admission", "--journal-dir", str(journal_dir), "--audit-interval-s",
                 str(GANG_AUDIT_INTERVAL_S), "--decisions", "--gang-resync-s",
                 str(PREEMPT_RESYNC_S), "--kubeconfig", str(kubeconfig), "--host", "127.0.0.1",
                 "--port", str(port)],
                cwd=ROOT, env=dict(os.environ, HOSTNAME=GANG_IDENTITY), stdout=log_file,
                stderr=subprocess.STDOUT)
        procs.append(ext)
        until(lambda: http_get(base + "/readyz")[0] == 200, "/readyz 200")
        until(lambda: any(m == "GET" and p.startswith("/api/v1/nodes?") and "watch=true" in p
                          for m, p in list(api.requests)), "the extender's node watch")
        apps_before = len(compute_apps())
        line["compute_apps_before"] = apps_before

        # 1. Two running batch victims. V_card: one member of c cards,
        # released onto N, allocated and bound, its pod stepping on the
        # card. V_syn: two 4-card pods bound to S, holding all its cards.
        v_card, v_syn = "vcard", "vsyn"
        v_member = f"{v_card}-0"
        api.add_pod(gpu_pod(v_member, v_card, 1, count, "batch"))
        until(lambda: not gated(v_member), "V_card's gate removed")
        syn_members = [f"{v_syn}-{i}" for i in range(2)]
        for name in syn_members:
            api.add_pod(gpu_pod(name, v_syn, 2, PREEMPT_SYN_CARDS // 2, "batch",
                                node=PREEMPT_HGX))
        channel = grpc.insecure_channel(f"unix:{dp_dir / req.endpoint}")
        stub = DevicePluginStub(channel)
        victim_env = allocate_and_bind(stub, podres, bind, v_member, PREEMPT_NODE, ids)
        with open(work / "victim.log", "w") as log_file:
            victim = subprocess.Popen([sys.executable, *VICTIM_POD_ARGS], cwd=ROOT,
                                      env=victim_env, text=True, stdout=subprocess.PIPE,
                                      stderr=log_file)
        procs.append(victim)
        victim_lines: list = []
        stepping = threading.Event()

        def read_victim() -> None:
            for raw_line in victim.stdout:
                victim_lines.append(raw_line)
                if raw_line.startswith("{") and json.loads(raw_line).get("partial") == \
                        "first_step":
                    stepping.set()

        reader = threading.Thread(target=read_victim, daemon=True)
        reader.start()
        t0 = time.monotonic()
        if not stepping.wait(PLUGIN_WAIT_S):
            preempt_fail(f"V_card's pod did not step within {PLUGIN_WAIT_S} s: "
                         f"{victim_lines[-3:]} {victim.poll()}")
        line["victim_start_to_first_step_s"] = time.monotonic() - t0
        stamp_checkpoint(v_member, VICTIM_CKPT_AGE_S["card"])
        for name in syn_members:
            stamp_checkpoint(name, VICTIM_CKPT_AGE_S["syn"])
        until(lambda: metric("tpu_gang_reservations") == 0, "V_card's hold dropped after its bind")

        # 2. A standard-tier gang cannot preempt: Q stays gated over three
        # ticks, nothing is evicted, and it waits under the standard tier.
        q = "qstd-0"
        api.add_pod(gpu_pod(q, "qstd", 1, count))
        until(lambda: metric("tpu_gang_waiting", tier="standard") == 1,
              "tpu_gang_waiting{tier=standard} 1")

        def ticks():
            return sum(metric("tpu_gang_ticks_total", mode=m) or 0 for m in ("full", "dirty"))
        t_q = ticks()
        until(lambda: ticks() >= t_q + STANDARD_WAIT_TICKS, f"{STANDARD_WAIT_TICKS} more ticks",
              every_s=0.05)
        line["standard"] = {"gated": gated(q), "evictions": len(api.evictions),
                            "waiting": metric("tpu_gang_waiting", tier="standard")}
        if not gated(q) or api.evictions or line["standard"]["waiting"] != 1:
            preempt_fail(f"the standard-tier gang: {line['standard']}")
        api.delete_pod("default", q)

        # 3. The verb is a dry run: a bare prod pod of c cards names N with
        # V_card's member alone, and nothing is evicted.
        bare = gpu_pod("bare", "", 1, count, "prod")
        req_ = urllib.request.Request(base + "/preemption",
                                      data=json.dumps({"pod": bare}).encode(),
                                      headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req_, timeout=30) as resp:
            verb = json.loads(resp.read())["nodeNameToMetaVictims"]
        line["verb"] = verb
        if (set(verb) != {PREEMPT_NODE}
                or [p["uid"] for p in verb[PREEMPT_NODE]["pods"]] != [f"{v_member}-uid"]
                or api.evictions):
            preempt_fail(f"the /preemption dry run: {verb}, evictions {api.evictions}")

        # 5's stand-in kubelet: on seeing V_card's pod deleted it sends
        # SIGTERM to its process and clears its PodResources entry.
        killed: dict = {}

        def kubelet_kill() -> None:
            while ("default", v_member) in api.pods:
                time.sleep(0.002)
            killed["t"] = time.monotonic()
            killed["stepping"] = victim.poll() is None
            victim.send_signal(signal.SIGTERM)
            podres.drop("default", v_member)

        killer = threading.Thread(target=kubelet_kill, daemon=True)
        killer.start()

        # 4. The round: G_P, gated, one member of c cards of class prod.
        g_p = "gprod"
        p_member = f"{g_p}-0"
        t_submit = time.monotonic()
        api.add_pod(gpu_pod(p_member, g_p, 1, count, "prod"))
        t_evicted, _ = until(lambda: ("default", v_member) in api.evictions,
                             "V_card's eviction", bound_s=PREEMPT_RESYNC_S + 10)  # a timeout
        t_released, _ = until(lambda: not gated(p_member), "G_P's gates removed")
        line["submit_to_eviction_s"] = t_evicted - t_submit
        line["submit_to_released_s"] = t_released - t_submit
        line["eviction_to_released_s"] = t_released - t_evicted
        # The limits of PERF.md §2: the round plans and evicts on the tick
        # after the watch marks G_P dirty, and releases it in that same tick.
        if line["submit_to_eviction_s"] > PREEMPT_RESYNC_S + 1:
            preempt_fail(f"submission to V_card's eviction {line['submit_to_eviction_s']:.3f} s, "
                         f"over --gang-resync-s + 1 s")
        if line["eviction_to_released_s"] > PREEMPT_RESYNC_S:
            preempt_fail(f"V_card's eviction to G_P's gates gone "
                         f"{line['eviction_to_released_s']:.3f} s, over one tick")
        evicted = sorted(name for _, name in api.evictions)
        line["evicted"] = evicted
        if evicted != [v_member]:
            preempt_fail(f"evictions {evicted}: V_card's member alone was the plan")

        def decisions(kind: str) -> list:
            status, body = http_get(base + f"/debug/decisions?kind={kind}")
            return json.loads(body).get("records", []) if status == 200 else []
        selected = [r for r in decisions("preempt_victim")
                    if r.get("gang") == f"default/{v_card}" and r.get("reason") == "selected"]
        executed = [r for r in decisions("preemption")
                    if r.get("gang") == f"default/{g_p}" and r.get("reason") == "executed"]
        line["decisions"] = {"selected": len(selected), "executed": len(executed)}
        if not selected or not executed:
            preempt_fail(f"the decision ledger's round: {line['decisions']}")
        counters = {"executed": metric("tpu_extender_preemptions_total", tier="critical",
                                       outcome="executed"),
                    "victims": metric("tpu_extender_preemption_victims_total",
                                      victim_tier="batch")}
        line["metrics"] = counters
        if counters != {"executed": 1, "victims": 1}:
            preempt_fail(f"the preemption counters: {counters}")
        store = statestore.read_state(str(journal_dir / "admission.journal"),
                                      str(journal_dir / "admission.snapshot.json"))
        ops = [r["op"] for r in store.records
               if r["op"].startswith("preempt_") and r.get("g") == ["default", g_p]]
        line["journal"] = ops
        if ops != ["preempt_intent", "preempt_evicted", "preempt_done"]:
            preempt_fail(f"the journal's round for G_P: {ops}")
        events = [e for e in api.events if e.get("reason") == "GPUGangPreempted"
                  and (e.get("involvedObject") or {}).get("name") == v_member]
        if len(events) != 1:
            preempt_fail(f"the victim's GPUGangPreempted Event: {api.events}")

        # 5. The stand-in kubelet's SIGTERM: the victim's process exits and
        # its context leaves the card.
        killer.join(timeout=PLUGIN_WAIT_S)
        if not killed.get("stepping"):
            preempt_fail(f"V_card's pod ended before its eviction: {victim_lines[-2:]}")
        victim_rc = victim.wait(timeout=PLUGIN_WAIT_S)
        t_exit = time.monotonic()
        t_gone, _ = until(lambda: len(compute_apps()) == apps_before,
                          "the victim's context gone from the card", every_s=0.05)
        line["victim"] = {"rc": victim_rc, "eviction_to_sigterm_s": killed["t"] - t_evicted,
                          "eviction_to_exit_s": t_exit - t_evicted,
                          "eviction_to_off_card_s": t_gone - t_evicted}

        # 6. G_P's member on the freed card: Allocate, bound, the hold drops;
        # its pod runs the kernels while no other process holds the card.
        peak_apps = [0]
        sampling = threading.Event()

        def sample_apps() -> None:
            while not sampling.is_set():
                peak_apps[0] = max(peak_apps[0], len(compute_apps()))
                sampling.wait(0.25)

        sampler = threading.Thread(target=sample_apps, daemon=True)
        sampler.start()
        try:
            pod_line: dict = {}
            launches = run_member_pod(stub, podres, bind, p_member, PREEMPT_NODE, ids, count,
                                      main_report, pod_line, preempt_fail)
        finally:
            sampling.set()
            sampler.join()
        line["preemptor"] = pod_line
        line["preemptor_peak_compute_apps"] = peak_apps[0]
        if peak_apps[0] > apps_before + 1:
            preempt_fail(f"{peak_apps[0]} processes held the card while G_P's pod stepped "
                         f"(the script's {apps_before} and the pod's)")
        until(lambda: metric("tpu_gang_reservations") == 0, "G_P's hold dropped after its bind")

        # 7. The explainer reads the live round.
        out = run_tool("preempt", "explain", "--evicted", v_card, "--url", base)
        wanted = (f"evicted by default/{g_p}", "victim tier batch", "last checkpoint")
        if out.returncode != 0 or not all(w in out.stdout for w in wanted):
            tool_fail(out, "tools.explain --evicted", preempt_fail)
        line["explain_head"] = out.stdout.splitlines()[0]

        # 8. The module's self-test.
        self_test = subprocess.run(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender.preemption",
             "--self-test"], cwd=ROOT, capture_output=True, text=True, timeout=120)
        line["self_test_rc"] = self_test.returncode
        if self_test.returncode != 0:
            preempt_fail(f"the preemption self-test: {self_test.stdout} {self_test.stderr}")

        # 9. Two clean audit sweeps or more; SIGTERM ends the extender and
        # the daemon with code 0 and releases the lease.
        def audited():
            status, body = http_get(base + "/debug/audit")
            snap = json.loads(body) if status == 200 else {}
            return snap.get("sweeps", 0) >= 2 and snap
        _, audit_snap = until(audited, "two audit sweeps", every_s=0.1)
        outcomes = {o: metric("tpu_audit_sweeps_total", outcome=o)
                    for o in ("clean", "findings", "error")}
        line["audit"] = {"sweeps": audit_snap["sweeps"], "outcomes": outcomes}
        if (audit_snap["findings"] or audit_snap["errors"] or outcomes["findings"]
                or outcomes["error"] or (outcomes["clean"] or 0) < 2):
            preempt_fail(f"the audit: {audit_snap}")
        ext.send_signal(signal.SIGTERM)
        ext_rc = ext.wait(timeout=PLUGIN_WAIT_S)
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=PLUGIN_WAIT_S)
        holder = api.leases[LEASE_KEY]["spec"].get("holderIdentity", "")
        line["rc"] = {"extender": ext_rc, "daemon": rc}
        line["lease_holder_after"] = holder
        line["phase_s"] = time.monotonic() - t_phase
        emit({"preemption": line})
        if ext_rc != 0 or rc != 0 or holder != "":
            preempt_fail(f"SIGTERM: the extender exited {ext_rc}, the daemon {rc}; the lease's "
                         f"holder reads {holder!r}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if channel is not None:
            channel.close()
        kubelet.server.stop(grace=0)
        podres.server.stop(grace=0)
        api.stop()
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -- phases 22 and 23: defragmentation and rescue ----------------------------

STAGE_RESYNC_S = 1
# The daemon's controller resync: the stand-in kubelet clears a killed pod's
# PodResources entry at once, and a delete the daemon saw before that clear
# frees the card at this resync.
STAGE_DAEMON_RESYNC_S = 2
STAGE_POLL_S = 0.01
STAGE_CLASSES = {"batch": -10}
DEFRAG_NODE = "defrag-node"
DEFRAG_S, DEFRAG_S2 = "defrag-s", "defrag-s2"
DEFRAG_SYN_CARDS = 8
DEFRAG_CKPT_AGE_S = 60.0
DEFRAG_STRANDED_TICKS = 3  # the extender's --defrag-stranded-ticks default
DEFRAG_BUDGET = 12  # its --defrag-max-evictions-per-hour default
RESCUE_NODE = "rescue-node"
RESCUE_H, RESCUE_F = "rescue-h", "rescue-f"
RESCUE_GRACE_TICKS = 2  # the extender's --rescue-grace-ticks default


class Stage:
    """Phase 21's stand-ins for phases 22 and 23: a short dir under /tmp, a
    fresh fake API server and its kube config, the daemon over the real NVML
    publishing this node, the stand-in kubelet and PodResources, and the
    extender run as phase 21 runs it (every eviction plane on by default).
    ``close`` stops every process it started."""

    def __init__(self, prefix: str, node: str, label: str):
        from k8s_device_plugin_tpu_torch.kube.client import KubeClient
        from tests.fake_apiserver import FakeApiServer

        self.label = label
        self.node = node
        self.work = Path(tempfile.mkdtemp(prefix=prefix, dir="/tmp"))
        self.dp_dir = self.work / "dp"
        self.dp_dir.mkdir()
        self.journal_dir = self.work / "journal"
        self.api = FakeApiServer()
        self.kubelet = Kubelet(str(self.dp_dir))
        self.podres = PodResources(str(self.work / "pod-resources" / "kubelet.sock"))
        api_url = self.api.start()
        self.api.add_node(node)
        for name, value in STAGE_CLASSES.items():
            self.api.add_priority_class(name, value)
        self.client = KubeClient(api_url)
        self.kubeconfig = self.work / "kubeconfig.json"
        self.kubeconfig.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config", "current-context": "smoke",
            "contexts": [{"name": "smoke", "context": {"cluster": "fake", "user": "smoke"}}],
            "clusters": [{"name": "fake", "cluster": {"server": api_url}}],
            "users": [{"name": "smoke", "user": {"token": "smoke"}}],
        }))
        self.procs: list = []
        self.channel = None
        self.base = ""

    def fail(self, msg: str) -> None:
        for path in sorted(self.work.glob("*.log")):
            print(f"{path.name}:", path.read_text()[-3000:], file=sys.stderr, flush=True)
        fail(f"{self.label}: {msg}")

    def until(self, pred, what: str, bound_s: float = PLUGIN_WAIT_S,
              every_s: float = STAGE_POLL_S):
        """Poll ``pred`` until it gives a value: (time, value)."""
        deadline = time.monotonic() + bound_s
        while not (value := pred()):
            if time.monotonic() > deadline:
                self.fail(f"not seen within {bound_s} s: {what}")
            time.sleep(every_s)
        return time.monotonic(), value

    def start_daemon(self, metrics_port: int = 0, audit_interval_s: float = 0):
        """The daemon over the real NVML: its registration, this node's
        annotation (every card free), the Allocate stub. With
        ``metrics_port`` its HTTP plane is at ``daemon_base``. Returns the
        node's card ids."""
        import grpc

        from k8s_device_plugin_tpu_torch.api.grpc_defs import DevicePluginStub

        self.daemon_base = f"http://127.0.0.1:{metrics_port}" if metrics_port else ""
        with open(self.work / "daemon.log", "w") as log_file:
            self.daemon = subprocess.Popen(
                [sys.executable, "-m", "k8s_device_plugin_tpu_torch", "--device-plugin-dir",
                 str(self.dp_dir), "--node-name", self.node, "--kubeconfig",
                 str(self.kubeconfig), "--podresources-socket", self.podres.socket_path,
                 "--metrics-port", str(metrics_port), "--audit-interval-s",
                 str(audit_interval_s), "--resync-interval", str(STAGE_DAEMON_RESYNC_S)],
                cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
        self.procs.append(self.daemon)
        _, req, _ = self.kubelet.next_registration()
        topo = self.topology(self.node, bound_s=PLUGIN_WAIT_S)
        if topo["chip_count"] < 1 or len(topo["available"]) != topo["chip_count"]:
            self.fail(f"the node's annotation before any allocation: {topo}")
        self.channel = grpc.insecure_channel(f"unix:{self.dp_dir / req.endpoint}")
        self.stub = DevicePluginStub(self.channel)
        return list(topo["available"])

    def topology(self, node: str, bound_s: float = PLUGIN_WAIT_S) -> dict:
        from k8s_device_plugin_tpu_torch.api import constants

        _, raw = self.until(lambda: self.api.nodes[node]["metadata"].get(
            "annotations", {}).get(constants.TOPOLOGY_ANNOTATION),
            f"{node}'s nvidia.com/gpu-topology annotation", bound_s)
        return json.loads(raw)

    def free_cards(self, node: str) -> int:
        return len(self.topology(node)["available"])

    def add_synthetic(self, name: str, index: int, count: int, free) -> None:
        """A synthetic node of ``count`` cards, every pair NV18, with the
        cards of ``free`` (indices) free."""
        from k8s_device_plugin_tpu_torch.api import constants

        self.api.add_node(name, {"metadata": {"name": name, "labels": {}, "annotations": {
            constants.TOPOLOGY_ANNOTATION: hgx_annotation(name, index, free, count)}}})

    def republish(self, name: str, index: int, count: int, free) -> None:
        """A synthetic node's daemon republishing its availability."""
        from k8s_device_plugin_tpu_torch.api import constants

        node = json.loads(json.dumps(self.api.nodes[name]))
        node["metadata"]["annotations"][constants.TOPOLOGY_ANNOTATION] = hgx_annotation(
            name, index, free, count)
        self.api.add_node(name, node)

    def start_extender(self) -> None:
        port = free_port()
        self.base = f"http://127.0.0.1:{port}"
        with open(self.work / "extender.log", "w") as log_file:
            self.ext = subprocess.Popen(
                [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--node-cache",
                 "--gang-admission", "--journal-dir", str(self.journal_dir),
                 "--audit-interval-s", str(GANG_AUDIT_INTERVAL_S), "--decisions",
                 "--gang-resync-s", str(STAGE_RESYNC_S), "--kubeconfig", str(self.kubeconfig),
                 "--host", "127.0.0.1", "--port", str(port)],
                cwd=ROOT, env=dict(os.environ, HOSTNAME=GANG_IDENTITY), stdout=log_file,
                stderr=subprocess.STDOUT)
        self.procs.append(self.ext)
        self.t_ready, _ = self.until(lambda: http_get(self.base + "/readyz")[0] == 200,
                                     "/readyz 200")
        self.until(lambda: any(m == "GET" and p.startswith("/api/v1/nodes?") and "watch=true" in p
                               for m, p in list(self.api.requests)), "the extender's node watch")

    def metric(self, name: str, base: str = "", **labels):
        """One sample of the extender's /metrics (``base``: another
        process's)."""
        status, body = http_get((base or self.base) + "/metrics")
        if status != 200:
            return None
        try:
            return sample_value(parse_metrics(body.decode()), name, **labels)
        except ValueError as e:
            self.fail(str(e))

    def gpu_pod(self, name: str, gang: str, n: int, class_name: str = "", node: str = "",
                size: int = 1) -> dict:
        """A member of ``n`` cards of ``gang`` (of ``size``): gated, or
        bound to ``node`` and running."""
        from k8s_device_plugin_tpu_torch.api import constants
        from k8s_device_plugin_tpu_torch.extender import gang as gang_mod

        meta = {"name": name, "namespace": "default", "uid": f"{name}-uid", "annotations": {},
                "labels": {gang_mod.GANG_NAME_LABEL: gang, gang_mod.GANG_SIZE_LABEL: str(size)}}
        spec = {"containers": [{"name": "main", "resources": {
            "requests": {constants.RESOURCE_NAME: str(n)}}}]}
        status = {"phase": "Pending"}
        if node:
            spec["nodeName"] = node
            status = {"phase": "Running"}
        else:
            spec["schedulingGates"] = [{"name": gang_mod.GATE_NAME}]
        if class_name:
            spec["priorityClassName"] = class_name
        return {"metadata": meta, "spec": spec, "status": status}

    def gated(self, name: str) -> bool:
        from k8s_device_plugin_tpu_torch.extender import gang as gang_mod

        return gang_mod.is_gated(self.api.pods[("default", name)])

    def bind(self, name: str, node: str) -> None:
        """The scheduler's bind of a member, as a watch sees it."""
        pod = json.loads(json.dumps(self.api.pods[("default", name)]))
        pod["spec"]["nodeName"] = node
        pod["status"] = {"phase": "Running"}
        self.api.update_pod(pod)

    def first_seen(self, preds: dict, bound_s: float):
        """Poll each of ``preds`` (name -> predicate) from a thread of its own
        until each has held once. Returns a join: name -> the monotonic time
        it first held, failing the phase for any not seen within
        ``bound_s``."""
        seen: dict = {}

        def poll() -> None:
            deadline = time.monotonic() + bound_s
            while len(seen) < len(preds) and time.monotonic() < deadline:
                for name, pred in preds.items():
                    if name not in seen and pred():
                        seen[name] = time.monotonic()
                time.sleep(STAGE_POLL_S)

        thread = threading.Thread(target=poll, daemon=True)
        thread.start()

        def join() -> dict:
            thread.join(bound_s + 5)
            missing = sorted(set(preds) - set(seen))
            if missing:
                self.fail(f"not seen within {bound_s} s: {missing}")
            return dict(seen)
        return join

    def stamp_checkpoint(self, name: str, age_s: float) -> None:
        """A save ``age_s`` ago, stamped through the port's beacon."""
        from k8s_device_plugin_tpu_torch.workload.beacon import CheckpointBeacon

        ts = time.time() - age_s
        beacon = CheckpointBeacon(lambda ann: self.client.patch_pod_annotations(
            "default", name, {k: str(ts) for k in ann}))
        if not beacon.note_saved(0):
            self.fail(f"the checkpoint beacon could not stamp {name}")

    def stepping_pod(self, member: str, ids):
        """A released member's pod stepping on the card until the stand-in
        kubelet stops it: Allocate, bind, ``VICTIM_POD_ARGS`` in its own
        process. Returns the process and its first step's wait (s)."""
        env = allocate_and_bind(self.stub, self.podres, self.bind, member, self.node, ids)
        with open(self.work / f"{member}.log", "w") as log_file:
            proc = subprocess.Popen([sys.executable, *VICTIM_POD_ARGS], cwd=ROOT, env=env,
                                    text=True, stdout=subprocess.PIPE, stderr=log_file)
        self.procs.append(proc)
        lines: list = []
        stepping = threading.Event()

        def read() -> None:
            for raw_line in proc.stdout:
                lines.append(raw_line)
                if raw_line.startswith("{") and json.loads(raw_line).get("partial") == \
                        "first_step":
                    stepping.set()

        threading.Thread(target=read, daemon=True).start()
        t0 = time.monotonic()
        if not stepping.wait(PLUGIN_WAIT_S):
            self.fail(f"{member}'s pod did not step within {PLUGIN_WAIT_S} s: {lines[-3:]} "
                      f"{proc.poll()}")
        return proc, time.monotonic() - t0

    def kubelet_kill(self, member: str, proc) -> dict:
        """The stand-in kubelet: once ``member``'s pod is deleted it clears
        its PodResources entry and sends its process SIGTERM. Returns the
        dict the thread fills (the deletion's time, whether the pod was still
        stepping, the exit's time and code)."""
        seen: dict = {}

        def watch() -> None:
            while ("default", member) in self.api.pods:
                time.sleep(0.002)
            seen["t"] = time.monotonic()
            seen["stepping"] = proc.poll() is None
            self.podres.drop("default", member)
            proc.send_signal(signal.SIGTERM)
            seen["rc"] = proc.wait(timeout=PLUGIN_WAIT_S)
            seen["t_exit"] = time.monotonic()

        seen["thread"] = threading.Thread(target=watch, daemon=True)
        seen["thread"].start()
        return seen

    def decisions(self, kind: str) -> list:
        status, body = http_get(self.base + f"/debug/decisions?kind={kind}")
        return json.loads(body).get("records", []) if status == 200 else []

    def journal_ops(self, plane: str, gang: str) -> list:
        """The journal's two-phase round records of ``plane`` for ``gang``
        (the budget's ``defrag_spend`` stamps left out)."""
        from k8s_device_plugin_tpu_torch.utils import statestore

        store = statestore.read_state(str(self.journal_dir / "admission.journal"),
                                      str(self.journal_dir / "admission.snapshot.json"))
        phases = {f"{plane}_{p}" for p in ("intent", "evicted", "done", "abort")}
        return [r["op"] for r in store.records
                if r["op"] in phases and r.get("g") == ["default", gang]]

    def audit_and_stop(self, invariant: str) -> dict:
        """Two clean audit sweeps or more, ``invariant`` among the
        invariants; then SIGTERM ends the extender and the daemon with code
        0 and releases the lease."""
        def audited():
            status, body = http_get(self.base + "/debug/audit")
            snap = json.loads(body) if status == 200 else {}
            return snap.get("sweeps", 0) >= 2 and snap
        _, snap = self.until(audited, "two audit sweeps", every_s=0.1)
        outcomes = {o: self.metric("tpu_audit_sweeps_total", outcome=o)
                    for o in ("clean", "findings", "error")}
        names = sorted(i["name"] for i in snap.get("invariants", []))
        out = {"sweeps": snap["sweeps"], "outcomes": outcomes, "invariants": names}
        if (snap["findings"] or snap["errors"] or outcomes["findings"] or outcomes["error"]
                or (outcomes["clean"] or 0) < 2 or invariant not in names):
            self.fail(f"the audit: {snap}")
        self.ext.send_signal(signal.SIGTERM)
        ext_rc = self.ext.wait(timeout=PLUGIN_WAIT_S)
        self.daemon.send_signal(signal.SIGTERM)
        rc = self.daemon.wait(timeout=PLUGIN_WAIT_S)
        holder = self.api.leases[LEASE_KEY]["spec"].get("holderIdentity", "")
        out["rc"] = {"extender": ext_rc, "daemon": rc}
        if ext_rc != 0 or rc != 0 or holder != "":
            self.fail(f"SIGTERM: the extender exited {ext_rc}, the daemon {rc}; the lease's "
                      f"holder reads {holder!r}")
        return out

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if self.channel is not None:
            self.channel.close()
        self.kubelet.server.stop(grace=0)
        self.podres.server.stop(grace=0)
        self.api.stop()
        shutil.rmtree(self.work, ignore_errors=True)


def phase_defrag(main_report: dict) -> dict:
    """Defragmentation on the card: a batch gang whose member's pod runs the
    kernels is migrated to free a whole node for a stranded 8-card gang, and
    its replacement member runs the kernels on the same card."""
    stage = Stage("dfg", DEFRAG_NODE, "defrag")
    line: dict = {"nvidia_smi": nvidia_smi()}
    t_phase = time.monotonic()
    api = stage.api
    try:
        ids = stage.start_daemon()
        count = len(ids)
        line["node"] = {"cards": count}
        if count >= 4:
            stage.fail(f"the phase's cluster needs a node of fewer than 4 cards, not {count}")
        # S: 8 cards, all free at first.
        stage.add_synthetic(DEFRAG_S, 22, DEFRAG_SYN_CARDS, range(DEFRAG_SYN_CARDS))
        stage.start_extender()
        base = stage.base
        apps_before = len(compute_apps())
        line["compute_apps_before"] = apps_before

        # 1. Two running gangs. V (batch), both members gated and admitted:
        # V-b's 4 cards on S (bound, no process), V-a on this card, its pod
        # stepping. W (standard): one 4-card member on S2, which joins with
        # its other 4 cards free.
        v, w, x = "v", "w", "x"
        va, vb, wm, xm = f"{v}-a", f"{v}-b", f"{w}-0", f"{x}-0"
        api.add_pod(stage.gpu_pod(vb, v, 4, "batch", size=2))
        api.add_pod(stage.gpu_pod(va, v, count, "batch", size=2))
        stage.until(lambda: not stage.gated(va) and not stage.gated(vb), "V's gates removed")
        holds = json.loads(http_get(base + "/reservations")[1])["holds"]
        if [h["hosts"] for h in holds if h["gang"] == v] != [{DEFRAG_S: 4, DEFRAG_NODE: count}]:
            stage.fail(f"V's hold: {holds}")
        stage.bind(vb, DEFRAG_S)
        stage.republish(DEFRAG_S, 22, DEFRAG_SYN_CARDS, range(4, DEFRAG_SYN_CARDS))
        va_proc, first_step_s = stage.stepping_pod(va, ids)
        line["va_start_to_first_step_s"] = first_step_s
        stage.add_synthetic(DEFRAG_S2, 23, DEFRAG_SYN_CARDS, range(4, DEFRAG_SYN_CARDS))
        api.add_pod(stage.gpu_pod(wm, w, 4, node=DEFRAG_S2))
        for name in (va, vb):
            stage.stamp_checkpoint(name, DEFRAG_CKPT_AGE_S)
        stage.until(lambda: stage.free_cards(DEFRAG_NODE) == 0, "V-a's card published held")
        stage.until(lambda: stage.metric("tpu_gang_reservations") == 0,
                    "V's hold dropped after its binds")
        out = run_tool("defrag", "defrag", "status", "--url", base)
        if out.returncode != 0 or "no stranded demand" not in out.stdout:
            tool_fail(out, "tools.defrag status before the stranded gang", stage.fail)

        # 3's stand-in kubelet, armed before the round.
        killed = stage.kubelet_kill(va, va_proc)

        # 2. X: one gated member of 8 cards, no class. Free cards: 4 on S, 4
        # on S2, none here; no node places 8.
        t_submit = time.monotonic()
        api.add_pod(stage.gpu_pod(xm, x, DEFRAG_SYN_CARDS))
        t_stranded, _ = stage.until(
            lambda: stage.metric("tpu_extender_stranded_demand", size=str(DEFRAG_SYN_CARDS),
                                 shard="") == 1, "tpu_extender_stranded_demand{size=8} 1")
        bound_s = (DEFRAG_STRANDED_TICKS + 2) * STAGE_RESYNC_S + 10
        t_evicted, _ = stage.until(lambda: {("default", va), ("default", vb)} <= set(
            api.evictions), "V's two evictions", bound_s)
        t_released, _ = stage.until(lambda: not stage.gated(xm), "X's gates removed")
        line["submit_to_stranded_s"] = t_stranded - t_submit
        line["submit_to_evictions_s"] = t_evicted - t_submit
        line["submit_to_released_s"] = t_released - t_submit
        # The detector counts a tick for each resync that finds X stranded,
        # and the round plans and evicts on the last of them.
        line["submit_to_evictions_limit_s"] = DEFRAG_STRANDED_TICKS * STAGE_RESYNC_S + 1
        if line["submit_to_evictions_s"] > line["submit_to_evictions_limit_s"]:
            stage.fail(f"submission to V's evictions {line['submit_to_evictions_s']:.3f} s, "
                       f"over {DEFRAG_STRANDED_TICKS} ticks + 1 s")
        evicted = sorted(name for _, name in api.evictions)
        line["evicted"] = evicted
        if evicted != sorted([va, vb]) or ("default", wm) not in api.pods:
            stage.fail(f"evictions {evicted}: V's two members alone were the plan, W untouched")
        executed = [r for r in stage.decisions("defrag")
                    if r.get("gang") == f"default/{x}" and r.get("reason") == "executed"]
        migrated = [r for r in stage.decisions("defrag_victim")
                    if r.get("gang") == f"default/{v}" and r.get("reason") == "migrated"]
        line["decisions"] = {"executed": len(executed), "migrated": len(migrated)}
        if not executed or not migrated:
            stage.fail(f"the decision ledger's round: {line['decisions']}")
        budget = stage.metric("tpu_extender_defrag_budget_remaining", shard="")
        line["budget_remaining"] = budget
        if budget != DEFRAG_BUDGET - 2:
            stage.fail(f"tpu_extender_defrag_budget_remaining {budget}, not {DEFRAG_BUDGET - 2}")
        ops = stage.journal_ops("defrag", x)
        line["journal"] = ops
        if ops != ["defrag_intent", "defrag_evicted", "defrag_done"]:
            stage.fail(f"the journal's round for X: {ops}")
        holds = json.loads(http_get(base + "/reservations")[1])["holds"]
        line["x_hold"] = [h["hosts"] for h in holds if h["gang"] == x]
        if line["x_hold"] != [{DEFRAG_S: DEFRAG_SYN_CARDS}]:
            stage.fail(f"X's hold: {holds}")
        events = [e for e in api.events if e.get("reason") == "GPUGangMigrated"
                  and (e.get("involvedObject") or {}).get("name") in (va, vb)]
        if len(events) != 1:
            stage.fail(f"V's GPUGangMigrated Event: {api.events}")
        # X bound to S, no process; S's daemon republishes it full.
        stage.bind(xm, DEFRAG_S)
        stage.republish(DEFRAG_S, 22, DEFRAG_SYN_CARDS, [])
        stage.until(lambda: stage.metric("tpu_gang_reservations") == 0,
                    "X's hold dropped after its bind")

        # 3. The stand-in kubelet stopped V-a's process: its exit, its
        # context off the card.
        killed["thread"].join(timeout=PLUGIN_WAIT_S)
        if not killed.get("stepping") or "rc" not in killed:
            stage.fail(f"V-a's pod ended before its eviction or did not exit: {killed}")
        t_gone, _ = stage.until(lambda: len(compute_apps()) == apps_before,
                                "V-a's context gone from the card", every_s=0.05)
        line["va"] = {"rc": killed["rc"], "eviction_to_exit_s": killed["t_exit"] - t_evicted,
                      "eviction_to_off_card_s": t_gone - t_evicted}
        t_free, _ = stage.until(lambda: stage.free_cards(DEFRAG_NODE) == count,
                                "this node's cards published free again")
        line["va"]["eviction_to_published_free_s"] = t_free - t_evicted

        # 4. V's job controller recreates its two members, gated: the 4-card
        # one lands on S2, the other on this card and runs the kernels.
        va2, vb2 = f"{v}-a2", f"{v}-b2"
        api.add_pod(stage.gpu_pod(vb2, v, 4, "batch", size=2))
        api.add_pod(stage.gpu_pod(va2, v, count, "batch", size=2))
        t_v2 = time.monotonic()
        t_v2_released, _ = stage.until(lambda: not stage.gated(va2) and not stage.gated(vb2),
                                       "V's replacements released")
        line["v_recreated_to_released_s"] = t_v2_released - t_v2
        holds = json.loads(http_get(base + "/reservations")[1])["holds"]
        line["v_hold"] = [h["hosts"] for h in holds if h["gang"] == v]
        if line["v_hold"] != [{DEFRAG_S2: 4, DEFRAG_NODE: count}]:
            stage.fail(f"V's replacements' hold: {holds}")
        stage.bind(vb2, DEFRAG_S2)
        pod_line: dict = {}
        launches = run_member_pod(stage.stub, stage.podres, stage.bind, va2, DEFRAG_NODE, ids,
                                  count, main_report, pod_line, stage.fail)
        line["replacement"] = pod_line
        stage.until(lambda: stage.metric("tpu_gang_reservations") == 0,
                    "V's hold dropped after its binds")

        # 5. The tools read the live round.
        out = run_tool("defrag", "defrag", "plan", "--url", base)
        if (out.returncode != 0 or f"box on {DEFRAG_S}" not in out.stdout
                or f"migrate default/{v}" not in out.stdout):
            tool_fail(out, "tools.defrag plan", stage.fail)
        line["plan_head"] = out.stdout.splitlines()[0]
        out = run_tool("defrag", "explain", "--migrated", v, "--url", base)
        if (out.returncode != 0 or DEFRAG_S not in out.stdout
                or f"default/{x}" not in out.stdout):
            tool_fail(out, "tools.explain --migrated", stage.fail)
        line["explain_head"] = out.stdout.splitlines()[0]
        out = run_tool("defrag", "tputop", "--url", base)
        footer = out.stdout.splitlines()[-1] if out.stdout else ""
        if (out.returncode != 0 or not footer.startswith("defrag: ")
                or f"budget {DEFRAG_BUDGET - 2} eviction(s) left/h" not in footer):
            tool_fail(out, "tools.tputop's defrag footer", stage.fail)
        line["tputop_footer"] = footer

        # 6. The self-tests.
        for module in ("extender.defrag", "tools.defrag"):
            st = subprocess.run([sys.executable, "-m", f"k8s_device_plugin_tpu_torch.{module}",
                                 "--self-test"], cwd=ROOT, capture_output=True, text=True,
                                timeout=120)
            line[f"{module}_self_test_rc"] = st.returncode
            if st.returncode != 0:
                stage.fail(f"{module} --self-test: {st.stdout} {st.stderr}")

        # 7. The audit and the shutdown.
        line["audit"] = stage.audit_and_stop("defrag_vs_reservations")
        line["phase_s"] = time.monotonic() - t_phase
        emit({"defrag": line})
    finally:
        stage.close()
    return launches


def phase_rescue(main_report: dict) -> dict:
    """Drain and rescue on the card: ``tpu-doctor drain`` evacuates a pod
    running the kernels off this node, then a gang bound to a node whose
    cards were withdrawn is rescued onto this card and runs the kernels."""
    from k8s_device_plugin_tpu_torch.api import constants

    stage = Stage("rsc", RESCUE_NODE, "rescue")
    line: dict = {"nvidia_smi": nvidia_smi()}
    t_phase = time.monotonic()
    api = stage.api
    try:
        ids = stage.start_daemon()
        count = len(ids)
        line["node"] = {"cards": count}
        # F: this node's card count, every card held by R's running member.
        stage.add_synthetic(RESCUE_F, 24, count, [])
        r, d = "r", "d"
        rm, dm = f"{r}-0", f"{d}-0"
        api.add_pod(stage.gpu_pod(rm, r, count, node=RESCUE_F))
        stage.start_extender()
        base = stage.base
        apps_before = len(compute_apps())
        line["compute_apps_before"] = apps_before

        # 1. D, standard, released onto this node (the only free one) and
        # stepping; then H, as many free cards, joins.
        api.add_pod(stage.gpu_pod(dm, d, count))
        stage.until(lambda: not stage.gated(dm), "D's gate removed")
        d_proc, first_step_s = stage.stepping_pod(dm, ids)
        line["d_start_to_first_step_s"] = first_step_s
        stage.add_synthetic(RESCUE_H, 25, count, range(count))
        stage.until(lambda: stage.metric("tpu_gang_reservations") == 0, "D's hold dropped")
        stage.until(lambda: stage.free_cards(RESCUE_NODE) == 0, "D's card published held")
        killed = stage.kubelet_kill(dm, d_proc)

        def cordoned() -> bool:
            node = api.nodes[RESCUE_NODE]
            taints = (node.get("spec") or {}).get("taints") or []
            return bool((node.get("spec") or {}).get("unschedulable")) and any(
                t.get("key") == constants.MAINTENANCE_TAINT
                and t.get("value") == constants.DRAIN_TAINT_VALUE for t in taints)

        def stamped() -> bool:
            return constants.DRAIN_COMPLETE_ANNOTATION in api.nodes[RESCUE_NODE]["metadata"].get(
                "annotations", {})

        t_post = time.monotonic()
        doctor = subprocess.Popen(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.tools.doctor", "drain",
             RESCUE_NODE, "--url", base, "--poll-s", "0.2", "--timeout-s", "60"],
            cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        stage.procs.append(doctor)
        bound_s = (RESCUE_GRACE_TICKS + 2) * STAGE_RESYNC_S + 10
        # The drain's events, each timed as it first shows while this thread
        # waits for the context to leave the card.
        drained = stage.first_seen({
            "cordoned": cordoned,
            "eviction": lambda: ("default", dm) in api.evictions,
            "drain_complete": stamped,
            "doctor_exit": lambda: doctor.poll() is not None,
        }, bound_s)
        stage.until(lambda: ("default", dm) in api.evictions, "D's eviction", bound_s)
        killed["thread"].join(timeout=PLUGIN_WAIT_S)
        if not killed.get("stepping") or "rc" not in killed:
            stage.fail(f"D's pod ended before its eviction or did not exit: {killed}")
        t_gone, _ = stage.until(lambda: len(compute_apps()) == apps_before,
                                "D's context gone from the card", every_s=0.05)
        seen = drained()
        d_out, d_err = doctor.communicate(timeout=PLUGIN_WAIT_S)
        if doctor.returncode != 0 or f"node {RESCUE_NODE} drained" not in d_out:
            stage.fail(f"tpu-doctor drain: rc {doctor.returncode}\n{d_out}\n{d_err}")
        line["drain"] = {f"post_to_{name}_s": t - t_post for name, t in sorted(seen.items())}
        # The rescue engine evicts on the grace window's last tick that finds
        # the node draining; the tap delivers the cordon within the first.
        rescue_limit_s = RESCUE_GRACE_TICKS * STAGE_RESYNC_S + 1
        line["drain"]["post_to_eviction_limit_s"] = rescue_limit_s
        if line["drain"]["post_to_eviction_s"] > rescue_limit_s:
            stage.fail(f"the drain's POST to D's eviction {seen['eviction'] - t_post:.3f} s, "
                       f"over {RESCUE_GRACE_TICKS} ticks + 1 s")
        line["drain"].update(post_to_exit_s=killed["t_exit"] - t_post,
                             post_to_off_card_s=t_gone - t_post, d_rc=killed["rc"])
        # D's controller recreates its member, gated: the rescue fence on H
        # releases it, bound there with no process; H's daemon republishes.
        dm2 = f"{d}-1"
        api.add_pod(stage.gpu_pod(dm2, d, count))
        stage.until(lambda: not stage.gated(dm2), "D's replacement released")
        holds = json.loads(http_get(base + "/reservations")[1])["holds"]
        if [h["hosts"] for h in holds if h["gang"] == d] != [{RESCUE_H: count}]:
            stage.fail(f"D's rescue fence: {holds}")
        stage.bind(dm2, RESCUE_H)
        stage.republish(RESCUE_H, 25, count, [])
        executed = [rec for rec in stage.decisions("rescue")
                    if rec.get("gang") == f"default/{d}" and rec.get("reason") == "executed"]
        if not executed or "draining" not in executed[-1].get("message", ""):
            stage.fail(f"D's rescue record: {executed}")
        ops = stage.journal_ops("rescue", d)
        line["drain"]["journal"] = ops
        if ops != ["rescue_intent", "rescue_evicted", "rescue_done"]:
            stage.fail(f"the journal's rescue of D: {ops}")
        gauge = stage.metric("tpu_node_cordoned", node=RESCUE_NODE)
        evicted = sorted(name for _, name in api.evictions)
        line["drain"].update(cordoned_gauge=gauge, evicted=evicted)
        if gauge != 1 or evicted != [dm]:
            stage.fail(f"tpu_node_cordoned {gauge}, evictions {evicted}")
        out = run_tool("rescue", "doctor", "drain", RESCUE_NODE, "--uncordon", "--url", base)
        node = api.nodes[RESCUE_NODE]
        after = {"unschedulable": bool(node["spec"].get("unschedulable")),
                 "taints": [t["key"] for t in node["spec"].get("taints") or []],
                 "stamped": stamped(),
                 "gauge": stage.metric("tpu_node_cordoned", node=RESCUE_NODE) or 0}
        line["uncordon"] = after
        if out.returncode != 0 or any(after.values()):
            tool_fail(out, f"tpu-doctor drain --uncordon: {after}", stage.fail)

        # 2. F's cards withdrawn, as its daemon publishes a health
        # withdrawal: R is rescued onto this node, the only free healthy one.
        stage.until(lambda: stage.free_cards(RESCUE_NODE) == count,
                    "this node's cards published free again")
        t_fail = time.monotonic()
        api.fail_chips(RESCUE_F, [c["id"] for c in stage.topology(RESCUE_F)["chips"]],
                       annotation=constants.TOPOLOGY_ANNOTATION)
        t_r_evicted, _ = stage.until(lambda: ("default", rm) in api.evictions, "R's eviction",
                                     bound_s)
        rm2 = f"{r}-1"
        api.add_pod(stage.gpu_pod(rm2, r, count))
        t_r_released, _ = stage.until(lambda: not stage.gated(rm2), "R's replacement released")
        line["rescue"] = {"failed_to_eviction_s": t_r_evicted - t_fail,
                          "failed_to_released_s": t_r_released - t_fail,
                          "failed_to_eviction_limit_s": rescue_limit_s}
        if line["rescue"]["failed_to_eviction_s"] > rescue_limit_s:
            stage.fail(f"the withdrawal to R's eviction {t_r_evicted - t_fail:.3f} s, over "
                       f"{RESCUE_GRACE_TICKS} ticks + 1 s")
        holds = json.loads(http_get(base + "/reservations")[1])["holds"]
        if [h["hosts"] for h in holds if h["gang"] == r] != [{RESCUE_NODE: count}]:
            stage.fail(f"R's rescue fence: {holds}")
        pod_line: dict = {}
        launches = run_member_pod(stage.stub, stage.podres, stage.bind, rm2, RESCUE_NODE, ids,
                                  count, main_report, pod_line, stage.fail)
        line["replacement"] = pod_line
        stage.until(lambda: stage.metric("tpu_gang_reservations") == 0,
                    "R's hold dropped after its bind")

        # 3. The tools and the self-test.
        out = run_tool("rescue", "explain", "--rescued", r, "--url", base)
        if out.returncode != 0 or RESCUE_F not in out.stdout or "chip_failed" not in out.stdout:
            tool_fail(out, "tools.explain --rescued R", stage.fail)
        line["explain_r_head"] = out.stdout.splitlines()[0]
        out = run_tool("rescue", "explain", "--rescued", d, "--url", base)
        if out.returncode != 0 or "draining" not in out.stdout:
            tool_fail(out, "tools.explain --rescued D", stage.fail)
        st = subprocess.run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender.rescue",
                             "--self-test"], cwd=ROOT, capture_output=True, text=True,
                            timeout=120)
        line["self_test_rc"] = st.returncode
        if st.returncode != 0:
            stage.fail(f"extender.rescue --self-test: {st.stdout} {st.stderr}")

        # 4. The audit and the shutdown.
        line["audit"] = stage.audit_and_stop("rescue_vs_health")
        line["phase_s"] = time.monotonic() - t_phase
        emit({"rescue": line})
    finally:
        stage.close()
    return launches


# -- phase 24: an API-server brownout and a partition ------------------------

BROWNOUT_NODE = "brownout-node"
BROWNOUT_PLAN = ROOT / "tests" / "chaos_plans" / "brownout.json"
# W, the brownout's window: shorter than the extender's renew budget, and no
# longer than its breaker's reset timeout, so no half-open probe falls inside
# W (the breaker opens after the load and stays open that long).
BROWNOUT_W_S = 10.0
# About 0.2 s a step: G's pod still steps when the partition is over (the
# phase needs about 60 s of them at most). The control pod runs the same.
BROWNOUT_POD_ARGS = ("-m", "k8s_device_plugin_tpu_torch.workload.smoke", "--bench", "--steps",
                     "400")
# The daemon controller's watch backoff cap (controller/controller.py,
# ``Backoff(base=0.5, max_delay=15.0)``): the longest sleep its relist loop
# can be in when the API server comes back.
DAEMON_WATCH_BACKOFF_MAX_S = 15.0
# Each timed wait's limit carries this for the host's own scheduling and the
# poll: the processes share the card machine's cores.
BROWNOUT_SLACK_S = 1.0
# G's step against the control pod's: the same pod on the same card just
# before, with no outage. A pod of hundreds of steps runs about 1% slower
# than phase 5's ten on a card held near its power limit that long, so
# phase 5's step is printed beside it, not held to the band.
POD_STEP_BAND = 0.01


def brownout_limits() -> dict:
    """Every limit of phase 24, from the code's settings: the resilience
    layer's default ``RetryPolicy`` and ``CircuitBreaker`` (both processes
    build them so), the extender's default lease and its renew cadence
    (``extender/leader.py``), the gang resync and the daemon's resync."""
    from k8s_device_plugin_tpu_torch.extender.__main__ import parse_args
    from k8s_device_plugin_tpu_torch.utils.resilience import CircuitBreaker, RetryPolicy

    breaker, policy = CircuitBreaker(), RetryPolicy()
    plan = json.loads(BROWNOUT_PLAN.read_text())
    # One failing call: its attempts back to back, the backoff between them
    # (no jitter above the base curve) and the plan's Retry-After.
    call_s = sum(min(policy.max_delay_s, policy.base_delay_s * 2 ** k)
                 for k in range(policy.max_attempts - 1))
    call_s += max(float(f.get("retry_after_s", 0)) for f in plan["faults"])
    # A call adds at least max_attempts - 1 failures in a row (the plan's 429
    # is no failure), so this many calls open the breaker.
    calls_to_open = math.ceil(breaker.failure_threshold / (policy.max_attempts - 1))
    lease_s = parse_args([]).lease_seconds
    renew_deadline = lease_s * 2.0 / 3.0
    renew_interval = max(min(lease_s / 3.0, renew_deadline / 3.0), 0.2)
    failed_wake = renew_interval / 2.0  # the renew loop's longest wait after a failure
    open_ext = calls_to_open * (STAGE_RESYNC_S + call_s) + BROWNOUT_SLACK_S
    # The daemon's pod watch open at the load runs out its window (the
    # resync) before its first failing call.
    open_daemon = (STAGE_DAEMON_RESYNC_S + calls_to_open * (STAGE_DAEMON_RESYNC_S + call_s)
                   + BROWNOUT_SLACK_S)
    return {
        "w_s": BROWNOUT_W_S, "call_s": call_s, "calls_to_open": calls_to_open,
        "breaker_threshold": breaker.failure_threshold,
        "breaker_reset_s": breaker.reset_timeout_s, "lease_s": lease_s,
        "renew_deadline_s": renew_deadline, "renew_interval_s": renew_interval,
        "open_extender_s": open_ext, "open_daemon_s": open_daemon,
        # From the clear, past the breaker's own reset: the extender's next
        # call comes within a gang tick, the daemon's within its backoff cap.
        "closed_extender_after_reset_s": STAGE_RESYNC_S + call_s + BROWNOUT_SLACK_S,
        "closed_daemon_after_reset_s": DAEMON_WATCH_BACKOFF_MAX_S + call_s + BROWNOUT_SLACK_S,
        # A renewal right before the load, the breaker open until its reset
        # and a probe, then the renew loop's next wake: it must land inside
        # the deadline, or W would cost the lease.
        "lease_unrenewed_worst_s": (open_ext + breaker.reset_timeout_s + STAGE_RESYNC_S + call_s
                                    + failed_wake),
        # The lease loop checks its deadline at each wake: a partitioned
        # extender exits by the deadline plus one wake after a failure.
        "partition_exit_s": renew_deadline + failed_wake + BROWNOUT_SLACK_S,
        "renewal_sync_s": renew_interval + BROWNOUT_SLACK_S,
    }


def http_post_json(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


class CardDuty:
    """The duty cycle of the card ``uuid`` through one NVML session of this
    process: a poll of ``nvidia-smi`` starts NVML anew each time, which the
    stepping pod beside it would pay for."""

    def __init__(self, uuid: str):
        from k8s_device_plugin_tpu_torch.discovery.scanner import (
            DEFAULT_DEV, DEFAULT_SYSFS_PCI, NvmlInfo)

        self.sysfs = DEFAULT_SYSFS_PCI
        self.info = NvmlInfo()
        mine = [c for c in self.info.scan(DEFAULT_SYSFS_PCI, DEFAULT_DEV) if c.uuid == uuid]
        if not mine:
            self.info.close()
            fail(f"NVML lists no card {uuid}")
        self.index = mine[0].index

    def __call__(self) -> float:
        return self.info.chip_telemetry(self.sysfs, self.index).duty_cycle_pct or 0.0

    def close(self) -> None:
        self.info.close()


def phase_brownout(main_report: dict) -> dict:
    """An API-server brownout and a partition under the daemon and the
    extender, while a gang member's pod steps on the card: both breakers
    open and both degraded gauges rise within their limits, /filter answers
    as before from the last-known-good index, no write lands, the extender
    keeps its lease, and recovery closes both breakers and delivers what the
    daemon queued; then a partitioned extender exits while the daemon keeps
    serving the card."""
    from k8s_device_plugin_tpu_torch.api import constants
    from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    lim = brownout_limits()
    stage = Stage("brw", BROWNOUT_NODE, "brownout")
    line: dict = {"nvidia_smi": nvidia_smi(), "limits": lim}
    t_phase = time.monotonic()
    api = stage.api
    if not (lim["w_s"] < lim["renew_deadline_s"] and lim["w_s"] <= lim["breaker_reset_s"]
            and lim["open_extender_s"] <= lim["w_s"] and lim["open_daemon_s"] <= lim["w_s"]
            and lim["lease_unrenewed_worst_s"] < lim["renew_deadline_s"]):
        stage.fail(f"W of {lim['w_s']} s does not fit the code's settings: {lim}")
    pod_proc = law_call = duty = None
    try:
        ids = stage.start_daemon(metrics_port=free_port(), audit_interval_s=GANG_AUDIT_INTERVAL_S)
        dbase = stage.daemon_base
        count = len(ids)
        line["node"] = {"cards": count}
        stage.start_extender()
        base = stage.base

        def both(name: str) -> dict:
            return {"daemon": stage.metric(f"tpu_plugin_kube_{name}", base=dbase),
                    "extender": stage.metric(f"tpu_extender_kube_{name}")}

        if both("circuit_state") != {"daemon": 0, "extender": 0}:
            stage.fail(f"a breaker not closed before the brownout: {both('circuit_state')}")

        # The control: G's pod on this card with no outage, as long.
        control = subprocess.run([sys.executable, *BROWNOUT_POD_ARGS, "--no-stream"], cwd=ROOT,
                                 env=dict(os.environ, CUDA_VISIBLE_DEVICES=ids[0]),
                                 capture_output=True, text=True, timeout=PLUGIN_WAIT_S * 5)
        if control.returncode != 0:
            stage.fail(f"the control pod exited {control.returncode}: {control.stderr[-2000:]}")
        control_report = json.loads(control.stdout.splitlines()[-1])
        line["control_pod"] = {k: control_report.get(k) for k in (
            "ok", "device_uuid", "steps_run", "step_time_s", "mfu")}

        # 1. G: one member of this node's cards, released onto it and
        # allocated, its pod stepping. The scheduler's bind comes inside W.
        g, gm = "g", "g-0"
        api.add_pod(stage.gpu_pod(gm, g, count))
        stage.until(lambda: not stage.gated(gm), "G's gate removed")
        # G's kubelet record comes with its bind: a record of a pod that no
        # relist of this node carries yet is pruned at the daemon's next
        # relist (every 2 s) whenever G's gate-removal event reaches the
        # controller after the record, which frees the card under the pod.
        env = allocate_and_bind(stage.stub, None, lambda *_: None, gm, BROWNOUT_NODE, ids)
        with open(stage.work / "g.log", "w") as log_file:
            pod_proc = subprocess.Popen([sys.executable, *BROWNOUT_POD_ARGS], cwd=ROOT, env=env,
                                        text=True, stdout=subprocess.PIPE, stderr=log_file)
        stage.procs.append(pod_proc)
        pod_lines: list = []
        first_step = threading.Event()

        def read_pod() -> None:
            for raw_line in pod_proc.stdout:
                if raw_line.startswith("{"):
                    snap = json.loads(raw_line)
                    pod_lines.append((time.monotonic(), snap))
                    if snap.get("partial") == "first_step":
                        first_step.set()

        threading.Thread(target=read_pod, daemon=True).start()
        if not first_step.wait(PLUGIN_WAIT_S):
            stage.fail(f"G's pod did not step within {PLUGIN_WAIT_S} s: {pod_proc.poll()}")
        duty = CardDuty(ids[0])
        stage.until(lambda: stage.free_cards(BROWNOUT_NODE) == 0, "G's card published held")
        probe_pod = {"metadata": {"name": "probe", "namespace": "default", "uid": "probe-uid"},
                     "spec": {"containers": [{"name": "main", "resources": {
                         "requests": {constants.RESOURCE_NAME: "1"}}}]}}
        verdict = {"pod": probe_pod, "nodenames": [BROWNOUT_NODE]}
        before = http_post_json(base + "/filter", verdict)
        line["filter_before"] = before

        def mutations() -> tuple:
            return (len(api.pod_patches), len(api.rejected_pod_patches), len(api.node_patches),
                    len(api.node_status_patches), len(api.events), len(api.evictions),
                    len(api.deletions),
                    json.dumps({"/".join(k): v for k, v in api.leases.items()}, sort_keys=True))

        def renewed() -> str:
            return api.leases[LEASE_KEY]["spec"].get("renewTime", "")

        def after_renewal() -> float:
            """Wait for the extender's next lease renewal: the outage starts
            with the whole renew budget ahead."""
            last = renewed()
            t, _ = stage.until(lambda: renewed() != last, "a lease renewal",
                               lim["renewal_sync_s"], every_s=0.002)
            return t

        # 2. The brownout, W long from the load.
        after_renewal()
        plan = json.loads(BROWNOUT_PLAN.read_text())
        t_load = time.monotonic()
        api.faults.load_plan(plan)
        marks = {"load": mutations()}
        stage.podres.set("default", gm, ids)
        stage.bind(gm, BROWNOUT_NODE)  # the pod watch open now may still carry it
        queued_max = [0]

        def queued() -> float:
            q = stage.metric("tpu_plugin_kube_queued_writes", base=dbase) or 0
            queued_max[0] = max(queued_max[0], q)
            return q

        opened = stage.first_seen({
            "daemon_open": lambda: stage.metric("tpu_plugin_kube_circuit_state", base=dbase) == 1,
            "extender_open": lambda: stage.metric("tpu_extender_kube_circuit_state") == 1,
            "daemon_degraded": lambda: stage.metric("tpu_plugin_kube_degraded_mode",
                                                    base=dbase) == 1,
            "extender_degraded": lambda: stage.metric("tpu_extender_kube_degraded_mode") == 1,
        }, lim["w_s"])
        inside: dict = {"filter": [], "readyz": [], "util": [], "stepping": []}
        while time.monotonic() < t_load + lim["w_s"] - 1.0:
            inside["filter"].append(http_post_json(base + "/filter", verdict) == before)
            inside["readyz"].append(http_get(base + "/readyz")[0])
            inside["stepping"].append(pod_proc.poll() is None)
            inside["util"].append(duty())
            queued()
            time.sleep(1.0)
        seen = opened()
        while time.monotonic() < t_load + lim["w_s"]:
            time.sleep(0.005)
        marks["clear"] = mutations()
        api.faults.clear()
        t_clear = time.monotonic()
        holder = api.leases[LEASE_KEY]["spec"].get("holderIdentity", "")
        w = {f"load_to_{k}_s": t - t_load for k, t in sorted(seen.items())}
        w.update(w_s=t_clear - t_load, filter_same=all(inside["filter"]),
                 readyz=sorted(set(inside["readyz"])), polls=len(inside["filter"]),
                 util_min=min(inside["util"]), stepping=all(inside["stepping"]),
                 queued_writes_max=queued_max[0], mutations_same=marks["load"] == marks["clear"],
                 lease_holder=holder)
        line["brownout"] = w
        late = {k: v for k, v in w.items() if k.startswith("load_to_") and v > (
            lim["open_daemon_s"] if "daemon" in k else lim["open_extender_s"])}
        if late:
            stage.fail(f"past the brownout's limits: {late} ({lim})")
        if not (w["filter_same"] and w["readyz"] == [200] and w["stepping"]
                and w["util_min"] >= 50 and w["mutations_same"] and holder == GANG_IDENTITY):
            stage.fail(f"inside W: {w}")

        # 3. Recovery, timed from the clear: both breakers closed, both
        # degraded gauges at 0, the daemon's queued writes delivered.
        # The breaker's own reset runs from its opening.
        reset_left = {k: max(0.0, seen[f"{k}_open"] + lim["breaker_reset_s"] - t_clear)
                      for k in ("daemon", "extender")}
        bounds = {"daemon": reset_left["daemon"] + lim["closed_daemon_after_reset_s"],
                  "extender": reset_left["extender"] + lim["closed_extender_after_reset_s"]}
        closed = stage.first_seen({
            "daemon_closed": lambda: stage.metric("tpu_plugin_kube_circuit_state",
                                                  base=dbase) == 0,
            "extender_closed": lambda: stage.metric("tpu_extender_kube_circuit_state") == 0,
            "daemon_not_degraded": lambda: stage.metric("tpu_plugin_kube_degraded_mode",
                                                        base=dbase) == 0,
            "extender_not_degraded": lambda: stage.metric("tpu_extender_kube_degraded_mode")
            == 0,
            "queued_delivered": lambda: queued() == 0 and constants.POD_DEVICES_ANNOTATION in (
                api.pods[("default", gm)]["metadata"].get("annotations") or {}),
        }, max(bounds.values()) + 10)()
        rec = {f"clear_to_{k}_s": t - t_clear for k, t in sorted(closed.items())}
        rec["limits_s"] = bounds
        line["recovery"] = rec
        late = {k: v for k, v in rec.items() if k.startswith("clear_to_")
                and v > bounds["daemon" if ("daemon" in k or "queued" in k) else "extender"]}
        if late:
            stage.fail(f"recovery past its limits: {late} ({bounds})")
        if api.pods[("default", gm)]["metadata"]["annotations"][
                constants.POD_DEVICES_ANNOTATION] != ",".join(sorted(ids)):
            stage.fail(f"G's devices annotation: {api.pods[('default', gm)]['metadata']}")

        def clean_sweeps(b: str, who: str, want: tuple) -> dict:
            """Two sweeps after recovery, both clean, ``want`` among the
            invariants."""
            def counts():
                return {o: stage.metric("tpu_audit_sweeps_total", base=b, outcome=o) or 0
                        for o in ("clean", "findings", "error")}
            c0 = counts()
            stage.until(lambda: counts()["clean"] >= c0["clean"] + 2, f"two {who} sweeps",
                        bound_s=4 * GANG_AUDIT_INTERVAL_S + 10, every_s=0.1)
            c1 = counts()
            snap = json.loads(http_get(b + "/debug/audit")[1])
            names = sorted(i["name"] for i in snap.get("invariants", []))
            out = {"counts": c1, "invariants": names}
            if (c1["findings"] != c0["findings"] or c1["error"] != c0["error"]
                    or snap.get("findings") or not set(want) <= set(names)):
                stage.fail(f"the {who}'s audit after recovery: {out} {snap.get('findings')}")
            return out

        line["audit_after_recovery"] = {
            "daemon": clean_sweeps(dbase, "daemon", ("degraded_consistency",)),
            "extender": clean_sweeps(base, "extender",
                                     ("degraded_consistency", "placeable_recount")),
        }

        # 4. The partition: every request reset until the extender exits;
        # the daemon keeps serving the card meanwhile.
        lists: list = []
        law_call = stage.stub.ListAndWatch(pb.Empty())

        def law() -> None:
            try:
                for resp in law_call:
                    lists.append((time.monotonic(), [(d.ID, d.health) for d in resp.devices]))
            except Exception as e:  # noqa: BLE001 - the stream's end, read below
                lists.append((time.monotonic(), repr(e)))

        law_thread = threading.Thread(target=law, daemon=True)
        law_thread.start()
        stage.until(lambda: lists, "the ListAndWatch stream's first list")
        t_renew = after_renewal()
        api.faults.add(kind="reset", times=-1)
        t_part = time.monotonic()
        n_lists = len(lists)
        part: dict = {"util": [], "free": [], "stepping": []}
        while stage.ext.poll() is None and time.monotonic() < t_part + lim[
                "partition_exit_s"] + 10:
            part["util"].append(duty())
            part["free"].append(stage.metric("tpu_node_free_chips", base=dbase))
            part["stepping"].append(pod_proc.poll() is None)
            time.sleep(0.5)
        ext_rc = stage.ext.poll()
        t_exit = time.monotonic()
        api.faults.clear()
        p = {"exit_rc": ext_rc, "renewal_to_exit_s": t_exit - t_renew,
             "partition_to_exit_s": t_exit - t_part, "limit_s": lim["partition_exit_s"],
             "lists_during": len(lists) - n_lists, "stream_open": law_thread.is_alive(),
             "free_chips": sorted(set(part["free"])), "util_min": min(part["util"]),
             "stepping": all(part["stepping"])}
        line["partition"] = p
        if ext_rc in (None, 0) or p["renewal_to_exit_s"] > lim["partition_exit_s"]:
            stage.fail(f"the partitioned extender: {p}")
        if not (p["stream_open"] and p["lists_during"] == 0 and p["free_chips"] == [0]
                and p["util_min"] >= 50 and p["stepping"]):
            stage.fail(f"the daemon's card through the partition: {p} {lists[-1:]}")
        t_restart = time.monotonic()
        stage.start_extender()
        p["restart_to_readyz_s"] = stage.t_ready - t_restart

        # 5. The resilience self-test over the same plan file.
        st = subprocess.run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.utils.resilience",
                             "--resilience-self-test", "--chaos-plan", str(BROWNOUT_PLAN)],
                            cwd=ROOT, capture_output=True, text=True, timeout=120)
        line["self_test"] = {"rc": st.returncode,
                             "result": json.loads(st.stdout.splitlines()[-1])
                             if st.returncode == 0 else st.stdout[-2000:]}
        if st.returncode != 0:
            stage.fail(f"utils.resilience --resilience-self-test: {st.stdout} {st.stderr}")

        # 6. G's pod: its timed steps spanned W and the partition.
        rc = pod_proc.wait(timeout=PLUGIN_WAIT_S * 3)
        final = [(t, snap) for t, snap in pod_lines if "partial" not in snap]
        if rc != 0 or not final:
            stage.fail(f"G's pod exited {rc} with {pod_lines[-1:]}")
        t_report, report = final[-1]
        t_first = next(t for t, snap in pod_lines if snap.get("partial") == "first_step")
        launches = report["kernel_launches"]
        want = bench_pod_launches(report["steps_run"])
        step, main_step = report.get("step_time_s"), main_report.get("step_time_s")
        control_step = control_report["step_time_s"]
        line["pod"] = {k: report.get(k) for k in (
            "ok", "device_uuid", "steps_run", "step_time_s", "mfu", "kernel_launches")}
        line["pod"].update(main_path_step_time_s=main_step,
                           step_vs_main=step / main_step if step and main_step else None,
                           step_vs_control=step / control_step,
                           spans_w_and_partition=t_first < t_load and t_report > t_exit)
        pod_ok = (report["ok"] and report.get("device_uuid") in ids and launches == want
                  and control_report["ok"] and line["pod"]["spans_w_and_partition"]
                  and abs(line["pod"]["step_vs_control"] - 1) <= POD_STEP_BAND)
        if pod_ok:
            law_call.cancel()
            law_call = None
            line["audit"] = stage.audit_and_stop("placeable_recount")
        line["phase_s"] = time.monotonic() - t_phase
        emit({"brownout": line})  # every time, the pod's verdict's too
        if not pod_ok:
            stage.fail(f"G's pod: {line['pod']}, launches expected {want}")
    finally:
        if law_call is not None:
            law_call.cancel()
        if duty is not None:
            duty.close()
        stage.close()
    return launches


# The port's traces: the four canned ones its golden covers, and hgx_su.
SIM_TRACES = PACKAGE / "extender" / "sim_traces"


def phase_simulator() -> None:
    """Phase 25: ``tpu-simreport --self-test`` and ``run --json`` in their own
    processes, every canned scorecard's sha256 against the port's golden;
    then each canned trace and ``hgx_su`` (twice) replayed in this process,
    timed. One line per run, the card's name and power limit on each."""
    import hashlib
    import logging

    from k8s_device_plugin_tpu_torch.extender import simulator

    smi = nvidia_smi()
    cli = [sys.executable, "-m", "k8s_device_plugin_tpu_torch.tools.simreport"]
    t0 = time.monotonic()
    out = subprocess.run(cli + ["--self-test"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    wall = time.monotonic() - t0
    lines = out.stdout.strip().splitlines()
    verdict = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    emit({"simulator": {"run": "self_test", "rc": out.returncode, "wall_s": wall, **verdict,
                        "nvidia_smi": smi}})
    if out.returncode != 0 or verdict.get("simulator_self_test") != "ok":
        fail(f"tpu-simreport --self-test exited {out.returncode}:\n{out.stdout[-3000:]}\n"
             f"{out.stderr[-3000:]}")
    golden = simulator.load_golden()
    if golden is None or set(golden["traces"]) != set(simulator.CANNED_TRACES):
        fail(f"the port's golden {simulator.golden_path()} is missing or incomplete")
    t0 = time.monotonic()
    out = subprocess.run(cli + ["run", "--json"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.monotonic() - t0
    cards = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    shas = {c["scorecard"]["trace"]: hashlib.sha256(
        simulator.canonical_json(c["scorecard"]).encode()).hexdigest() for c in cards}
    bad = {c["scorecard"]["trace"]: c["deltas"] for c in cards
           if any(v != 0 for v in c["deltas"].values()) or not c["deltas"]}
    mismatch = sorted(name for name in simulator.CANNED_TRACES
                      if shas.get(name) != golden["traces"][name]["sha256"])
    emit({"simulator": {"run": "run_json", "rc": out.returncode, "wall_s": wall,
                        "traces": sorted(shas), "golden_mismatch": mismatch, "deltas_nonzero": bad,
                        "nvidia_smi": smi}})
    if out.returncode != 0 or mismatch or bad:
        fail(f"tpu-simreport run --json: rc {out.returncode}, golden mismatch {mismatch}, "
             f"deltas {bad}\n{out.stderr[-3000:]}")

    def replay(name: str) -> tuple[dict, str]:
        t0 = time.monotonic()
        logging.disable(logging.WARNING)  # every round logs a line
        try:
            card = simulator.run_trace(str(SIM_TRACES / f"{name}.json"))
        finally:
            logging.disable(logging.NOTSET)
        wall = time.monotonic() - t0
        sha = hashlib.sha256(simulator.canonical_json(card).encode()).hexdigest()
        score = card["score"]
        emit({"simulator": {"trace": name, "wall_s": wall, "arrivals": card["arrivals"],
                            "admitted_ratio": score["admitted_ratio"],
                            "utilization": score["utilization"],
                            "evictions": score["evictions_total"], "sha256": sha,
                            "nvidia_smi": smi}})
        return card, sha

    for name in simulator.CANNED_TRACES:
        _card, sha = replay(name)
        if sha != shas[name]:
            fail(f"{name} replayed in this process reads {sha}, the CLI's {shas[name]}")
    first, sha_a = replay("hgx_su")
    _again, sha_b = replay("hgx_su")
    if sha_a != sha_b:
        fail(f"hgx_su's two replays differ: {sha_a} and {sha_b}")
    if first["arrivals"]["admitted"] <= 0:
        fail(f"hgx_su admitted nothing: {first['arrivals']}")


# The bounds of the JAX tests/test_scale_bench.py, which phase 26 holds the
# port's bench to at the same sizes (this script imports nothing of JAX's).
SCALE_BENCH_BOUNDS = {
    "warm_p50_ms": {"filter": 25, "prioritize": 30, "filter_objects": 60,
                    "prioritize_objects": 70, "gang_tick_steady": 100, "gang_tick_full": 250,
                    "gang_tick_dirty": 100, "gang_tick_idle": 20},
    "warm_spike_ratio": 3.0,
    "warm_spike_floor_ms": 30.0,
    "cold_ms": 2000.0,
    "overhead_ratio": 1.05,
    "overhead_floor_ms": 0.3,
    "phase_s": 60.0,
}


def scale_bench_run_problems(r: dict) -> list:
    """``run``'s bounds: warm p50s, the p99 spike guard of the RPC paths and
    the cold first call."""
    b = SCALE_BENCH_BOUNDS
    out = [f"{k} p50 {r[k]['p50_ms']}ms >= {v}ms"
           for k, v in b["warm_p50_ms"].items() if r[k]["p50_ms"] >= v]
    for k in ("filter", "prioritize", "filter_objects", "prioritize_objects"):
        limit = max(b["warm_spike_ratio"] * r[k]["p50_ms"], b["warm_spike_floor_ms"])
        if r[k]["p99_ms"] >= limit:
            out.append(f"{k} warm p99 {r[k]['p99_ms']}ms >= {limit:.0f}ms")
    out += [f"cold {k} {r['cold_first_call'][k]}ms >= {b['cold_ms']}ms"
            for k in ("filter_ms", "prioritize_ms", "index_build_ms")
            if r["cold_first_call"][k] >= b["cold_ms"]]
    return out


def scale_bench_ratio(r: dict, control: str, arm: str, paths) -> list:
    """An overhead probe's bound: each path's arm p99 within 1.05x + 0.3 ms
    of its control's."""
    b = SCALE_BENCH_BOUNDS
    return [f"{path}: {arm} p99 {r[arm][path]['p99_ms']}ms vs {control} "
            f"{r[control][path]['p99_ms']}ms"
            for path in paths
            if r[arm][path]["p99_ms"] > b["overhead_ratio"] * r[control][path]["p99_ms"]
            + b["overhead_floor_ms"]]


def phase_scale_bench() -> None:
    """Phase 26: the bench's self-tests and refusal in their own processes,
    then each tier-1-size probe in this process, held to the tests' bounds
    with one full re-run. One line per probe, then the phase's wall time."""
    import logging

    from k8s_device_plugin_tpu_torch.extender import scale_bench as sb

    smi = nvidia_smi()
    t_phase = time.monotonic()
    cli = [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender.scale_bench"]
    for flag in ("--cold-start-self-test", "--profile-self-test", "--placement-self-test"):
        key = flag[2:].replace("-", "_")
        t0 = time.monotonic()
        out = subprocess.run(cli + [flag], cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        wall = time.monotonic() - t0
        lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
        verdict = json.loads(lines[-1]) if lines else {}
        emit({"scale_bench": {"run": key, "rc": out.returncode, "wall_s": wall, **verdict,
                              "nvidia_smi": smi}})
        if out.returncode != 0 or verdict.get(key) != "ok":
            fail(f"scale_bench {flag} exited {out.returncode}:\n{out.stdout[-3000:]}\n"
                 f"{out.stderr[-3000:]}")
    out = subprocess.run(cli + ["--placement-kernel"], cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    refusal = out.stderr.strip().splitlines()
    emit({"scale_bench": {"run": "placement_kernel", "rc": out.returncode,
                          "stderr": refusal, "nvidia_smi": smi}})
    if (out.returncode != 2 or out.stdout or len(refusal) != 1
            or "--placement-kernel" not in refusal[0]):
        fail(f"scale_bench --placement-kernel: rc {out.returncode}, stdout {out.stdout!r}, "
             f"stderr {out.stderr!r}")

    def held(name: str, probe, problems, summary) -> dict:
        """The probe, and once more if a bound failed (the suite's host
        contention re-run); fails the phase if the second run fails too."""
        for attempt in (1, 2):
            t0 = time.monotonic()
            r = probe()
            wall = time.monotonic() - t0
            found = problems(r)
            emit({"scale_bench": {"probe": name, "attempt": attempt, "wall_s": wall,
                                  **summary(r), "problems": found, "nvidia_smi": smi}})
            if not found:
                return r
        fail(f"scale_bench {name}: {found}")

    def pctls(r: dict, *paths) -> dict:
        out = {}
        for path in paths:
            node = r
            for k in path.split("."):
                node = node[k]
            out[path] = [node["p50_ms"], node["p99_ms"]]
        return out

    logging.disable(logging.WARNING)  # the relists and sweeps log per node
    try:
        held("run", lambda: sb.run(n_nodes=1000, n_gangs=100, filter_calls=20, tick_rounds=2),
             scale_bench_run_problems,
             lambda r: {"p50_p99_ms": pctls(r, "filter", "prioritize", "filter_objects",
                                            "prioritize_objects", "gang_tick_full",
                                            "gang_tick_steady", "gang_tick_dirty",
                                            "gang_tick_idle"),
                        "index_build_ms": r["cold_first_call"]["index_build_ms"],
                        "cold_filter_ms": r["cold_first_call"]["filter_ms"]})

        def shard_problems(r):
            peer = r["sharded"]["filter_peer_overlay"]["p99_ms"]
            single = r["single"]["filter"]["p99_ms"]
            out = []
            if sum(v["gangs"] for v in r["sharded"]["per_shard"].values()) != 30:
                out.append(f"shards admitted {r['sharded']['per_shard']}, not 30 gangs")
            if peer >= max(1.1 * single, single + 2.0):
                out.append(f"peer-overlay /filter p99 {peer}ms vs single {single}ms")
            return out

        held("shard_scaling",
             lambda: sb.shard_scaling(n_nodes=300, n_gangs=30, shards=3, filter_calls=20),
             shard_problems,
             lambda r: {"p50_p99_ms": pctls(r, "single.filter", "sharded.filter_local",
                                            "sharded.filter_peer_overlay"),
                        "gangs_per_s": r["single"]["gangs_per_s"],
                        "gangs_per_s_parallel": r["sharded"]["gangs_per_s_parallel"]})

        def defrag_problems(r):
            out = []
            if r["plan_victims"] != 1 or 4 not in r["placeable_after"]:
                out.append(f"plan {r['plan_victims']} victims, after {r['placeable_after']}")
            if r["plan"]["p99_ms"] >= 50.0:
                out.append(f"plan p99 {r['plan']['p99_ms']}ms >= 50ms")
            if r["detect"]["p99_ms"] >= 25.0:
                out.append(f"detect p99 {r['detect']['p99_ms']}ms >= 25ms")
            return out

        held("defrag_planning", lambda: sb.defrag_planning(n_nodes=1000, samples=20),
             defrag_problems,
             lambda r: {"p50_p99_ms": pctls(r, "detect", "plan"),
                        "plan_victims": r["plan_victims"],
                        "placeable_after": r["placeable_after"]})

        def cold_problems(r):
            full = r["full_parse"]["time_to_ready"]["p50_ms"]
            snap = r["snapshot_warm"]["time_to_ready"]["p50_ms"]
            stale = r["snapshot_stale"]["time_to_ready"]["p50_ms"]
            out = []
            if snap * 5 > full:
                out.append(f"snapshot time to ready p50 {snap}ms not 5x under {full}ms")
            if stale > 1.05 * full + 2.0:
                out.append(f"stale fallback p50 {stale}ms over 1.05x {full}ms + 2ms")
            if r["snapshot_warm"]["restored_per_start"] != 1000:
                out.append(f"restored {r['snapshot_warm']['restored_per_start']} per start")
            return out

        held("cold_start",
             lambda: sb.cold_start(n_nodes=1000, ready_samples=101, slow_samples=7),
             cold_problems,
             lambda r: {"p50_p99_ms": pctls(r, "full_parse.time_to_ready",
                                            "snapshot_warm.time_to_ready",
                                            "snapshot_stale.time_to_ready",
                                            "snapshot_warm.cold_first_call",
                                            "snapshot_warm.warm_drain"),
                        "ready_speedup_p50": r["ready_speedup_p50"],
                        "stale_overhead_pct": r["stale_overhead_pct"]})
        for name, probe, control, arm, paths in (
                ("telemetry_overhead",
                 lambda: sb.telemetry_overhead(n_nodes=60, filter_calls=101, tick_rounds=101,
                                               sampler_rounds=5),
                 "control", "tracked", ("filter", "prioritize", "tick_dirty")),
                ("audit_overhead",
                 lambda: sb.audit_overhead(n_nodes=60, n_holds=10, filter_calls=101,
                                           sweep_every=10, sweep_rounds=5),
                 "control", "audited", ("filter",)),
                ("profiler_overhead", lambda: sb.profiler_overhead(n_nodes=60, filter_calls=101),
                 "control", "profiled", ("filter",)),
                ("blackbox_overhead", lambda: sb.blackbox_overhead(n_nodes=60, filter_calls=101),
                 "control", "blackbox", ("filter",)),
                ("resilience_overhead", lambda: sb.resilience_overhead(calls=101, batch=50),
                 "control", "wrapped", ("call",))):
            held(name, probe,
                 lambda r, c=control, a=arm, p=paths: scale_bench_ratio(r, c, a, p),
                 lambda r, c=control, a=arm, p=paths: {
                     "p50_p99_ms": pctls(r, *(f"{x}.{path}" for x in (c, a) for path in p))})
    finally:
        logging.disable(logging.NOTSET)
    wall = time.monotonic() - t_phase
    emit({"scale_bench": {"phase_wall_s": wall, "limit_s": SCALE_BENCH_BOUNDS["phase_s"],
                          "nvidia_smi": smi}})
    if wall >= SCALE_BENCH_BOUNDS["phase_s"]:
        fail(f"phase 26 took {wall:.1f} s, not under {SCALE_BENCH_BOUNDS['phase_s']} s")


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
    phase_lint()
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
    gang_launches = phase_gang(main_report)
    shard_launches = phase_shards(main_report)
    preempt_launches = phase_preemption(main_report)
    defrag_launches = phase_defrag(main_report)
    rescue_launches = phase_rescue(main_report)
    brownout_launches = phase_brownout(main_report)
    phase_simulator()
    phase_scale_bench()
    dist.destroy_process_group()
    path_launches = {name: (launches[name], steps) for name in FLASH}
    path_launches["rmsnorm"] = (norm_launches["rmsnorm"], norm_steps)
    path_launches["head_gemm"] = (launches["head_gemm"], steps)
    by_path = {"bench": launches, "norm": norm_launches, "multi_step": multi_launches,
               "generate_dense": dense_gen, "generate_flash": flash_gen,
               "sharded": sharded_launches, "moe": moe_launches, "ring": ring_launches,
               "resume": resume_launches, "kv_sweep": sweep_launches,
               "plugin_pod": pod_launches, "dra_pod": dra_launches, "gang_pod": gang_launches,
               "shard_pod": shard_launches, "preempt_pod": preempt_launches,
               "defrag_pod": defrag_launches, "rescue_pod": rescue_launches,
               "brownout_pod": brownout_launches}
    emit({"tools": {"nvidia_smi": nvidia_smi(), "runs": [
        {k: r[k] for k in ("phase", "tool", "rc", "wall_s")}
        | {"verb": r["args"][0] if r["tool"] == "doctor" else ""} for r in TOOL_RUNS]}})
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
