"""A cell of several cards on the CPU: four gloo ranks through the harness's
``chips`` > 1 path (``ranks.py``) at a tiny size, the reference laid over
several devices, and the per-card arithmetic of the readers."""

import dataclasses
import json
import math
import threading
import time

import pytest
import torch

from gpubench import arith, correct, faults, families, generator, ranks, run, trace
from gpubench.families import dense_lm
from gpubench.kinds import train
from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool

CELL = "cerebras-gpt-6.7b.train-tp4"
SEED = 2**31 + 13
# Four heads, so that the model axis of 4 splits them (and the vocabulary,
# 256 rows, as the real cell's 50257 cannot be).
HEADS = 4


@pytest.fixture
def tp_cell(tiny_cell):
    return _tp(tiny_cell)


def _tp(tiny_cell):
    cell = tiny_cell(CELL)
    return dataclasses.replace(cell, config=dict(cell.config, n_head=HEADS))


def _one_card(cell):
    return dataclasses.replace(cell, chips=1, traffic={k: v for k, v in cell.traffic.items()
                                                      if k != "mesh"})


def test_four_rank_run_is_correct_on_four_devices(tp_cell):
    result = run.run_cell(tp_cell, SEED, 0.5, False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 4 and result["failed"] == 0
    assert result["attempted"] >= 2
    assert set(result["metrics"]) == {m["name"] for m in tp_cell.end_to_end} - {"peak_mem_gib"}
    assert list(result)[-1] == "checks"
    json.dumps(result, allow_nan=False)


def test_four_rank_readings_equal_the_one_process_runs(tp_cell):
    """The whole model's readings put together from four ranks' slices
    against one process's on the same weights and batches. The model axis
    sums each rank's bf16 partial products in bf16 (Megatron's pair), where
    one process accumulates the whole product in f32 and rounds once: the
    two differ by bf16 rounding (2^-8 of a leaf's norm at most, 1e-4 nats
    of loss as read), not by f32 rounding."""
    with RankPool(4, "cpu") as pool:
        evidence = train.gather(pool.run(ranks.rank_evidence, tp_cell, SEED, "cpu"))
    one = train.start(_one_card(tp_cell), SEED, torch.device("cpu")).evidence
    assert set(evidence.split) >= {"embed", "blocks.0.attn.wq", "blocks.1.mlp.w2"}
    assert torch.equal(evidence.batches, one.batches)
    gaps = correct.gaps(evidence.readings, one.readings)
    assert gaps["loss_gap"] < 1e-3
    assert gaps["grad_gap"] < 2**-8 and gaps["change_gap"] < 2**-8, gaps


@pytest.mark.parametrize("kind", faults.KINDS + faults.SPLIT_KINDS)
def test_each_fault_makes_the_four_rank_run_incorrect(tp_cell, kind):
    with faults.planted(kind):
        result = run.run_cell(tp_cell, SEED, 0.2, False, device="cpu")
    assert result["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in result["checks"].values()), result["checks"]


def test_control_fails_the_four_card_cells_limits(tp_cell):
    """The reference one precision step lower (fp8 block products, TF32
    head), put in the place of the four ranks' program, reads over a limit
    of the cell; the program's readings, taken over the ranks, do not."""
    fam = families.load(tp_cell.config)
    sz = fam.sizes(tp_cell.config)
    dev = torch.device("cpu")
    opt = tp_cell.traffic["optimizer"]
    with RankPool(4, "cpu") as pool:
        progs = {seed: train.gather(pool.run(ranks.rank_evidence, tp_cell, seed, "cpu"))
                 for seed in (1, 2, 3)}
    for seed, prog in progs.items():
        ref = correct.reference_readings(fam, sz, seed, prog.batches, opt, dev, devices=[dev] * 4)
        ctl = correct.reference_readings(fam, sz, seed, prog.batches, opt, dev, "control",
                                         [dev] * 4)
        assert not all(c["ok"] for c in correct.checks(correct.gaps(ctl, ref, fam.HEAD_LEAVES),
                                                       tp_cell.limits).values())
        assert all(c["ok"] for c in correct.checks(correct.gaps(prog.readings, ref, fam.HEAD_LEAVES),
                                                   tp_cell.limits).values())


def test_calibrate_reads_the_four_rank_program_and_each_side(tp_cell, monkeypatch, capsys):
    """``calibrate.py`` through the same four-rank path: the program's
    readings under the cell's limits, the control and both faults over
    one of them."""
    from gpubench import calibrate

    monkeypatch.setattr(run, "load_cell", lambda name: tp_cell)
    monkeypatch.setenv("TPU_WORKLOAD_COMPILATION_CACHE_DIR", "unused on the CPU")
    assert calibrate.main(["--workload", CELL, "--seeds", "1", "--control-seeds", "1",
                           "--fault-seeds", "1", "--device", "cpu"]) == 0
    line, summary = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert line["seed"] == 1 and summary["workload"] == CELL

    def over(side):
        return [k for k, v in tp_cell.limits.items() if not line[side][k] <= v]

    assert over("program") == []
    assert over("control") and over("half_batch") and over("no_exchange")


def test_traced_four_rank_run_reads_the_first_ranks_spans(tp_cell):
    result = run.run_cell(tp_cell, SEED, 0.3, True, device="cpu")
    assert result["correct"] is True and result["device"]["count"] == 4
    # The CPU has no device trace: only the host's span is read.
    assert set(result["metrics"]) == {"dispatch_ms"}
    assert result["device"]["window_s"] > 0


def test_a_rank_that_loads_a_forbidden_module_fails_the_run(tp_cell, monkeypatch):
    monkeypatch.setattr(run, "forbidden_modules", lambda: ["jax"])
    got = [{"loaded": ["jax"], "window": {"steps": 2, "opened": 0.0}, "started": 0.0}]
    monkeypatch.setattr(RankPool, "__init__", lambda self, *a, **k: None)
    monkeypatch.setattr(RankPool, "run", lambda self, *a: got)
    monkeypatch.setattr(RankPool, "close", lambda self: None)
    with pytest.raises(run.Forbidden, match="jax"):
        ranks.run_cell(tp_cell, SEED, 0.2, False, device="cpu", start=0.0)


def test_the_reference_on_four_devices_is_the_one_device_reference(tiny_cell):
    """Laid over four devices (all the CPU here), the reference takes the
    same steps as on one: the same losses, gradients and parameters."""
    cell = _tp(tiny_cell)
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    dev = torch.device("cpu")
    batches = generator.batches(cell.traffic, sz.vocab, sz.seq, SEED, dev)[:2]
    opt = cell.traffic["optimizer"]
    runs = [list(fam.reference_steps(sz, fam.place(sz, fam.initial_weights(sz, SEED, dev), d),
                                     batches, opt))
            for d in ([dev], [dev] * 4)]
    for (loss, grads, params), (loss4, grads4, params4) in zip(*runs):
        assert torch.equal(loss, loss4)
        for name in grads:
            assert torch.equal(grads[name], grads4[name]), name
            assert torch.equal(params[name], params4[name]), name
    one = correct.reference_readings(fam, sz, SEED, batches, opt, dev)
    four = correct.reference_readings(fam, sz, SEED, batches, opt, dev, devices=[dev] * 4)
    assert one == four


def _sizes(name):
    with open(run.HERE / "configs" / f"{name}.json") as f:
        return dense_lm.sizes(json.load(f))


def test_cerebras_sizes_and_parameters_are_the_published_ones():
    sz = _sizes("cerebras-gpt-6.7b")
    assert sz == dense_lm.Sizes(vocab=50257, d_model=4096, heads=32, layers=32, d_ff=16384,
                                seq=2048)
    specs = dense_lm.leaves(sz)
    assert sum(math.prod(s) for _, s, _ in specs) == 6_656_958_464
    # 3 x 4 x 2048 x (32 x (8 d^2 + 4 s d + 4 d d_ff) + 2 d V)
    assert dense_lm.flops_per_step(sz, 4) == 3 * 4 * 2048 * 14_370_349_056


def test_placement_lays_32_layers_8_to_a_card():
    sz = _sizes("cerebras-gpt-6.7b")
    cards = [torch.device("cuda", i) for i in range(4)]
    where = dense_lm.placement(sz, cards)
    assert set(where) == {name for name, _, _ in dense_lm.leaves(sz)}
    layers = {i: {where[f"blocks.{i}.{leaf}"] for leaf in dense_lm._BLOCK_LEAVES}
              for i in range(sz.layers)}
    assert all(len(d) == 1 for d in layers.values())
    for c, card in enumerate(cards):
        assert [i for i, d in layers.items() if d == {card}] == list(range(8 * c, 8 * c + 8))
    assert where["embed"] == where["pos"] == cards[0] and where["norm.scale"] == cards[3]


def test_flash_shape_and_mfu_read_per_card_under_model_4():
    sz = _sizes("cerebras-gpt-6.7b")
    assert dense_lm.flash_shape(sz, 4) == (4, 32, 2048, 128)
    assert dense_lm.flash_shape(sz, 4, (1, 1, 4)) == (4, 8, 2048, 128)
    # A model axis that does not divide the heads leaves them whole; the
    # batch splits over data x fsdp.
    assert dense_lm.flash_shape(sz, 4, (1, 1, 3)) == (4, 32, 2048, 128)
    assert dense_lm.flash_shape(sz, 8, (2, 2, 1)) == (2, 32, 2048, 128)

    fwd = trace_summary(flash={"fwd": (1e-3, 32)})
    tp = dict(mesh=[1, 1, 4])

    def ctx(chips, traffic):
        window = {"seconds": 10.0, "steps": 20, "step_s": [0.5] * 20, "dispatch_s": [],
                  "counters": {}}
        return run.Context(window=window, units_per_step=8192, peak_bytes=None, setup_s=1.0,
                           family=dense_lm, sizes=sz, traffic={"batch": 4, **traffic},
                           summary=fwd, chips=chips)

    bound = 32 * arith.flash_bound_s("fwd", 4, 8, 2048, 128)
    assert run.reader("flash_roofline_pct")(ctx(4, tp)) == pytest.approx(100 * bound / 1e-3)
    assert run.reader("flash_roofline_pct")(ctx(1, {})) == pytest.approx(400 * bound / 1e-3)
    flops = dense_lm.flops_per_step(sz, 4)
    assert run.reader("mfu_pct")(ctx(4, tp)) == pytest.approx(100 * flops / (4 * 989e12 * 0.5))
    assert run.reader("mfu_pct")(ctx(1, {})) == pytest.approx(4 * run.reader("mfu_pct")(ctx(4, tp)))


def trace_summary(**fields):
    base = dict(steps=1, window_s=1.0, busy_s=0.5, group_s={}, flash={}, device_ops=[],
                idle_gaps=[], events=[])
    return trace.Summary(**{**base, **fields})


# Kernel names of the one-card cells' breakdowns (the ledger's, PRs 27-29),
# with the group each has always had.
ONE_CARD = [
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT", "matmul"),
    ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN", "matmul"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_w", "matmul_f32"),
    ("void_cutlass::Kernel2_cutlass_80_simt_sgemm_128x256_8x4_nt_align", "matmul_f32"),
    ("void_head::gemm_f32f32_3xtf32_nn_0__head::Maps__head::Operand__f", "matmul_f32"),
    ("void_flash::dkv_kernel_128__2__true__CUtensorMap_st__CUtensorMap", "flash_bwd"),
    ("void_at::native::elementwise_kernel_128__2__at::native::gpu_kern", "other"),
    ("void_at::native::vectorized_elementwise_kernel_4__at::native::Bi", "other"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "optimizer"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "softmax_xent"),
]


@pytest.mark.parametrize("name, group", ONE_CARD)
def test_one_card_kernels_keep_their_group(name, group):
    assert arith.group(name) == group


@pytest.mark.parametrize("name", [
    "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWork)",
    "void NCCL_allreduce_kernel<float>(...)",
])
def test_nccl_kernels_land_in_collective(name):
    assert arith.GROUPS[0][0] == "collective"
    assert arith.group(name) == "collective"


def test_collective_readers_of_a_made_up_trace():
    """NCCL at 0-10 and 20-30 ms of two steps; a product under 5-8 ms and
    elementwise work under 25-35 ms hide 8 of its 20 ms."""
    events = [trace.Event("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", True, 0.0, 0.010),
              trace.Event("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT", True, 0.005, 0.008),
              trace.Event("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", True, 0.020, 0.030),
              trace.Event("void at::native::vectorized_elementwise_kernel<4>", True, 0.025, 0.035),
              trace.Event("cudaLaunchKernel", False, 0.0, 0.035)]
    s = trace_summary(steps=2, group_s={"collective": 0.020, "matmul": 0.003, "other": 0.010},
                      events=events)
    ctx = run.Context(window={}, units_per_step=1, peak_bytes=None, setup_s=1.0, family=None,
                      sizes=None, traffic={}, summary=s, chips=4)
    assert run.reader("collective_ms")(ctx) == pytest.approx(10.0)
    assert run.reader("exposed_collective_pct")(ctx) == pytest.approx(60.0)
    one_card = dataclasses.replace(ctx, summary=trace_summary(
        group_s={"matmul": 0.003}, events=[e for e in events if "nccl" not in e.name]))
    for name in ("collective_ms", "exposed_collective_pct"):
        assert run.reader(name)(one_card) is None
        assert run.reader(name)(dataclasses.replace(ctx, summary=None)) is None


def _lockstep(n_ranks: int):
    """A step for each of ``n_ranks`` threads that waits for the others, as
    a collective does, and counts its calls."""
    meet = threading.Barrier(n_ranks)
    counts = [0] * n_ranks

    def step_of(r):
        def step(_):
            meet.wait(timeout=30)
            counts[r] += 1
            time.sleep(0.002)
            return torch.tensor(1.0)
        return step

    return step_of, counts


def _threads(*jobs):
    out = [None] * len(jobs)
    errors = []

    def run_job(i, job):
        try:
            out[i] = job()
        except BaseException as e:  # noqa: BLE001 -- re-raised in the test
            errors.append(e)

    threads = [threading.Thread(target=run_job, args=(i, j)) for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def test_ranks_end_the_window_after_the_same_step():
    store = torch.distributed.HashStore()
    step_of, counts = _lockstep(3)
    teams = [ranks.Team(store, r == 0) for r in range(3)]
    wins = _threads(*[lambda r=r: run._window(step_of(r), [None], 3, 0.1, False, dict, teams[r])
                      for r in range(3)])
    assert len({w["steps"] for w in wins}) == 1 and counts == [wins[0]["steps"]] * 3
    # The first rank's clock ended it: it stopped ``MARGIN`` steps after the
    # step at which its 0.1 s had passed.
    assert wins[0]["steps"] >= 2 + ranks.MARGIN
    assert teams[1].poll_s > 0 and teams[0].poll_s == 0


@pytest.mark.parametrize("lost", [0, 1, 2])
def test_a_trace_that_lost_a_marker_is_taken_once_more(monkeypatch, short_trace, capsys, lost):
    """The first rank's trace loses a marker ``lost`` times: once, it and
    the rank that follows it take the window again; twice, the run fails."""
    real = trace.summarize
    calls = []

    def flaky(prof, steps):
        calls.append(steps)
        if len(calls) <= lost:
            raise trace.MarkerLost(f"the trace holds 1 {trace.MARKER} markers, not 2")
        return real(prof, steps)

    monkeypatch.setattr(trace, "summarize", flaky)
    store = torch.distributed.HashStore()
    step_of, counts = _lockstep(2)
    lead, follower = ranks.Team(store, True), ranks.Team(store, False)
    jobs = (lambda: run._traced(step_of(0), [None], 0, False, lead),
            lambda: ranks.follow_traced(step_of(1), [None], 0, False, follower))
    if lost == 2:
        with pytest.raises(trace.MarkerLost):
            run._traced(lambda _: torch.tensor(1.0), [None], 0, False)
        assert len(calls) == 2
        return
    (summary, _), _ = _threads(*jobs)
    assert len(calls) == lost + 1 and summary.steps == calls[-1]
    assert counts[0] == counts[1]
    assert ("tracing the window once more" in capsys.readouterr().err) == bool(lost)
