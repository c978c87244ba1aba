"""The Moonlight cell's family, configuration and kind, the graphed smoke
cell's kind, and the readers of the metrics they bring: whole runs at a
tiny size on the CPU, and the readers on traces made up by hand."""

import dataclasses
import json
import math

import pytest
import torch
from torch.autograd import DeviceType

from gpubench import arith, arith_mla, correct, faults, families, run, trace
from gpubench.families import deepseek_v3
from gpubench.kinds import train_graphed, train_moe
from gpubench.tests.test_gpubench_spans import Prof, card, context, ev, made_up_spans
from k8s_device_plugin_tpu_torch.workload import deepseek_reference as port_reference

SEED = 2**31 + 11
MOONLIGHT = "moonlight-16b-a3b.train-ep8-8k"
GRAPHED = "smoke-bench.train-graphed"
# DeepSeek-V3's keys at the CPU tests' size: d 64, 4 heads of 24 + 8 q.k
# and 16 v, latent 32, 4 of 8 experts held (top 2), seq 32.
TINY_DS = {"vocab_size": 256, "hidden_size": 64, "num_attention_heads": 4,
           "num_hidden_layers": 3, "intermediate_size": 128, "max_position_embeddings": 32,
           "kv_lora_rank": 32, "qk_nope_head_dim": 24, "qk_rope_head_dim": 8, "v_head_dim": 16,
           "n_routed_experts": 4, "moe_intermediate_size": 32, "num_experts_per_tok": 2,
           "published": {"n_routed_experts": 8, "vocab_size": 2048, "num_hidden_layers": 27}}
TINY_GPT = {"vocab_size": 256, "n_positions": 32, "n_embd": 128, "n_layer": 2, "n_head": 2,
            "n_inner": 256}


def tiny(name):
    cell = run.load_cell(name)
    sizes = TINY_DS if name == MOONLIGHT else TINY_GPT
    return dataclasses.replace(cell, config=dict(cell.config, **sizes),
                               traffic={**cell.traffic, "batch": 2})


def test_the_configuration_states_its_cuts_and_counts_a_cards_parameters():
    cell = run.load_cell(MOONLIGHT)
    cfg = cell.config
    assert cfg["family"] == "deepseek_v3" and cell.chips == 1
    assert set(cfg["reduced"]) == {"n_routed_experts", "vocab_size", "num_hidden_layers"}
    assert cfg["published"] == {"n_routed_experts": 64, "vocab_size": 163840,
                                "num_hidden_layers": 27}
    assert (cfg["n_routed_experts"], cfg["vocab_size"], cfg["num_hidden_layers"]) == (
        8, 163840 // 8, 13)
    sz = deepseek_v3.sizes(cfg)
    assert (sz.n_experts, sz.n_held, sz.top_k, sz.qk_head, sz.v_head, sz.seq) == (
        64, 8, 6, 192, 128, 8192)
    assert sum(math.prod(shape) for _, shape, _ in deepseek_v3.leaves(sz)) == 1_371_730_432
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in bench["workloads"]]
    assert names[-2:] == [GRAPHED, MOONLIGHT]
    assert all(len(w["why"]) <= 200 for w in bench["workloads"])


def test_the_frozen_reference_is_the_ports():
    """The family's copy of the reference and the port's give the same
    loss and gradients on the same weights (the tiny size, f32)."""
    sz = deepseek_v3.sizes(tiny(MOONLIGHT).config)
    weights = deepseek_v3.initial_weights(sz, 5, "cpu")
    tokens = torch.randint(0, sz.vocab, (2, sz.seq), generator=torch.Generator().manual_seed(3))
    biases = {i: torch.zeros(sz.n_experts) for i in range(sz.first_dense, sz.layers)}
    shape = port_reference.Shape(**{f.name: getattr(sz, f.name)
                                    for f in dataclasses.fields(port_reference.Shape)})
    a = {n: w.clone().requires_grad_() for n, w in weights.items()}
    b = {n: w.clone().requires_grad_() for n, w in weights.items()}
    la, _, _ = deepseek_v3.loss(a, biases, tokens, sz)
    lb, _, _ = port_reference.loss(b, biases, tokens, shape)
    la.backward()
    lb.backward()
    assert torch.equal(la, lb)
    assert all(torch.equal(a[n].grad, b[n].grad) for n in a)
    # In blocks of query rows, each recomputed, the same function.
    c = {n: w.clone().requires_grad_() for n, w in weights.items()}
    lc, _, _ = deepseek_v3.loss(c, biases, tokens, sz, block=8, recompute=True)
    lc.backward()
    assert float(lc.detach()) == pytest.approx(float(la.detach()), rel=1e-6)
    # f32 sums in another order: each gradient within 1e-5 of its norm.
    assert all(float((c[n].grad - a[n].grad).norm()) <= 1e-5 * float(a[n].grad.norm())
               for n in a)


@pytest.mark.parametrize("name", [MOONLIGHT, GRAPHED])
def test_a_tiny_run_of_each_new_cell_is_correct(name):
    cell = tiny(name)
    result = run.run_cell(cell, SEED, 0.3, False, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"train_tokens_per_s", "step_ms_p90", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", [MOONLIGHT, GRAPHED])
def test_half_a_batch_makes_each_new_cell_incorrect(name):
    with faults.planted("half_batch"):
        result = run.run_cell(tiny(name), SEED, 0.2, False, device="cpu")
    assert result["correct"] is False


def test_the_moe_kind_reads_both_sides_routing_and_the_counters():
    cell = tiny(MOONLIGHT)
    dev = torch.device("cpu")
    prog = train_moe.start(cell, SEED, dev)
    assert sorted(prog.evidence.choices) == [1, 2]
    assert all(c.shape == (2 * 32, 2) for c in prog.evidence.choices.values())
    counted = train_moe.counters()
    assert counted["moe.layer_steps"] == 3 * 2  # three checked steps, two routed layers
    assert sum(counted[f"moe.rows.{i}"] for i in range(4)) <= 3 * 2 * 64 * 2
    found = train_moe.check(cell, SEED, dev, prog.evidence)
    assert 0.0 <= found["routing_disagreement"] <= 0.1
    assert set(found) >= {"loss_gap", "grad_gap", "change_gap", "head_grad_gap"}
    assert train_moe.disagreement({1: torch.tensor([[0, 1], [2, 3]])},
                                  {1: torch.tensor([[1, 0], [2, 4]])}) == 0.5


def test_the_graphed_kind_compares_the_first_calls_steps():
    cell = tiny(GRAPHED)
    prog = train_graphed.start(cell, SEED, torch.device("cpu"))
    assert prog.pool.shape == (128 // 8, 8, 2, 32)
    assert prog.units_per_step == 8 * 2 * 32
    ev_ = prog.evidence
    assert len(ev_.readings.losses) == 8 and ev_.batches.shape == (8, 2, 32)
    fam = families.load(cell.config)
    assert set(ev_.readings.grad_norms) == {n for n, _, _ in fam.leaves(fam.sizes(cell.config))}
    assert train_graphed.LAST == {"capture_s": None}  # the CPU's eager loop captures nothing


def test_arith_mla_at_equal_widths_is_arith():
    for kind in ("fwd", "dq", "dkv", "delta"):
        assert arith_mla.flash_bound_s(kind, 8, 16, 2048, 128, 128) == pytest.approx(
            arith.flash_bound_s(kind, 8, 16, 2048, 128), rel=1e-12)
    # At 192/128 the forward does (192 + 128) / (2 x 128) of the work.
    assert arith_mla.flash_bound_s("fwd", 2, 16, 8192, 192, 128) == pytest.approx(
        arith.flash_bound_s("fwd", 2, 16, 8192, 128) * 320 / 256, rel=1e-12)


FLASH = {"fwd": "void flash::fwd_kernel<192, 128, 3>(...)",
         "delta": "void flash::bwd_delta_kernel<128>(...)",
         "dq": "void flash::dq_kernel<192, 128, 2>(...)",
         "dkv": "void flash::dkv_kernel<192, 128, 2, true>(...)"}
SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def _summary(events, steps=2):
    return trace.summarize(Prof([card(-0.02, 0.0, SPIN), card(10.0, 10.001, SPIN)] + events),
                           steps=steps)


def _moonlight_ctx(summary, spans=(), counters=None):
    ctx = context(summary, list(spans))
    fam = families.load(run.load_cell(MOONLIGHT).config)
    window = {**ctx.window, "counters": counters or {}}
    return dataclasses.replace(ctx, window=window, family=fam,
                               sizes=fam.sizes(run.load_cell(MOONLIGHT).config),
                               traffic={"batch": 2, "inner_steps": 8})


def test_mla_flash_roofline_reads_the_four_kernels_at_192_128():
    ms = {"fwd": 1.0, "delta": 0.05, "dq": 1.5, "dkv": 2.0}
    events, t = [], 0.5
    for _ in range(2):
        for kind, name in FLASH.items():
            events.append(card(t, t + ms[kind], name))
            t += ms[kind]
    ctx = _moonlight_ctx(_summary(events))
    shape = (2, 16, 8192, 192, 128)
    bound = 2 * sum(arith_mla.flash_bound_s(k, *shape) for k in FLASH)
    want = 100 * bound / (2 * sum(ms.values()) / 1e3)
    assert run.reader("mla_flash_roofline_pct")(ctx) == pytest.approx(want, rel=1e-9)
    assert run.reader("mla_flash_roofline_pct")(_moonlight_ctx(_summary([card(0.5, 1, "gemm")]))
                                                ) is None


def _with_moe_spans(offset_ns):
    spans = made_up_spans(offset_ns)

    def ns(ms):
        return offset_ns + round(ms * 1e6)

    # moe.dispatch in step 1's forward, moe.backward in step 2's backward.
    spans += [{"name": "moe.dispatch", "span_id": "m1", "parent_span_id": "s01", "trace_id": "t0",
               "start_ns": ns(1.25), "end_ns": ns(1.9), "service": "workload"},
              {"name": "moe.backward", "span_id": "m2", "parent_span_id": "", "trace_id": "t9",
               "start_ns": ns(6.4), "end_ns": ns(6.9), "service": "workload"}]
    return spans


def test_moe_ms_counts_the_kernels_launched_inside_the_moe_spans():
    """Six launches inside the two steps, each one kernel later on the
    card; the launches at 1.3 ms (in moe.dispatch) and 6.5 ms (in
    moe.backward) are the second and fifth, whose kernels took 0.2 and
    0.4 ms; a copy between them is no kernel."""
    launches = [1.3, 2.5, 3.5, 5.3, 6.5, 7.5]
    kernels = [(1.4, 1.6), (2.6, 2.7), (3.6, 3.65), (5.5, 5.6), (6.6, 7.0), (7.6, 7.7)]
    events = [ev("cudaLaunchKernel", -0.03, -0.025), ev("cudaLaunchKernel", 8.0, 8.01),
              card(4.0, 4.1, "Memcpy DtoH (Device -> Pageable)"), ev("cudaMemcpyAsync", 4.0, 4.2)]
    events += [ev("cudaLaunchKernel", t, t + 0.01) for t in launches]
    events += [card(a, b) for a, b in kernels]
    summary = _summary(events)
    ctx = _moonlight_ctx(summary, _with_moe_spans(10**9))
    # Matched from the end (the opening marker's launch left over): 1.3 ms
    # to the first kernel (1.4-1.6), 6.5 ms to the fifth (6.6-7.0).
    assert run.reader("moe_ms")(ctx) == pytest.approx((0.2 + 0.4) / 2, rel=1e-9)
    # Without the spans, or with a kernel no launch accounts for, none.
    assert run.reader("moe_ms")(_moonlight_ctx(summary, made_up_spans())) is None
    extra = _summary(events + [card(0.2, 0.25), card(0.3, 0.35)])  # no launch of theirs
    assert run.reader("moe_ms")(_moonlight_ctx(extra, _with_moe_spans(10**9))) is None


def test_expert_rows_imbalance_is_the_mean_over_layer_steps():
    ctx = _moonlight_ctx(None, counters={"moe.layer_steps": 30, "moe.routed_layer_steps": 24,
                                         "moe.rows_max_over_mean": 30.0})
    assert run.reader("expert_rows_imbalance")(ctx) == pytest.approx(1.25)
    assert run.reader("expert_rows_imbalance")(_moonlight_ctx(None)) is None


def test_launches_per_replay_and_capture_s():
    kernels = [card(0.1 + 0.01 * i, 0.105 + 0.01 * i) for i in range(32)]
    copies = [card(5.0 + 0.1 * i, 5.01 + 0.1 * i, "Memcpy DtoD (Device -> Device)")
              for i in range(16)]
    ctx = _moonlight_ctx(_summary(kernels + copies))  # two calls of 8 replays
    assert run.reader("launches_per_replay")(ctx) == 2.0
    assert run.reader("launches_per_replay")(_moonlight_ctx(None)) is None
    train_graphed.LAST["capture_s"] = 1.5
    try:
        assert run.reader("capture_s")(ctx) == 1.5
    finally:
        train_graphed.LAST.clear()
    assert run.reader("capture_s")(ctx) is None


def test_the_new_limits_are_compared():
    for name in (MOONLIGHT, GRAPHED):
        limits = run.load_cell(name).limits
        assert limits and all(v > 0 for v in limits.values())
        assert correct.checks({k: 0.0 for k in limits}, limits)
