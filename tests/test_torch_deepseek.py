"""The port's DeepSeek-V3 model (``DeepSeekV3Config``: multi-head latent
attention, SwiGLU, the routed layer of ``workload/routed.py``, an untied
head) against its plain reference (``workload/deepseek_reference.py``), on
the CPU at a small size: d 64, 4 heads of 24 + 8 q.k and 16 v, latent 32,
8 experts (top 2, 2 shared), vocabulary 256, seq 32.

The model runs in float32 here (``dtype``), so it and the reference
compute the same f32 function and differ only in the order of f32 sums
(einsum against matmul, the flash function's plain version against the
reference's softmax, a grouped loop against a per-expert one): about
1e-6 relative. Hence 1e-4 relative on the logits, the loss and each
gradient's norm, and on each leaf's change after three AdamW steps 1e-3 of
the change (AdamW's first steps move an element by lr sign(g), so an
element whose gradient is f32 noise in both may move either way). The
routing decisions, computed from those same f32 scores, agree exactly.
This file imports no JAX: the JAX package has no such model.
"""

import dataclasses

import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import attention as tattn
from k8s_device_plugin_tpu_torch.utils import tracing
from k8s_device_plugin_tpu_torch.workload import deepseek_reference as ref
from k8s_device_plugin_tpu_torch.workload import routed, train
from k8s_device_plugin_tpu_torch.workload.model import (
    DeepSeekV3Config, ModelConfig, TransformerLM, init_model,
)
from k8s_device_plugin_tpu_torch.workload.routed import RoutedMoe

F32 = dict(dtype=torch.float32)
RTOL = 1e-4
OPT = {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}
# Moonlight-16B-A3B at its published widths, one card's share of an
# expert-parallel 8 deployment's first pipeline stage (gpubench's config).
MOONLIGHT_SHARE = DeepSeekV3Config(
    vocab_size=20480, d_model=2048, n_heads=16, n_layers=13, d_ff=11264, max_seq_len=8192,
    moe_top_k=6, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_routed_experts=64, held_experts=(0, 8), expert_d_ff=1408)


def _cfg(**changes) -> DeepSeekV3Config:
    return dataclasses.replace(DeepSeekV3Config.tiny(), **F32, **changes)


def _tokens(cfg, batch=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=gen)


def _state(model):
    params = {n: w.detach().clone() for n, w in model.named_parameters()}
    biases = {i: b.moe.router_bias.detach().clone() for i, b in enumerate(model.blocks)
              if b.is_moe}
    return params, biases


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_the_tiny_size_and_the_moonlight_share_parameter_count():
    cfg = DeepSeekV3Config.tiny()
    assert (cfg.d_model, cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.kv_lora_rank, cfg.n_routed_experts, cfg.moe_top_k,
            cfg.n_shared_experts, cfg.vocab_size, cfg.max_seq_len) == (
        64, 4, 24, 8, 16, 32, 8, 2, 2, 256, 32)
    model = TransformerLM(MOONLIGHT_SHARE, device="meta")
    by_layer = {}
    for name, p in model.named_parameters():
        key = name.split(".")[1] if name.startswith("blocks.") else "outside"
        by_layer[key] = by_layer.get(key, 0) + p.numel()
    # A card's count: layer 0, each MoE layer, embedding + head
    # (+ the final norm's 2048).
    assert by_layer["0"] == 82_973_184
    assert all(by_layer[str(i)] == 100_405_760 for i in range(1, 13))
    assert by_layer["outside"] == 83_886_080 + 2048
    assert sum(by_layer.values()) == 1_371_730_432
    assert model.pos is None and model.head is not None
    assert len(model.routed_layers) == 12


def test_logits_loss_and_every_gradient_match_the_reference():
    cfg = _cfg()
    model = init_model(cfg, 0, "cpu")
    tokens = _tokens(cfg)
    params, biases = _state(model)
    logits = model(tokens)
    loss = train.loss_fn(model, tokens)
    loss.backward()
    sh = ref.Shape.of(cfg)
    leaves = {n: w.clone().requires_grad_() for n, w in params.items()}
    h, _, _, _ = ref.forward(leaves, biases, tokens, sh)
    want_logits = h @ leaves["head"].T
    want, _, _ = ref.loss(leaves, biases, tokens, sh)
    want.backward()
    assert _rel(logits, want_logits) <= RTOL
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=RTOL)
    # The balance term enters the loss.
    assert cfg.moe_aux_weight > 0
    for name, p in model.named_parameters():
        assert _rel(p.grad, leaves[name].grad) <= RTOL, name


def test_three_adamw_steps_with_the_bias_update_match_the_reference():
    cfg = _cfg(n_layers=3)
    model = init_model(cfg, 2, "cpu")
    params, biases = _state(model)
    start = {n: w.clone() for n, w in params.items()}
    batches = [_tokens(cfg, seed=s) for s in (3, 4, 5)]
    opt = train.make_optimizer(model, lr=OPT["lr"])
    losses = [float(train.train_step(model, opt, t)) for t in batches]
    steps = list(ref.reference_steps(ref.Shape.of(cfg), params, biases, batches, OPT))
    assert losses == pytest.approx([float(s[0]) for s in steps], rel=RTOL)
    for name, p in model.named_parameters():
        moved = start[name] - steps[-1][2][name].detach()
        assert float((p.detach() - steps[-1][2][name].detach()).norm()) <= 1e-3 * float(
            moved.norm()), name
    for i, block in enumerate(model.blocks):
        if block.is_moe:
            assert torch.equal(block.moe.router_bias, biases[i])
            assert block.moe.router_bias.abs().max() > 0


def _layer_and_input(cfg, seed=0):
    layer = RoutedMoe(cfg, torch.Generator().manual_seed(seed), "cpu")
    x = torch.randn(2, cfg.max_seq_len, cfg.d_model, generator=torch.Generator().manual_seed(9))
    return layer, x


def _reference_layer(layer, x, cfg):
    p = {f"moe.{n}": w for n, w in layer.named_parameters()}
    y, aux, chosen, counts = ref._routed(x, p, "moe.", layer.router_bias, ref.Shape.of(cfg),
                                          ref.matmul, ref.matmul)
    return y, aux, chosen, counts


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four shares of two experts each: their routed parts, plus the shared
    expert once, equal the uncut layer; and the uncut layer equals the
    reference's."""
    cfg = _cfg()
    whole, x = _layer_and_input(cfg)
    y_whole, aux_whole = whole(x)
    y_ref, aux_ref, _, _ = _reference_layer(whole, x, cfg)
    assert _rel(y_whole, y_ref) <= RTOL
    assert float(aux_whole.detach()) == pytest.approx(float(aux_ref.detach()), rel=RTOL)
    shared = whole.shared(x.reshape(-1, cfg.d_model)).view_as(x)
    total = shared.clone()
    for first in range(0, 8, 2):
        part = RoutedMoe(_cfg(held_experts=(first, 2)), None, "cpu")
        with torch.no_grad():
            part.router.copy_(whole.router)
            for name in ("w_gate", "w_up", "w_down"):
                getattr(part, name).copy_(getattr(whole, name)[first:first + 2])
            for name, w in whole.shared.named_parameters():
                getattr(part.shared, name).copy_(w)
        y_part, aux_part = part(x)
        assert float(aux_part.detach()) == pytest.approx(float(aux_whole.detach()), rel=1e-6)
        total = total + (y_part - shared)
    assert _rel(total, y_whole) <= RTOL


def test_a_skewed_router_drops_nothing():
    """Every token picks expert 3 (its bias far above the rest): expert 3
    gets every token's row, nothing is dropped, and the layer is still the
    reference's."""
    cfg = _cfg()
    layer, x = _layer_and_input(cfg, seed=4)
    with torch.no_grad():
        layer.router_bias[3] = 100.0
    routed.COUNTERS.reset()
    routed.COUNTERS.on = True
    try:
        y, _ = layer(x)
        read = routed.COUNTERS.read()
    finally:
        routed.COUNTERS.on = False
        routed.COUNTERS.reset()
    tokens = x.shape[0] * x.shape[1]
    assert read["moe.rows.3"] == tokens == read["moe.choices.3"]
    assert sum(read[f"moe.rows.{i}"] for i in range(8)) == tokens * cfg.moe_top_k
    assert read["moe.layer_steps"] == 1 == read["moe.routed_layer_steps"]
    assert read["moe.rows_max_over_mean"] == pytest.approx(tokens / (tokens * 2 / 8))
    y_ref, _, chosen, _ = _reference_layer(layer, x, cfg)
    assert (chosen == 3).any(-1).all()
    assert _rel(y, y_ref) <= RTOL


def test_a_layer_step_without_held_rows_is_counted_apart():
    """Where no token chose a held expert, the ratio has no value: the
    layer-step is counted, but not among those the ratio averages over."""
    cfg = _cfg(held_experts=(0, 2))
    layer, x = _layer_and_input(cfg, seed=4)
    with torch.no_grad():
        layer.router_bias[2:4] = 100.0  # every token picks 2 and 3, neither held
    routed.COUNTERS.reset()
    routed.COUNTERS.on = True
    try:
        y, _ = layer(x)
        y.float().sum().backward()
        read = routed.COUNTERS.read()
    finally:
        routed.COUNTERS.on = False
        routed.COUNTERS.reset()
    assert (read["moe.layer_steps"], read["moe.routed_layer_steps"]) == (1, 0)
    assert read["moe.rows_max_over_mean"] == 0 == read["moe.rows.0"] + read["moe.rows.1"]
    assert layer.w_gate.grad is None  # nothing ran on the held experts
    shared = layer.shared(x.reshape(-1, cfg.d_model)).view_as(x)
    assert _rel(y, shared) <= RTOL


def test_counters_stay_off_unless_turned_on():
    cfg = _cfg()
    layer, x = _layer_and_input(cfg)
    routed.COUNTERS.reset()
    layer(x)
    assert routed.COUNTERS.read() == {"moe.layer_steps": 0.0}


@pytest.mark.parametrize("widths", [(32, 16), (24, 8)], ids=["32-16", "24-8"])
def test_plain_flash_takes_q_k_heads_wider_than_v(widths):
    """The flash function's CPU path at d_qk != d_v: forward and gradients
    against plain f32 attention, scale 1/sqrt(d_qk)."""
    d_qk, d_v = widths
    gen = torch.Generator().manual_seed(d_qk)
    q, k = (torch.randn(2, 3, 40, d_qk, generator=gen).requires_grad_() for _ in range(2))
    v = torch.randn(2, 3, 40, d_v, generator=gen).requires_grad_()
    out = tattn.flash_attention(q, k, v)
    assert out.shape == (2, 3, 40, d_v)
    scores = (q @ k.transpose(-1, -2)) / d_qk ** 0.5
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1) @ v
    assert _rel(out, want) <= 1e-5
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    exp = torch.autograd.grad(want, (q, k, v), g)
    for a, b in zip(got, exp):
        assert _rel(a, b) <= 1e-5
    assert tattn.fwd_stages_for(d_qk, d_v) == 3
    with pytest.raises(ValueError, match="ring depth"):
        tattn.flash_attention(q, k, v, fwd_stages=4)


def test_kernel_wrappers_take_only_the_built_head_widths():
    """q.k 192 over v 128 passes the widths check (and then needs the card);
    a pair the kernels are not built for is refused first, on any device."""
    q = torch.zeros(1, 1, 8, 192, dtype=torch.bfloat16)
    v = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_fwd_kernel(q, q, v)
    for v_width in (192, 64):
        with pytest.raises(ValueError, match="head_dim pairs"):
            tattn.flash_fwd_kernel(q, q, torch.zeros(1, 1, 8, v_width, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="ring depth"):
        tattn.flash_fwd_kernel(q, q, v, 4)
    assert tattn.fwd_stages_for(128, 128) == tattn.DEFAULT_FWD_STAGES == 4


def test_routing_bias_moves_by_the_step_choice_counts():
    cfg = _cfg()
    model = init_model(cfg, 5, "cpu")
    opt = train.make_optimizer(model)
    train.train_step(model, opt, _tokens(cfg))
    layer = model.routed_layers[0]
    counts = layer.choice_counts
    assert float(counts.sum()) == 2 * cfg.max_seq_len * cfg.moe_top_k
    want = cfg.bias_update_speed * torch.sign(counts.mean() - counts)
    assert torch.equal(layer.router_bias, want)


def test_routed_spans_are_recorded_only_while_tracing():
    cfg = _cfg()
    model = init_model(cfg, 0, "cpu")
    opt = train.make_optimizer(model)
    tokens = _tokens(cfg)
    names = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.backward"}
    tracing.COLLECTOR.clear()
    train.train_step(model, opt, tokens)
    assert not names & {s["name"] for s in tracing.COLLECTOR.spans()}
    tracing.enable("workload")
    try:
        train.train_step(model, opt, tokens)
    finally:
        tracing.disable()
    spans = tracing.COLLECTOR.spans()
    tracing.COLLECTOR.clear()
    counted = {n: sum(s["name"] == n for s in spans) for n in names}
    assert counted == {n: 1 for n in names}  # one routed layer in the tiny model
    forward = next(s for s in spans if s["name"] == "train.forward")
    inside = [s for s in spans if s["name"] in names - {"moe.backward"}]
    assert all(s["parent_span_id"] == forward["span_id"] for s in inside)
    backward = next(s for s in spans if s["name"] == "train.backward")
    moe_bwd = next(s for s in spans if s["name"] == "moe.backward")
    assert backward["start_ns"] <= moe_bwd["start_ns"] <= moe_bwd["end_ns"] <= backward["end_ns"]


def test_existing_configs_build_what_they_built():
    """A GPT-style config keeps its learned positions, its tied head and
    no routed layer; its names and shapes are the JAX layout's."""
    model = TransformerLM(ModelConfig.bench(), device="meta")
    assert model.head is None and model.pos is not None and model.routed_layers == ()
    names = [n for n, _ in model.named_parameters()]
    assert names[:2] == ["embed", "pos"] and names[-1] == "norm.scale"
    assert not any(".moe." in n or "wdkv" in n for n in names)


def test_sharding_and_other_paths_are_refused(monkeypatch):
    """The routed layer holds its share of the experts itself: a mesh axis
    larger than 1 is refused; so are the paths MLA does not run."""
    model = init_model(_cfg(), 0, "cpu")
    sizes = {"data": 1, "fsdp": 1, "expert": 2, "pipe": 1, "seq": 1, "model": 1}
    monkeypatch.setattr(train, "axis_sizes", lambda mesh: sizes)
    with pytest.raises(NotImplementedError, match="unsharded"):
        train.shard_model(model, object())
    with pytest.raises(ValueError, match="flash path"):
        _cfg(use_flash_attention=False)
    with pytest.raises(ValueError, match="held_experts"):
        _cfg(held_experts=(6, 4))
