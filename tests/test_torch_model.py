"""The PyTorch port's transformer LM against the JAX package's, on the
same weights (through ``from_jax_params``) and the same tokens.

float32: logits within 1e-4 and the loss within rtol 1e-5. bf16: the loss
within 1e-2 and the logits within 0.1, the JAX package's bf16 tolerance
for two formulations of one model (workload/generate.py). Both attention
paths (dense, and flash through its plain version on the CPU), both norms
(flax's, and the RMSNorm kernel's plain version under use_pallas_norm) and
both parameter layouts (unrolled and scan_layers) are covered.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch.workload import model as tmodel
from k8s_device_plugin_tpu_torch.workload import train as ttrain
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _configs(dtype="f32", scan_layers=False, **kw):
    """The JAX config and the port's; only the JAX one stacks its layers
    (the port's parameters are always per layer)."""
    jdt, tdt = DTYPES[dtype]
    return (
        jmodel.ModelConfig(dtype=jdt, scan_layers=scan_layers, **SMALL, **kw),
        tmodel.ModelConfig(dtype=tdt, **SMALL, **kw),
    )


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(jcfg, tcfg, seed=0):
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tmodel.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(_numpy_tree(params), tcfg))
    return params, model


def _tokens(batch=3, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SMALL["vocab_size"], (batch, SMALL["max_seq_len"]), dtype=np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scan"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("pallas_norm", [False, True], ids=["flax_norm", "pallas_norm"])
def test_logits_and_loss_match_jax(pallas_norm, flash, scan_layers, dtype):
    jcfg, tcfg = _configs(dtype, use_flash_attention=flash, scan_layers=scan_layers,
                          use_pallas_norm=pallas_norm)
    params, model = _port_model(jcfg, tcfg)
    tokens = _tokens()
    logits_j = np.asarray(jmodel.forward(jcfg, params, jnp.asarray(tokens)))
    loss_j = float(jtrain.loss_fn(jcfg, params, jnp.asarray(tokens)))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits_t = tmodel.forward(model, tt).numpy()
        loss_t = float(ttrain.loss_fn(model, tt))
    assert logits_t.dtype == np.float32  # the tied unembed runs in f32
    if dtype == "f32":
        np.testing.assert_allclose(logits_t, logits_j, atol=1e-4, rtol=0)
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
    else:
        assert np.abs(logits_t - logits_j).max() < 0.1
        assert abs(loss_t - loss_j) <= 1e-2


def test_pallas_norm_layout_loads_and_matches_jax():
    """The use_pallas_norm parameter layout (Norm_k/scale) loads straight
    into the port's model under use_pallas_norm, and into its flax-norm
    model: in f32 the Pallas RMSNorm and flax's compute the same."""
    jcfg, tcfg = _configs("f32", use_pallas_norm=True, scan_layers=True)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    assert "scale" in params["Norm_0"]
    tokens = _tokens(seed=8)
    logits_j = np.asarray(jmodel.forward(jcfg, params, jnp.asarray(tokens)))
    for cfg in (tcfg, dataclasses.replace(tcfg, use_pallas_norm=False)):
        model = tmodel.TransformerLM(cfg)
        model.load_state_dict(from_jax_params(_numpy_tree(params), cfg))
        assert model.norm.use_pallas_norm is cfg.use_pallas_norm
        with torch.no_grad():
            logits_t = model(torch.from_numpy(tokens).long()).numpy()
        np.testing.assert_allclose(logits_t, logits_j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scan"])
def test_from_jax_params_maps_every_parameter(scan_layers):
    jcfg, tcfg = _configs("f32", scan_layers=scan_layers)
    params = _numpy_tree(jmodel.init_params(jcfg, jax.random.PRNGKey(2)))
    sd = from_jax_params(params, tcfg)
    model = tmodel.TransformerLM(tcfg)
    assert set(sd) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert sd[name].shape == tensor.shape, name
    layer1 = (params["blocks"]["Block_0"]["Attention_0"]["wq"][1] if scan_layers
              else params["Block_1"]["Attention_0"]["wq"])
    np.testing.assert_array_equal(sd["blocks.1.attn.wq"].numpy(), layer1)
    with pytest.raises(ValueError, match="unmapped"):
        from_jax_params({**params, "extra": np.zeros(1)}, tcfg)
    if scan_layers:
        with pytest.raises(ValueError, match="layers"):
            from_jax_params(params, dataclasses.replace(tcfg, n_layers=3))


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; torch's F.gelu does not."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh_form = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh_form, ref, atol=1e-6, rtol=0)
    assert np.abs(exact - ref).max() > 1e-4
    jcfg, tcfg = _configs("f32")
    rng = np.random.default_rng(3)
    w1 = rng.standard_normal((32, 64), dtype=np.float32)
    w2 = rng.standard_normal((64, 32), dtype=np.float32)
    xs = rng.standard_normal((2, 5, 32), dtype=np.float32)
    out_j = jmodel.Mlp(jcfg).apply({"params": {"w1": w1, "w2": w2}}, jnp.asarray(xs))
    mlp = tmodel.Mlp(tcfg)
    mlp.load_state_dict({"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)})
    with torch.no_grad():
        out_t = mlp(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=1e-4, rtol=1e-5)


def test_rmsnorm_returns_float32_for_bf16_input():
    """flax nn.RMSNorm (eps 1e-6) reduces in f32 and, with a bf16 input and
    an f32 scale, returns f32; the port's Norm does the same."""
    jcfg, _ = _configs("bf16")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    out_j = jmodel.Norm(jcfg).apply({"params": {"RMSNorm_0": {"scale": scale}}}, xj)
    assert out_j.dtype == jnp.float32
    norm = tmodel.Norm(32)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    with torch.no_grad():
        out_t = norm(torch.from_numpy(x).to(torch.bfloat16))
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pallas_norm_returns_the_input_dtype(dtype):
    """Under use_pallas_norm the norm is the RMSNorm kernel, whose output
    has x's dtype: a bf16 input gives bf16 (flax's norm gives f32), so in a
    bf16 model every block input and the final norm's output are bf16."""
    jcfg, _ = _configs(dtype, use_pallas_norm=True)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32)
    out_j = jmodel.Norm(jcfg).apply({"params": {"scale": scale}}, jnp.asarray(x, jdt))
    assert out_j.dtype == jdt
    norm = tmodel.Norm(32, use_pallas_norm=True)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    with torch.no_grad():
        out_t = norm(torch.from_numpy(x).to(tdt))
    assert out_t.dtype == tdt
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                               atol=1e-5 if dtype == "f32" else 2.0 ** -6, rtol=2.0 ** -8)


def test_dense_attention_divides_scores_in_bf16():
    """The dense branch in bf16: scores divided in bf16 by a bf16
    sqrt(head_dim), masked with -1e9, softmax in f32 and cast back. The
    port's bf16 output matches the JAX module's to bf16 rounding."""
    jcfg, tcfg = _configs("bf16")
    rng = np.random.default_rng(5)
    w = {n: rng.standard_normal((32, 2, 16), dtype=np.float32) * 0.3 for n in ("wq", "wk", "wv")}
    w["wo"] = rng.standard_normal((2, 16, 32), dtype=np.float32) * 0.3
    x = rng.standard_normal((2, 16, 32), dtype=np.float32)
    out_j = np.asarray(
        jmodel.Attention(jcfg).apply({"params": w}, jnp.asarray(x)), np.float32
    )
    attn = tmodel.Attention(tcfg)
    attn.load_state_dict({n: torch.from_numpy(a) for n, a in w.items()})
    with torch.no_grad():
        out_t = attn(torch.from_numpy(x))
    assert out_t.dtype == torch.bfloat16
    diff = np.abs(out_t.float().numpy() - out_j).max()
    assert diff <= 2.0 ** -6 * np.abs(out_j).max(), diff


@pytest.mark.parametrize(
    "option",
    [
        dict(use_ring_attention=True),
        dict(n_experts=2),
        dict(pipeline_microbatches=2),
        dict(decode=True),
    ],
    ids=["ring", "moe", "pipeline", "decode"],
)
def test_options_not_ported_raise_naming_the_roadmap(option):
    """Every option of the JAX config is ported now: each builds a model.
    MoE and decode mode run as they are; ring attention and the pipeline
    need the mesh that ``train.shard_model`` gives them, and raise for its
    absence only when they are run, as the JAX model without ``ring_mesh``
    or ``pipe_mesh`` does."""
    cfg = tmodel.ModelConfig(**SMALL, **option)
    model = tmodel.TransformerLM(cfg)
    assert model.cfg == cfg
    tokens = torch.zeros(2, 1 if cfg.decode else cfg.max_seq_len, dtype=torch.long)
    if cfg.use_ring_attention or cfg.pipeline_microbatches:
        with pytest.raises(ValueError, match="requires a mesh"):
            model(tokens)
    elif cfg.decode:
        assert model(tokens, tmodel.init_cache(cfg, 2, "cpu")).shape == (2, 1, cfg.vocab_size)
    else:
        with torch.no_grad():
            assert model(tokens).shape == (2, cfg.max_seq_len, cfg.vocab_size)
        assert isinstance(model.blocks[0].moe, torch.nn.Module)


def test_flops_accounting_matches_jax():
    for name in ("tiny", "bench"):
        jcfg = getattr(jmodel.ModelConfig, name)()
        tcfg = getattr(tmodel.ModelConfig, name)()
        assert tcfg.matmul_params() == jcfg.matmul_params()
        assert tcfg.train_flops_per_step(8) == jcfg.train_flops_per_step(8)
        assert tcfg.decode_supported() == jcfg.decode_supported()
    bench = tmodel.ModelConfig.bench()
    assert (bench.d_model // bench.n_heads, bench.dtype) == (128, torch.bfloat16)
    assert bench.use_flash_attention
    # Every JAX config field but the layer stacking has its counterpart.
    jfields = {f.name for f in dataclasses.fields(jmodel.ModelConfig)}
    tfields = {f.name for f in dataclasses.fields(tmodel.ModelConfig)}
    assert tfields <= jfields - {"scan_layers"}
    assert jmodel.ModelConfig.bench().scan_layers
