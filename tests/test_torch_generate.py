"""The PyTorch port's decode mode (KV cache) and greedy decoders against
the JAX package's ``workload/generate.py`` and decode-mode model, on the
CPU, from the same weights (``from_jax_params``) and the same prompt.

float32 throughout the parity tests: decode-mode logits within 1e-5
(absolute and relative), and generated tokens equal. Token equality is
pinned in float32 only: in bf16, accumulation order flips argmax ties on
near-uniform random logits, which is why ``run_generation_smoke`` judges
the two decoders by their prefill logits (0.1 in bf16) instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.workload import generate as jgen
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu_torch.workload import generate as tgen
from k8s_device_plugin_tpu_torch.workload import model as tmodel
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _models(seed=0, **kw):
    """The JAX config and parameters, and the port's model holding them
    (float32)."""
    jcfg = jmodel.ModelConfig(dtype=jnp.float32, **SMALL, **kw)
    tcfg = tmodel.ModelConfig(dtype=torch.float32, **SMALL, **kw)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tmodel.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, params, model


def _prompt(batch=3, length=5, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SMALL["vocab_size"], (batch, length), dtype=np.int32)


@pytest.mark.parametrize("pallas_norm", [False, True], ids=["flax_norm", "pallas_norm"])
def test_decode_logits_match_jax_one_position_at_a_time(pallas_norm):
    jcfg, params, model = _models(use_pallas_norm=pallas_norm)
    prompt = _prompt(batch=2, length=7)
    jm = jmodel.TransformerLM(jgen._decode_cfg(jcfg))
    jone = jgen._one_step(jm)
    jcache = jgen._init_cache(jm, 2)
    dmodel = tgen._decode_model(model)
    tone = tgen._one_step(dmodel)
    tcache = tmodel.init_cache(dmodel.cfg, 2, "cpu")
    tprompt = torch.from_numpy(prompt).long()
    for t in range(prompt.shape[1]):
        jcache, logits_j = jone(params, jcache, jnp.asarray(prompt[:, t]))
        with torch.inference_mode():
            logits_t = tone(tcache, tprompt[:, t])
        assert tcache.pos == t + 1
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-5, rtol=1e-5)
    # The cache holds what JAX's holds, layer by layer.
    np.testing.assert_allclose(tcache.k[1].numpy(), np.asarray(jcache["Block_1"]["Attention_0"]["k"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(use_flash_attention=True, use_pallas_norm=True)],
    ids=["dense", "flash-pallas_norm"],
)
def test_greedy_generate_tokens_match_jax(kw):
    jcfg, params, model = _models(**kw)
    prompt = _prompt()
    want = np.asarray(jgen.greedy_generate(jcfg, params, jnp.asarray(prompt), 8))
    got = tgen.greedy_generate(model, torch.from_numpy(prompt).long(), 8)
    assert got.shape == (3, 13)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pallas_norm", [False, True], ids=["flax_norm", "pallas_norm"])
def test_greedy_generate_kv_tokens_match_jax(pallas_norm):
    jcfg, params, model = _models(use_pallas_norm=pallas_norm)
    prompt = _prompt()
    want = np.asarray(jgen.greedy_generate_kv(jcfg, params, jnp.asarray(prompt), 8))
    got = tgen.greedy_generate_kv(model, torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_decode_matches_full_forward_decode():
    """Mirrors the JAX test of the same name: the KV decoder's tokens equal
    the full-forward decoder's, token for token (float32)."""
    cfg = dataclasses.replace(tmodel.ModelConfig.tiny(), dtype=torch.float32)
    model = tmodel.init_model(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(_prompt(length=5)).long()
    full = tgen.greedy_generate(model, prompt, 8)
    kv = tgen.greedy_generate_kv(model, prompt, 8)
    assert torch.equal(full, kv)
    assert kv.shape == (3, 13)
    assert torch.equal(kv[:, :5], prompt)


def test_greedy_generate_is_deterministic_and_causal():
    """Mirrors the JAX test_greedy_generate_deterministic_and_causal: a
    shorter continuation is a prefix of the longer one."""
    model = tmodel.init_model(tmodel.ModelConfig.tiny(), seed=0, device="cpu")
    prompt = torch.from_numpy(_prompt(batch=2, length=4)).long()
    out1 = tgen.greedy_generate(model, prompt, 6)
    assert torch.equal(out1, tgen.greedy_generate(model, prompt, 6))
    assert out1.shape == (2, 10) and torch.equal(out1[:, :4], prompt)
    assert torch.equal(tgen.greedy_generate(model, prompt, 3), out1[:, :7])


def test_decoders_reject_overflow():
    model = tmodel.init_model(tmodel.ModelConfig.tiny(), seed=0, device="cpu")
    prompt = torch.zeros(1, 10, dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds"):
        tgen.greedy_generate(model, prompt, 10)
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.greedy_generate_kv(model, prompt, model.cfg.max_seq_len)
    assert tgen.greedy_generate_kv(model, prompt, 0) is prompt


@pytest.mark.parametrize(
    "option",
    [dict(use_flash_attention=True), dict(use_ring_attention=True), dict(n_experts=2),
     dict(pipeline_microbatches=2)],
    ids=["flash", "ring", "moe", "pipeline"],
)
def test_decode_config_validation(option):
    """Mirrors the JAX test of the same name: decode mode exists for the
    plain dense path only, and the config refuses the others naming it."""
    with pytest.raises(ValueError, match="decode"):
        tmodel.ModelConfig(**SMALL, decode=True, **option)
    cfg = tmodel.ModelConfig(**SMALL, **option)
    assert not tgen.kv_decode_supported(cfg)
    with pytest.raises(ValueError, match="dense attention path only"):
        tgen._decode_cfg(cfg)


def test_decode_forward_takes_one_position_and_its_cache():
    cfg = tmodel.ModelConfig(**SMALL, decode=True)
    model = tmodel.TransformerLM(cfg)
    cache = tmodel.init_cache(cfg, 2, "cpu")
    assert [tuple(t.shape) for t in cache.k] == [(2, 16, 2, 16)] * 2
    assert cache.k[0].dtype == torch.bfloat16 and cache.pos == 0
    with pytest.raises(ValueError, match="one position per call"):
        model(torch.zeros(2, 2, dtype=torch.long), cache)
    with pytest.raises(ValueError, match="KV cache"):
        model(torch.zeros(2, 1, dtype=torch.long))
    plain = tmodel.TransformerLM(tmodel.ModelConfig(**SMALL))
    with pytest.raises(ValueError, match="decode mode"):
        plain(torch.zeros(2, 1, dtype=torch.long), cache)


def test_decode_mode_returns_logits_under_xent_chunk():
    """The model returns hidden states for the chunked CE only outside
    decode mode, as the JAX model does (xent_chunk > 0 and not decode)."""
    cfg = tmodel.ModelConfig(**SMALL, xent_chunk=32)
    with torch.no_grad():
        hidden = tmodel.TransformerLM(cfg)(torch.zeros(2, 16, dtype=torch.long))
        dcfg = dataclasses.replace(cfg, decode=True)
        logits = tmodel.TransformerLM(dcfg)(torch.zeros(2, 1, dtype=torch.long),
                                            tmodel.init_cache(dcfg, 2, "cpu"))
    assert hidden.shape == (2, 16, 32)
    assert logits.shape == (2, 1, 64) and logits.dtype == torch.float32


def test_generate_strips_xent_chunk():
    """Generation needs logits: a chunked-CE training config decodes as
    the same model without the option."""
    model = tmodel.init_model(tmodel.ModelConfig.tiny(), seed=0, device="cpu")
    chunked = tmodel.TransformerLM(dataclasses.replace(model.cfg, xent_chunk=32))
    chunked.load_state_dict(model.state_dict())
    prompt = torch.from_numpy(_prompt(batch=2, length=4)).long()
    assert torch.equal(tgen.greedy_generate(chunked, prompt, 4),
                       tgen.greedy_generate(model, prompt, 4))
    assert torch.equal(tgen.greedy_generate_kv(chunked, prompt, 4),
                       tgen.greedy_generate_kv(model, prompt, 4))


def test_decode_model_shares_the_parameters():
    model = tmodel.init_model(tmodel.ModelConfig.tiny(), seed=0, device="cpu")
    twin = tgen._decode_model(model)
    assert twin.cfg.decode and not model.cfg.decode
    for (name, a), b in zip(model.named_parameters(), twin.parameters()):
        assert a is b, name


def test_generation_smoke_keys_and_bf16_verdict():
    report = tgen.run_generation_smoke(tmodel.ModelConfig.tiny(), batch=2, prompt_len=8,
                                       steps=8, device="cpu")
    assert set(report) == {
        "prompt_shape", "output_shape", "tokens_in_vocab", "prompt_preserved",
        "flash_attention", "ok", "kv_decode_s", "full_decode_s", "kv_tokens_match_full",
        "kv_prefill_logits_maxdiff",
    }
    assert report["prompt_shape"] == [2, 8] and report["output_shape"] == [2, 16]
    assert report["tokens_in_vocab"] and report["prompt_preserved"]
    # tiny() is bf16: the verdict is the prefill logits within 0.1.
    assert report["ok"] is True and report["kv_prefill_logits_maxdiff"] < 0.1


def test_generation_smoke_with_flash_attention_has_no_kv_verdict():
    """Mirrors the JAX test_generation_smoke_with_flash_attention and
    test_generation_smoke_skips_kv_for_unsupported_configs."""
    cfg = tmodel.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                             max_seq_len=32, use_flash_attention=True, use_pallas_norm=True)
    report = tgen.run_generation_smoke(cfg, batch=1, prompt_len=8, steps=4, device="cpu")
    assert report["tokens_in_vocab"] and report["prompt_preserved"]
    assert report["flash_attention"] and report["ok"] is None
    assert "kv_prefill_logits_maxdiff" not in report


def test_generation_smoke_strips_xent_chunk():
    cfg = dataclasses.replace(tmodel.ModelConfig.tiny(), xent_chunk=32)
    report = tgen.run_generation_smoke(cfg, batch=2, prompt_len=4, steps=4, device="cpu")
    assert report["tokens_in_vocab"] and report["prompt_preserved"]
    assert report["ok"] is True
