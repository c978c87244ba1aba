"""The PyTorch port's chunked-vocab cross-entropy against the JAX
package's, and the training path that uses it.

The same numpy inputs go through the JAX ``chunked_softmax_xent`` and the
port's, in float32, at the JAX suite's own tolerance (1e-5 in value and in
both gradients, tests/test_ops.py), with targets in the first and last
chunks and on both sides of a chunk boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.ops import xent as jxent
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch.ops import xent as txent
from k8s_device_plugin_tpu_torch.workload import model as tmodel
from k8s_device_plugin_tpu_torch.workload import smoke
from k8s_device_plugin_tpu_torch.workload import train as ttrain
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _inputs(seed=0, rows=48, d=16, vocab=96):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((6, rows // 6, d), dtype=np.float32)
    embed = rng.standard_normal((vocab, d), dtype=np.float32) * 0.1
    targets = np.concatenate(
        [[0, vocab - 1, 31, 32], rng.integers(0, vocab, rows - 4)]
    ).reshape(6, rows // 6)
    return hidden, embed, targets


@pytest.mark.parametrize("chunk", [32, 96], ids=["three_chunks", "one_chunk"])
def test_chunked_matches_jax_and_reference_in_value_and_grads(chunk):
    hidden, embed, targets = _inputs()
    jt = jnp.asarray(targets)

    def loss_j(h, e):
        return jxent.chunked_softmax_xent(h, e, jt, chunk)

    loss_j_val = float(loss_j(jnp.asarray(hidden), jnp.asarray(embed)))
    grads_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(embed))

    tt = torch.from_numpy(targets)
    ht, et = (torch.from_numpy(a).requires_grad_() for a in (hidden, embed))
    loss_t = txent.chunked_softmax_xent(ht, et, tt, chunk)
    loss_t.backward()
    hr, er = (torch.from_numpy(a).requires_grad_() for a in (hidden, embed))
    loss_r = txent.reference_softmax_xent(hr, er, tt)
    loss_r.backward()

    assert abs(loss_t.item() - loss_j_val) < 1e-5
    assert abs(loss_t.item() - loss_r.item()) < 1e-5
    for got, ref, want in ((ht.grad, hr.grad, grads_j[0]), (et.grad, er.grad, grads_j[1])):
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
        assert (got - ref).abs().max() < 1e-5


def test_reference_matches_jax_reference():
    hidden, embed, targets = _inputs(seed=1)
    want = jxent.reference_softmax_xent(jnp.asarray(hidden), jnp.asarray(embed),
                                        jnp.asarray(targets))
    got = txent.reference_softmax_xent(torch.from_numpy(hidden), torch.from_numpy(embed),
                                       torch.from_numpy(targets))
    assert abs(float(got) - float(want)) < 1e-5


def test_bf16_hidden_gets_a_bf16_gradient():
    """The final norm's output is bf16 under use_pallas_norm: the loss
    widens it to f32 and hands its gradient back in bf16, as JAX does."""
    hidden, embed, targets = _inputs(seed=2)
    ht = torch.from_numpy(hidden).to(torch.bfloat16).requires_grad_()
    et = torch.from_numpy(embed).requires_grad_()
    txent.chunked_softmax_xent(ht, et, torch.from_numpy(targets), 32).backward()
    gh_j, ge_j = jax.grad(
        lambda h, e: jxent.chunked_softmax_xent(h, e, jnp.asarray(targets), 32),
        argnums=(0, 1),
    )(jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(embed))
    assert ht.grad.dtype == torch.bfloat16 and str(gh_j.dtype) == "bfloat16"
    assert et.grad.dtype == torch.float32
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge_j), atol=1e-5, rtol=0)


def test_rejects_a_chunk_that_does_not_divide_vocab():
    h = torch.zeros(4, 8)
    e = torch.zeros(100, 8)
    t = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="not a multiple"):
        txent.chunked_softmax_xent(h, e, t, 32)
    with pytest.raises(ValueError, match="must divide"):
        tmodel.ModelConfig(**{**SMALL, "vocab_size": 100}, xent_chunk=32)


@pytest.mark.parametrize("pallas_norm", [False, True], ids=["flax_norm", "pallas_norm"])
def test_loss_fn_with_xent_chunk_matches_jax(pallas_norm):
    """loss_fn under xent_chunk against the JAX loss_fn on the same weights
    and tokens, and against the port's own full-logits loss."""
    jcfg = jmodel.ModelConfig(dtype=jnp.float32, xent_chunk=32,
                              use_pallas_norm=pallas_norm, **SMALL)
    tcfg = tmodel.ModelConfig(dtype=torch.float32, xent_chunk=32,
                              use_pallas_norm=pallas_norm, **SMALL)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = tmodel.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg))
    tokens = np.random.default_rng(9).integers(0, 64, (3, 16), dtype=np.int32)
    loss_j = float(jtrain.loss_fn(jcfg, params, jnp.asarray(tokens)))
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        loss_t = float(ttrain.loss_fn(model, tt))
        hidden = model(tt)
    assert hidden.shape == (3, 16, 32)  # hidden states, not logits
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    plain_cfg = tmodel.ModelConfig(dtype=torch.float32, use_pallas_norm=pallas_norm, **SMALL)
    plain = tmodel.TransformerLM(plain_cfg)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert float(ttrain.loss_fn(plain, tt)) == pytest.approx(loss_t, abs=1e-4)


def test_training_with_xent_chunk_learns():
    """A few AdamW steps under xent_chunk lower the loss on a fixed batch."""
    cfg = tmodel.ModelConfig(**SMALL, xent_chunk=32)
    model, optimizer = ttrain.make_train_state(cfg, "cpu", seed=0)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 64, (4, 16), dtype=np.int64))
    first = float(ttrain.train_step(model, optimizer, tokens))
    for _ in range(5):
        loss = float(ttrain.train_step(model, optimizer, tokens))
    assert loss < first


def test_run_smoke_with_xent_chunk_on_cpu():
    report = smoke.run_smoke(steps=3, cfg=tmodel.ModelConfig.tiny(), device="cpu",
                             xent_chunk=32)
    assert report["ok"] is True and report["xent_chunk"] == 32
    assert smoke.main(["--device", "cpu", "--steps", "2", "--no-stream",
                       "--xent-chunk", "16"]) == 0
