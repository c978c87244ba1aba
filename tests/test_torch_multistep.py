"""The PyTorch port's multi-step dispatch (``make_multi_train_step``) and
the smoke's ``inner_steps`` / chunked-CE A/B paths, against the JAX
package's on the CPU.

On the CPU the port's multi-step is the eager loop of ``train_step`` (the
card replays a CUDA graph of it: ``tests/test_torch_kernels.py``). float32
tolerances, as ``test_torch_train.py`` sets them: losses within 1e-5
relative, parameters within 1e-4 absolute (Adam's first update turns
rounding in a near-zero gradient into a change of up to lr).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_device_plugin_tpu.parallel.mesh import batch_sharding, make_mesh
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch.workload import model as tmodel
from k8s_device_plugin_tpu_torch.workload import smoke
from k8s_device_plugin_tpu_torch.workload import train as ttrain
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _states(kw):
    """The JAX train state on a one-device mesh and the port's model and
    optimizer holding the same weights (float32)."""
    jcfg = jmodel.ModelConfig(dtype=jnp.float32, **kw)
    tcfg = tmodel.ModelConfig(dtype=torch.float32, **kw)
    mesh = make_mesh(jax.devices()[:1])
    params, opt_state, tx = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
    # Copy out before a donating step consumes the buffers.
    start = jax.tree_util.tree_map(np.array, params)
    model = tmodel.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(start, tcfg))
    return jcfg, tcfg, mesh, (params, opt_state, tx), model, ttrain.make_optimizer(model)


def _stack(n, batch=4, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SMALL["vocab_size"], (n, batch, SMALL["max_seq_len"]), dtype=np.int32)


def _jax_stack(stack, mesh):
    bsh = batch_sharding(mesh)
    return jax.device_put(jnp.asarray(stack), NamedSharding(bsh.mesh, P(None, *bsh.spec)))


@pytest.mark.parametrize(
    "kw,variant_chunk",
    [
        (dict(), None),
        (dict(use_flash_attention=True), None),
        (dict(use_flash_attention=True, use_pallas_norm=True), None),
        (dict(), 32),  # the A/B's chunked variant of a full-logits model
        (dict(xent_chunk=32), 0),  # and the full-logits variant of a chunked one
    ],
    ids=["dense", "flash", "flash-pallas_norm", "dense-variant-chunked", "chunked-variant-plain"],
)
def test_multi_step_matches_jax(kw, variant_chunk):
    kw = {**SMALL, **kw}
    jcfg, _, mesh, (params, opt_state, tx), model, optimizer = _states(kw)
    stack = _stack(3)
    if variant_chunk is not None:
        # JAX's A/B builds the variant's step from a config with the other chunk.
        jcfg = dataclasses.replace(jcfg, xent_chunk=variant_chunk)
    jstep = jtrain.make_multi_train_step(jcfg, mesh, tx, 3)
    params, opt_state, losses_j = jstep(params, opt_state, _jax_stack(stack, mesh))
    tstep = ttrain.make_multi_train_step(model, optimizer, 3, variant_chunk)
    losses_t = tstep(torch.from_numpy(stack).long())
    assert losses_t.shape == (3,) and losses_t.dtype == torch.float32
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-5, atol=0)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, params), model.cfg)
    got = model.state_dict()
    for name, tensor in want.items():
        np.testing.assert_allclose(got[name].numpy(), tensor.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_multi_step_of_one_equals_train_step_exactly():
    """Mirrors the JAX test_multi_train_step_matches_plain_step: one inner
    step gives the plain step's loss bit for bit, from the same weights and
    tokens, and that loss is above the ln(vocab) entropy floor."""
    cfg = tmodel.ModelConfig(dtype=torch.float32, **SMALL)
    tokens = torch.from_numpy(_stack(1)).long()
    model_a, opt_a = ttrain.make_train_state(cfg, "cpu", seed=0)
    plain = ttrain.train_step(model_a, opt_a, tokens[0])
    model_b, opt_b = ttrain.make_train_state(cfg, "cpu", seed=0)
    losses = ttrain.make_multi_train_step(model_b, opt_b, 1)(tokens)
    assert float(plain) == float(losses[0])
    for (name, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), name
    assert float(plain) > math.log(cfg.vocab_size) - 0.25


def test_multi_step_rejects_a_stack_of_the_wrong_depth():
    model, optimizer = ttrain.make_train_state(ModelConfig.tiny(), "cpu")
    with pytest.raises(ValueError, match="inner_steps"):
        ttrain.make_multi_train_step(model, optimizer, 0)
    step = ttrain.make_multi_train_step(model, optimizer, 2)
    with pytest.raises(ValueError, match="stack of 2"):
        step(torch.zeros(3, 1, 16, dtype=torch.long))


def test_optimizer_is_capturable_only_on_the_card():
    model = tmodel.TransformerLM(tmodel.ModelConfig(**SMALL))
    assert ttrain.make_optimizer(model).param_groups[0]["capturable"] is False


def test_run_smoke_multi_step_cpu():
    """Mirrors the JAX test_run_smoke_multi_step_cpu_mesh: the same report
    schema and checks through the multi-step path."""
    snaps = []
    report = smoke.run_smoke(steps=4, cfg=ModelConfig.tiny(), batch_per_device=1,
                             inner_steps=2, device="cpu", emit=snaps.append)
    assert report["ok"]
    assert report["inner_steps"] == 2
    assert report["first_loss_sane"] and report["loss_decreased"]
    # Readiness excludes the first call's extra inner_steps - 1 steps.
    assert 0 <= report["time_to_ready_s"] <= report["time_to_first_step_s"]
    assert report["measured_windows"] == "2/2" and report["measured_steps"] == 4
    assert report["steps_run"] == 6  # the first call and two measured ones
    assert report["capture_s"] is None  # the eager loop captures nothing
    assert [s["partial"] for s in snaps] == ["devices_up", "first_step", "window_1/2"]


def test_run_smoke_rounds_steps_up_to_whole_calls():
    report = smoke.run_smoke(steps=5, cfg=ModelConfig.tiny(), batch_per_device=1,
                             inner_steps=3, device="cpu")
    assert report["measured_windows"] == "2/2"
    assert report["measured_steps"] == 6 and report["steps_run"] == 9


def test_run_smoke_in_process_xent_ab():
    """Mirrors the JAX test of the same name: the report carries
    ab.vs_plain_step, the A/B's first loss is finite, the main verdict is
    unaffected, and the ab_pending snapshot carries the final verdict."""
    snaps = []
    cfg = ModelConfig.tiny()
    report = smoke.run_smoke(steps=4, cfg=cfg, batch_per_device=1, inner_steps=2,
                             device="cpu", emit=snaps.append,
                             ab_xent_chunk=cfg.vocab_size // 2)
    assert report["ok"]
    ab = report["ab"]
    assert ab["xent_chunk"] == cfg.vocab_size // 2
    assert "error" not in ab, ab
    assert ab["step_time_s"] > 0 and ab["vs_plain_step"] > 0
    assert math.isfinite(ab["first_loss"])
    assert ab["variant_xent_chunk"] == cfg.vocab_size // 2 and ab["interleaved"]
    # The variant's first call, then AB_PAIRS pairs of calls.
    assert ab["steps_run"] == 2 * (1 + 2 * smoke.AB_PAIRS)
    assert report["steps_run"] == 6 + ab["steps_run"]
    pending = [s for s in snaps if s.get("partial") == "ab_pending"]
    assert pending and pending[-1]["ok"] is True and "ab" not in pending[-1]


def test_run_smoke_ab_flips_to_plain_when_main_is_chunked():
    """Mirrors the JAX test of the same name: with the main run chunked at
    the A/B's chunk, the variant is full-logits, and vs_plain_step keeps
    its orientation."""
    cfg = dataclasses.replace(ModelConfig.tiny(), xent_chunk=32)
    report = smoke.run_smoke(steps=4, cfg=cfg, batch_per_device=1, inner_steps=2,
                             device="cpu", ab_xent_chunk=32)
    ab = report["ab"]
    assert "error" not in ab, ab
    assert ab["main_xent_chunk"] == 32 and ab["variant_xent_chunk"] == 0
    assert ab["vs_plain_step"] > 0


def test_run_smoke_ab_requires_multi_step():
    report = smoke.run_smoke(steps=2, cfg=ModelConfig.tiny(), batch_per_device=1,
                             inner_steps=1, device="cpu", ab_xent_chunk=32)
    assert report["ok"]
    assert "skipped" in report["ab"]


def test_run_smoke_ab_skips_a_main_chunk_that_differs():
    cfg = dataclasses.replace(ModelConfig.tiny(), xent_chunk=16)
    report = smoke.run_smoke(steps=2, cfg=cfg, batch_per_device=1, inner_steps=2,
                             device="cpu", ab_xent_chunk=32)
    assert report["ok"]
    assert "two chunked variants" in report["ab"]["skipped"]
