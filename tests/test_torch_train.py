"""The PyTorch port's AdamW train step against the JAX package's
``make_train_step`` on a one-device mesh, from the same weights and tokens.

float32, parameters within 1e-4 after 1 and after 3 steps: Adam's first
update is g / (|g| + eps), which turns rounding in a near-zero gradient
into a change of up to lr, so the tolerance is set by the update, not by
float32's epsilon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.parallel.mesh import batch_sharding, make_mesh
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch.workload import model as tmodel
from k8s_device_plugin_tpu_torch.workload import train as ttrain
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


@pytest.mark.parametrize(
    "flash,n_steps,pallas_norm",
    [(False, 1, False), (False, 3, False), (True, 3, False), (False, 3, True), (True, 3, True)],
    ids=["dense-1", "dense-3", "flash-3", "dense-3-pallas_norm", "flash-3-pallas_norm"],
)
def test_params_after_adamw_steps_match_jax(flash, n_steps, pallas_norm):
    kw = dict(use_flash_attention=flash, use_pallas_norm=pallas_norm, **SMALL)
    jcfg = jmodel.ModelConfig(dtype=jnp.float32, **kw)
    tcfg = tmodel.ModelConfig(dtype=torch.float32, **kw)
    mesh = make_mesh(jax.devices()[:1])
    params, opt_state, tx = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
    # Copy out before the donating step consumes the buffers.
    start = jax.tree_util.tree_map(np.array, params)
    model = tmodel.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(start, tcfg))
    optimizer = ttrain.make_optimizer(model)

    rng = np.random.default_rng(11)
    tokens = rng.integers(0, SMALL["vocab_size"], (4, SMALL["max_seq_len"]), dtype=np.int32)
    step = jtrain.make_train_step(jcfg, mesh, tx)
    jtokens = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh))
    ttokens = torch.from_numpy(tokens).long()
    for _ in range(n_steps):
        params, opt_state, loss_j = step(params, opt_state, jtokens)
        loss_t = ttrain.train_step(model, optimizer, ttokens)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
    got = model.state_dict()
    for name, tensor in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), tensor.numpy(), atol=1e-4, rtol=0, err_msg=name
        )


def test_optimizer_uses_optax_adamw_defaults():
    model = tmodel.TransformerLM(tmodel.ModelConfig(**SMALL))
    group = ttrain.make_optimizer(model).param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 1e-4,
    )
    assert len(group["params"]) == len(list(model.parameters()))
