"""The JAX side of the port's parallel parity tests: the JAX package's
sharded train step on its simulated CPU devices, float32, from seed 0.

Imported by the test modules (never by the port's rank processes, which
import no JAX)."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from k8s_device_plugin_tpu.parallel.mesh import batch_sharding, make_mesh
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain


def jax_config(kw: dict, mesh=None, dtype=jnp.float32) -> jmodel.ModelConfig:
    """The JAX config of the port's ``ModelConfig(**kw)``: a ring or
    pipelined one carries ``mesh`` (JAX's ``ring_mesh``/``pipe_mesh``), and
    a pipelined one stacks its layers (``scan_layers``), as JAX needs."""
    extra = {}
    if kw.get("use_ring_attention"):
        extra.update(ring_mesh=mesh)
    if kw.get("pipeline_microbatches", 0) > 0:
        extra.update(scan_layers=True, pipe_mesh=mesh)
    return jmodel.ModelConfig(dtype=dtype, **kw, **extra)


def jax_mesh(shape):
    return make_mesh(jax.devices()[:math.prod(shape)], shape=tuple(shape))


def jax_train_steps(kw: dict, shape, tokens: np.ndarray, steps: int = 3, keep=(1, 3)):
    """``steps`` JAX sharded train steps on a mesh of ``shape`` over the
    global batch ``tokens``: the start parameters, the losses and the
    parameters after each step in ``keep`` (numpy trees)."""
    mesh = jax_mesh(shape)
    cfg = jax_config(kw, mesh)
    params, opt_state, tx = jtrain.make_train_state(cfg, mesh, jax.random.PRNGKey(0))
    # Copy out before the donating step consumes the buffers.
    start = jax.tree_util.tree_map(np.array, params)
    step = jtrain.make_train_step(cfg, mesh, tx)
    jtokens = jax.device_put(jnp.asarray(tokens, dtype=jnp.int32), batch_sharding(mesh))
    losses, after = [], {}
    for i in range(1, steps + 1):
        params, opt_state, loss = step(params, opt_state, jtokens)
        losses.append(float(loss))
        if i in keep:
            after[i] = jax.tree_util.tree_map(np.array, params)
    return start, losses, after
