"""The PyTorch port's ring attention (``parallel/ring.py``) and its ring
model on gloo ranks on the CPU, against the JAX package's: the JAX
``tests/test_ring.py`` cases, mirrored, and the context-parallel train
step against the JAX 8-device step.

The JAX side runs in this process on its 8 simulated devices; the port's
side on the 8 rank processes of one ``RankPool``, which import no JAX
(``tests/torch_rank_jobs.py``), on the JAX tests' meshes. Each rank takes
its (batch, heads, seq) block of the same numpy inputs, as the JAX
``shard_map`` gives it, and the test puts the blocks back together.

Tolerances: the JAX tests' own (1e-5 on the output, 1e-4 on the
gradients, 1e-6 between the chunked and unchunked outputs, 0.15 max and
0.02 mean between the bf16 ring and dense models); against the JAX
``ring_attention`` on the same inputs, 1e-5 at float32 and, at bf16, one
bf16 rounding of the output (2^-8 of the largest output, as both round the
same f32 values); the JAX sharded step's 1e-5 relative on the loss and
1e-4 absolute on the parameters (``test_torch_sharded.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from k8s_device_plugin_tpu.ops.attention import reference_attention
from k8s_device_plugin_tpu.parallel.ring import ring_attention as jax_ring_attention
from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool
from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh
from k8s_device_plugin_tpu_torch.parallel.ring import ring_attention
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params
from tests import torch_rank_jobs as jobs
from tests.torch_jax_reference import jax_mesh, jax_train_steps

TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq_len=16)
SMALL = dict(TINY, n_layers=2)
JOB_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def pool8():
    with RankPool(8, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


def _qkv(b=4, h=2, s=32, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d), dtype=np.float32) for _ in range(3))


def _six(shape) -> tuple:
    """A JAX test's 4-axis (data, fsdp, seq, model) mesh as six axes."""
    return (shape[0], shape[1], 1, 1, shape[2], shape[3])


def _assemble(parts: list, key: str, like: np.ndarray, index=None) -> np.ndarray:
    """The global tensor from each rank's (batch, heads, seq) block."""
    out = np.zeros_like(like)
    for part in parts:
        idx = []
        for dim, axis in enumerate(("batch", "heads", "seq")):
            i, n = part["coords"][axis]
            size = like.shape[dim] // n
            idx.append(slice(i * size, (i + 1) * size))
        value = part[key] if index is None else part[key][index]
        out[tuple(idx)] = value
    return out


def _in_world_of_one(fn):
    """``fn(seq_group)`` over a world of one in this process (a size-1
    mesh, as the JAX test's (1, 1, 1, 1))."""
    was_up = dist.is_initialized()
    try:
        return fn(make_mesh(1, device="cpu")["seq"].get_group())
    finally:
        if not was_up:
            dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(2, 1, 4, 1), (1, 2, 2, 2), (1, 1, 8, 1), (1, 1, 1, 1)])
def test_ring_matches_reference(pool8, shape):
    q, k, v = _qkv()
    ref = np.asarray(reference_attention(*map(jnp.asarray, (q, k, v))))
    if math.prod(shape) == 1:
        out = _in_world_of_one(lambda g: ring_attention(
            *map(torch.from_numpy, (q, k, v)), g).numpy())
    else:
        out = _assemble(pool8.run(jobs.ring_shard, _six(shape), q, k, v), "out", q)
    assert np.abs(out - ref).max() < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_matches_jax_ring(pool8, dtype):
    """The port's ring against the JAX ``ring_attention`` on the same
    inputs and the (1, 2, 2, 2) mesh; at bf16 both compute in f32 and
    round the output once."""
    q, k, v = (jnp.asarray(a).astype(dtype) for a in _qkv(seed=3))
    shape = _six((1, 2, 2, 2))
    jring = np.asarray(jax_ring_attention(q, k, v, jax_mesh(shape)), np.float32)
    as_np = [np.asarray(a, np.float32) for a in (q, k, v)]
    out = _assemble(pool8.run(jobs.ring_shard, shape, *as_np, 0, dtype), "out", as_np[0])
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(jring).max()
    assert np.abs(out - jring).max() <= tol


def test_ring_gradients_match_reference(pool8):
    q, k, v = _qkv()
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def grads(att):
        return jax.grad(lambda q, k, v: jnp.sum(att(q, k, v) ** 2), argnums=(0, 1, 2))(jq, jk, jv)

    g_ref = grads(reference_attention)
    parts = pool8.run(jobs.ring_shard, _six((2, 1, 4, 1)), q, k, v, 0, "float32", True)
    for i, want in enumerate(g_ref):
        got = _assemble(parts, "grads", q, index=i)
        assert np.abs(got - np.asarray(want)).max() < 1e-4


def test_ring_q_chunked_matches_unchunked(pool8):
    """q_chunk caps the per-step score tile; the forward and the gradients
    equal the unchunked ones (s 32 over 8 shards: s_local 4, chunk 2), and
    a chunk that does not divide the shard is refused up front."""
    q, k, v = _qkv()
    shape = _six((1, 1, 8, 1))
    full = pool8.run(jobs.ring_shard, shape, q, k, v, 0, "float32", True)
    chunked = pool8.run(jobs.ring_shard, shape, q, k, v, 2, "float32", True)
    out_full, out_chunk = _assemble(full, "out", q), _assemble(chunked, "out", q)
    assert np.abs(out_full - out_chunk).max() < 1e-6
    ref = np.asarray(reference_attention(*map(jnp.asarray, (q, k, v))))
    assert np.abs(out_chunk - ref).max() < 1e-5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    g_ref = jax.grad(lambda q, k, v: jnp.sum(reference_attention(q, k, v) ** 2),
                     argnums=(0, 1, 2))(jq, jk, jv)
    for i, want in enumerate(g_ref):
        assert np.abs(_assemble(chunked, "grads", q, index=i) - np.asarray(want)).max() < 1e-4
    errors = pool8.run(jobs.ring_refusal, shape, q, 3)
    assert all("must divide" in e for e in errors)


def test_model_with_ring_attention_matches_dense(pool8):
    """bf16 ``tiny()`` on (1, 2, 2, 2): the ring model's logits against
    the dense model's on the same weights and tokens, the JAX test's
    bounds (the two reorder the softmax's sums)."""
    dense = init_model(ModelConfig(**TINY), 0, "cpu")
    state = {k: v.numpy() for k, v in dense.state_dict().items()}
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (4, TINY["max_seq_len"]))
    with torch.no_grad():
        want = dense(torch.from_numpy(tokens).long()).numpy()
    parts = pool8.run(jobs.model_logits, dict(TINY, use_ring_attention=True),
                      _six((1, 2, 2, 2)), state, tokens)
    rows = {p["batch"][0]: p["logits"] for p in parts}
    got = np.concatenate([rows[i] for i in sorted(rows)])
    diff = np.abs(got - want)
    assert diff.max() < 0.15 and diff.mean() < 0.02


def test_train_step_with_context_parallelism(pool8):
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (8, TINY["max_seq_len"]))
    results = pool8.run(jobs.train_steps, dict(TINY, use_ring_attention=True),
                        _six((1, 2, 2, 2)), tokens, 3)
    losses = results[0]["losses"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert all(r["losses"] == losses for r in results)


def test_ring_float32_matches_jax_sharded_step(pool8):
    """fsdp 2 x seq 2 x model 2, float32, against the JAX step on the same
    mesh: the loss after 1, 2 and 3 steps within 1e-5 relative and every
    parameter within 1e-4 after 1 and 3. Without the split region's
    entry sum, wq, wk and wv would get half their gradient."""
    kw = dict(SMALL, use_ring_attention=True)
    shape = (1, 2, 1, 1, 2, 2)
    tokens = np.random.default_rng(11).integers(0, kw["vocab_size"], (4, kw["max_seq_len"]))
    start, jlosses, jafter = jax_train_steps(kw, shape, tokens)
    tcfg = ModelConfig(dtype=torch.float32, **kw)
    state = {k: v.numpy() for k, v in from_jax_params(start, tcfg).items()}
    got = pool8.run(jobs.train_steps, dict(kw, dtype=torch.float32), shape, tokens, 3,
                    state, (1, 3))[0]
    for loss_t, loss_j in zip(got["losses"], jlosses):
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
    for i in (1, 3):
        for name, tensor in from_jax_params(jafter[i], tcfg).items():
            np.testing.assert_allclose(got["params"][i][name], tensor.numpy(), atol=1e-4,
                                       rtol=0, err_msg=f"{name} after {i}")


def test_ring_model_needs_a_mesh():
    """A ring model run without ``shard_model``'s seq group raises, as the
    JAX model without ``ring_mesh`` does; so does ring with flash."""
    tokens = torch.zeros(2, TINY["max_seq_len"], dtype=torch.long)
    model = init_model(ModelConfig(**TINY, use_ring_attention=True), 0, "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        model(tokens)
    both = init_model(ModelConfig(**TINY, use_ring_attention=True, use_flash_attention=True),
                      0, "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        both(tokens)
