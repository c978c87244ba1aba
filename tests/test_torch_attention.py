"""The PyTorch port's causal flash attention against the JAX package's.

The same inputs, drawn with numpy from a seed, go through the JAX
``flash_attention`` (Pallas in interpret mode on the CPU) and the port's
(the kernels' plain PyTorch versions on the CPU), in float32, at the JAX
suite's own tolerances: 2e-5 for outputs, 2e-4 for gradients
(tests/test_ops.py). The kernels themselves run only on a CUDA card; their
tests are in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.ops import attention as jattn
from k8s_device_plugin_tpu_torch.device import uses_kernel
from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
from k8s_device_plugin_tpu_torch.ops import attention as tattn

# (shape, JAX block_q, block_kv): the JAX suite's base case at its default
# blocks, the kv-wider-than-q tiling case, and a seq no block divides
# (the JAX kernel falls back to 50-row blocks; the port masks the ragged
# tail instead).
CASES = [
    ((2, 2, 128, 32), 0, 0),
    ((1, 1, 256, 16), 64, 128),
    ((1, 1, 100, 16), 64, 64),
]
IDS = ["base", "kv_wider_tiles", "seq100"]


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape,bq,bkv", CASES, ids=IDS)
def test_forward_and_lse_match_jax(shape, bq, bkv):
    q, k, v = _inputs(shape, 0)
    out_j, res = jattn._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq, bkv)
    b, h, seq, _ = shape
    # The JAX residual stores lse lane-broadcast as (b*h, seq, 8).
    lse_j = np.asarray(res[4])[..., 0].reshape(b * h, seq)
    out_t, lse_t = tattn.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=2e-5, rtol=0)
    public = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(public.numpy(), np.asarray(out_j), atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape,bq,bkv", CASES, ids=IDS)
def test_gradients_match_jax(shape, bq, bkv):
    q, k, v = _inputs(shape, 1)

    def loss_j(q_, k_, v_):
        return jnp.sum(jnp.tanh(jattn.flash_attention(q_, k_, v_, bq, bkv)))

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    torch.tanh(tattn.flash_attention(qt, kt, vt)).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_matches_reference_attention_and_jax_reference():
    q, k, v = _inputs((2, 2, 64, 16), 2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ref_j = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_t = tattn.reference_attention(tq, tk, tv)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        tattn.flash_attention(tq, tk, tv).numpy(), ref_t.numpy(), atol=2e-5, rtol=0
    )


def test_flash_attention_is_causal():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 1, 64, 16), 3))
    out1 = tattn.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 32:] = 0.0
    v2[:, :, 32:] = 99.0
    out2 = tattn.flash_attention(q, k2, v2)
    assert torch.allclose(out1[:, :, :32], out2[:, :, :32], atol=1e-6)
    assert not torch.allclose(out1[:, :, 32:], out2[:, :, 32:], atol=1e-2)


def test_bf16_plain_versions_match_jax_interpret_mode():
    """In bf16 both sides round p and dS to bf16 before their products."""
    q, k, v, g = _inputs((1, 2, 128, 32), 4, n=4)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    out_j, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(a, b, c, 64, 64), jq, jk, jv)
    grads_j = vjp(jg)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    out_t, lse_t = tattn.flash_attention_fwd_plain(tq, tk, tv)
    grads_t = tattn.flash_attention_bwd_plain(tq, tk, tv, out_t, lse_t, tg)
    for got, want in zip((out_t, *grads_t), (out_j, *grads_j)):
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
        scale = np.abs(np.asarray(want, np.float32)).max()
        assert diff <= 2.0 ** -5 * scale, (diff, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_delta_plain_matches_numpy_and_the_jax_backward(dtype):
    """delta = rowsum(dO * O) in f32: the expression the JAX ``_dq_kernel``
    and ``_dkv_kernel`` evaluate per tile, on the JAX forward's own O (Pallas
    in interpret mode), against the port's plain prepass and numpy."""
    shape = (2, 2, 100, 32)
    b, h, seq, d = shape
    q, k, v, g = _inputs(shape, 7, n=4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    _, res = jattn._flash_fwd(jq, jk, jv, 0, 0)
    out_j = res[3]  # (b*h, seq, d), the O the JAX backward reads
    do_j = jg.reshape(b * h, seq, d)
    delta_j = np.asarray(jnp.sum(do_j.astype(jnp.float32) * out_j.astype(jnp.float32), axis=-1))
    tdt = getattr(torch, dtype)
    o_t = torch.from_numpy(np.array(out_j, np.float32)).to(tdt).reshape(shape)
    do_t = torch.from_numpy(np.array(jg, np.float32)).to(tdt)
    got = tattn.flash_bwd_delta_plain(o_t, do_t)
    assert got.dtype == torch.float32 and got.shape == (b * h, seq)
    want_np = (np.asarray(do_j, np.float64) * np.asarray(out_j, np.float64)).sum(-1)
    tol = tattn.DELTA_RTOL * np.abs(want_np).max()
    np.testing.assert_allclose(got.numpy(), delta_j, atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_np, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,bq,bkv", CASES, ids=IDS)
def test_backward_with_a_precomputed_delta_matches_the_one_without(shape, bq, bkv):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, 8, n=4))
    o, lse = tattn.flash_attention_fwd(q, k, v)
    delta = tattn.flash_bwd_delta_plain(o, do)
    given = tattn.flash_attention_bwd(q, k, v, o, lse, do, delta=delta)
    derived = tattn.flash_attention_bwd(q, k, v, o, lse, do)
    for got, want in zip(given, derived):
        assert torch.equal(got, want)
    assert torch.equal(tattn.flash_dq_plain(q, k, v, o, lse, do, delta), given[0])
    assert all(torch.equal(a, b_) for a, b_ in
               zip(tattn.flash_dkv_plain(q, k, v, o, lse, do, delta), given[1:]))


def test_cpu_path_launches_no_kernel():
    reset_launches()
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs((1, 2, 32, 16), 5))
    tattn.flash_attention(q, k, v).sum().backward()
    assert LAUNCHES == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_bwd_delta": 0, "rmsnorm": 0,
        "head_gemm": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: a kernel wrapper given anything but CUDA bf16 raises."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 1, 64, 64), 6))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_fwd_kernel(q, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_fwd_kernel(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_bwd_delta_kernel(q, v)
    with pytest.raises(ValueError):
        uses_kernel(torch.empty(1, device="meta"))
