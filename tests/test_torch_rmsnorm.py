"""The PyTorch port's RMSNorm against the JAX package's.

The same inputs, drawn with numpy from a seed, go through the JAX
``rmsnorm`` (the Pallas kernel in interpret mode on the CPU) and the
port's (the kernel's plain PyTorch version on the CPU). float32 at the JAX
suite's own tolerances (tests/test_ops.py): 1e-6 for the forward, 1e-5 for
the gradients. bf16: y within one bf16 ulp of the JAX value, and the
output and gradient dtypes equal to the JAX ones. The kernel itself runs
only on a CUDA card; its tests are in test_torch_kernels.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import LAUNCHES, reset_launches
from k8s_device_plugin_tpu_torch.ops import rmsnorm as trms

# ``k8s_device_plugin_tpu.ops`` re-exports the function under the module's
# name, so the module is taken from the import system.
jrms = importlib.import_module("k8s_device_plugin_tpu.ops.rmsnorm")

EPS = 1e-6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    scale = rng.standard_normal(shape[-1], dtype=np.float32) * 0.1 + 1.0
    return x, scale


def _bf16_ulp(values: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (8 bits of significand)."""
    mag = np.maximum(np.abs(values), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(64, 128), (300, 32)], ids=["base", "rows300"])
def test_forward_and_rrms_match_jax(shape):
    """y and rrms against the Pallas kernel's own outputs, and y against
    the public JAX ``rmsnorm``. 300 rows: no 256-row block divides it."""
    x, scale = _inputs(shape, 0)
    y_j, rrms_j = jrms._rmsnorm_fwd_pallas(jnp.asarray(x), jnp.asarray(scale), EPS)
    y_t, rrms_t = trms.rmsnorm_fwd(torch.from_numpy(x), torch.from_numpy(scale), EPS)
    assert tuple(rrms_t.shape) == rrms_j.shape == (shape[0], 1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rrms_t.numpy(), np.asarray(rrms_j), atol=1e-6, rtol=0)
    public = trms.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jrms.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(public.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(32, 64), (300, 32), (2, 7, 48)],
                         ids=["base", "rows300", "3d"])
def test_gradients_match_jax(shape):
    """Gradients of sum(sin(rmsnorm(x, scale))) in x and scale."""
    x, scale = _inputs(shape, 1)

    def loss_j(x_, s_):
        return jnp.sum(jnp.sin(jrms.rmsnorm(x_, s_)))

    gx_j, gs_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    xt, st = (torch.from_numpy(a).requires_grad_() for a in (x, scale))
    torch.sin(trms.rmsnorm(xt, st)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j), atol=1e-5, rtol=0)


def test_three_dimensional_input_keeps_its_shape():
    x, scale = _inputs((3, 5, 64), 2)
    y_t = trms.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    y_j = jrms.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    assert tuple(y_t.shape) == y_j.shape == (3, 5, 64)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bf16_matches_jax_in_value_and_dtype(scale_dtype):
    """bf16 x: y is bf16 (x's dtype, not promoted), within one bf16 ulp of
    the JAX value; dx is bf16 and dscale has the scale's dtype, each within
    one ulp of its own type of the JAX gradient."""
    x, scale = _inputs((300, 64), 3)
    g = np.random.default_rng(4).standard_normal((300, 64), dtype=np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    js = jnp.asarray(scale, JDT[scale_dtype])
    y_j, vjp = jax.vjp(jrms.rmsnorm, jx, js)
    dx_j, ds_j = vjp(jnp.asarray(g, jnp.bfloat16))

    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    st = torch.from_numpy(scale).to(scale_dtype).requires_grad_()
    y_t = trms.rmsnorm(xt, st)
    y_t.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert (y_t.dtype, xt.grad.dtype, st.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, scale_dtype)
    assert (str(y_j.dtype), str(dx_j.dtype), str(ds_j.dtype)) == (
        "bfloat16", "bfloat16", str(JDT[scale_dtype].dtype))
    for got, want in ((y_t, y_j), (xt.grad, dx_j)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().float().numpy() - want)
        assert (err <= _bf16_ulp(want)).all(), err.max()
    ds_want = np.asarray(ds_j, np.float32)
    ds_err = np.abs(st.grad.float().numpy() - ds_want)
    ulp = _bf16_ulp(ds_want) if scale_dtype == torch.bfloat16 else 1e-5 * np.abs(ds_want)
    assert (ds_err <= ulp).all(), ds_err.max()


def test_backward_follows_the_jax_vjp_term_for_term():
    """rmsnorm_bwd on the saved residuals equals the JAX ``_vjp_bwd``."""
    x, scale = _inputs((40, 32), 5)
    g = np.random.default_rng(6).standard_normal((40, 32), dtype=np.float32)
    _, res = jrms._vjp_fwd(jnp.asarray(x), jnp.asarray(scale), EPS)
    dx_j, ds_j = jrms._vjp_bwd(EPS, res, jnp.asarray(g))
    _, rrms = trms.rmsnorm_fwd_plain(torch.from_numpy(x), torch.from_numpy(scale), EPS)
    dx_t, ds_t = trms.rmsnorm_bwd(torch.from_numpy(x), rrms, torch.from_numpy(scale),
                                  torch.from_numpy(g))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), atol=1e-5, rtol=0)


def test_cpu_path_launches_no_kernel_and_the_wrapper_refuses_cpu():
    """No fallback: the CPU path takes the plain version, and the kernel
    wrapper given a CPU tensor raises."""
    x, scale = _inputs((8, 64), 7)
    reset_launches()
    xt = torch.from_numpy(x).requires_grad_()
    trms.rmsnorm(xt, torch.from_numpy(scale)).sum().backward()
    assert LAUNCHES["rmsnorm"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm_fwd_kernel(torch.from_numpy(x), torch.from_numpy(scale), EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        trms.rmsnorm_fwd_kernel(torch.from_numpy(x)[:, :60], torch.from_numpy(scale)[:60], EPS)
