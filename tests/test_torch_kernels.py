"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on the card.

Every test here carries the ``cuda`` marker and skips without a card. This
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda

bf16 tolerance: the kernel and its plain version round the same f32
values to bf16 at the same places, so each element is held to about one
bf16 ulp of itself plus a small share of the tensor's rms
(``bf16_agreement`` in ``ops/attention.py``); lse is f32 in both (1e-4).
"""

import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card to build and launch the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 100, 64), (1, 2, 256, 128), (2, 3, 200, 128)])
def test_kernels_match_plain_on_card(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (
        torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(4)
    )
    o_p, lse_p = tattn.flash_attention_fwd_plain(q, k, v)
    o, lse = tattn.flash_fwd_kernel(q, k, v)
    bwd = (q, k, v, o_p, lse_p, do)
    grads = (tattn.flash_dq_kernel(*bwd), *tattn.flash_dkv_kernel(*bwd))
    grads_p = (tattn.flash_dq_plain(*bwd), *tattn.flash_dkv_plain(*bwd))
    torch.cuda.synchronize()
    assert (lse - lse_p).abs().max() <= 1e-4
    for got, want in zip((o, *grads), (o_p, *grads_p)):
        agree = tattn.bf16_agreement(got, want)
        assert agree["ok"], agree


@pytest.mark.cuda
def test_kernel_wrappers_refuse_float32_on_card(cuda_device):
    q = torch.zeros(1, 1, 64, 64, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tattn.flash_fwd_kernel(q, q, q)


@pytest.mark.cuda
def test_autograd_function_launches_each_kernel_once(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (
        torch.randn(1, 2, 128, 64, generator=gen, device=cuda_device)
        .to(torch.bfloat16).requires_grad_()
        for _ in range(3)
    )
    tattn.reset_launches()
    tattn.flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
