"""The frozen arithmetic against numbers worked by hand."""

import json
import math

import pytest

from gpubench import arith, run
from gpubench.families import dense_lm


def sizes(name):
    with open(run.HERE / "configs" / f"{name}.json") as f:
        return dense_lm.sizes(json.load(f))


def test_gpt2_xl_sizes_are_the_published_ones():
    assert sizes("gpt2-xl") == dense_lm.Sizes(vocab=50257, d_model=1600, heads=25, layers=48,
                                              d_ff=6400, seq=1024)


@pytest.mark.parametrize("name, per_token, per_step", [
    # gpt2-xl: 48 x (8*1600^2 + 4*1024*1600 + 4*1600*6400) + 2*1600*50257
    ("gpt2-xl", 3_424_515_200, 8.416e13),
    # smoke-bench: 4 x (8*2048^2 + 4*2048*2048 + 4*2048*8192) + 2*2048*32768
    ("smoke-bench", 603_979_776, 2.969e13),
])
def test_flops_per_step(name, per_token, per_step):
    sz = sizes(name)
    flops = dense_lm.flops_per_step(sz, 8)
    assert flops == 3 * 8 * sz.seq * per_token
    assert flops == pytest.approx(per_step, rel=1e-3)


@pytest.mark.parametrize("name, with_scales, without_scales", [
    ("gpt2-xl", 1_556_764_800, 1_556_609_600),
    ("smoke-bench", 272_648_192, 272_629_760),
])
def test_parameter_counts(name, with_scales, without_scales):
    specs = dense_lm.leaves(sizes(name))
    assert sum(math.prod(s) for _, s, _ in specs) == with_scales
    assert sum(math.prod(s) for _, s, std in specs if std is not None) == without_scales


@pytest.mark.parametrize("kind, ms", [
    # The port's kernel table at (8, 16, 2048, 128): K1 0.1390, K2 0.2086,
    # K3 0.2781 ms on operations, delta 0.04038 ms on bytes.
    ("fwd", 0.1390), ("dq", 0.2086), ("dkv", 0.2781), ("delta", 0.04038),
])
def test_flash_bounds_match_the_kernel_table(kind, ms):
    assert arith.flash_bound_s(kind, 8, 16, 2048, 128) * 1e3 == pytest.approx(ms, rel=5e-4)


def test_flash_forward_bound_by_hand():
    # gpt2-xl's shape: 2 products x 2 FLOPs x head_dim x batch x heads x
    # s(s+1)/2 over 989 TFLOP/s is 27.2 us, under Q, K, V read and O written
    # in bf16 and lse in f32 over 3.35 TB/s, 31.5 us: bound by bytes.
    rows = 8 * 25 * 1024
    flops = 2 * 2 * 64 * 8 * 25 * (1024 * 1025 // 2)
    nbytes = 4 * rows * 64 * 2 + rows * 4
    assert flops / 989e12 < nbytes / 3.35e12
    assert arith.flash_bound_s("fwd", 8, 25, 1024, 64) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("name, group, flash", [
    ("void flash::fwd_kernel<128, 4>(CUtensorMap, CUtensorMap)", "flash_fwd", "fwd"),
    ("void flash::dq_kernel<64, 2>(CUtensorMap)", "flash_bwd", "dq"),
    ("void flash::dkv_kernel<128, 2>(CUtensorMap)", "flash_bwd", "dkv"),
    ("flash::bwd_delta_kernel(__nv_bfloat16 const*, float*, int)", "flash_bwd", "delta"),
    ("void rmsnorm::fwd_kernel<__nv_bfloat16, float>(...)", "rmsnorm", None),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "matmul_f32", None),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN", "matmul", None),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "optimizer", None),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "softmax_xent", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>", "other", None),
])
def test_kernel_groups(name, group, flash):
    assert arith.group(name) == group
    assert arith.flash_kernel(name) == flash
