"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on the card.

Every test here carries the ``cuda`` marker and skips without a card. This
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda

bf16 tolerance: the kernel and its plain version round the same f32
values to bf16 at the same places, so each element is held to about one
bf16 ulp of itself plus a small share of the tensor's rms
(``bf16_agreement`` in ``ops/attention.py``); lse is f32 in both (1e-4),
the backward's delta (f32, the same products summed in another order) is
held to a relative 1e-5, and the RMSNorm kernel's rrms to a relative 1e-5
(f32 sums in another order, and rsqrt).
"""

import re
import time

import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import LAUNCHES, _build, reset_launches
from k8s_device_plugin_tpu_torch.ops import attention as tattn
from k8s_device_plugin_tpu_torch.ops import rmsnorm as trms


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card to build and launch the kernels")
    return torch.device("cuda")


FLASH_SHAPES = [
    (2, 4, 100, 64),  # ragged: the last q and kv tiles run past seq
    (1, 2, 256, 128),
    (2, 3, 200, 128),
    (1, 2, 64, 128),  # one tile
    (1, 1, 1, 64),  # seq 1
    (1, 1, 1, 128),
    (1, 132, 128, 64),  # b*h >= 132: more heads than the card has SMs
    (1, 1, 8192, 128),  # the microbench's seq
    # around the forward's 128-row q block: one row short, one and two over;
    # with b*h > 1 they also start the dK/dV kernel's lse and delta tiles
    # off 16-byte boundaries
    (1, 2, 127, 128),
    (1, 2, 129, 128),
    (2, 2, 130, 64),
    (1, 1, 2, 64),  # seq not a multiple of 4
    (1, 1, 3, 128),
]


def _seq1_residue_bound(o, do, other):
    """At seq 1 each query sees only its own key, so O = V and dS = P (dP -
    delta) is zero in exact arithmetic: dq and dk are the f32 rounding
    residue of dP - delta in either version, summed in different orders,
    and no two such residues agree. Each is held to the residue's bound
    instead, d * 2^-24 * sum_d |dO O| a row (a float32 sum's worst case)
    times scale * |K| (for dq) or |Q| (for dk)."""
    d = o.shape[-1]
    row = d * 2.0 ** -24 * (do.float() * o.float()).abs().sum(-1, keepdim=True)
    return row * d ** -0.5 * other.float().abs()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain_on_card(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (
        torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(4)
    )
    o_p, lse_p = tattn.flash_attention_fwd_plain(q, k, v)
    o, lse = tattn.flash_fwd_kernel(q, k, v)
    bwd = (q, k, v, o_p, lse_p, do)
    delta = tattn.flash_bwd_delta_kernel(o_p, do)
    delta_p = tattn.flash_bwd_delta_plain(o_p, do)
    grads = (tattn.flash_dq_kernel(*bwd), *tattn.flash_dkv_kernel(*bwd))
    grads_p = (tattn.flash_dq_plain(*bwd), *tattn.flash_dkv_plain(*bwd))
    torch.cuda.synchronize()
    assert (lse - lse_p).abs().max() <= 1e-4
    assert (delta - delta_p).abs().max() <= tattn.DELTA_RTOL * delta_p.abs().max()
    pairs = list(zip((o, *grads), (o_p, *grads_p)))
    if shape[2] == 1:
        for (got, want), other in zip(pairs[1:3], (k, q)):
            bound = _seq1_residue_bound(o_p, do, other)
            assert (got.float().abs() <= bound).all() and (want.float().abs() <= bound).all()
        del pairs[1:3]
    for got, want in pairs:
        agree = tattn.bf16_agreement(got, want)
        assert agree["ok"], agree


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 100, 64), (2, 8, 1024, 128)])
def test_backward_kernels_repeat_bit_for_bit(cuda_device, shape):
    """One owner per output row and no atomics: two launches on the same
    inputs give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (
        torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(4)
    )
    o, lse = tattn.flash_fwd_kernel(q, k, v)
    first = tattn.flash_attention_bwd(q, k, v, o, lse, do)
    second = tattn.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 100, 64), (8, 16, 2048, 128)])
def test_forward_kernel_repeats_bit_for_bit(cuda_device, shape):
    """One owner per output row and no atomics: two forward launches on the
    same inputs give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (
        torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(3)
    )
    first = tattn.flash_fwd_kernel(q, k, v)
    second = tattn.flash_fwd_kernel(q, k, v)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [100, 127, 129, 2])
def test_forward_writes_nothing_past_each_heads_rows(cuda_device, seq):
    """The forward's C entry point given O and lse buffers longer than
    b*h*seq rows, filled with a sentinel: every head's rows hold the plain
    version's values and the rows past the last head keep the sentinel, so
    no ragged q block stores past its head's seq."""
    shape, pad = (1, 3, seq, 64), 128
    gen = torch.Generator(device=cuda_device).manual_seed(seq)
    q, k, v = (
        torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(3)
    )
    rows = 3 * seq
    o_buf = torch.full((rows + pad, 64), 7.0, dtype=torch.bfloat16, device=cuda_device)
    lse_buf = torch.full((rows + pad,), 7.0, dtype=torch.float32, device=cuda_device)
    fn = _build.bind("flash_fwd", "flash_fwd", [tattn._P] * 5 + [tattn._I] * 4
                     + [tattn._F, tattn._P])
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_buf.data_ptr(),
                    lse_buf.data_ptr(), 3, seq, 64, tattn.DEFAULT_FWD_STAGES, 64 ** -0.5,
                    stream), "flash_fwd")
    o_p, lse_p = tattn.flash_attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o_buf[rows:], torch.full_like(o_buf[rows:], 7.0))
    assert torch.equal(lse_buf[rows:], torch.full_like(lse_buf[rows:], 7.0))
    assert (lse_buf[:rows] - lse_p.reshape(-1)).abs().max() <= 1e-4
    agree = tattn.bf16_agreement(o_buf[:rows].reshape(shape), o_p)
    assert agree["ok"], agree


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 2048, 128), (2, 4, 130, 64)],
                         ids=["bench", "ragged"])
def test_every_ring_depth_matches_plain_on_card(cuda_device, shape):
    """Every instance the kernels are built for: the forward at each K/V
    ring depth, dQ and dK/dV at each depth of their streamed ring, each
    against the plain version (bf16_agreement; lse within 1e-4), each
    launch counted under its kernel's name."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, do = (
        torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(4)
    )
    o_p, lse_p = tattn.flash_attention_fwd_plain(q, k, v)
    bwd = (q, k, v, o_p, lse_p, do)
    delta = tattn.flash_bwd_delta_kernel(o_p, do)
    dq_p, (dk_p, dv_p) = tattn.flash_dq_plain(*bwd), tattn.flash_dkv_plain(*bwd)
    reset_launches()
    for stages in tattn.FWD_STAGES:
        o, lse = tattn.flash_fwd_kernel(q, k, v, stages)
        torch.cuda.synchronize()
        assert (lse - lse_p).abs().max() <= 1e-4, stages
        agree = tattn.bf16_agreement(o, o_p)
        assert agree["ok"], (stages, agree)
    for stages in tattn.BWD_STAGES:
        dq = tattn.flash_dq_kernel(*bwd, delta=delta, stages=stages)
        dk, dv = tattn.flash_dkv_kernel(*bwd, delta=delta, stages=stages)
        torch.cuda.synchronize()
        for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
            agree = tattn.bf16_agreement(got, want)
            assert agree["ok"], (stages, agree)
    assert LAUNCHES == {"flash_fwd": len(tattn.FWD_STAGES), "flash_dq": len(tattn.BWD_STAGES),
                        "flash_dkv": len(tattn.BWD_STAGES), "flash_bwd_delta": 0, "rmsnorm": 0}


@pytest.mark.cuda
def test_a_depth_not_built_is_refused_on_card(cuda_device):
    """The wrapper refuses it, and so does the C entry point behind it."""
    q = torch.zeros(1, 1, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ring depth"):
        tattn.flash_fwd_kernel(q, q, q, 5)
    fn = _build.bind("flash_fwd", "flash_fwd", [tattn._P] * 5 + [tattn._I] * 4
                     + [tattn._F, tattn._P])
    out, lse = torch.empty_like(q), torch.empty(1, 64, device=cuda_device)
    err = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), lse.data_ptr(), 1, 64,
             64, 5, 0.125, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(err, "flash_fwd")


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
    reset_launches()
    tattn.flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_bwd_delta": 1, "rmsnorm": 0}
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,x_dtype,scale_dtype",
    [
        ((16384, 2048), torch.bfloat16, torch.float32),  # the bench model's norms
        ((8192, 4096), torch.bfloat16, torch.bfloat16),  # the microbench's case
        ((300, 2048), torch.bfloat16, torch.float32),  # no 256-row block divides it
        ((300, 8192), torch.float32, torch.bfloat16),  # the widest row, f32 x
        ((7, 8), torch.float32, torch.float32),  # the narrowest row
    ],
    ids=["bench", "microbench", "ragged", "f32-widest", "narrowest"],
)
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device, shape, x_dtype, scale_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda_device).to(x_dtype)
    scale = (1.0 + 0.1 * torch.randn(shape[1], generator=gen, device=cuda_device)).to(scale_dtype)
    y, rrms = trms.rmsnorm_fwd_kernel(x, scale, 1e-6)
    y_p, rrms_p = trms.rmsnorm_fwd_plain(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert y.dtype == x_dtype and rrms.shape == (shape[0], 1)
    assert ((rrms - rrms_p).abs() / rrms_p).max() <= 1e-5
    if x_dtype == torch.bfloat16:
        agree = tattn.bf16_agreement(y, y_p)
        assert agree["ok"], agree
    else:
        torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_rmsnorm_launches_the_kernel_once_per_forward(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(2, 50, 256, generator=gen, device=cuda_device).to(torch.bfloat16)
    x.requires_grad_()
    scale = torch.ones(256, device=cuda_device, requires_grad=True)
    reset_launches()
    y = trms.rmsnorm(x, scale)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_bwd_delta": 0, "rmsnorm": 1}
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert x.grad.dtype == torch.bfloat16 and scale.grad.dtype == torch.float32
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(scale.grad).all()


@pytest.mark.cuda
def test_rmsnorm_kernel_refuses_what_it_does_not_take(cuda_device):
    scale = torch.ones(64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trms.rmsnorm_fwd_kernel(torch.zeros(4, 64, device=cuda_device).half(), scale, 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        trms.rmsnorm_fwd_kernel(torch.zeros(4, 60, device=cuda_device), scale[:60], 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        wide = torch.zeros(2, 8200, device=cuda_device)
        trms.rmsnorm_fwd_kernel(wide, torch.ones(8200, device=cuda_device), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        trms.rmsnorm_fwd_kernel(torch.zeros(64, 4, device=cuda_device).T, scale, 1e-6)


@pytest.mark.cuda
def test_graphed_steps_match_eager_and_count_replayed_launches(cuda_device):
    """The multi-step dispatch on the card: a CUDA graph of the step
    (flash attention, the RMSNorm kernel) against eager steps from the same
    weights and stack, every loss within 1e-6 relative (the replays run
    the eager step's kernels on the same inputs, none of which sums with
    atomics); the capture's own launches are taken back, and each replay
    adds one step's."""
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    cfg = ModelConfig(vocab_size=1024, d_model=256, n_heads=2, n_layers=2, d_ff=1024,
                      max_seq_len=256, use_flash_attention=True, use_pallas_norm=True)
    gen = torch.Generator().manual_seed(0)
    stack = torch.randint(0, cfg.vocab_size, (6, 2, cfg.max_seq_len), generator=gen)
    stack = stack.to(cuda_device)
    model, optimizer = train.make_train_state(cfg, cuda_device, seed=1)
    eager = torch.stack([train.train_step(model, optimizer, t) for t in stack])
    model, optimizer = train.make_train_state(cfg, cuda_device, seed=1)
    step = train.make_multi_train_step(model, optimizer, 6)
    reset_launches()
    graphed = step(stack)
    torch.cuda.synchronize()
    per_step = {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "flash_bwd_delta": 2,
                "rmsnorm": 5}
    assert isinstance(step, train.GraphedTrainStep) and step.capture_s > 0
    assert step.launches == per_step
    assert LAUNCHES == {name: 6 * n for name, n in per_step.items()}
    rel = ((graphed - eager).abs() / eager.abs()).cpu()
    assert rel.max() <= 1e-6, rel
    again = step(stack)  # replays only
    torch.cuda.synchronize()
    assert LAUNCHES == {name: 12 * n for name, n in per_step.items()}
    assert torch.isfinite(again).all() and float(again.mean()) < float(graphed[0])


@pytest.mark.cuda
def test_graphed_step_refuses_a_stack_on_the_cpu(cuda_device):
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    model, optimizer = train.make_train_state(ModelConfig.tiny(), cuda_device)
    step = train.make_multi_train_step(model, optimizer, 2)
    with pytest.raises(ValueError, match="on the card"):
        step(torch.zeros(2, 1, 16, dtype=torch.long))


@pytest.mark.cuda
def test_attention_scores_are_divided_truly_on_card(cuda_device):
    """The dense attention and the KV decoder divide the scores by the bf16
    sqrt(head_dim), a 0-d tensor on the card: a true division, the f32
    quotient rounded to bf16, bit for bit. (With a Python-float divisor CUDA
    multiplies by the reciprocal instead, one bf16 ulp off on some scores.)"""
    from k8s_device_plugin_tpu_torch.workload.model import _sqrt_in

    gen = torch.Generator().manual_seed(0)
    scores = (40.0 * torch.randn(1 << 20, generator=gen)).to(torch.bfloat16)
    divisor = _sqrt_in(128, torch.bfloat16, cuda_device)
    assert divisor.device.type == "cuda" and float(divisor) == 11.3125
    want = (scores.float() / 11.3125).to(torch.bfloat16)
    assert torch.equal((scores.to(cuda_device) / divisor).cpu(), want)


@pytest.mark.cuda
def test_one_rank_nccl_group_and_mesh_on_card(cuda_device):
    """A process with one card is a world of one over NCCL (no launcher,
    no port), and the six-axis mesh over it is all ones."""
    import torch.distributed as dist

    from k8s_device_plugin_tpu_torch.parallel.distributed import initialize
    from k8s_device_plugin_tpu_torch.parallel.mesh import AXES, axis_sizes, make_mesh

    initialize("cuda")
    mesh = make_mesh(1, device="cuda")
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert axis_sizes(mesh) == {axis: 1 for axis in AXES}
    one = torch.ones(2, device=cuda_device)
    dist.all_reduce(one, group=mesh["model"].get_group())
    assert one.tolist() == [1.0, 1.0]


@pytest.mark.cuda
def test_tp_and_fsdp_over_size_one_axes_leave_the_bench_loss(cuda_device):
    """``apply_tp`` and ``apply_fsdp`` over the size-1 axes split nothing:
    a ``bench()``-width forward's loss (flash kernels on the local heads,
    the tensor-parallel sums and FSDP2's gathers over NCCL) within 1e-5
    of the unsharded model's, with each flash forward launched once a
    layer."""
    import dataclasses

    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model

    cfg = dataclasses.replace(ModelConfig.bench(), n_layers=2)
    mesh = make_mesh(1, device="cuda")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=gen).cuda()
    with torch.no_grad():
        plain = float(train.loss_fn(init_model(cfg, 0, "cuda"), tokens))
        model = init_model(cfg, 0, "cuda")
        train.apply_tp(model, mesh["model"])
        train.apply_fsdp(model, mesh)
        assert train.is_sharded(model) and model.blocks[0].attn.tp_group is not None
        reset_launches()
        sharded = float(train.loss_fn(model, tokens))
    assert LAUNCHES["flash_fwd"] == cfg.n_layers
    assert sharded == pytest.approx(plain, rel=1e-5)


# The bench widths cut to 2 layers, on the bench's global batch of 8.
FOUR_CARD_CFG = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=2, d_ff=8192,
                     max_seq_len=2048, use_flash_attention=True)
_ONE_CARD = {}


@pytest.fixture(scope="module")
def four_cards():
    """Four NCCL ranks, one a card, for the module; skips with fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards on one host")
    from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool

    with RankPool(4, "cuda", timeout_s=600.0) as pool:
        yield pool


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(1, 4, 1, 1, 1, 1), (2, 2, 1, 1, 1, 1), (1, 2, 1, 1, 1, 2), (1, 1, 1, 1, 1, 4)],
    ids=["fsdp", "data-fsdp", "fsdp-model", "model"],
)
def test_sharded_steps_on_four_cards_match_one_card(four_cards, shape):
    """The bench model (2 layers) sharded over four cards on the same
    weights and global batch as one card: the first loss within 1e-4
    relative (the JAX sharded test's bound; bf16 sums in another order),
    every loss finite, and the flash kernels on each rank's local heads."""
    import numpy as np

    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
    from tests import torch_rank_jobs as jobs

    steps = 3
    tokens = np.random.default_rng(1).integers(0, FOUR_CARD_CFG["vocab_size"],
                                               (8, FOUR_CARD_CFG["max_seq_len"]))
    if "losses" not in _ONE_CARD:
        model, optimizer = train.make_train_state(ModelConfig(**FOUR_CARD_CFG), "cuda", seed=0)
        rows = torch.from_numpy(tokens).long().cuda()
        _ONE_CARD["losses"] = [float(train.train_step(model, optimizer, rows))
                               for _ in range(steps)]
        del model, optimizer
        torch.cuda.empty_cache()
    got = four_cards.run(jobs.train_steps, FOUR_CARD_CFG, shape, tokens, steps, None, (),
                         "cuda")
    losses = got[0]["losses"]
    print(f"four cards {shape}: {losses}; one card: {_ONE_CARD['losses']}")
    assert all(r["losses"] == losses for r in got)
    assert all(np.isfinite(losses))
    assert losses[0] == pytest.approx(_ONE_CARD["losses"][0], rel=1e-4)


# The parallel paths at bench widths on four cards: (config, mesh). Ring
# attention over seq 4 (512 positions a rank, flash off as the ring needs);
# the pipeline over pipe 4 (one layer a stage, 4 microbatches, flash on, so
# K1-K3 run in every stage); MoE over expert 4 (one expert a rank), and
# again in f32 (2 layers, flash off, which takes bf16 only): in bf16 the
# expert sum's rounding moves near-tied tokens to another expert, which
# changes their gradients whole, so only f32 holds each gradient value.
def _bench(**changes) -> dict:
    import dataclasses

    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    return dataclasses.asdict(dataclasses.replace(ModelConfig.bench(), **changes))


PARALLEL_FOUR_CARD = {
    "ring-seq4": (dict(use_flash_attention=False, use_ring_attention=True), (1, 1, 1, 1, 4, 1)),
    "pipeline-pipe4": (dict(pipeline_microbatches=4), (1, 1, 1, 4, 1, 1)),
    "moe-expert4": (dict(n_experts=4), (1, 1, 4, 1, 1, 1)),
    "moe-expert4-f32": (dict(n_experts=4, n_layers=2, dtype=torch.float32,
                             use_flash_attention=False), (1, 1, 4, 1, 1, 1)),
}

# Bounds for the backwards written over NCCL, each parameter's gathered
# gradient after one backward against one card's: one minus their cosine
# and the distance of their norms' ratio from 1 (a collective off by the
# group's size reads 0.75 or more), and in f32 the largest gap over the
# largest magnitude; and the losses after the first update. Each is two to
# three times the largest reading on four H100s (PERF.md): MoE in bf16 1 - cos
# 5.6e-3 and norm ratio 0.9923, its third loss 2.3e-3 apart; the f32 gap
# 4.7e-6.
FOUR_CARD_GRAD_COS = 1e-2
FOUR_CARD_GRAD_NORM = 2e-2
FOUR_CARD_F32_GRAD_GAP = 1e-5
FOUR_CARD_LATER_LOSS_REL = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PARALLEL_FOUR_CARD))
def test_parallel_paths_on_four_cards_match_one_card(four_cards, case, tmp_path):
    """Ring, pipeline and MoE at bench widths over four cards against the
    same config on one card (through a size-1 mesh, which the ring and the
    pipeline need), same weights and global batch of 8. The backwards
    written over NCCL (the ring's dK/dV hops, the pipeline's reverse
    send/receive pairs, the expert split's sums): every parameter's
    gathered gradient after one backward against one card's, within the
    FOUR_CARD_GRAD_* bounds. Three steps: the first loss within 1e-4
    relative, the next two within FOUR_CARD_LATER_LOSS_REL, every rank's
    losses equal and finite. Prints each side's losses and step times and
    the worst gradient readings."""
    import numpy as np

    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
    from tests import torch_rank_jobs as jobs

    changes, shape = PARALLEL_FOUR_CARD[case]
    kw = _bench(**changes)
    steps = 3
    tokens = np.random.default_rng(1).integers(0, kw["vocab_size"], (8, kw["max_seq_len"]))
    model, optimizer = train.make_train_state(ModelConfig(**kw), "cuda", seed=0,
                                              mesh=make_mesh(1, device="cuda"))
    rows = torch.from_numpy(tokens).long().cuda()
    train.loss_fn(model, rows).backward()
    reference = str(tmp_path / "one_card_grads.pt")
    names = {n for n, _ in model.named_parameters()}
    torch.save({n: p.grad.detach().cpu() for n, p in model.named_parameters()}, reference)
    one, one_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        one.append(float(train.train_step(model, optimizer, rows)))
        one_s.append(time.monotonic() - t0)
    del model, optimizer, rows
    torch.cuda.empty_cache()
    stats = four_cards.run(jobs.grad_gaps, kw, shape, tokens, reference, "cuda")[0]["stats"]
    worst = {key: max(stats.items(), key=lambda kv: abs(kv[1][key] - ideal))
             for key, ideal in (("gap", 0.0), ("cos", 1.0), ("norm", 1.0))}
    got = four_cards.run(jobs.train_steps, kw, shape, tokens, steps, None, (), "cuda")
    losses = got[0]["losses"]
    print(f"four cards {case} {shape}: losses {losses}, step s {got[0]['step_s']}; "
          f"one card: losses {one}, step s {one_s}; worst gradients {worst}")
    assert set(stats) == names
    assert all(1.0 - g["cos"] < FOUR_CARD_GRAD_COS for g in stats.values()), worst
    assert all(abs(g["norm"] - 1.0) < FOUR_CARD_GRAD_NORM for g in stats.values()), worst
    if kw["dtype"] == torch.float32:
        assert all(g["gap"] < FOUR_CARD_F32_GRAD_GAP for g in stats.values()), worst
    assert all(r["losses"] == losses for r in got)
    assert all(np.isfinite(losses))
    assert losses[0] == pytest.approx(one[0], rel=1e-4)
    assert losses[1:] == pytest.approx(one[1:], rel=FOUR_CARD_LATER_LOSS_REL)


@pytest.mark.cuda
def test_checkpoint_on_four_cards_restores_onto_other_meshes(four_cards, tmp_path):
    """Checkpoint/resume at bench widths (2 layers) over four cards: one
    step on fsdp 2 x model 2, saved, and a second step there (the run that
    never stopped); the save restored onto fsdp 4 and onto one card, into
    models of other weights. Every parameter equals the saved one bit for
    bit (sha256 of each whole tensor), and each restored run's next loss is
    within 1e-4 relative of the run that never stopped (the four-card
    bound above: bf16 sums in another order on another mesh)."""
    import numpy as np

    from tests import torch_rank_jobs as jobs

    tokens = np.random.default_rng(1).integers(0, FOUR_CARD_CFG["vocab_size"],
                                               (8, FOUR_CARD_CFG["max_seq_len"]))
    directory = str(tmp_path / "ckpt")
    t0 = time.monotonic()
    saved = four_cards.run(jobs.checkpoint_save, FOUR_CARD_CFG, (1, 2, 1, 1, 1, 2), tokens,
                           directory, 1, 1, "cuda", True)[0]
    t1 = time.monotonic()
    fsdp4 = four_cards.run(jobs.checkpoint_restore, FOUR_CARD_CFG, (1, 4, 1, 1, 1, 1), tokens,
                           directory, 1, "cuda", True)[0]
    t2 = time.monotonic()
    one = jobs.checkpoint_restore(FOUR_CARD_CFG, (1,) * 6, tokens, directory, 1, "cuda", True)
    t3 = time.monotonic()
    never_stopped = saved["later_losses"][0]
    print(f"four-card checkpoint: losses {saved['losses']} then {never_stopped} (never "
          f"stopped); restored on fsdp 4 {fsdp4['losses']}, on one card {one['losses']}; "
          f"job s: save {t1 - t0:.1f}, restore fsdp 4 {t2 - t1:.1f}, one card {t3 - t2:.1f}")
    assert fsdp4["step"] == one["step"] == 1
    want = saved["whole"]["params"]
    assert len(want) == 3 + 8 * FOUR_CARD_CFG["n_layers"]  # embed, pos, final norm; 8 a block
    assert fsdp4["whole"]["params"] == want
    assert one["whole"]["params"] == want
    assert fsdp4["losses"][0] == pytest.approx(never_stopped, rel=1e-4)
    assert one["losses"][0] == pytest.approx(never_stopped, rel=1e-4)


@pytest.mark.cuda
def test_async_checkpoint_on_card_commits_what_it_saved(cuda_device, tmp_path):
    """``async_save`` on the card (NCCL world of one, so DCP's thread runs
    over the checkpointer's own gloo group): the save goes on while the
    next step moves the live state, ``wait`` commits it, and a restore
    gives the state of the step saved, AdamW's step count on the card."""
    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh
    from k8s_device_plugin_tpu_torch.workload import train
    from k8s_device_plugin_tpu_torch.workload.checkpointing import TrainCheckpointer
    from k8s_device_plugin_tpu_torch.workload.model import ModelConfig

    cfg = ModelConfig.tiny()
    mesh = make_mesh(1, device="cuda")
    model, optimizer = train.make_train_state(cfg, "cuda", 0, mesh=mesh)
    tokens = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len),
                           generator=torch.Generator().manual_seed(1)).cuda()
    train.train_step(model, optimizer, tokens)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with TrainCheckpointer(str(tmp_path / "ckpt"), async_save=True) as ckpt:
        ckpt.save(1, model, optimizer)
        train.train_step(model, optimizer, tokens)
        ckpt.wait()
        assert ckpt.committed_steps() == [1]
        fresh, fresh_opt = train.make_train_state(cfg, "cuda", 1, mesh=mesh)
        assert ckpt.restore_latest(fresh, fresh_opt)[0] == 1
    for name, tensor in fresh.state_dict().items():
        assert torch.equal(tensor, saved[name]), name
    steps = {p: fresh_opt.state[p]["step"] for p in fresh.parameters()}
    assert all(s.is_cuda and float(s) == 1.0 for s in steps.values())


def _smi(*args: str):
    import subprocess

    out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
    return out.returncode, re.sub(r"\x1b\[[0-9;]*m", "", out.stdout)


def _smi_matrix(text: str) -> dict:
    """The GPU x GPU cells of an ``nvidia-smi topo`` matrix, by index."""
    lines = [l.split() for l in text.splitlines() if l.strip()]
    gpus = [h for h in lines[0] if re.fullmatch(r"GPU\d+", h)]
    return {(int(row[0][3:]), j): cell
            for row in lines[1:] if row and row[0] in gpus
            for j, cell in enumerate(row[1:1 + len(gpus)])}


def _nvidia_smi_topology() -> tuple:
    """nvidia-smi's class of every pair of GPUs, by index, and where it
    came from: ``topo -m``'s matrix; where that does not run (a container
    that hides the PCI tree: "Failed to run topology matrix"), ``NV<n>``
    for a pair that ``topo -p2p n`` says talks over NVLink, n the lesser of
    the two cards' links up in ``nvlink -s``, and "unknown" for any other
    pair (the PCIe class is what ``topo -m`` cannot read)."""
    rc, out = _smi("topo", "-m")
    if rc == 0:
        return _smi_matrix(out), "nvidia-smi topo -m"
    rc, out = _smi("topo", "-p2p", "n")
    assert rc == 0, out
    p2p = _smi_matrix(out)
    rc, out = _smi("nvlink", "-s")
    assert rc == 0, out
    links, gpu = {}, None
    for line in out.splitlines():
        m = re.match(r"GPU (\d+):", line)
        if m:
            gpu = int(m.group(1))
            links[gpu] = 0
        elif gpu is not None and re.search(r"Link \d+: [\d.]+ GB/s", line):
            links[gpu] += 1
    table = {(i, j): ("X" if i == j else
                      f"NV{min(links[i], links[j])}" if cell == "OK" else "unknown")
             for (i, j), cell in p2p.items()}
    return table, "nvidia-smi topo -p2p n and nvlink -s (topo -m does not run here)"


@pytest.mark.cuda
def test_link_topology_on_four_cards_matches_nvidia_smi():
    """Every pair's link class from NVML (``LinkTopology``) equals
    nvidia-smi's for it (``NV18`` on an HGX H100: every NVLink goes to an
    NVSwitch, so counting the links whose far end is the peer would give
    0)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards on one host")
    from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
    from k8s_device_plugin_tpu_torch.topology.links import LinkTopology

    truth, source = _nvidia_smi_topology()
    with NvmlInfo() as info:
        chips = info.scan()
        topo = LinkTopology(chips, info)
    ids = {c.index: c.device_id_str for c in chips}
    print("cards:", [c.to_dict() for c in chips])
    print("nvml pair classes:", topo.pair_classes())
    print("nvml pair scores:", {f"{i}-{j}": topo.score_pair(ids[i], ids[j])
                                for i in ids for j in ids if i < j})
    print(f"{source}:", {f"{i}-{j}": c for (i, j), c in truth.items() if i < j})
    assert len(chips) >= 4 and len(set(ids.values())) == len(chips)
    for i in ids:
        for j in ids:
            assert topo.link_class(ids[i], ids[j]) == truth[(i, j)], (i, j)
