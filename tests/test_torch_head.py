"""The LM head's 3xTF32 products (``ops/head.py``) on the CPU: the plain
versions, which do the kernel's arithmetic, against the f32 einsum and an
f64 product; ``HeadProduct``'s values and gradients against autograd of
the einsum; ``model.unembed``'s routing; the wrappers' refusals. The
kernel itself runs in ``tests/test_torch_kernels.py`` on the card.

Tolerances. The split carries 22 of a value's 24 significand bits (error
at most 2^-22 of it) and the dropped lo . lo term is below 2^-22 of each
product, so against f64 the three-pass product is held to at most twice
the f32 product's own RMS error (its sums in f32 are three products'
plus two adds), and to within 1e-5 of the f32 einsum, relative to the
result's RMS; at a depth of a few values, where the f32 sum is nearly
exact, the split's own 2^-22 is allowed beside it.
"""

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from k8s_device_plugin_tpu_torch.ops import LAUNCHES, head, reset_launches
from k8s_device_plugin_tpu_torch.workload import model as tmodel

LAYOUTS = ("nt", "nn", "tn")
PLAIN = {"nt": head.head_matmul_nt_plain, "nn": head.head_matmul_nn_plain,
         "tn": head.head_matmul_tn_plain}
WRAPPER = {"nt": head.head_matmul_nt, "nn": head.head_matmul_nn, "tn": head.head_matmul_tn}


def _operands(layout, m, n, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"nt": ((m, k), (n, k)), "nn": ((m, k), (k, n)), "tn": ((k, m), (k, n))}[layout]
    return tuple(torch.randn(s, generator=g) for s in shapes)


def _product(layout, a, b):
    return {"nt": lambda: a @ b.T, "nn": lambda: a @ b, "tn": lambda: a.T @ b}[layout]()


def _rms_err(got, want):
    return float((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mnk", [(37, 53, 1601), (128, 96, 2048), (5, 7, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_three_pass_is_as_accurate_as_f32(layout, mnk):
    a, b = _operands(layout, *mnk)
    want = _product(layout, a.double(), b.double())
    got = PLAIN[layout](a, b)
    f32 = _product(layout, a, b)
    assert got.dtype == torch.float32 and got.shape == f32.shape
    # At a short depth the f32 sum is nearly exact and the split's own
    # 2^-22 shows; at the head's depths the f32 accumulation dominates.
    assert _rms_err(got, want) <= 2 * _rms_err(f32, want) + 2.0 ** -22
    assert _rms_err(got, f32.double()) <= 1e-5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cpu_wrappers_are_the_plain_versions(layout):
    a, b = _operands(layout, 9, 11, 40, seed=1)
    reset_launches()
    assert torch.equal(WRAPPER[layout](a, b), PLAIN[layout](a, b))
    assert LAUNCHES["head_gemm"] == 0


def test_single_tf32_pass_misses_what_three_passes_keep():
    """One pass of TF32 (hi . hi alone) is far from the f32 product: the
    two small terms carry the accuracy."""
    a, b = _operands("nt", 64, 64, 2048, seed=2)
    want = a.double() @ b.double().T
    a_hi, _ = head.split_tf32(a)
    b_hi, _ = head.split_tf32(b)
    one_pass = _rms_err(a_hi @ b_hi.T, want)
    assert one_pass > 100 * _rms_err(head.head_matmul_nt_plain(a, b), want)


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 0.0,
                      2 - ulp / 4, 3.0e-39])
    got = head.tf32_rna(x).tolist()
    assert got[:7] == [1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 0.0, 2.0]
    assert (head.tf32_rna(x).view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_carries_22_bits():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3)) * 1e3
    hi, lo = head.split_tf32(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert (resid <= 2.0 ** -22 * x.double().abs()).all()
    assert (lo.abs() <= 2.0 ** -11 * x.abs()).all()


def test_head_product_matches_einsum_values_and_gradients():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 24, 64, generator=g)
    embed = torch.randn(96, 64, generator=g) * 0.02
    w = torch.randn(2, 24, 96, generator=g)
    xa, ea = x.clone().requires_grad_(), embed.clone().requires_grad_()
    xb, eb = x.clone().requires_grad_(), embed.clone().requires_grad_()
    ours = head.head_logits(xa, ea)
    ref = torch.einsum("bsd,vd->bsv", xb, eb)
    (ours * w).sum().backward()
    (ref * w).sum().backward()
    assert ours.shape == ref.shape
    for got, want in ((ours, ref), (xa.grad, xb.grad), (ea.grad, eb.grad)):
        assert _rms_err(got.detach(), want.detach().double()) <= 1e-5


def test_head_product_skips_the_gradients_not_asked_for(monkeypatch):
    calls = []
    monkeypatch.setattr(head, "head_matmul_nn", lambda *a: calls.append("nn"))
    x = torch.randn(8, 16)
    embed = torch.randn(32, 16, requires_grad=True)
    head.HeadProduct.apply(x, embed).sum().backward()
    assert calls == [] and embed.grad.shape == embed.shape


@pytest.mark.parametrize("rows,routed", [
    (16384, True),  # smoke-bench.train
    (8192, True),  # gpt2-xl.train
    (2048, True),  # a bench prompt's prefill forward
    (768, True),  # the least rows timed faster on the kernel at both cells' widths
    (767, False),
    (512, False),  # slower on the kernel at gpt2-xl's widths
    (8, False),  # decoding: one token a sequence
])
def test_takes_from_min_rows(monkeypatch, rows, routed):
    monkeypatch.setattr(head, "_on_one_card", lambda x, embed: True)
    assert head.takes(torch.zeros(rows, 64), torch.zeros(16, 64)) is routed


def _card_mocked(monkeypatch):
    """``takes`` as on a card for CPU tensors, and the kernel path
    replaced by a recorder returning the einsum's logits."""
    calls = []
    monkeypatch.setattr(head, "_on_one_card", lambda x, embed: True)

    def fake(x, embed):
        calls.append(tuple(x.shape))
        return torch.einsum("bsd,vd->bsv", x, embed)

    monkeypatch.setattr(head, "head_logits", fake)
    return calls


@pytest.mark.parametrize("batch,seq,routed", [(3, 256, True), (1, 767, False), (8, 1, False)])
def test_unembed_asks_for_the_kernel_from_min_rows(monkeypatch, batch, seq, routed):
    calls = _card_mocked(monkeypatch)
    x = torch.zeros(batch, seq, 2048, dtype=torch.bfloat16)
    embed = torch.zeros(16, 2048)
    out = tmodel.unembed(x, embed)
    assert out.shape == (batch, seq, 16) and out.dtype == torch.float32
    assert calls == ([(batch, seq, 2048)] if routed else [])


def test_unembed_on_the_cpu_is_the_einsum():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 1152, 2048, generator=g).to(torch.bfloat16)
    embed = torch.randn(16, 2048, generator=g)
    reset_launches()
    out = tmodel.unembed(x, embed)
    assert not head.takes(x.float(), embed)
    assert torch.equal(out, torch.einsum("bsd,vd->bsv", x.float(), embed))
    assert LAUNCHES["head_gemm"] == 0


def test_unembed_keeps_the_einsum_for_dtensors(monkeypatch):
    """A DTensor embedding (here replicated over a world of one) keeps the
    einsum even where a plain tensor of its rows would take the kernel."""
    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh

    calls = _card_mocked(monkeypatch)
    was_up = dist.is_initialized()
    try:
        mesh = make_mesh(1, device="cpu")["model"]
        x = torch.zeros(1, 1152, 2048)
        embed = distribute_tensor(torch.zeros(16, 2048), mesh, [Replicate()])
        assert head.takes(x, embed.to_local())
        assert not head.takes(x, embed)
        assert not head.takes(distribute_tensor(x, mesh, [Replicate()]), embed)
        out = tmodel.unembed(distribute_tensor(x, mesh, [Replicate()]), embed)
        assert isinstance(out, DTensor) and out.shape == (1, 1152, 16)
        assert calls == []
    finally:
        if not was_up:
            dist.destroy_process_group()


def test_takes_wants_aligned_float32_on_one_device(monkeypatch):
    x = torch.zeros(16384, 2048)
    embed = torch.zeros(16, 2048)
    assert not head.takes(x, embed)  # the CPU
    monkeypatch.setattr(head, "_on_one_card", lambda x, embed: True)
    assert head.takes(x, embed)
    assert not head.takes(x.double(), embed)
    assert not head.takes(x, embed.to(torch.bfloat16))
    # d not a multiple of 4: rows TMA cannot describe
    assert not head.takes(torch.zeros(16384, 2047), torch.zeros(16, 2047))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wrappers_refuse_what_the_kernel_does_not_take(monkeypatch, layout):
    """On a CUDA tensor a wrapper launches or raises; here the device test
    is made to say CUDA, so each refusal is reached before any launch."""
    monkeypatch.setattr(head, "uses_kernel", lambda t: True)
    a, b = _operands(layout, 8, 8, 8)
    fn = WRAPPER[layout]
    with pytest.raises(ValueError, match="CUDA"):
        fn(a, b)
    monkeypatch.setattr(head, "_check_device", lambda t, first: None)
    with pytest.raises(TypeError, match="float32"):
        fn(a.double(), b)
    with pytest.raises(TypeError, match="float32"):
        fn(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fn(a.T, b)
    with pytest.raises(ValueError, match="2-D"):
        fn(a[None], b)
    with pytest.raises(ValueError, match="depths differ"):
        fn(a, torch.zeros(3, 5))
    ragged = {"nt": (torch.zeros(8, 7), torch.zeros(8, 7)), "nn": (a, torch.zeros(8, 7)),
              "tn": (a, torch.zeros(8, 7))}[layout]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fn(*ragged)
