"""The plain reference holds the port's training step, at a tiny size on
the CPU: the same weights and batches, step by step."""

import pytest
import torch

from gpubench import families, generator
from k8s_device_plugin_tpu_torch.workload import train

SEED = 5


@pytest.mark.parametrize("xent_chunk", [0, 64])
def test_port_step_follows_the_reference(tiny_cell, xent_chunk):
    cell = tiny_cell(xent_chunk=xent_chunk)
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    dev = torch.device("cpu")
    opt_cfg = cell.traffic["optimizer"]
    pool = generator.batches(cell.traffic, sz.vocab, sz.seq, SEED, dev)
    model = fam.program_model(sz, cell.config, dev)
    fam.load_weights(model, fam.initial_weights(sz, SEED, dev))
    optimizer = train.make_optimizer(model, lr=opt_cfg["lr"])
    w0 = fam.initial_weights(sz, SEED, dev)
    ref = list(fam.reference_steps(sz, fam.initial_weights(sz, SEED, dev), pool[:1], opt_cfg))
    (ref_loss, ref_grads, ref_params), = ref

    loss = train.train_step(model, optimizer, pool[0], xent_chunk)
    # Both sides round the blocks' products to bf16 (2^-8); they differ in
    # the attention's rounding order (flash's unnormalised P against the
    # softmax), a few bf16 ulps of the activations.
    assert abs(loss.item() - ref_loss.item()) < 1e-3
    for name, p in model.named_parameters():
        g, rg = p.grad, ref_grads[name]
        assert (g - rg).norm() <= 0.05 * rg.norm(), name
        # AdamW's first update is lr * g / (|g| + eps) plus the decay: where
        # the reference gradient is well clear of the rounding, the port
        # moves each element as the reference does, to f32 rounding.
        clear = rg.abs() > 0.05 * rg.abs().max()
        moved, ref_moved = (p.detach() - w0[name])[clear], (ref_params[name].detach() - w0[name])[clear]
        torch.testing.assert_close(moved, ref_moved, rtol=1e-4, atol=1e-7, msg=name)


def test_reference_steps_refuse_an_unknown_precision(tiny_cell):
    cell = tiny_cell()
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    with pytest.raises(ValueError, match="precision"):
        next(fam.reference_steps(sz, {}, [], cell.traffic["optimizer"], "fp4"))


def test_head_tf32_reference_runs_its_head_apart(tiny_cell):
    """The head-only control's own products, forward and backward, run; on
    the CPU, where TF32 changes nothing, they give the stated reference."""
    cell = tiny_cell()
    fam = families.load(cell.config)
    sz = fam.sizes(cell.config)
    dev = torch.device("cpu")
    pool = generator.batches(cell.traffic, sz.vocab, sz.seq, SEED, dev)
    opt = cell.traffic["optimizer"]
    runs = [list(fam.reference_steps(sz, fam.initial_weights(sz, SEED, dev), pool[:2], opt, p))
            for p in ("stated", "head_tf32")]
    for (loss, grads, params), (loss2, grads2, params2) in zip(*runs):
        assert loss.item() == loss2.item()
        for name in grads:
            torch.testing.assert_close(grads2[name], grads[name], rtol=1e-6, atol=1e-9)
