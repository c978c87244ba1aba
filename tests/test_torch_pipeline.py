"""The PyTorch port's GPipe pipeline (``parallel/pipeline.py``) and its
pipelined model on gloo ranks on the CPU: the JAX
``tests/test_pipeline.py`` cases, mirrored, and the pipelined train step
against the JAX 8-device step.

The JAX side runs in this process on its 8 simulated devices; the port's
side on the 8 rank processes of one ``RankPool`` (which import no JAX), on
the JAX tests' meshes.

Tolerances: the JAX tests' own (the toy pipeline within 1e-5, its
gradients within 1e-4; the pipelined model within 5e-2 of the unpipelined
one in bf16). In float32 the pipelined and unpipelined forwards run the
same arithmetic on each microbatch's rows: their loss within 1e-6
relative, their gradients within 1e-5. Against the JAX sharded step, its
1e-5 relative on the loss and 1e-4 absolute on the parameters
(``test_torch_sharded.py``).
"""

import math

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool
from k8s_device_plugin_tpu_torch.parallel.pipeline import stack_stages
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params
from tests import torch_rank_jobs as jobs
from tests.torch_jax_reference import jax_train_steps

TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq_len=16)
PIPE4 = (1, 2, 1, 4, 1, 1)  # the toy's mesh: fsdp 2, pipe 4
MODEL_MESH = (1, 2, 1, 2, 1, 2)  # the model tests' mesh: fsdp 2, pipe 2, model 2
JOB_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def pool8():
    with RankPool(8, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


def _toy(n_layers=8, d=16):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((n_layers, d, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, d)).astype(np.float32)
    return ws, x


def _sequential(ws, x):
    """The toy's layers one after another, with the gradients of
    sum(y ** 2) by layer."""
    w = torch.from_numpy(ws).requires_grad_()
    h = torch.from_numpy(x)
    for i in range(len(ws)):
        h = torch.tanh(h @ w[i])
    (h ** 2).sum().backward()
    return h.detach().numpy(), w.grad.numpy()


def test_pipeline_matches_sequential(pool8):
    ws, x = _toy()
    y, _ = _sequential(ws, x)
    results = pool8.run(jobs.pipeline_toy, PIPE4, ws, x, 4)
    for r in results:  # every rank of every pipe group holds the output
        np.testing.assert_allclose(r["y"], y, atol=1e-5)


def test_pipeline_grad_matches_sequential(pool8):
    ws, x = _toy()
    _, want = _sequential(ws, x)
    got = {}
    for r in pool8.run(jobs.pipeline_toy, PIPE4, ws, x, 4):
        got.update(r["grads"])
    assert sorted(got) == list(range(len(ws)))
    for i, g in got.items():
        np.testing.assert_allclose(g, want[i], atol=1e-4)


def test_single_stage_mesh_falls_through(pool8):
    ws, x = _toy()
    y, want = _sequential(ws, x)
    r = pool8.run(jobs.pipeline_toy, (1, 4, 1, 1, 1, 2), ws, x, 4)[0]
    np.testing.assert_allclose(r["y"], y, atol=1e-5)
    np.testing.assert_allclose(np.stack([r["grads"][i] for i in range(len(ws))]), want,
                               atol=1e-4)


def test_stack_stages_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        stack_stages(range(3), 2)
    assert stack_stages(range(4), 2) == [[0, 1], [2, 3]]


def test_pipeline_rejects_bad_microbatching(pool8):
    _, x = _toy()
    assert all("microbatch" in e for e in pool8.run(jobs.pipeline_refusal, PIPE4, x, 3))


def _model_kw(**extra):
    return dict(TINY, n_layers=4, **extra)


def _pipelined_pair(pool, dtype):
    """(pipelined, unpipelined) loss and gradients of ``tiny()`` at 4
    layers on the same weights and tokens, on the model tests' mesh."""
    kw = _model_kw(dtype=dtype)
    state = {k: v.numpy() for k, v in init_model(ModelConfig(**kw), 0, "cpu").state_dict().items()}
    tokens = np.random.default_rng(1).integers(0, kw["vocab_size"], (8, kw["max_seq_len"]))
    pp = pool.run(jobs.loss_and_grads, dict(kw, pipeline_microbatches=4), MODEL_MESH, state,
                  tokens)[0]
    plain = pool.run(jobs.loss_and_grads, kw, MODEL_MESH, state, tokens)[0]
    return pp, plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_model_pipelined_forward_matches_unpipelined(pool8, dtype):
    kw = _model_kw(dtype=dtype)
    state = {k: v.numpy() for k, v in init_model(ModelConfig(**kw), 0, "cpu").state_dict().items()}
    tokens = np.random.default_rng(1).integers(0, kw["vocab_size"], (8, kw["max_seq_len"]))
    pp = pool8.run(jobs.model_logits, dict(kw, pipeline_microbatches=4), MODEL_MESH, state,
                   tokens)
    plain = pool8.run(jobs.model_logits, kw, MODEL_MESH, state, tokens)
    tol = 1e-6 if dtype == torch.float32 else 5e-2
    for a, b in zip(pp, plain):
        np.testing.assert_allclose(a["logits"], b["logits"], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_model_pipelined_grads_match_unpipelined(pool8, dtype):
    pp, plain = _pipelined_pair(pool8, dtype)
    if dtype == torch.float32:
        assert pp["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    diffs = [np.abs(pp["grads"][n] - plain["grads"][n]).max() for n in plain["grads"]]
    assert sorted(pp["grads"]) == sorted(plain["grads"])
    assert max(diffs) < (1e-5 if dtype == torch.float32 else 5e-2)


def test_pipelined_train_step_converges(pool8):
    kw = _model_kw(pipeline_microbatches=4)
    layout = pool8.run(jobs.layout, kw, MODEL_MESH)
    # Each rank holds its stage's two blocks, the other two stay empty.
    for r, lay in enumerate(layout):
        stage = (r // 2) % 2  # the pipe coordinate of rank r on (1, 2, 1, 2, 1, 2)
        held = {int(n.split(".")[1]) for n in lay["params"] if n.startswith("blocks.")}
        assert held == {2 * stage, 2 * stage + 1}
    tokens = np.random.default_rng(1).integers(0, kw["vocab_size"], (8, kw["max_seq_len"]))
    losses = pool8.run(jobs.train_steps, kw, MODEL_MESH, tokens, 4)[0]["losses"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def test_pipelined_model_takes_the_eager_multi_step(pool8):
    """A model sharded over pipe counts as sharded: the multi-step dispatch
    takes the eager loop, and its steps train."""
    kw = _model_kw(pipeline_microbatches=4)
    stack = np.random.default_rng(2).integers(0, kw["vocab_size"], (3, 8, kw["max_seq_len"]))
    got = pool8.run(jobs.multi_step, kw, MODEL_MESH, stack, None)[0]
    assert got["eager"] and all(math.isfinite(x) for x in got["losses"])


def test_config_validation():
    """The JAX config's checks: the pipeline refuses MoE and ring attention;
    a pipelined model builds, and raises only when run without a mesh (the
    port's layers are never stacked, so no ``scan_layers`` is asked for)."""
    with pytest.raises(ValueError, match="MoE"):
        ModelConfig(**_model_kw(pipeline_microbatches=2, n_experts=2))
    with pytest.raises(ValueError, match="ring attention"):
        ModelConfig(**_model_kw(pipeline_microbatches=2, use_ring_attention=True))
    model = init_model(ModelConfig(**_model_kw(pipeline_microbatches=2)), 0, "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        model(torch.zeros(2, TINY["max_seq_len"], dtype=torch.long))


def test_pipeline_float32_matches_jax_sharded_step(pool8):
    """data 2 x pipe 2 x model 2, float32, 2 layers over 2 stages and 2
    microbatches (dryrun plan C's config), against the JAX step on the
    same mesh: the loss after 1, 2 and 3 steps within 1e-5 relative and
    every parameter within 1e-4 after 1 and 3."""
    kw = dict(TINY, n_layers=2, pipeline_microbatches=2)
    shape = (2, 1, 1, 2, 1, 2)
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
