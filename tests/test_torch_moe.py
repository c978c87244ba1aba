"""The PyTorch port's MoE MLP (``workload/moe.py``) and its expert-parallel
model, against the JAX package's: the JAX ``tests/test_moe.py`` cases,
mirrored, the module against the JAX ``MoeMlp`` on the same numpy inputs,
and the expert-parallel train step against the JAX 8-device step.

The JAX side runs in this process on its 8 simulated devices; the port's
sharded side on the 8 rank processes of one ``RankPool`` (which import no
JAX), on the JAX test's mesh (fsdp 2, expert 2, model 2).

Tolerances: the JAX tests' own (the dense mixture within 1e-5 at float32,
aux within [1, e]); the module against the JAX one, 1e-5 at float32 and,
at bf16, 2^-6 of the largest output, the bound of the model tests' bf16
attention (XLA rounds GELU's bf16 steps one by one, torch once); the
router runs in f32 in both, so aux within 1e-6; the JAX sharded step's 1e-5
relative on the loss and 1e-4 absolute on the parameters
(``test_torch_sharded.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.workload.moe import MoeMlp as JaxMoeMlp
from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool
from k8s_device_plugin_tpu_torch.workload import train
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, forward_with_aux, init_model
from k8s_device_plugin_tpu_torch.workload.moe import MoeMlp
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params
from tests import torch_rank_jobs as jobs
from tests.torch_jax_reference import jax_mesh, jax_train_steps

TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq_len=16)
MOE = dict(TINY, n_experts=4)
EP_MESH = (1, 2, 2, 1, 1, 2)  # fsdp 2, expert 2, model 2
JOB_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def pool8():
    with RankPool(8, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _layer(d, seed=1, **kw):
    """A port MoE layer with weights from ``seed`` (f32 unless given)."""
    kw.setdefault("dtype", torch.float32)
    gen = torch.Generator().manual_seed(seed)
    return MoeMlp(d, kw.pop("n_experts"), kw.pop("d_ff"), generator=gen, **kw)


def test_moe_forward_shape_and_finite():
    layer = _layer(8, n_experts=4, d_ff=32)
    y, aux = layer(torch.from_numpy(_x((2, 16, 8))))
    assert y.shape == (2, 16, 8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))


def test_moe_full_capacity_topk_equals_dense_mixture():
    """With top_k == n_experts and ample capacity nothing is dropped, so the
    output equals the explicit prob-weighted sum of every expert FFN."""
    e, d, ff = 4, 8, 16
    layer = _layer(d, n_experts=e, d_ff=ff, top_k=e, capacity_factor=float(e))
    x = torch.from_numpy(_x((2, 6, d)))
    with torch.no_grad():
        y, _ = layer(x)
        probs = torch.softmax(x @ layer.wg, dim=-1)
        h = torch.nn.functional.gelu(torch.einsum("bsd,edf->bsef", x, layer.w1),
                                     approximate="tanh")
        expected = torch.einsum("bse,bsed->bsd", probs, torch.einsum("bsef,efd->bsed", h, layer.w2))
    np.testing.assert_allclose(y.numpy(), expected.numpy(), atol=1e-5)


def test_moe_capacity_drops_are_bounded():
    """A capacity of ~0 clamps to 1 slot an expert: at most 4 tokens of a
    row are served, the rest get zero output (they ride the residual)."""
    layer = _layer(8, n_experts=4, d_ff=16, capacity_factor=1e-9)
    with torch.no_grad():
        y, _ = layer(torch.from_numpy(_x((2, 8, 8))))
    assert y.shape == (2, 8, 8) and bool(torch.isfinite(y).all())
    served = (y.abs().sum(-1) > 0).sum(-1)
    assert int(served.max()) <= 4


def test_moe_aux_loss_bounded():
    """Perfectly balanced routing gives 1.0; any routing lies in [1, e]."""
    with torch.no_grad():
        _, aux = _layer(8, n_experts=4, d_ff=16)(torch.from_numpy(_x((2, 16, 8))))
    assert 1.0 - 1e-4 <= float(aux) <= 4.0 + 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_jax_module(dtype):
    """The port's layer against the JAX ``MoeMlp`` on the same weights and
    inputs: y and the sown aux term."""
    x = _x((2, 16, 8))
    jlayer = JaxMoeMlp(n_experts=4, d_ff=32, dtype=getattr(jnp, dtype))
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want, mods = jlayer.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    (jaux,) = jax.tree_util.tree_leaves(mods["intermediates"])
    want = np.asarray(want, np.float32)
    layer = _layer(8, n_experts=4, d_ff=32, dtype=getattr(torch, dtype))
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(want).max()
    assert np.abs(y.float().numpy() - want).max() <= tol
    assert float(aux) == pytest.approx(float(np.asarray(jaux).reshape(())), rel=1e-6)


def test_moe_train_step_expert_parallel(pool8):
    """The sharded step with the expert axis 2: each rank holds 2 of the 4
    experts' w1 and w2 (and half the mlp columns, half the embed dim under
    FSDP2), and the loss falls over 4 steps."""
    layout = pool8.run(jobs.layout, MOE, EP_MESH)[0]
    assert layout["table"]["blocks.0.moe.w1"] == ("expert", "fsdp", "model")
    assert layout["params"]["blocks.0.moe.w1"]["local_shape"] == (2, 16, 32)
    tokens = np.random.default_rng(1).integers(0, MOE["vocab_size"], (8, MOE["max_seq_len"]))
    losses = pool8.run(jobs.train_steps, MOE, EP_MESH, tokens, 4)[0]["losses"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def test_param_shardings_match_jax_with_moe(pool8):
    """Every parameter's mesh axes on the expert mesh, the MoE weights'
    included, equal the JAX ``param_shardings`` PartitionSpecs."""
    from k8s_device_plugin_tpu.workload import model as jmodel
    from k8s_device_plugin_tpu.workload import train as jtrain

    jspecs = jtrain.param_shardings(jmodel.ModelConfig(**MOE), jax_mesh(EP_MESH))
    by_path = {"/".join(k.key for k in path): tuple(s.spec)
               for path, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]}
    table = pool8.run(jobs.layout, MOE, EP_MESH)[0]["table"]
    assert table["blocks.0.moe.wg"] == by_path["Block_0/MoeMlp_0/wg"] == ("fsdp", None)
    assert table["blocks.0.moe.w1"] == by_path["Block_0/MoeMlp_0/w1"]
    assert table["blocks.0.moe.w2"] == by_path["Block_0/MoeMlp_0/w2"]
    assert table["blocks.0.attn.wq"] == by_path["Block_0/Attention_0/wq"]


def test_moe_per_layer_aux_terms_sum():
    """Two MoE layers: the aux the model returns is the sum of the layers'
    terms, each in [1, e]; the loss adds it at ``moe_aux_weight``, and the
    router's gradient is non-zero (the JAX stacked-aux case; the port's
    layers are never stacked)."""
    model = init_model(ModelConfig(**dict(MOE, n_layers=2)), 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 16))).long()
    terms = []
    x = model.tied_embedding()[tokens] + model.pos[None]
    x = x.to(model.cfg.dtype)
    with torch.no_grad():
        for block in model.blocks:
            x, a = block(x)
            terms.append(float(a))
    _, aux = forward_with_aux(model, tokens)
    assert aux.item() == pytest.approx(sum(terms), rel=1e-6)
    assert all(1.0 - 1e-3 <= t <= 4.0 + 1e-3 for t in terms)
    loss = train.loss_fn(model, tokens)
    assert math.isfinite(loss.item())
    loss.backward()
    assert model.blocks[0].moe.wg.grad.abs().max() > 0


def test_moe_flops_accounting_matches_jax():
    """N counts every expert's weights; the step's FLOPs count top_k
    experts a token and the router, as the JAX config does."""
    from k8s_device_plugin_tpu.workload import model as jmodel

    for kw in (MOE, dict(MOE, n_layers=4, moe_top_k=1)):
        tcfg, jcfg = ModelConfig(**kw), jmodel.ModelConfig(**kw)
        assert tcfg.matmul_params() == jcfg.matmul_params()
        assert tcfg.train_flops_per_step(8) == jcfg.train_flops_per_step(8)


def test_moe_grads_reach_all_expert_weights():
    model = init_model(ModelConfig(**MOE), 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 16))).long()
    train.loss_fn(model, tokens).backward()
    moe = model.blocks[0].moe
    for name in ("wg", "w1", "w2"):
        g = getattr(moe, name).grad
        assert bool(torch.isfinite(g).all()) and g.abs().max() > 0, name
    for w in (moe.w1, moe.w2):
        assert all(w.grad[i].abs().max() > 0 for i in range(4))  # every expert


def test_moe_float32_matches_jax_sharded_step(pool8):
    """fsdp 2 x expert 2 x model 2, float32, against the JAX step on the
    same mesh: the loss after 1, 2 and 3 steps within 1e-5 relative and
    every parameter within 1e-4 after 1 and 3. The aux loss's fractions
    are means over the global batch: averaging them over the fsdp ranks
    before their product, with a summing backward, is what this holds."""
    tokens = np.random.default_rng(11).integers(0, MOE["vocab_size"], (4, MOE["max_seq_len"]))
    start, jlosses, jafter = jax_train_steps(MOE, EP_MESH, tokens)
    tcfg = ModelConfig(dtype=torch.float32, **MOE)
    state = {k: v.numpy() for k, v in from_jax_params(start, tcfg).items()}
    got = pool8.run(jobs.train_steps, dict(MOE, dtype=torch.float32), EP_MESH, tokens, 3,
                    state, (1, 3))[0]
    for loss_t, loss_j in zip(got["losses"], jlosses):
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
    for i in (1, 3):
        for name, tensor in from_jax_params(jafter[i], tcfg).items():
            np.testing.assert_allclose(got["params"][i][name], tensor.numpy(), atol=1e-4,
                                       rtol=0, err_msg=f"{name} after {i}")
