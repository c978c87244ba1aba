"""The PyTorch port's sharded training step on gloo ranks on the CPU,
against its own single-process step and the JAX package's sharded step.

The JAX side runs in this process on its 8 simulated devices; the port's
side on 4 (or 2) rank processes of one ``RankPool`` a module, which import
no JAX (``tests/torch_rank_jobs.py``). Every rank draws the same whole
weights and the same global batch, and trains its own rows.

Tolerances: the JAX tests' own. The sharded loss equals the single-process
loss within 1e-4 relative (``test_sharded_matches_single_device``); at
float32, the loss equals the JAX sharded step's within 1e-5 relative and
the parameters within 1e-4 absolute after 1 and 3 steps
(``test_torch_train.py``: Adam's first update turns rounding in a
near-zero gradient into a change of up to lr).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_device_plugin_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool
from k8s_device_plugin_tpu_torch.workload import chips
from k8s_device_plugin_tpu_torch.workload import train as ttrain
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params
from tests import torch_rank_jobs as jobs

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)
TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq_len=16)
# Each job's deadline: a hung rank fails its test, not the suite.
JOB_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


def _jax_names(tree, cfg) -> dict:
    """The port's name of each leaf of a JAX parameter-shaped tree, by the
    leaf's path (through ``from_jax_params``' own mapping)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = ["/".join(k.key for k in path) for path, _ in flat]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), [np.full((1,), i) for i in range(len(flat))])
    return {name: paths[int(t[0])] for name, t in from_jax_params(tagged, cfg).items()}


def _jax_table(kw: dict, shape) -> dict:
    """The JAX ``param_shardings`` PartitionSpec of each parameter on a
    4-device mesh of ``shape``, by the port's name."""
    jspecs = jtrain.param_shardings(jmodel.ModelConfig(**kw),
                                    jax_make_mesh(jax.devices()[:4], shape=shape))
    by_path = {"/".join(k.key for k in path): tuple(s.spec)
               for path, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]}
    return {name: by_path[path] for name, path in _jax_names(jspecs, ModelConfig(**kw)).items()}


def test_param_shardings_match_jax_and_w1_is_split_fsdp_by_model(pool4):
    """The JAX test's config on (1, 2, 1, 1, 1, 2): every parameter's mesh
    axes equal the JAX ``param_shardings`` PartitionSpec, and w1 (embed,
    mlp) -> (fsdp, model) keeps a (d_model/2, d_ff/2) shard a rank."""
    kw = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=1, d_ff=128, max_seq_len=32)
    shape = (1, 2, 1, 1, 1, 2)
    layouts = pool4.run(jobs.layout, kw, shape)
    table = layouts[0]["table"]
    assert table == _jax_table(kw, shape)
    assert table["blocks.0.mlp.w1"] == ("fsdp", "model")
    for lay in layouts:
        w1 = lay["params"]["blocks.0.mlp.w1"]
        assert w1["local_shape"] == (kw["d_model"] // 2, kw["d_ff"] // 2)
        assert w1["fsdp_dim"] == 0 and w1["tp_dim"] == 1
        # FSDP2 shards the JAX embed dim, not its default dim 0.
        assert lay["params"]["blocks.0.mlp.w2"]["fsdp_dim"] == 1
        assert lay["params"]["blocks.0.attn.wo"]["fsdp_dim"] == 2
        assert lay["params"]["embed"]["local_shape"] == (kw["vocab_size"] // 2, kw["d_model"] // 2)


def test_dropped_axis_keeps_attention_whole_and_splits_the_mlp(pool4):
    """``tiny()`` on (1, 1, 1, 1, 1, 4): 2 heads do not split 4 ways, so the
    attention weights stay whole on every rank, as the JAX rule drops the
    axis, while mlp and vocab split 4 ways."""
    shape = (1, 1, 1, 1, 1, 4)
    layouts = pool4.run(jobs.layout, TINY, shape)
    table = layouts[0]["table"]
    assert table == _jax_table(TINY, shape)
    # fsdp (size 1) divides every dim; model divides mlp and vocab only.
    assert table["blocks.0.attn.wq"] == ("fsdp", None, None)
    assert table["blocks.0.mlp.w1"] == ("fsdp", "model")
    assert table["embed"] == ("model", "fsdp")
    for lay in layouts:
        assert lay["params"]["blocks.0.attn.wq"]["local_shape"] == (32, 2, 16)
        assert lay["params"]["blocks.0.mlp.w1"]["local_shape"] == (32, 16)
        assert lay["params"]["embed"]["local_shape"] == (16, 32)


def test_train_step_decreases_loss_sharded(pool4):
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (8, TINY["max_seq_len"]))
    results = pool4.run(jobs.train_steps, TINY, None, tokens, 5)
    losses = results[0]["losses"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert all(r["losses"] == losses for r in results)  # every rank reports the global loss


@pytest.mark.parametrize(
    "shape,extra",
    [
        ((1, 2, 1, 1, 1, 2), {}),
        ((1, 1, 1, 1, 1, 4), {}),
        ((2, 2, 1, 1, 1, 1), {}),
        ((1, 2, 1, 1, 1, 2), dict(use_flash_attention=True, use_pallas_norm=True)),
        ((1, 2, 1, 1, 1, 2), dict(xent_chunk=32)),
    ],
    ids=["fsdp-model", "model", "data-fsdp", "fsdp-model-flash-pallas_norm",
         "fsdp-model-chunked_ce"],
)
def test_sharded_matches_single_process(pool4, shape, extra):
    """Sharding does not change the math: bf16 ``tiny()``, same seed, same
    global batch, the loss within 1e-4 relative of one process's. The
    flash case runs on each rank's one local head, the RMSNorm scale
    sharded over fsdp; the chunked CE reads the gathered embedding."""
    kw = {**TINY, **extra}
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (8, TINY["max_seq_len"]))
    model, optimizer = ttrain.make_train_state(ModelConfig(**kw), "cpu", seed=0)
    single = float(ttrain.train_step(model, optimizer, torch.from_numpy(tokens).long()))
    sharded = pool4.run(jobs.train_steps, kw, shape, tokens, 1)[0]["losses"][0]
    assert sharded == pytest.approx(single, rel=1e-4)


_JAX_REFS = {}


def _jax_reference(name: str, kw: dict):
    """The JAX sharded step on its 8-device mesh, float32, 3 steps from
    seed 0 over 4 rows: its start weights, the losses, and the weights
    after 1 and 3 steps. Run once a config."""
    if name not in _JAX_REFS:
        jcfg = jmodel.ModelConfig(dtype=jnp.float32, **kw)
        mesh = jax_make_mesh()
        params, opt_state, tx = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
        # Copy out before the donating step consumes the buffers.
        start = jax.tree_util.tree_map(np.array, params)
        tokens = np.random.default_rng(11).integers(0, kw["vocab_size"], (4, kw["max_seq_len"]))
        step = jtrain.make_train_step(jcfg, mesh, tx)
        jtokens = jax.device_put(jnp.asarray(tokens, dtype=jnp.int32), batch_sharding(mesh))
        losses, after = [], {}
        for i in (1, 2, 3):
            params, opt_state, loss = step(params, opt_state, jtokens)
            losses.append(float(loss))
            if i in (1, 3):
                after[i] = jax.tree_util.tree_map(np.array, params)
        _JAX_REFS[name] = start, tokens, losses, after
    return _JAX_REFS[name]


@pytest.mark.parametrize(
    "shape", [(1, 2, 1, 1, 1, 2), (2, 2, 1, 1, 1, 1), (1, 1, 1, 1, 1, 4)],
    ids=["fsdp-model", "data-fsdp", "model"],
)
def test_sharded_float32_matches_jax_sharded_step(pool4, shape):
    """On (1, 1, 1, 1, 1, 4) the 2 heads do not split: the attention
    weights stay whole while mlp and vocab split 4 ways."""
    kw = SMALL
    tcfg = ModelConfig(dtype=torch.float32, **kw)
    start, tokens, jlosses, jafter = _jax_reference("small", kw)
    state = {k: v.numpy() for k, v in from_jax_params(start, tcfg).items()}
    got = pool4.run(jobs.train_steps, dict(dtype=torch.float32, **kw), shape, tokens, 3,
                    state, (1, 3))[0]
    for loss_t, loss_j in zip(got["losses"], jlosses):
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
    for i in (1, 3):
        want = from_jax_params(jafter[i], tcfg)
        for name, tensor in want.items():
            np.testing.assert_allclose(got["params"][i][name], tensor.numpy(), atol=1e-4,
                                       rtol=0, err_msg=f"{name} after {i}")


def test_multi_step_on_two_ranks_matches_jax(pool2):
    """The eager multi-step loop over a 2-rank (fsdp) mesh against the JAX
    ``make_multi_train_step`` (lax.scan) on a 2-device mesh of that shape,
    float32, 3 steps a call."""
    shape = (1, 2, 1, 1, 1, 1)
    jcfg = jmodel.ModelConfig(dtype=jnp.float32, **SMALL)
    tcfg = ModelConfig(dtype=torch.float32, **SMALL)
    mesh = jax_make_mesh(jax.devices()[:2], shape=shape)
    params, opt_state, tx = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
    start = jax.tree_util.tree_map(np.array, params)
    stack = np.random.default_rng(11).integers(0, SMALL["vocab_size"], (3, 4, SMALL["max_seq_len"]))
    bsh = batch_sharding(mesh)
    jstack = jax.device_put(jnp.asarray(stack, dtype=jnp.int32),
                            NamedSharding(bsh.mesh, P(None, *bsh.spec)))
    params, opt_state, jlosses = jtrain.make_multi_train_step(jcfg, mesh, tx, 3)(
        params, opt_state, jstack)

    state = {k: v.numpy() for k, v in from_jax_params(start, tcfg).items()}
    got = pool2.run(jobs.multi_step, dict(dtype=torch.float32, **SMALL), shape, stack, state)[0]
    assert got["eager"]
    np.testing.assert_allclose(got["losses"], np.asarray(jlosses), rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
    for name, tensor in want.items():
        np.testing.assert_allclose(got["params"][name], tensor.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_run_smoke_on_cpu_mesh(pool4):
    """The JAX ``test_run_smoke_on_cpu_mesh`` over 4 gloo ranks: the world
    is the device count, the mesh is factorize(4)'s, the global batch is
    batch_per_device x 4, and only rank 0 emits."""
    results = pool4.run(jobs.run_smoke, dict(steps=3, cfg=ModelConfig.tiny(), batch_per_device=1))
    report = results[0]["report"]
    assert report["ok"] and report["loss_decreased"]
    assert report["devices"] == 4 and report["devices_used"] == 4
    assert report["mesh"] == {"data": 1, "fsdp": 1, "expert": 1, "pipe": 1, "seq": 1, "model": 4}
    assert report["tokens_per_s"] > 0 and report["mfu"] is None
    assert report["model_flops_per_step"] == ModelConfig.tiny().train_flops_per_step(4)
    assert "time_to_mesh_s" in report
    assert results[0]["streamed"] == ["devices_up", "first_step"]
    assert all(r["streamed"] == [] for r in results[1:])
    assert all(r["report"]["final_loss"] == report["final_loss"] for r in results)


def test_run_smoke_multi_step_and_ab_on_cpu_mesh(pool4):
    """``inner_steps`` and the chunked-CE A/B under the mesh: the eager
    loop, reported ``graphed: false``."""
    report = pool4.run(jobs.run_smoke, dict(steps=2, cfg=ModelConfig.tiny(), batch_per_device=1,
                                            inner_steps=2, ab_xent_chunk=32))[0]["report"]
    assert report["ok"] and report["graphed"] is False
    assert "vs_plain_step" in report["ab"] and "error" not in report["ab"]


def test_mfu_accounting():
    """``peak_flops_for`` scales by the device count, as the JAX one does,
    and the analytic FLOPs sit between 6 N tokens and 1.3x of it."""
    assert chips.peak_flops_for("NVIDIA H100 80GB HBM3", 1) == 989e12
    assert chips.peak_flops_for("NVIDIA H100 80GB HBM3", 4) == 4 * 989e12
    assert chips.peak_flops_for("NVIDIA H100 PCIe", 2) == 2 * 756e12
    assert chips.peak_flops_for("cpu", 8) is None
    cfg = ModelConfig.bench()
    tokens = 4 * cfg.max_seq_len
    n = cfg.matmul_params()
    assert 6 * n * tokens < cfg.train_flops_per_step(4) < 1.3 * 6 * n * tokens
