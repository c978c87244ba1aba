"""The PyTorch port's dryrun twin (``k8s_device_plugin_tpu_torch/dryrun.py``)
against the JAX package's ``__graft_entry__.py``.

The JAX side runs in this process on its 8 simulated devices; the port's
plans on the 8 gloo rank processes of ``RankPool``s (which import no JAX).

Tolerances: each plan's first loss at float32 within 1e-4 relative of the
JAX plan's on the same weights and tokens (the JAX sharded tests' bound);
``entry()``'s bf16 loss within 1e-2 of the JAX one's (the model tests'
bf16 loss bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from k8s_device_plugin_tpu.parallel.mesh import batch_sharding
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch import dryrun
from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool
from k8s_device_plugin_tpu_torch.workload import train
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig, init_model
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params
from tests import torch_rank_jobs as jobs
from tests.torch_jax_reference import jax_mesh

JOB_TIMEOUT_S = 120.0
N = 8


@pytest.fixture(scope="module")
def pool8():
    with RankPool(N, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_plans_are_the_jax_plans(n):
    assert dryrun._mesh_plans(n) == graft._mesh_plans(n)


def _jax_plan_config(opts: dict, mesh, dtype):
    """The JAX dryrun's config of a plan (``__graft_entry__.py:168-190``)."""
    cfg = jmodel.ModelConfig.tiny()
    if opts.get("ring"):
        cfg = dataclasses.replace(cfg, use_ring_attention=True, ring_mesh=mesh)
    if opts.get("qchunk"):
        cfg = dataclasses.replace(cfg, ring_q_chunk=cfg.max_seq_len // 4)
    if opts.get("xent"):
        cfg = dataclasses.replace(cfg, xent_chunk=cfg.vocab_size // 2)
    if opts.get("flash"):
        cfg = dataclasses.replace(cfg, use_flash_attention=True)
    if opts.get("moe"):
        cfg = dataclasses.replace(cfg, n_experts=4)
    if opts.get("pipeline"):
        cfg = dataclasses.replace(cfg, n_layers=2, scan_layers=True, pipeline_microbatches=2,
                                  pipe_mesh=mesh)
    return dataclasses.replace(cfg, dtype=dtype)


@pytest.mark.parametrize("plan", graft._mesh_plans(N), ids=[p[0] for p in graft._mesh_plans(N)])
def test_plan_first_loss_matches_jax_at_float32(pool8, plan):
    """Each plan's first step at float32, on the JAX dryrun's weights
    (seed 0) and tokens (seed 1, batch max(2n, 4)), within 1e-4 relative
    of the JAX plan's loss: the port's config of the plan
    (``dryrun.plan_config``, the JAX one's values) sharded on the plan's
    mesh, as ``dryrun.plan_step`` shards it."""
    _, shape, opts = plan
    mesh = jax_mesh(shape)
    jcfg = _jax_plan_config(opts, mesh, jnp.float32)
    tcfg = dataclasses.replace(dryrun.plan_config(opts), dtype=torch.float32)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name) or field.name == "dtype"
    params, opt_state, tx = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
    state = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.array, params), tcfg).items()}
    batch = max(2 * N, 4)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (batch, jcfg.max_seq_len), 0,
                                           jcfg.vocab_size))
    step = jtrain.make_train_step(jcfg, mesh, tx)
    _, _, jloss = step(params, opt_state, jax.device_put(jnp.asarray(tokens),
                                                         batch_sharding(mesh)))
    kw = dataclasses.asdict(tcfg)
    loss = pool8.run(jobs.train_steps, kw, shape, tokens, 1, state)[0]["losses"][0]
    assert loss == pytest.approx(float(jloss), rel=1e-4)


def test_dryrun_prints_every_jax_plan(capsys):
    """``dryrun_multichip(8)`` on the CPU: an OK line for every plan of the
    JAX ``_mesh_plans(8)``, then, in the JAX order, for the decode leg, the
    checkpoint-reshard leg (fsdp 4 x model 2 -> fsdp 8, finite loss) and
    the multi-process smoke."""
    losses = dryrun.dryrun_multichip(N, "cpu")
    ok = [line for line in capsys.readouterr().out.splitlines() if line.endswith(" OK")]
    for name, _, _ in graft._mesh_plans(N):
        assert any(f"dryrun_multichip({N}) {name}: " in line for line in ok), (name, ok)
    legs = ok[len(graft._mesh_plans(N)):]
    mesh_a = "{'data': 1, 'fsdp': 4, 'expert': 1, 'pipe': 1, 'seq': 1, 'model': 2}"
    mesh_b = "{'data': 1, 'fsdp': 8, 'expert': 1, 'pipe': 1, 'seq': 1, 'model': 1}"
    assert legs[0] == f"dryrun_multichip({N}) decode: mesh={mesh_a} generated=4 tokens OK"
    assert legs[1].startswith(f"dryrun_multichip({N}) checkpoint-reshard: {mesh_a} -> {mesh_b} ")
    assert " multiprocess: " in legs[2]
    assert len(ok) == len(graft._mesh_plans(N)) + 3
    assert len(losses) == len(graft._mesh_plans(N)) + 2
    assert np.isfinite(losses["checkpoint-reshard"])


def test_decode_leg_matches_jax_greedy_at_float32(pool8):
    """The decode leg's greedy decode on fsdp 4 x model 2 (every rank its
    rows) at float32 on the JAX dryrun's weights (seed 0), against the JAX
    ``greedy_generate`` of the same prompt on the same mesh: the same
    tokens, every one."""
    from k8s_device_plugin_tpu.workload.generate import greedy_generate

    shape = (1, N // 2, 1, 1, 1, 2)
    kw = dataclasses.asdict(dataclasses.replace(dryrun.plan_config({}), dtype=torch.float32))
    mesh = jax_mesh(shape)
    jcfg = dataclasses.replace(jmodel.ModelConfig.tiny(), dtype=jnp.float32)
    params, _, _ = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
    state = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.array, params), ModelConfig(**kw)).items()}
    batch = max(2 * N, 4)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, kw["vocab_size"], (batch, dryrun.DECODE_PROMPT), generator=gen)
    want = np.asarray(greedy_generate(jcfg, params, jax.device_put(
        jnp.asarray(prompt.numpy(), jnp.int32), batch_sharding(mesh)), dryrun.DECODE_STEPS))
    got = pool8.run(dryrun.decode_step, shape, batch, "cpu", kw, state)
    for r in got:
        index, shards = r["batch"]
        per = batch // shards
        np.testing.assert_array_equal(r["tokens"], want[index * per:(index + 1) * per])


def test_dryrun_main_takes_the_cpu_only_when_asked():
    """Without ``--dryrun-only`` the twin runs the dryrun at 8: with fewer
    than 8 cards and no ``--device cpu`` it refuses, naming both ways out,
    before it trains anything."""
    if torch.cuda.device_count() >= 8:
        pytest.skip("8 cards are here: the dryrun at 8 runs on them")
    with pytest.raises(SystemExit, match="--device cpu, or --dryrun-only N"):
        dryrun.main([])
    with pytest.raises(SystemExit, match="needs 8 cards"):
        dryrun.main(["--device", "cuda"])


def test_entry_twin_matches_jax_entry():
    """``entry()`` on the CPU: the loss of the default config on a batch of
    8, finite and near ln(vocab); on the JAX entry's weights and tokens,
    the JAX entry's loss (bf16)."""
    fn, args = dryrun.entry("cpu")
    with torch.no_grad():
        loss = float(fn(*args))
    assert abs(loss - np.log(ModelConfig().vocab_size)) < 0.5
    jfn, (jparams, jtokens) = graft.entry()
    want = float(jax.jit(jfn)(jparams, jtokens))
    model = init_model(ModelConfig(), 0, "cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.array, jparams),
                                          ModelConfig()))
    with torch.no_grad():
        got = float(train.loss_fn(model, torch.from_numpy(np.array(jtokens)).long()))
    assert got == pytest.approx(want, abs=1e-2)
