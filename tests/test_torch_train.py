"""The PyTorch port's AdamW train step against the JAX package's
``make_train_step`` on a one-device mesh, from the same weights and tokens.

float32, parameters within 1e-4 after 1 and after 3 steps: Adam's first
update is g / (|g| + eps), which turns rounding in a near-zero gradient
into a change of up to lr, so the tolerance is set by the update, not by
float32's epsilon.

With tracing on, ``train_step`` records ``train.step`` and, inside it,
``train.forward``, ``train.backward`` and ``train.optimizer``; off, it
records none and computes the same bits. A graph's capture records none.
"""

import contextlib
import time
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.parallel.mesh import batch_sharding, make_mesh
from k8s_device_plugin_tpu.workload import model as jmodel
from k8s_device_plugin_tpu.workload import train as jtrain
from k8s_device_plugin_tpu_torch.utils import tracing
from k8s_device_plugin_tpu_torch.workload import model as tmodel
from k8s_device_plugin_tpu_torch.workload import train as ttrain
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


@pytest.mark.parametrize(
    "flash,n_steps,pallas_norm",
    [(False, 1, False), (False, 3, False), (True, 3, False), (False, 3, True), (True, 3, True)],
    ids=["dense-1", "dense-3", "flash-3", "dense-3-pallas_norm", "flash-3-pallas_norm"],
)
def test_params_after_adamw_steps_match_jax(flash, n_steps, pallas_norm):
    kw = dict(use_flash_attention=flash, use_pallas_norm=pallas_norm, **SMALL)
    jcfg = jmodel.ModelConfig(dtype=jnp.float32, **kw)
    tcfg = tmodel.ModelConfig(dtype=torch.float32, **kw)
    mesh = make_mesh(jax.devices()[:1])
    params, opt_state, tx = jtrain.make_train_state(jcfg, mesh, jax.random.PRNGKey(0))
    # Copy out before the donating step consumes the buffers.
    start = jax.tree_util.tree_map(np.array, params)
    model = tmodel.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(start, tcfg))
    optimizer = ttrain.make_optimizer(model)

    rng = np.random.default_rng(11)
    tokens = rng.integers(0, SMALL["vocab_size"], (4, SMALL["max_seq_len"]), dtype=np.int32)
    step = jtrain.make_train_step(jcfg, mesh, tx)
    jtokens = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh))
    ttokens = torch.from_numpy(tokens).long()
    for _ in range(n_steps):
        params, opt_state, loss_j = step(params, opt_state, jtokens)
        loss_t = ttrain.train_step(model, optimizer, ttokens)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
    got = model.state_dict()
    for name, tensor in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), tensor.numpy(), atol=1e-4, rtol=0, err_msg=name
        )


def test_optimizer_uses_optax_adamw_defaults():
    model = tmodel.TransformerLM(tmodel.ModelConfig(**SMALL))
    group = ttrain.make_optimizer(model).param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 1e-4,
    )
    assert len(group["params"]) == len(list(model.parameters()))


PHASES = ["train.forward", "train.backward", "train.optimizer"]


def _state(seed=0):
    cfg = tmodel.ModelConfig(dtype=torch.float32, **SMALL)
    model = tmodel.init_model(cfg, seed, torch.device("cpu"))
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, SMALL["vocab_size"], (2, 4, SMALL["max_seq_len"]))).long()
    return model, ttrain.make_optimizer(model), tokens


@contextlib.contextmanager
def _traced(on=True):
    """Tracing on (or off) over the block: yields the list that holds,
    once the block is done, the spans that started in it."""
    was = tracing.enabled()
    if on:
        tracing.enable()
    else:
        tracing.disable()
    since = time.time_ns()
    found = []
    try:
        yield found
    finally:
        if not was:
            tracing.disable()
        found.extend(sp for sp in tracing.COLLECTOR.spans() if sp["start_ns"] >= since)


def test_traced_train_step_records_the_step_and_its_three_phases():
    model, optimizer, tokens = _state()
    with _traced() as spans:
        ttrain.train_step(model, optimizer, tokens[0])
    (step,) = [sp for sp in spans if sp["name"] == "train.step"]
    children = sorted((sp for sp in spans if sp is not step), key=lambda sp: sp["start_ns"])
    assert [sp["name"] for sp in children] == PHASES
    assert step["parent_span_id"] == "" and step["service"] == "workload"
    for sp in children:
        assert sp["parent_span_id"] == step["span_id"]
        assert sp["trace_id"] == step["trace_id"] and sp["service"] == "workload"
        assert step["start_ns"] <= sp["start_ns"] <= sp["end_ns"] <= step["end_ns"]
    for a, b in zip(children, children[1:]):
        assert a["end_ns"] <= b["start_ns"]


def test_the_steps_autograd_graph_is_released_inside_its_span(monkeypatch):
    """The graph's teardown (milliseconds at 48 layers) is host work of the
    step, so ``train.step`` ends after it: a node holding a token on the
    loss frees it before the span's end."""
    freed = []

    class Token:
        pass

    class Hold(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, token):
            ctx.token = token
            return x.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    loss_fn = ttrain.loss_fn

    def holding(*args):
        token = Token()
        weakref.finalize(token, lambda: freed.append(time.time_ns()))
        return Hold.apply(loss_fn(*args), token)

    monkeypatch.setattr(ttrain, "loss_fn", holding)
    model, optimizer, tokens = _state()
    with _traced() as spans:
        ttrain.train_step(model, optimizer, tokens[0])
    (step,) = [sp for sp in spans if sp["name"] == "train.step"]
    assert len(freed) == 1 and freed[0] <= step["end_ns"]


def test_untraced_train_step_records_nothing_and_computes_the_same_bits():
    runs = []
    for on in (False, True):
        model, optimizer, tokens = _state()
        with _traced(on) as spans:
            losses = [ttrain.train_step(model, optimizer, t) for t in tokens]
        runs.append((losses, model.state_dict(), spans))
    (off_losses, off_params, off_spans), (on_losses, on_params, on_spans) = runs
    assert off_spans == [] and len(on_spans) == 8
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    assert off_params.keys() == on_params.keys()
    assert all(torch.equal(off_params[k], on_params[k]) for k in off_params)


def test_graph_capture_and_replays_record_no_span(monkeypatch):
    """The CPU's multi-step call is the eager loop of ``train_step``, a
    step's spans a step. A graph's warm-up steps are eager ``train_step``s
    and record theirs; its capture (``_loss_and_update``, run here eagerly
    under stand-ins for the CUDA stream and graph) and its replays record
    none."""
    model, optimizer, tokens = _state()
    with _traced() as spans:
        ttrain.make_multi_train_step(model, optimizer, 2)(tokens)
    assert [sp["name"] for sp in spans if sp["parent_span_id"] == ""] == ["train.step"] * 2

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    graph = types.SimpleNamespace(replay=lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    inner = ttrain.WARMUP_STEPS + 1
    stack = tokens[torch.arange(inner) % 2]
    graphed = ttrain.GraphedTrainStep(model, optimizer, inner)
    with _traced() as spans:
        warm = graphed._warm_up_and_capture(stack, torch.empty(inner))
        graphed.graph.replay()
    assert warm == ttrain.WARMUP_STEPS and graphed.loss is not None
    assert [sp["name"] for sp in spans if sp["parent_span_id"] == ""] == ["train.step"] * warm
    assert len(spans) == 4 * warm
