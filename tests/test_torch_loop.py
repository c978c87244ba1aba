"""The PyTorch port's resumable training loop (``workload/loop.py``) against
the JAX package's ``run_training``, and the loop's utilities: the kernel
build cache (``utils/compilation_cache.py``) and the profiler trace
(``utils/profiling.py``).

The JAX loop runs in a child interpreter, as ``tests/test_checkpointing.py``
runs it (a crash of the CPU pjit path costs one test, not the run); it
hands back its losses, its initial weights and the tokens of each step.
The port's loop is fed the same weights and tokens by patching its
``make_train_state`` and ``synthetic_batch``.

Tolerance: float32 losses within 1e-5 relative, the bound of the f32
train-step parity tests (``tests/test_torch_train.py``,
``tests/test_torch_multistep.py``); the largest gap read 2.3e-7 relative
(torch 2.13 on the CPU).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import _build
from k8s_device_plugin_tpu_torch.utils import compilation_cache, profiling
from k8s_device_plugin_tpu_torch.workload import loop, train
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
from k8s_device_plugin_tpu_torch.workload.params import from_jax_params

STEPS = 6
BATCH_PER_DEVICE = 4
LOSS_RTOL = 1e-5


def _jax_run(tmp_path) -> tuple[dict, dict, np.ndarray]:
    """The JAX ``run_training`` of ``tiny()`` at float32 on one device, 6
    steps from seed 0: its report, its initial parameters and the tokens
    of each step (``synthetic_batch``)."""
    out = tmp_path / "jax"
    code = textwrap.dedent(
        f"""
        import json, jax, jax.numpy as jnp, numpy as np
        from k8s_device_plugin_tpu.parallel.mesh import make_mesh
        from k8s_device_plugin_tpu.workload import train
        from k8s_device_plugin_tpu.workload.loop import run_training, synthetic_batch
        from k8s_device_plugin_tpu.workload.model import ModelConfig
        cfg = ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                          max_seq_len=16, dtype=jnp.float32)
        mesh = make_mesh(jax.devices()[:1])
        params, _, _ = train.make_train_state(cfg, mesh, jax.random.PRNGKey(0))
        flat = {{jax.tree_util.keystr(k): np.asarray(v)
                 for k, v in jax.tree_util.tree_leaves_with_path(params)}}
        np.savez({str(out)!r} + "-params.npz", **flat)
        tokens = np.stack([np.asarray(synthetic_batch(cfg, mesh, {BATCH_PER_DEVICE}, s))
                           for s in range({STEPS})])
        np.save({str(out)!r} + "-tokens.npy", tokens)
        r = run_training(cfg, steps={STEPS}, batch_per_device={BATCH_PER_DEVICE}, seed=0,
                         mesh=mesh)
        json.dump({{"losses": [float(x) for x in r["losses"]], "start_step": r["start_step"],
                    "end_step": r["end_step"], "resumed": r["resumed"],
                    "mesh": dict(r["mesh"])}}, open({str(out)!r} + ".json", "w"))
        """
    )
    p = subprocess.run([sys.executable, "-c", code], env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, f"JAX loop died rc={p.returncode}: {p.stderr[-800:]}"
    report = json.load(open(f"{out}.json"))
    with np.load(f"{out}-params.npz") as flat:
        params = _unflatten({k: flat[k] for k in flat.files})
    return report, params, np.load(f"{out}-tokens.npy")


def _unflatten(flat: dict) -> dict:
    """``{"['params']['embed']": a, ...}`` back into the nested tree."""
    tree: dict = {}
    for path, value in flat.items():
        keys = [k.strip("'") for k in path.strip("[]").split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def test_run_training_matches_the_jax_loop(tmp_path, monkeypatch):
    """The port's ``run_training`` (world of one, CPU) on the JAX loop's
    weights and token stream: the same report keys and values, and each
    loss within ``LOSS_RTOL``."""
    want, params, tokens = _jax_run(tmp_path)
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=torch.float32)
    make_train_state = train.make_train_state

    def from_jax(cfg, device, seed, mesh=None):
        model, optimizer = make_train_state(cfg, device, seed, mesh=mesh)
        model.load_state_dict(from_jax_params(params, cfg))
        return model, optimizer

    monkeypatch.setattr(train, "make_train_state", from_jax)
    monkeypatch.setattr(loop, "synthetic_batch",
                        lambda cfg, mesh, batch, step, dev: torch.from_numpy(tokens[step]).long())
    got = loop.run_training(cfg, steps=STEPS, batch_per_device=BATCH_PER_DEVICE, seed=0,
                            device="cpu")
    for key in ("start_step", "end_step", "resumed", "mesh"):
        assert got[key] == want[key], key
    assert got["first_loss"] == got["losses"][0] and got["final_loss"] == got["losses"][-1]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=0)
    assert len(got["step_s"]) == STEPS and got["restore_s"] is None and got["save_s"] == []


def test_synthetic_batch_is_seeded_by_step_and_sharded():
    """Each step's global batch comes from the step's own seed, whatever
    ran before, and a rank keeps its (data, fsdp) rows."""
    from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh

    cfg = ModelConfig.tiny()
    mesh = make_mesh(1, device="cpu")
    a = loop.synthetic_batch(cfg, mesh, 4, 5, "cpu")
    loop.synthetic_batch(cfg, mesh, 4, 6, "cpu")
    assert torch.equal(a, loop.synthetic_batch(cfg, mesh, 4, 5, "cpu"))
    assert not torch.equal(a, loop.synthetic_batch(cfg, mesh, 4, 6, "cpu"))
    assert a.shape == (4, cfg.max_seq_len) and a.dtype == torch.long


def test_run_training_needs_cuda_unless_cpu_is_asked():
    """The entry point runs on the card unless the caller asks for the
    CPU: without CUDA it raises before training anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.run_training(ModelConfig.tiny(), steps=1)


def test_run_training_traces_into_the_profile_dir(tmp_path, monkeypatch):
    """``TPU_WORKLOAD_PROFILE_DIR`` captures the run as a trace file that
    names each step's region."""
    monkeypatch.setenv(loop.PROFILE_DIR_ENV, str(tmp_path / "trace"))
    loop.run_training(ModelConfig.tiny(), steps=2, batch_per_device=2, device="cpu")
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 2


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with profiling.trace(""), profiling.annotate("x"):
        pass
    with profiling.trace(None):
        pass
    assert not list(tmp_path.iterdir())


def test_compilation_cache_is_the_kernel_build_directory(tmp_path, monkeypatch):
    """``maybe_enable`` keeps the JAX return contract (False without a
    directory, True with one, the argument before the environment) and
    points the kernel build there, for this process and the ranks it
    starts; without it the build stays beside the sources."""
    monkeypatch.delenv(compilation_cache.ENV_VAR, raising=False)
    assert compilation_cache.maybe_enable() is False
    assert _build.build_dir() == _build.BUILD_DIR
    monkeypatch.setenv(compilation_cache.ENV_VAR, str(tmp_path / "env"))
    assert compilation_cache.maybe_enable(tmp_path / "arg") is True
    assert os.environ[compilation_cache.ENV_VAR] == str(tmp_path / "arg")
    assert _build.build_dir() == tmp_path / "arg" and (tmp_path / "arg").is_dir()
    assert compilation_cache.maybe_enable() is True  # again: idempotent
    assert _build.build_dir() == tmp_path / "arg"


@pytest.mark.parametrize("kind", ["file", "under-a-file", "dangling-link"])
def test_compilation_cache_refuses_a_directory_it_cannot_use(tmp_path, monkeypatch, kind):
    """A cache directory that cannot hold a build raises, at ``maybe_enable``
    and at the build; nothing moves the build elsewhere."""
    monkeypatch.delenv(compilation_cache.ENV_VAR, raising=False)
    path = tmp_path / "cache"
    if kind == "file":
        path.write_text("not a directory")
    elif kind == "under-a-file":
        (tmp_path / "f").write_text("")
        path = tmp_path / "f" / "cache"
    else:
        path.symlink_to(tmp_path / "gone")
        (tmp_path / "gone").mkdir()
        (tmp_path / "gone").rmdir()
    with pytest.raises(RuntimeError, match="cannot be used"):
        compilation_cache.maybe_enable(path)
    assert compilation_cache.ENV_VAR not in os.environ
    monkeypatch.setenv(compilation_cache.ENV_VAR, str(path))
    with pytest.raises(RuntimeError, match="cannot be used"):
        _build.build_all()
